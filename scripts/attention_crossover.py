#!/usr/bin/env python3
"""K3 (flash_attention) against the dense prefill attention, on one CUDA GPU.

    python3 scripts/attention_crossover.py [--chunks 30,60,120,240,360]
                                           [--batch 1,8] [--reps 10]

At the prompt length of each chunk bucket (``AsrEngine._prompt_bucket``:
432 tokens at 30 chunks, 4736 at 360) and each batch size, with
Qwen3-ASR-0.6B decoder shapes (16 query heads over 8 kv heads, D = 128),
bf16, causal, and at B > 1 per-row kv_start (right-aligned prompts, as
chip_smoke's ``row_starts``), it times

- ``flash_attention`` (K3),
- ``attention(impl="dense")`` (``ops/attention.py``: float32 scores and
  softmax, the path the auto dispatch takes below the threshold),
- ``scaled_dot_product_attention`` (causal, GQA; at B > 1 with an
  additive mask for kv_start), the library's yardstick,

by device time (``chip_smoke.device_ms``: torch.profiler's device time
of a window of ``--reps`` calls over ``--reps``, the median of three
windows) and by CUDA events around the call, and
reports which one the auto dispatch picks at the default
``ASR_ATTN_THRESHOLD`` (4096, the JAX package's). One JSON line per case,
each with nvidia-smi's name and power limit of the card. Imports nothing
of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import types
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", default="30,60,120,240,360")
    ap.add_argument("--batch", default="1,8")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attention_crossover: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from qwen3_asr_rs_tpu_torch.config import AsrConfig
    from qwen3_asr_rs_tpu_torch.ops.attention import (
        MASK_VALUE, attention, auto_attention_impl)
    from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_attention)
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    config = AsrConfig()
    text = config.text
    hq, hkv, d = (text.num_attention_heads, text.num_key_value_heads,
                  text.head_dim)
    stub = types.SimpleNamespace(config=config)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for chunks in map(int, args.chunks.split(",")):
        s = AsrEngine._prompt_bucket(stub, chunks)
        for b in map(int, args.batch.split(",")):
            q = torch.randn((b, s, hq, d), generator=gen,
                            device="cuda").bfloat16()
            k = torch.randn((b, s, hkv, d), generator=gen,
                            device="cuda").bfloat16()
            v = torch.randn_like(k)
            starts = [st % (s // 2) for st in smoke.row_starts(b)]
            kv_start = (torch.tensor(starts, dtype=torch.int32,
                                     device="cuda") if b > 1 else None)
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            if kv_start is None:
                def library():
                    return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            else:
                pos = torch.arange(s, device="cuda")
                ok = ((pos[None, :] <= pos[:, None])[None]
                      & (pos[None, None, :] >= kv_start[:, None, None]))
                mask = torch.where(ok, 0.0, MASK_VALUE).to(torch.bfloat16)[
                    :, None]

                def library():
                    return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
            calls = {
                "flash": lambda: flash_attention(q, k, v, None, kv_start,
                                                 causal=True),
                "dense": lambda: attention(q, k, v, causal=True,
                                           kv_start=kv_start, impl="dense"),
                "sdpa": library,
            }
            row = {"section": "attention_crossover", "chunks": chunks,
                   "prompt": s, "B": b, "kv_start": starts if b > 1 else None,
                   "auto_impl_at_4096": auto_attention_impl(b, hq, s, s, True),
                   # causal, keys from the row's start
                   "flops": 4 * hq * d * sum(
                       (s - s0) * (s - s0 + 1) // 2
                       for s0 in (starts if b > 1 else [0]))}
            for name, fn in calls.items():
                try:
                    row[f"{name}_device_ms"] = smoke.device_ms(
                        torch, fn, reps=args.reps)
                    row[f"{name}_event_ms"] = smoke.cuda_ms(torch, fn,
                                                            reps=args.reps)
                except torch.cuda.OutOfMemoryError:
                    row[f"{name}_device_ms"] = row[f"{name}_event_ms"] = None
                    row[f"{name}_note"] = "out of device memory"
                    torch.cuda.empty_cache()
            row["flash_TFLOP_per_s"] = (row["flops"] / row["flash_device_ms"]
                                        / 1e9)
            row["faster"] = min(
                ("flash", "dense"),
                key=lambda n: row[f"{n}_device_ms"] or float("inf"))
            row["card"] = card
            print(json.dumps(row), flush=True)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
