#!/usr/bin/env python3
"""K3 (flash_attention) against the dense attention, at the shapes the
port's callers of ``ops/attention.py::attention`` produce, on one CUDA GPU.

    python3 scripts/attention_crossover.py [--chunks 30,60,120,240,360]
                                           [--batch 1,8,32,64]
                                           [--windows 1x30,8x30,32x30,64x30,2x360]
                                           [--reps 10]

Two sections, bf16, Qwen3-ASR's widths (the 0.6B's and the 1.7B's
decoders share 16 query heads over 8 kv heads of 128):

- ``decoder``: the text decoder's prefill at the prompt length of each
  chunk bucket (``AsrEngine._prompt_bucket``: 432 tokens at 30 chunks,
  4736 at 360) and each batch size, causal. At B > 1 the rows are
  right-aligned prompts, as ``prefill_batch`` lays them out: row r's
  clip lasts a lognormal draw of median chunks / 3 seconds (sigma 0.5,
  within [1, chunks]: the ``asr17-batch-b32`` traffic at 30 chunks), its
  prompt is its audio tokens plus 15 prompt ids, and ``kv_start`` is the
  bucket less that. At B = 1 the prompt fills the bucket (``prefill``).
- ``encoder``: the audio tower's windows for ``CLIPSxCHUNKS`` (clips of
  one chunk bucket: ``chunks_per_window`` chunks, 104 tokens, a window),
  14 heads of 64, not causal, ``kv_valid`` each window's valid tokens
  (clip lengths drawn as above; a window past a clip's end has 0).

For each case it times

- ``flash_attention`` (K3),
- ``attention(impl="dense")`` (float32 scores, masks and softmax),
- ``scaled_dot_product_attention`` (GQA; with an additive bf16 mask for
  kv_start / kv_valid), the library's yardstick,

by device time (``chip_smoke.device_ms``: torch.profiler's device time
of a window of ``--reps`` calls over ``--reps``, the median of three
windows) and by CUDA events around the call, holds K3 to the dense path
on the rows that have a key to attend (bf16 bound of ``chip_smoke``:
2e-2 + 2^-7 max|dense|; every output finite), and reports which path
``auto_attention_impl`` picks for the case (``auto``) beside the faster
one. One JSON line per case, each with nvidia-smi's name and power limit
of the card. Imports nothing of JAX. Exits non-zero without a CUDA
device, and when K3 leaves the bound.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", default="30,60,120,240,360")
    ap.add_argument("--batch", default="1,8,32,64")
    ap.add_argument("--windows", default="1x30,8x30,32x30,64x30,2x360")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attention_crossover: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from qwen3_asr_rs_tpu_torch.config import AsrConfig, audio_tokens
    from qwen3_asr_rs_tpu_torch.ops.attention import (
        attention, auto_attention_impl)
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
    text, audio = config.text, config.audio
    stub = types.SimpleNamespace(config=config)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    failed = []

    def run_case(row, b, s, hq, hkv, d, causal, kv_valid, kv_start, live):
        """Times the three paths at one shape; ``live[r]``: row r's first
        query with a key to attend (K3's other rows are discarded)."""
        q = torch.randn((b, s, hq, d), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((b, s, hkv, d), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn_like(k)
        idx = {n: (None if x is None else torch.tensor(
            x, dtype=torch.int32, device="cuda"))
            for n, x in (("kv_valid", kv_valid), ("kv_start", kv_start))}
        library = smoke.sdpa_masked(torch, q, k, v, causal, idx["kv_valid"],
                                    idx["kv_start"])
        calls = {
            "flash": lambda: flash_attention(q, k, v, idx["kv_valid"],
                                             idx["kv_start"], causal=causal),
            "dense": lambda: attention(q, k, v, causal=causal,
                                       kv_valid=idx["kv_valid"],
                                       kv_start=idx["kv_start"],
                                       impl="dense"),
            "sdpa": library,
        }
        row["auto"] = auto_attention_impl(b, hq, s, s, on_cuda=True,
                                          dtype=torch.bfloat16, grad=False,
                                          head_dim=d)
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
        got = calls["flash"]()
        row["flash_finite"] = bool(torch.isfinite(got.float()).all())
        if row["dense_device_ms"] is not None:
            ref = calls["dense"]().float()
            err, bound = 0.0, 0.0
            for r, s0 in enumerate(live):
                if s0 is None:
                    continue
                err = max(err, float((got[r, s0:].float()
                                      - ref[r, s0:]).abs().max()))
                bound = max(bound, float(2e-2 + 2 ** -7
                                         * ref[r, s0:].abs().max()))
            row["flash_vs_dense_max_err"], row["bound"] = err, bound
            if err > bound:
                failed.append(row)
        if not row["flash_finite"]:
            failed.append(row)
        row["flash_TFLOP_per_s"] = (row["flops"] / row["flash_device_ms"]
                                    / 1e9)
        row["faster"] = min(
            ("flash", "dense"),
            key=lambda n: row[f"{n}_device_ms"] or float("inf"))
        row["card"] = card
        print(json.dumps(row), flush=True)
        del q, k, v, library, calls
        torch.cuda.empty_cache()

    hq, hkv, d = (text.num_attention_heads, text.num_key_value_heads,
                  text.head_dim)
    for chunks in map(int, args.chunks.split(",")):
        s = AsrEngine._prompt_bucket(stub, chunks)
        for b in map(int, args.batch.split(",")):
            if b == 1:
                starts = None
                lens = [s]
            else:
                lens = [audio_tokens(audio, f) + smoke.PROMPT_IDS for f in
                        smoke.clip_frames(rng, b, chunks, audio.chunk_frames)]
                starts = [s - n for n in lens]
            row = {"section": "decoder", "chunks": chunks, "prompt": s,
                   "B": b, "live_mean": float(np.mean(lens)),
                   # causal, keys from the row's start
                   "flops": 4 * hq * d * sum(n * (n + 1) // 2
                                             for n in lens)}
            run_case(row, b, s, hq, hkv, d, True, None, starts,
                     starts or [0])

    nh = audio.encoder_attention_heads
    hd = audio.d_model // nh
    for spec in args.windows.split(","):
        clips, chunks = map(int, spec.split("x"))
        per_clip = -(-chunks // audio.chunks_per_window)
        s = min(chunks, audio.chunks_per_window) * audio.tokens_per_chunk
        counts = []
        for f in smoke.clip_frames(rng, clips, chunks, audio.chunk_frames):
            n = audio_tokens(audio, f)
            counts += [int(np.clip(n - w * s, 0, s)) for w in range(per_clip)]
        row = {"section": "encoder", "clips": clips, "chunks": chunks,
               "windows": len(counts), "window_tokens": s,
               "empty_windows": counts.count(0),
               "flops": 4 * nh * hd * s * sum(counts)}
        run_case(row, len(counts), s, nh, nh, hd, False, counts, None,
                 [0 if c else None for c in counts])
    if failed:
        print(f"attention_crossover: K3 out of bound or not finite in "
              f"{len(failed)} case(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
