#!/usr/bin/env python3
"""Device memory of the decode loop's slabs, on one CUDA GPU.

    python3 scripts/slab_memory.py [--batch 32] [--seconds 300]
                                   [--max-new 4096] [--warm 1,8]
                                   [--port-root DIR]

One AsrEngine of the PyTorch/CUDA port at the full Qwen3-ASR-0.6B width
and depth, bf16 weights and KV slab, synthetic weights from the JAX
package's seeds, ``max_new_tokens`` the engine's default (4096). Three
steps, each printed as one JSON line with nvidia-smi's name and power
limit: the bytes allocated after the step and its peak during the step,
both over what the engine held before the first step (its weights), the
bytes the caching allocator reserved after it, the wall seconds and the
loop's last_stats (decode steps, slab lengths):

1. ``warmup(batch_sizes=(B,), buckets=(the clip's bucket,))``
2. ``transcribe_batch`` of B synthetic clips of ``--seconds`` (random
   weights emit no EOS, so the loop decodes to the cap through every
   slab stage)
3. ``warmup`` of the ``--warm`` batch sizes at the same bucket

``--port-root DIR`` imports the port from DIR instead (an unpacked older
tree), so that two versions can be measured in turns on one card.
Imports nothing of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--max-new", type=int, default=4096)
    ap.add_argument("--warm", default="1,8",
                    help="comma-separated batch sizes of the last warmup")
    ap.add_argument("--port-root", type=Path, default=REPO,
                    help="directory holding the qwen3_asr_rs_tpu_torch "
                         "package to measure")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("slab_memory: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    sys.path.insert(0, str(args.port_root.resolve()))
    from qwen3_asr_rs_tpu_torch.audio.load import load_audio
    from qwen3_asr_rs_tpu_torch.config import AsrConfig
    from qwen3_asr_rs_tpu_torch.features.mel import num_mel_frames
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np, init_encoder_params_np)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build()
    config = AsrConfig()
    engine = AsrEngine(None, dtype=torch.bfloat16,
                       max_new_tokens=args.max_new, config=config,
                       params=(init_encoder_params_np(config.audio),
                               init_decoder_params_np(config.text)),
                       tokenizer=smoke.StubTokenizer(), device="cuda")
    with tempfile.TemporaryDirectory(prefix="slab_memory_") as tmp:
        path = Path(tmp) / "clip.wav"
        smoke.write_wav(path, args.seconds, 3)
        clip = load_audio(path, 16000)
    bucket = engine._pick_bucket(num_mel_frames(len(clip)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gib = 2.0 ** 30

    def measure(step, fn):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        st = engine.last_stats
        print(json.dumps({
            "step": step, "B": args.batch, "clip_seconds": args.seconds,
            "bucket_chunks": bucket, "max_new_tokens": args.max_new,
            "wall_s": time.perf_counter() - t0,
            "allocated_gib": (torch.cuda.memory_allocated() - base) / gib,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / gib,
            "reserved_gib": torch.cuda.memory_reserved() / gib,
            "weights_gib": base / gib,
            "decode_steps": st.get("decode_steps"),
            "slab_lens": st.get("slab_lens"),
            "port_root": str(args.port_root), "card": card}), flush=True)

    measure(f"warmup B={args.batch}",
            lambda: engine.warmup((args.batch,), (bucket,)))
    measure(f"transcribe_batch {args.batch} x {args.seconds:g} s",
            lambda: engine.transcribe_batch([clip] * args.batch))
    warm = tuple(int(b) for b in args.warm.split(","))
    measure(f"warmup B={warm}", lambda: engine.warmup(warm, (bucket,)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
