#!/usr/bin/env python3
"""Where the time of a full-width training step goes, on one CUDA GPU.

    python3 scripts/profile_train_step.py [--steps 3] [--no-remat]
                                          [--port-root DIR]

The step of ``chip_smoke.py``'s phase 11: Qwen3-ASR-0.6B at full width
and depth, synthetic weights from the JAX package's seeds, AdamW(1e-3),
float32 with TF32 off, one batch of eight ~28 s clips from ``AsrDataset``
(30-chunk bucket, 544 tokens). After two unprofiled steps, ``--steps`` steps run
under torch.profiler. Prints one JSON line with nvidia-smi's name and
power limit: wall ms per step (host clock, synchronized), the device's
busy ms per step (the union of kernel intervals), the busy share, device
ms per step by kernel (the largest 15) and by class (products: GEMM
kernels; the optimizer: multi-tensor kernels; the rest: elementwise,
reductions, copies), and the peak memory. With ``--port-root DIR`` (an
unpacked older commit under the git-ignored ``build/``) it profiles that
tree's port on the same card.
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


def kernel_class(name: str) -> str:
    low = name.lower()
    if "gemm" in low or "sm90_xmma" in low or "cutlass" in low:
        return "products"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer"
    return "other"


def busy_ms(events) -> float:
    """The union of the device intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--port-root", default=str(REPO))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.port_root).resolve()), str(REPO)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from qwen3_asr_rs_tpu_torch import AsrConfig
    from qwen3_asr_rs_tpu_torch.training import (
        AsrDataset, TrainState, adamw, make_train_step, prefetch_to_device)
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np, init_encoder_params_np, to_torch)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    config = AsrConfig()
    tmp = Path(tempfile.mkdtemp(prefix="profile_train_"))
    ds = AsrDataset(cs.train_corpus(tmp, cs.TRAIN_SECONDS, 11),
                    cs.WordTokenizer(), config=config,
                    batch_size=cs.TRAIN_B)
    batch = next(prefetch_to_device(ds.batches(), device="cuda"))
    state = TrainState.create(
        {"encoder": to_torch(init_encoder_params_np(config.audio),
                             torch.float32, "cuda"),
         "decoder": to_torch(init_decoder_params_np(config.text),
                             torch.float32, "cuda")}, adamw(cs.TRAIN_LR))
    remat = not args.no_remat
    step = make_train_step(config, adamw(cs.TRAIN_LR), remat=remat,
                           device="cuda")
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, loss = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps * 1e3
    # kernels only: a record_function range (the optimizer's step) also
    # shows on the device's timeline
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    by_kernel, by_class = {}, {}
    for e in device:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / args.steps
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + ms
        c = kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + ms
    busy = busy_ms(device) / args.steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "section": "train_step", "nvidia_smi": card,
        "port_root": args.port_root,
        "batch": list(batch["token_ids"].shape),
        "remat": remat, "steps": args.steps, "loss": float(loss),
        "wall_ms_per_step": wall, "busy_ms_per_step": busy,
        "busy_share": busy / wall,
        "device_ms_by_class": by_class,
        "device_ms_top_kernels": [[n[:120], ms] for n, ms in top],
        "kernels_per_step": len(device) / args.steps,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
