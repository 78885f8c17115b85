#!/usr/bin/env python3
"""The sampled decode step and the sampled serving step, on one CUDA GPU.

    python3 scripts/sampling_step.py [--port-root DIR] [--repeats 3]
                                     [--sections decode,serving]

Full Qwen3-ASR-0.6B width, bf16, synthetic weights from the JAX
package's seeds, the 4 s clip of chip_smoke.py. Prints one JSON line per
measurement, each with nvidia-smi's name and power limit of the card:

1. decode — the engine's decode loop on CUDA graphs (a capture run
   first), greedy and sampled (chip_smoke's SAMPLED: temperature 0.7,
   top-k 50, top-p 0.9, seed 0) at B = 1 and 8: wall and GPU elapsed ms
   per step (``last_stats``), and busy ms per step (the union of the
   loop's device intervals under torch.profiler, chip_smoke's
   loop_events), ``--repeats`` runs each.
2. serving — a ContinuousBatcher of 8 slots after warmup, every slot
   decoding the 4 s clip, greedy and sampled (chip_smoke's
   SERVING_SAMPLED: temperature 0.7, top-p 0.9): chip_smoke's
   serving_steady (wall, GPU elapsed and busy ms per decode step),
   ``--repeats`` runs each.

``--port-root DIR`` imports the port from DIR (an unpacked older commit
under the git-ignored ``build/``), so that two versions can be timed in
turns on one card: parent, change, change, parent. Imports nothing of
JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-root", type=Path, default=REPO,
                    help="directory holding the qwen3_asr_rs_tpu_torch "
                         "package to time")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sections", default="decode,serving",
                    help="comma-separated sections: decode, serving")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sampling_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    sys.path.insert(0, str(args.port_root.resolve()))
    from qwen3_asr_rs_tpu_torch.audio.load import load_audio
    from qwen3_asr_rs_tpu_torch.config import AsrConfig
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.runtime.sampling import SamplingParams
    from qwen3_asr_rs_tpu_torch.runtime.serving import ContinuousBatcher
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np, init_encoder_params_np, to_torch)

    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

    def emit(row):
        row.update(card=card, port_root=str(args.port_root))
        print(json.dumps(row), flush=True)

    _build.build()
    config = AsrConfig()
    params = (to_torch(init_encoder_params_np(config.audio), torch.float32,
                       "cuda"),
              to_torch(init_decoder_params_np(config.text), torch.float32,
                       "cuda"))
    engine = AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=128,
                       config=config, params=params,
                       tokenizer=smoke.StubTokenizer(), device="cuda")
    with tempfile.TemporaryDirectory(prefix="sampling_step_") as tmp:
        wav = Path(tmp) / "clip_4s.wav"
        smoke.write_wav(wav, 4, 1)
        clip = load_audio(wav, 16000)

    def decode(b, sampling):
        if b == 1:
            return [engine.generate(clip, sampling=sampling)]
        return engine.generate_batch([clip] * b, [None] * b,
                                     np.ones(b, bool), sampling=sampling)

    sections = set(args.sections.split(","))
    for b in (1, 8) if "decode" in sections else ():
        for name, sp in (("greedy", None),
                         ("sampled", SamplingParams(seed=0,
                                                    **smoke.SAMPLED))):
            decode(b, sp)  # capture
            runs = []
            for _ in range(args.repeats):
                torch.cuda.synchronize()
                decode(b, sp)
                st = engine.last_stats
                n = st["decode_steps"]
                _, events = smoke.loop_events(torch, lambda: decode(b, sp))
                busy = engine.last_stats["decode_steps"]
                runs.append({
                    "wall_ms_per_step": 1e3 * st["decode_seconds"] / n,
                    "gpu_ms_per_step": 1e3 * st["decode_gpu_seconds"] / n,
                    "busy_ms_per_step": (smoke.busy_us(events) / 1e3 / busy
                                         if events else None),
                    "steps": n})
            emit({"section": "decode", "B": b, "mode": name,
                  "runs": runs, **{k: statistics.median(
                      r[k] for r in runs) for k in (
                      "wall_ms_per_step", "gpu_ms_per_step",
                      "busy_ms_per_step") if all(r[k] is not None
                                                 for r in runs)}})

    if "serving" not in sections:
        return 0
    batcher = ContinuousBatcher(engine, n_slots=8)
    batcher.warmup(buckets=[engine._pick_bucket(-(-len(clip) // 160))])
    clock = smoke.SegmentClock(torch, batcher)
    for name, sp in (("greedy", None), ("sampled", smoke.SERVING_SAMPLED)):
        runs = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            runs.append(smoke.serving_steady(torch, batcher, clock,
                                             [clip] * 8, sp))
            runs[-1]["seconds"] = time.perf_counter() - t0
        emit({"section": "serving", "slots": 8, "mode": name, "runs": runs,
              **{k: statistics.median(r[k] for r in runs) for k in (
                  "wall_ms_per_step", "gpu_ms_per_step",
                  "busy_ms_per_step") if all(r[k] is not None
                                             for r in runs)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
