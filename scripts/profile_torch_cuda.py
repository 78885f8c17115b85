#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, on one CUDA GPU.

    python3 scripts/profile_torch_cuda.py [--seeds 8] [--steps 64]
                                          [--quantize none,int8,int4,int4g]
                                          [--batch 1,8,32] [--kv bf16,int8]
                                          [--fold] [--port-root DIR]
                                          [--prefill 30,300]
                                          [--sections k4,k1,decode,prefill]

Full Qwen3-ASR-0.6B width, bf16 activations, synthetic weights from the
JAX package's seeds, for each weight mode of ``--quantize`` (none: bf16
weights; int8 / int4 / int4g: the engine's merged quantized layout, int4
with its int4 lm_head, int4g with group size 128 and an int8 lm_head).
``--fold`` folds the lm_head into K1 (``ASR_FOLD_LM=1``; not with an
int4 lm_head) in k1_parts and decode_step. Prints one JSON line per
section and mode, each with nvidia-smi's name and power limit of the
card:

1. k1_error_spread — K1 (decode_layers_fused) bf16 against its plain
   version at chip_smoke's slab cases, over ``--seeds`` input seeds:
   max|kernel - plain| / max|plain| for every run.
2. k1_parts — K1 alone at S=360 (and S=4992 for B <= 8), for each
   batch size of ``--batch`` (rows start at chip_smoke's per-row starts,
   capped at half the end) and slab type of ``--kv`` (bf16, or int8 with
   per-slot scales): wall per call (20 calls between synchronisations),
   host time to enqueue one call, and per kernel class its launches,
   device microseconds (exclusive of the overlap of kernels launched with
   programmatic dependent launch, device_times) and weight or K/V bytes
   per call, from torch.profiler's device events.
3. decode_step — ``decode_step_token`` with one host read of the token
   per step (the engine's loop before its CUDA graphs; chip_smoke.py's
   phase 7 times the graph loop) on the 4 s clip: wall per step with
   and without the profiler, device time by kernel class per step, and
   the device's busy share under the profiler.
4. prefill — ``AsrEngine.prefill`` of each clip of ``--prefill`` (30
   and 300 s: prompts of 432 and 4736 tokens; "batch": chip_smoke's five
   clips of 4 to 30 s through ``prefill_batch``, 8 rows of 432): wall,
   device time by
   kernel (the largest 12) and by kernel class, the busy share, and K5's
   (int8 quant_matmul's) launches, device time and share of the device
   time; fails unless the profile holds one K5 product kernel per launch
   that K5's wrapper counted.
5. k4 — once, K4 (quant_matvec_int4) on the int4 lm_head at 1, 8 and 32
   bf16 rows: event and device ms (chip_smoke's cuda_ms and device_ms),
   the bound, and tinygemm's (torch._weight_int4pack_mm) times.

``--sections`` picks the sections to run (k1 covers k1_error_spread and
k1_parts). ``--port-root DIR`` imports the port from DIR instead (an unpacked
older commit that has the port's own ``config`` and ``audio`` copies),
so that two versions can be compared in turns on one card; a port
without weight quantization takes ``--quantize none``, one without
batched K1 or int8 slabs ``--batch 1 --kv bf16``.
Imports nothing of JAX. Exits non-zero without a CUDA device.
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


def device_times(prof) -> dict:
    """{device event name: [count, exclusive microseconds]} of a profile:
    each event counts from its start, or from the end of the events that
    started before it where that is later, to its end, so that a kernel
    launched with programmatic dependent launch, which starts while its
    predecessor runs and waits for it, counts only its own time; the
    totals add up to the time in which the device ran anything."""
    from torch.autograd import DeviceType

    out: dict = {}
    run_end = float("-inf")
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        c = out.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += max(0.0, b - max(a, run_end))
        run_end = max(run_end, b)
    if not out:
        raise RuntimeError("torch.profiler recorded no device events")
    return out


def kernel_class(name: str) -> str:
    """The decode step's kernels by role; anything else by its name."""
    for gemv in ("gemv_kernel<", "gemv_mma_kernel<"):
        if gemv in name:
            # gemv_kernel<EPI, weight kind, sources, rows> (an older
            # tree's: gemv_kernel<T, EPI, ...>), gemv_mma_kernel<EPI, ...>
            args = name.split(gemv, 1)[1].split(">", 1)[0].split(",")
            epi = args[1] if not args[0].strip().isdigit() else args[0]
            return {"0": "gemv q/k/v", "1": "gemv o/down +residual",
                    "2": "gemv gate/up SwiGLU",
                    "3": "lm_head fold (K1)"}.get(epi.strip(), name[:90])
    for key, label in (("attn_kernel", "attention (K2)"),
                       ("qk_norm_rope", "qk-norm + rope"),
                       ("flash", "flash attention (K3)"),
                       ("qmv4_", "lm_head int4 (K4)"),
                       ("qmv_kernel", "int8 GEMV (K5)"),
                       ("qmm_kernel", "int8 tiled matmul (K5)"),
                       ("qmm_wgmma", "int8 wgmma tiles (K5)"),
                       ("qmv8_mma", "int8 tensor-core GEMV (K5)"),
                       ("qmm_sum", "int8 split-K sum (K5)"),
                       ("lm_fold", "lm_head fold (K1)"),
                       ("fold_finish", "lm_head fold (K1)")):
        if key in name:
            return label
    return name[:90]


def by_class(times: dict, per: int) -> dict:
    out: dict = {}
    for name, (count, us) in times.items():
        c = out.setdefault(kernel_class(name), [0, 0.0])
        c[0] += count
        c[1] += us
    return {k: {"launches": c / per, "device_us": us / per}
            for k, (c, us) in sorted(out.items(), key=lambda kv: -kv[1][1])}


def profile(torch, fn):
    """(result of fn(), host seconds, device events) under torch.profiler."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, device_times(prof)


def k1_error_spread(torch, smoke, layers, seeds: int, mode: str) -> dict:
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused, decode_layers_fused_plain)

    ratios = []
    for seed in range(seeds):
        gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
        for s_max, start, end in smoke.SLAB_CASES:
            x, cos, sin, ks, vs = smoke.k1_inputs(torch, gen, torch.bfloat16,
                                                  s_max, end)
            idx = [torch.tensor([v], dtype=torch.int32, device="cuda")
                   for v in (start, end)]
            out = decode_layers_fused(x, cos, sin, layers, ks, vs, start, end,
                                      eps=1e-6)
            ref = decode_layers_fused_plain(x, cos, sin, layers, ks, vs, *idx,
                                            eps=1e-6)
            err = max(smoke.max_err(torch, o, r) for o, r in zip(out, ref))
            scale = max(float(r.float().abs().max()) for r in ref)
            ratios.append(err / scale)
            del ks, vs
    atol, rtol = smoke.TOL[("decode_layers_fused", "bfloat16")]
    return {"section": "k1_error_spread", "weights": mode,
            "runs": len(ratios),
            "err_over_ref_max": sorted(ratios), "max": max(ratios),
            "median": statistics.median(ratios), "smoke_rtol": rtol,
            "smoke_atol": atol}


def k1_parts(torch, smoke, layers, cfg, mode: str, b: int, kv: str,
             fold: dict) -> list:
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused)

    h, inter = cfg.hidden_size, cfg.intermediate_size
    qd = cfg.num_attention_heads * cfg.head_dim
    kvd = cfg.num_key_value_heads * cfg.head_dim
    nl = cfg.num_hidden_layers
    # bytes per weight (int4g: and a float32 scale per 128 of them)
    wb = {"none": 2, "int8": 1, "int4": 0.5, "int4g": 0.5 + 4 / 128}[mode]
    weight_bytes = {  # weight bytes per call, by GEMV class
        "gemv q/k/v": wb * nl * h * (qd + 2 * kvd),
        "gemv o/down +residual": wb * nl * (qd * h + inter * h),
        "gemv gate/up SwiGLU": wb * nl * 2 * h * inter,
    }
    if fold:
        weight_bytes["lm_head fold (K1)"] = sum(
            t.numel() * t.element_size() for t in (fold["lm_head"],
                                                   fold["lm_scales"])
            if t is not None)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    for s_max, end in ((360, 217), (4992, 4737))[:1 if b > 8 else 2]:
        x, cos, sin, ks, vs = smoke.k1_inputs(torch, gen, torch.bfloat16,
                                              s_max, end, b)
        starts = [min(st, end // 2) for st in smoke.row_starts(b)]
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        scales = {}
        if kv == "int8":
            from qwen3_asr_rs_tpu_torch.models.text_decoder import quantize_kv

            (ks, k_s), (vs, v_s) = quantize_kv(ks), quantize_kv(vs)
            scales = dict(k_scales=k_s, v_scales=v_s)

        def call():
            return decode_layers_fused(x, cos, sin, layers, ks, vs, start,
                                       end, eps=1e-6, **scales, **fold)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
        enqueue = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            enqueue.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        _, _, times = profile(torch, lambda: [call() for _ in range(n)])
        parts = by_class(times, n)
        live = sum(end - st for st in starts)
        weight_bytes["attention (K2)"] = (
            2 * nl * kvd * live * (1 if kv == "int8" else 2)
            + (2 * 4 * nl * cfg.num_key_value_heads * live
               if kv == "int8" else 0))
        for k, n_bytes in weight_bytes.items():
            if k in parts:
                parts[k]["bytes"] = n_bytes
                parts[k]["TB_per_s"] = n_bytes / parts[k]["device_us"] / 1e6
        device_us = sum(p["device_us"] for p in parts.values())
        launches = sum(p["launches"] for p in parts.values())
        rows.append({"section": "k1_parts", "weights": mode, "B": b,
                     "kv": kv, "fold": bool(fold), "starts": starts,
                     "S": s_max, "end": end,
                     "wall_ms_per_call": wall_ms,
                     "enqueue_ms_per_call": statistics.median(enqueue),
                     "device_ms_per_call": device_us / 1e3,
                     "launches_per_call": launches,
                     "launches_per_layer": launches / nl,
                     "gemv_share": sum(p["device_us"] for k, p in parts.items()
                                       if k.startswith("gemv")) / device_us,
                     "parts": parts})
        del ks, vs
    return rows


def decode_step(torch, engine, samples, steps: int, mode: str) -> dict:
    dec = engine.decoder
    _, cache, true_len = engine.prefill(samples)

    def loop(first_pos: int):
        tok = torch.zeros((1,), dtype=torch.long, device="cuda")
        for i in range(steps):
            tok, _ = dec.decode_step_token(engine.dec_params, tok,
                                           first_pos + i, cache)
            int(tok[0])

    with torch.inference_mode():
        loop(true_len)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(true_len)
        wall_plain = time.perf_counter() - t0
        _, wall, times = profile(torch, lambda: loop(true_len))
    busy_us = sum(us for _, us in times.values())
    return {"section": "decode_step", "weights": mode, "clip_seconds": 4,
            "fold": dec._fold(engine.dec_params, torch.zeros(
                (1,), dtype=torch.long, device="cuda")),
            "steps": steps,
            "slab": int(cache.k.shape[3]),
            "wall_ms_per_step": 1e3 * wall_plain / steps,
            "wall_ms_per_step_profiled": 1e3 * wall / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "busy_share_profiled": busy_us / 1e6 / wall,
            "parts_per_step": by_class(times, steps)}


def prefill(torch, engine, samples, seconds, mode: str) -> dict:
    """One clip's prefill, or (samples a list) one batch's. Raises unless
    the profile holds one K5 product kernel for each launch K5's wrapper
    counted (a profiler that drops events would read K5 low)."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matmul import quant_matmul

    if isinstance(samples, list):
        def run():
            return engine.prefill_batch(samples, [None] * len(samples))
    else:
        def run():
            return engine.prefill(samples)
    with torch.inference_mode():
        run()  # warm-up: this bucket's shapes
        calls = quant_matmul.launches
        _, wall, times = profile(torch, run)
        calls = quant_matmul.launches - calls
    busy_us = sum(us for _, us in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][1])[:12]
    parts = by_class(times, 1)
    k5 = [p for k, p in parts.items() if k.endswith("(K5)")]
    k5_us = sum(p["device_us"] for p in k5)
    products = sum(p["launches"] for k, p in parts.items()
                   if k.endswith("(K5)") and "split-K sum" not in k)
    if products != calls:
        raise RuntimeError(f"prefill {seconds}: the profile holds {products} "
                           f"K5 product kernels, the wrapper launched {calls}")
    return {"section": "prefill", "weights": mode, "clip_seconds": seconds,
            "wall_ms": 1e3 * wall,
            "device_ms": busy_us / 1e3, "busy_share": busy_us / 1e6 / wall,
            "k5_wrapper_launches": calls,
            "k5_launches": sum(p["launches"] for p in k5),
            "k5_device_ms": k5_us / 1e3, "k5_share": k5_us / busy_us,
            "parts": parts,
            "top": [{"name": n[:90], "launches": c, "device_ms": us / 1e3}
                    for n, (c, us) in top]}


def k4_rows(torch, smoke, dec) -> list:
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matvec_int4 import (
        quant_matvec_int4)
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight_int4_tiled

    w_q4, sc = quantize_weight_int4_tiled(dec["lm_head"].float().T)
    rows = []
    for r in (1, 8, 32):
        x = torch.randn((r, w_q4.shape[0]), device="cuda").bfloat16()
        lib = smoke.int4pack_mm(torch, x, w_q4, sc)
        rows.append({
            "section": "k4", "rows": r,
            "ms": smoke.cuda_ms(torch, lambda: quant_matvec_int4(x, w_q4, sc)),
            "device_ms": smoke.device_ms(
                torch, lambda: quant_matvec_int4(x, w_q4, sc)),
            **smoke.bound_of(smoke.nbytes(x, w_q4, sc) + 4 * r * sc.shape[0],
                             2 * r * w_q4.shape[0] * sc.shape[0]),
            "tinygemm_ms": smoke.cuda_ms(torch, lib),
            "tinygemm_device_ms": smoke.device_ms(torch, lib)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--quantize", default="none,int8,int4",
                    help="comma-separated weight modes: none, int8, int4, "
                         "int4g")
    ap.add_argument("--batch", default="1",
                    help="comma-separated K1 batch sizes for k1_parts")
    ap.add_argument("--kv", default="bf16",
                    help="comma-separated slab types for k1_parts: bf16, int8")
    ap.add_argument("--fold", action="store_true",
                    help="fold the lm_head into K1 (ASR_FOLD_LM=1)")
    ap.add_argument("--prefill", default="300",
                    help="comma-separated clip seconds of the prefill section")
    ap.add_argument("--sections", default="k4,k1,decode,prefill",
                    help="comma-separated sections: k4, k1, decode, prefill")
    ap.add_argument("--port-root", type=Path, default=REPO,
                    help="directory holding the qwen3_asr_rs_tpu_torch "
                         "package to profile")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_cuda: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    sys.path.insert(0, str(args.port_root.resolve()))
    from qwen3_asr_rs_tpu_torch.audio.load import load_audio
    from qwen3_asr_rs_tpu_torch.config import AsrConfig
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np, init_encoder_params_np, to_torch)

    if args.fold:
        import os

        os.environ["ASR_FOLD_LM"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

    def emit(row):
        row["card"] = card
        row["port_root"] = str(args.port_root)
        print(json.dumps(row), flush=True)

    _build.build()
    config = AsrConfig()
    enc = to_torch(init_encoder_params_np(config.audio), torch.bfloat16,
                   "cuda")
    dec = to_torch(init_decoder_params_np(config.text), torch.bfloat16,
                   "cuda")
    sections = set(args.sections.split(","))
    prefill_clips = args.prefill.split(",")
    with tempfile.TemporaryDirectory(prefix="profile_torch_") as tmp:
        clips = {}
        for seconds, seed in ((4, 1), (30, 2), (300, 3), (8, 4), (15, 5),
                              (22, 6)):
            path = Path(tmp) / f"clip_{seconds}s.wav"
            smoke.write_wav(path, seconds, seed)
            clips[seconds] = load_audio(path, 16000)
    if "k4" in sections:
        for row in k4_rows(torch, smoke, dec):
            emit(row)
    for mode in args.quantize.split(","):
        engine = AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=128,
                           config=config, params=(enc, dec),
                           tokenizer=smoke.StubTokenizer(), device="cuda",
                           quantize=None if mode == "none" else mode)
        layers = engine.dec_params["layers"]
        params = engine.dec_params
        fold = {}
        if args.fold and "lm_head_q4" not in params:
            lm_q = params.get("lm_head_q")
            fold = dict(fold_lm=True, final_ln_w=params["final_ln_w"],
                        lm_head=params["lm_head"] if lm_q is None else lm_q,
                        lm_scales=params.get("lm_head_s"))
        if "k1" in sections:
            emit(k1_error_spread(torch, smoke, layers, args.seeds, mode))
            for b in map(int, args.batch.split(",")):
                for kv in args.kv.split(","):
                    for row in k1_parts(torch, smoke, layers, config.text,
                                        mode, b, kv, fold):
                        emit(row)
                    torch.cuda.empty_cache()
        if "decode" in sections:
            emit(decode_step(torch, engine, clips[4], args.steps, mode))
        if "prefill" in sections:
            for c in prefill_clips:
                samples = ([clips[t] for t in smoke.FIVE_CLIPS]
                           if c == "batch" else clips[int(c)])
                emit(prefill(torch, engine, samples, c, mode))
        del engine, layers
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
