#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (qwen3_asr_rs_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device  — requires CUDA; prints nvidia-smi's name and power limit.
2. build   — compiles every kernel of csrc/ with nvcc (sm_90a), in parallel.
3. kernels — each kernel against its plain PyTorch version on the same
             inputs at the 0.6B main-path shapes, max abs error against a
             stated tolerance, median CUDA-event time of both: K2, K1
             (bf16/f32 weights, and int8 merged, int4 merged, int8
             unmerged weights quantized by the port's own quantizer), K3,
             K4 (int4 lm_head) and K5 (int8 prefill linears and lm_head);
             then K1 at B = 2, 8, 32 with per-row starts (float weights,
             int8 merged at B = 8, int4 merged at B = 8 and 32), K1 and
             K2 on int8 slabs at B = 1 and 8, S = 360 and 4992, and K3 at
             B = 2 with per-row kv_start.
4. main    — AsrEngine at full Qwen3-ASR-0.6B width (28 decoder + 18
             encoder layers, bf16, seeded synthetic weights) transcribes
             synthetic 4 s, 30 s and 300 s WAV files; then AsrEngine with
             quantize='int8' (4 s, 30 s, 300 s), quantize='int4' (4 s,
             30 s), and on the 4 s clip quantize='lm8' and the crossed
             lm_head widths (ASR_LM_BITS=4 under int8, 8 under int4). Each
             path runs with the launch counters set to 0, and they must
             show that it went through its kernels.
5. batch   — AsrEngine.transcribe_batch at full width, bf16 weights:
             clips of 4, 8, 15, 22 and 30 s (B = 8, 3 born-done rows) with
             bf16 and with int8 KV, 32 clips of 4 s, 8 clips of 300 s with
             int8 KV, and the 4 s clip alone with int8 KV; then the five
             clips with int8 weights and int8 KV, and with int4 weights;
             per run B, live rows, bucket, wall, aggregate xRT, tokens/s,
             prefill s, decode ms per step and the launch counts, which
             must show K1 once per step whatever B is, K2 once per layer
             and step, and K4/K5 as the weights need them.
6. parity  — the 4 s clip teacher-forced in float32 at full width, with
             float, int8 and int4 weights: the decode-kernel path against
             the plain per-layer path, per-step logits within a stated
             tolerance; then a batch of 3 clips (4, 8, 15 s) with bf16 and
             with int8 KV, every live row's logits from the same slab
             state on both paths.

Then a {"kernels": [...]} summary line, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0

# Tolerances, kernel vs plain version on the same inputs: a case passes
# when max|kernel - plain| <= atol + rtol * max|plain|. float32: both sides
# compute in float32 and differ only in summation order. bf16: both round
# to bf16 at the same stages, but an order difference can flip a rounding
# (one bf16 ulp is 2^-8..2^-7 of the value): attention outputs may differ by
# two ulps of the largest value. The decode step carries such flips through
# 28 layers: over 8 input seeds x SLAB_CASES on an H100 its max|err| /
# max|plain| ran from 0.008 to 0.040, median 0.024
# (scripts/profile_torch_cuda.py, PERF.md); its bound is 2^-4.
TOL = {
    ("decode_attention", "float32"): (2e-5, 0.0),
    ("decode_attention", "bfloat16"): (2e-2, 2 ** -7),
    ("decode_layers_fused", "float32"): (1e-4, 1e-5),
    ("decode_layers_fused", "bfloat16"): (1e-2, 2 ** -4),
    ("flash_attention", "float32"): (1e-4, 0.0),
    ("flash_attention", "bfloat16"): (2e-2, 2 ** -7),
    # K5 and K4: float32 sums of the same exact products in another order;
    # a bf16 output may flip one rounding (2^-8 of the value, at most)
    ("quant_matmul", "float32"): (1e-4, 1e-5),
    ("quant_matmul", "bfloat16"): (1e-4, 2 ** -7),
    ("quant_matmul", "bfloat16->float32"): (1e-4, 1e-5),
    ("quant_matvec_int4", "float32"): (1e-4, 1e-5),
    ("quant_matvec_int4", "bfloat16->float32"): (1e-4, 1e-5),
}
# float32 teacher-forced logits, decode kernel vs plain per-layer path
PARITY_LOGITS_ATOL = 1e-3

REPLACES = {
    "decode_layers_fused": "qwen3_asr_rs_tpu/ops/pallas/decode_layer.py:678",
    "decode_attention": "qwen3_asr_rs_tpu/ops/pallas/decode_attention.py:413",
    "flash_attention": "qwen3_asr_rs_tpu/ops/pallas/flash_attention.py:152",
    "quant_matmul": "qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py:66",
    "quant_matvec_int4": "qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py:351",
}
SOURCES = {
    "decode_layers_fused": "qwen3_asr_rs_tpu_torch/csrc/decode_layer.cu",
    "decode_attention": "qwen3_asr_rs_tpu_torch/csrc/decode_attention.cuh",
    "flash_attention": "qwen3_asr_rs_tpu_torch/csrc/flash_attention.cu",
    "quant_matmul": "qwen3_asr_rs_tpu_torch/csrc/quant_matmul.cu",
    "quant_matvec_int4": "qwen3_asr_rs_tpu_torch/csrc/quant_matvec_int4.cu",
}
K1_COVERS = ("B=1..32 with per-row starts; bf16/f32 activations; bf16/f32, "
             "int8 and int4 weights, merged qkv|gate-up and per projection; "
             "bf16/f32 and int8 slabs")
# K1 quantized layouts checked in phase 3: (label, bits, merge)
K1_QUANT = (("int8 merged", 8, True), ("int4 merged", 4, True),
            ("int8 unmerged", 8, False))
# K5's prefill rows (30 s and 300 s prompts) and its four linears (K, N)
K5_ROWS = (432, 4736)
K5_LINEARS = (("qkv_w", 1024, 4096), ("o_w", 2048, 1024),
              ("gateup_w", 1024, 6144), ("down_w", 3072, 1024))


# (S, start, end) of the decode kernels' checks: the 4 s bucket's slab and
# the 300 s bucket's (4736 prompt + 256), start 0 and > 0, ends at no block
# boundary
SLAB_CASES = ((360, 0, 217), (360, 37, 301), (4992, 0, 4737),
              (4992, 129, 4990))
# K1 at B > 1 (S=360, shared end 301) and K1/K2 on int8 slabs: (B, S, end)
K1_BATCH = (2, 8, 32)
# K1 at B > 1 with merged quantized weights: (bits, batch sizes)
K1_BATCH_QUANT = ((8, (8,)), (4, (8, 32)))
KV8_CASES = ((1, 360, 301), (8, 360, 301), (1, 4992, 4737), (8, 4992, 4737))
# Qwen3-ASR-0.6B decoder dims
L, HQ, HKV, D, H = 28, 16, 8, 128, 1024


def row_starts(b: int) -> list:
    """Per-row first live slots of a right-aligned batch of b rows."""
    return [(0, 37, 129, 200, 5, 77, 150, 263)[i % 8] for i in range(b)]


def k1_inputs(torch, gen, dtype, s_max: int, end: int, b: int = 1):
    """Inputs of one decode step at slot ``end`` of an (L, b, Hkv, s_max, D)
    slab: (x, cos, sin, k_slabs, v_slabs), slab values at the scale of
    normalized, rotated keys and of the values, row r at position
    end - row_starts(b)[r]."""
    dev = torch.device("cuda")
    ks = torch.randn((L, b, HKV, s_max, D), generator=gen,
                     device=dev).to(dtype)
    vs = (0.05 * torch.randn((L, b, HKV, s_max, D), generator=gen,
                             device=dev)).to(dtype)
    x = (0.02 * torch.randn((b, H), generator=gen, device=dev)).to(dtype)
    pos = end - torch.tensor(row_starts(b), device=dev)[:, None]
    ang = pos * torch.logspace(0, -6, D // 2, base=10.0, device=dev)
    cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
    sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    return x, cos, sin, ks, vs


def quantized_tree(torch, dec_params_f32, dtype, bits, merge):
    """The decoder layers (and lm_head) cast to dtype, then quantized by
    the port's own quantizer."""
    from qwen3_asr_rs_tpu_torch.weights.quantize import quantize_decoder_params

    tree = {"layers": {k: v.to(dtype)
                       for k, v in dec_params_f32["layers"].items()},
            "lm_head": dec_params_f32["lm_head"].to(dtype)}
    return quantize_decoder_params(tree, bits=bits, merge=merge, lm_bits=8)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(torch, a, b) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite values in the kernel output or "
                             "its plain version")
    return float((a.float() - b.float()).abs().max())


def check_case(torch, results, name, dtype, case, kernel_fn, plain_fn,
               rows=slice(None)):
    """Compare kernel_fn() with plain_fn() (a tensor or a tuple of them,
    each against its own tolerance), then time both."""
    out, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    dt = str(dtype).replace("torch.", "")
    if isinstance(out[0], torch.Tensor) and out[0].dtype != dtype:
        dt = f"{dt}->{str(out[0].dtype).replace('torch.', '')}"
    atol, rtol = TOL[(name, dt)]
    err = bound = scale = 0.0
    for o, r in zip(out, ref):
        e = max_err(torch, o[rows], r[rows])
        sc = float(r[rows].float().abs().max())
        if not e <= atol + rtol * sc:
            emit({"phase": "kernel", "kernel": name, "dtype": dt,
                  "case": case, "max_abs_err": e, "ref_max": sc,
                  "bound": atol + rtol * sc, "ok": False})
            raise AssertionError(f"{name} {case} {dt}: error {e} > "
                                 f"{atol} + {rtol} * {sc}")
        err, bound, scale = max(err, e), max(bound, atol + rtol * sc), max(scale, sc)
    ms = cuda_ms(torch, kernel_fn)
    plain_ms = cuda_ms(torch, plain_fn, reps=3, warmup=1)
    row = {"phase": "kernel", "kernel": name, "dtype": dt, "case": case,
           "max_abs_err": err, "ref_max": scale, "bound": bound,
           "atol": atol, "rtol": rtol, "ms": ms, "plain_ms": plain_ms}
    emit(row)
    results.append(row)


def kernel_checks(torch, dec_params_f32):
    """Phase 3: K2, K1, K3 against their plain versions."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused, decode_layers_fused_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = []

    def idx(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        for s_max, start, end in SLAB_CASES:
            ks = torch.randn((L, 1, HKV, s_max, D), generator=gen,
                             device=dev).to(dtype)
            vs = torch.randn_like(ks)
            q = torch.randn((1, HQ, D), generator=gen, device=dev).to(dtype)
            k_self = torch.randn((1, HKV, D), generator=gen,
                                 device=dev).to(dtype)
            v_self = torch.randn_like(k_self)
            case = f"S={s_max} start={start} end={end} layer=27"
            check_case(
                torch, results, "decode_attention", dtype, case,
                lambda: decode_attention(q, ks, vs, k_self, v_self, 27,
                                         start, end),
                lambda: decode_attention_plain(q, ks, vs, k_self, v_self, 27,
                                               idx(start), idx(end)),
            )
            del ks, vs

    layers = {
        torch.float32: dec_params_f32["layers"],
        torch.bfloat16: {k: v.to(torch.bfloat16)
                         for k, v in dec_params_f32["layers"].items()},
    }
    for dtype in (torch.float32, torch.bfloat16):
        lay = layers[dtype]
        for s_max, start, end in SLAB_CASES:
            x, cos, sin, ks, vs = k1_inputs(torch, gen, dtype, s_max, end)
            case = f"L=28 S={s_max} start={start} end={end}"
            check_case(
                torch, results, "decode_layers_fused", dtype, case,
                lambda: decode_layers_fused(x, cos, sin, lay, ks, vs, start,
                                            end, eps=1e-6),
                lambda: decode_layers_fused_plain(x, cos, sin, lay, ks, vs,
                                                  idx(start), idx(end),
                                                  eps=1e-6),
            )
            del ks, vs
    del layers

    # K3 at the 360-chunk prefill bucket: 4736 tokens, causal
    S = 4736
    flash_cases = [
        (torch.float32, "causal", dict(causal=True), 0),
        (torch.bfloat16, "causal", dict(causal=True), 0),
        (torch.bfloat16, "causal kv_valid=4000",
         dict(causal=True, kv_valid=idx(4000)), 0),
        (torch.bfloat16, "causal kv_start=100",
         dict(causal=True, kv_start=idx(100)), 100),
        (torch.bfloat16, "kv_valid=3001 (not causal)",
         dict(kv_valid=idx(3001)), 0),
    ]
    for dtype, case, kw, first_row in flash_cases:
        q = torch.randn((1, S, HQ, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((1, S, HKV, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((1, S, HKV, D), generator=gen, device=dev).to(dtype)
        kv_valid, kv_start = kw.get("kv_valid"), kw.get("kv_start")
        causal = kw.get("causal", False)
        # rows with no attendable key are discarded by callers
        check_case(
            torch, results, "flash_attention", dtype, f"Sq=Sk={S} {case}",
            lambda: flash_attention(q, k, v, kv_valid, kv_start,
                                    causal=causal),
            lambda: flash_attention_plain(q, k, v, kv_valid, kv_start,
                                          causal=causal),
            rows=(slice(None), slice(first_row, None)),
        )
        del q, k, v
    torch.cuda.empty_cache()
    quant_kernel_checks(torch, dec_params_f32, gen, results)
    batch_kernel_checks(torch, dec_params_f32, gen, results)
    return results


def quant_kernel_checks(torch, dec_params_f32, gen, results):
    """Phase 3, quantized: K1 with int8/int4 weights, K5, K4."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused, decode_layers_fused_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matvec_int4 import (
        quant_matvec_int4, quant_matvec_int4_plain)
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight_int4_tiled

    dev = torch.device("cuda")

    def idx(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        for label, bits, merge in K1_QUANT:
            qtree = quantized_tree(torch, dec_params_f32, dtype, bits, merge)
            lay = qtree["layers"]
            for s_max, start, end in (SLAB_CASES[0], SLAB_CASES[2]):
                x, cos, sin, ks, vs = k1_inputs(torch, gen, dtype, s_max, end)
                case = f"{label} L=28 S={s_max} start={start} end={end}"
                check_case(
                    torch, results, "decode_layers_fused", dtype, case,
                    lambda: decode_layers_fused(x, cos, sin, lay, ks, vs,
                                                start, end, eps=1e-6),
                    lambda: decode_layers_fused_plain(
                        x, cos, sin, lay, ks, vs, idx(start), idx(end),
                        eps=1e-6),
                )
                del ks, vs
            if label == "int8 merged":
                # K5 at the int8 path's shapes: layer 0's merged linears
                # over the prefill rows, and the lm_head at one row
                for rows in K5_ROWS:
                    for name, k, n in K5_LINEARS:
                        w_q, sc = lay[f"{name}_q"][0], lay[f"{name}_s"][0]
                        x = torch.randn((rows, k), generator=gen,
                                        device=dev).to(dtype)
                        check_case(
                            torch, results, "quant_matmul", dtype,
                            f"{name} ({rows}, {k}) @ ({k}, {n})",
                            lambda: quant_matmul(x, w_q, sc),
                            lambda: quant_matmul_plain(x, w_q, sc),
                        )
                w_q, sc = qtree["lm_head_q"], qtree["lm_head_s"]
                x = torch.randn((1, H), generator=gen, device=dev).to(dtype)
                check_case(
                    torch, results, "quant_matmul", dtype,
                    f"lm_head (1, {H}) @ {tuple(w_q.shape)} -> float32",
                    lambda: quant_matmul(x, w_q, sc, out_dtype=torch.float32),
                    lambda: quant_matmul_plain(x, w_q, sc,
                                               out_dtype=torch.float32),
                )
            del qtree, lay
            torch.cuda.empty_cache()

    # K4 at the int4 lm_head's shape
    w_q4, sc = quantize_weight_int4_tiled(dec_params_f32["lm_head"].T)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((1, H), generator=gen, device=dev).to(dtype)
        check_case(
            torch, results, "quant_matvec_int4", dtype,
            f"lm_head (1, {H}) @ unpack{tuple(w_q4.shape)} -> "
            f"(1, {sc.shape[0]})",
            lambda: quant_matvec_int4(x, w_q4, sc),
            lambda: quant_matvec_int4_plain(x, w_q4, sc),
        )
    del w_q4, sc
    torch.cuda.empty_cache()


def batch_kernel_checks(torch, dec_params_f32, gen, results):
    """Phase 3, batched: K1 at B > 1 with per-row starts, K1 and K2 on
    int8 slabs, K3 at B = 2 with per-row kv_start."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import quantize_kv
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused, decode_layers_fused_plain)
    from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    dev = torch.device("cuda")

    def idx(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def k1_case(dtype, lay, b, s_max, end, label, int8_slabs=False):
        x, cos, sin, ks, vs = k1_inputs(torch, gen, dtype, s_max, end, b)
        scales = {}
        if int8_slabs:
            (ks, kscale), (vs, vscale) = quantize_kv(ks), quantize_kv(vs)
            scales = dict(k_scales=kscale, v_scales=vscale)
        start, ends = idx(row_starts(b)), idx([end] * b)
        check_case(
            torch, results, "decode_layers_fused", dtype,
            f"{label} B={b} L=28 S={s_max} start={row_starts(b)[:8]} "
            f"end={end}",
            lambda: decode_layers_fused(x, cos, sin, lay, ks, vs, start, end,
                                        eps=1e-6, **scales),
            lambda: decode_layers_fused_plain(x, cos, sin, lay, ks, vs, start,
                                              ends, eps=1e-6, **scales),
        )

    for dtype in (torch.float32, torch.bfloat16):
        lay = {k: v.to(dtype) for k, v in dec_params_f32["layers"].items()}
        for b in K1_BATCH:
            k1_case(dtype, lay, b, 360, 301, "float weights")
        for b, s_max, end in KV8_CASES:
            k1_case(dtype, lay, b, s_max, end, "int8 slab", int8_slabs=True)
        del lay
        for bits, batches in K1_BATCH_QUANT:
            qlay = quantized_tree(torch, dec_params_f32, dtype, bits,
                                  True)["layers"]
            for b in batches:
                k1_case(dtype, qlay, b, 360, 301, f"int{bits} merged weights")
            del qlay
        torch.cuda.empty_cache()

        for b, s_max, end in KV8_CASES:
            (kq, kscale), (vq, vscale) = (
                quantize_kv(torch.randn((L, b, HKV, s_max, D), generator=gen,
                                        device=dev)) for _ in range(2))
            q = torch.randn((b, HQ, D), generator=gen, device=dev).to(dtype)
            k_self = torch.randn((b, HKV, D), generator=gen,
                                 device=dev).to(dtype)
            v_self = torch.randn_like(k_self)
            start, ends = idx(row_starts(b)), idx([end] * b)
            check_case(
                torch, results, "decode_attention", dtype,
                f"int8 slab B={b} S={s_max} start={row_starts(b)} end={end} "
                "layer=27",
                lambda: decode_attention(q, kq, vq, k_self, v_self, 27, start,
                                         ends, k_scales=kscale,
                                         v_scales=vscale),
                lambda: decode_attention_plain(q, kq, vq, k_self, v_self, 27,
                                               start, ends, k_scales=kscale,
                                               v_scales=vscale),
            )
            del kq, vq, kscale, vscale

    # K3 at the 360-chunk prefill bucket, B = 2 right-aligned rows; query
    # rows before a row's start have no key (compared from the later one)
    S, kv_start = 4736, (0, 517)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((2, S, HQ, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((2, S, HKV, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((2, S, HKV, D), generator=gen, device=dev).to(dtype)
        start = idx(list(kv_start))
        check_case(
            torch, results, "flash_attention", dtype,
            f"B=2 Sq=Sk={S} causal kv_start={kv_start}",
            lambda: flash_attention(q, k, v, None, start, causal=True),
            lambda: flash_attention_plain(q, k, v, None, start, causal=True),
            rows=(slice(None), slice(max(kv_start), None)),
        )
        del q, k, v
    torch.cuda.empty_cache()


def write_wav(path: Path, seconds: float, seed: int) -> float:
    """16 kHz PCM16 WAV: a chirp-like tone plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * (220 + 40 * np.sin(0.5 * t)) * t)
    x = x + 0.05 * rng.standard_normal(n)
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return seconds


class StubTokenizer:
    """Token ids as text (no tokenizer.json needed)."""

    def encode(self, text):
        return [101] * 4

    def decode(self, ids):
        return " ".join(map(str, ids))


def kernel_wrappers():
    """{kernel name: wrapper}; each wrapper's ``launches`` is its count."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
        decode_attention)
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        decode_layers_fused)
    from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_attention)
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matvec_int4 import (
        quant_matvec_int4)

    return {"decode_layers_fused": decode_layers_fused,
            "decode_attention": decode_attention,
            "flash_attention": flash_attention,
            "quant_matmul": quant_matmul,
            "quant_matvec_int4": quant_matvec_int4}


# (quantize, ASR_LM_BITS, clips) of the main paths
MAIN_PATHS = ((None, None, (4, 30, 300)), ("int8", None, (4, 30, 300)),
              ("int4", None, (4, 30)), ("lm8", None, (4,)), ("int8", 4, (4,)),
              ("int4", 8, (4,)))


def expected_launches(quantize, lm_bits, layers: int, steps: int,
                      seconds: int):
    """Launches each kernel must show for one clip: K1 once per decode
    step, K2 once per layer and step (counted by K1's C entry), K3 in the
    300 s prefill; int8 layers: K5 for the 4 merged prefill linears of
    each layer; an int8 lm_head: K5 at the last prompt token and each
    step; an int4 lm_head: K4 likewise. None: must be above 0."""
    layer_bits = {"int8": 8, "int4": 4}.get(quantize, 0)
    lm = lm_bits or {"int8": 8, "int4": 4, "lm8": 8}.get(quantize, 0)
    return {
        "decode_layers_fused": steps,
        "decode_attention": layers * steps,
        "flash_attention": None if seconds == 300 else 0,
        "quant_matmul": (4 * layers if layer_bits == 8 else 0)
        + (steps + 1 if lm == 8 else 0),
        "quant_matvec_int4": steps + 1 if lm == 4 else 0,
    }


def run_path(torch, engine, clips, quantize, lm_bits, card):
    """Phase 4 for one engine: a warm-up, then the counters set to 0 and
    the clips transcribed, each checked against expected_launches.
    Returns {kernel: launches in this path's run}."""
    fns = kernel_wrappers()
    layers = engine.config.text.num_hidden_layers
    engine.transcribe(clips[4])  # warm-up: CUDA context, cuBLAS, kernels
    for fn in fns.values():
        fn.launches = 0
    for seconds, path in clips.items():
        before = {n: fn.launches for n, fn in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = engine.transcribe(path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = engine.last_stats
        steps = st["decode_steps"]
        got = {n: fn.launches - before[n] for n, fn in fns.items()}
        row = {"phase": "main", "quantize": quantize, "lm_bits": lm_bits,
               "clip_seconds": seconds,
               "language": r.language, "text_chars": len(r.text),
               "tokens": len(r.raw_output.split()), "decode_steps": steps,
               "k1_launches": got["decode_layers_fused"],
               "k2_launches": got["decode_attention"],
               "k3_launches": got["flash_attention"],
               "k4_launches": got["quant_matvec_int4"],
               "k5_launches": got["quant_matmul"],
               "wall_s": wall, "xRT": seconds / wall,
               "prefill_s": st["prefill_seconds"],
               "decode_ms_per_token": (1e3 * st["decode_seconds"] / steps
                                       if steps else None),
               "card": card}
        emit(row)
        if not isinstance(r.language, str) or not isinstance(r.text, str):
            raise AssertionError("transcription gave no language/text")
        for n, want in expected_launches(quantize, lm_bits, layers, steps,
                                         seconds).items():
            if (got[n] <= 0) if want is None else (got[n] != want):
                raise AssertionError(
                    f"{quantize or 'bf16'} lm_bits={lm_bits} {seconds} s: "
                    f"{n} launched "
                    f"{got[n]} times, expected {'> 0' if want is None else want}")
    return {n: fn.launches for n, fn in fns.items()}


# phase 5: (label, clip seconds, kv_dtype, quantize); a single clip takes
# the B = 1 path. Clips of one length share one WAV.
FIVE_CLIPS = (4, 8, 15, 22, 30)
BATCH_RUNS = (("5 clips", FIVE_CLIPS, None, None),
              ("32 x 4 s", (4,) * 32, None, None),
              ("5 clips", FIVE_CLIPS, "int8", None),
              ("8 x 300 s", (300,) * 8, "int8", None),
              ("B=1 4 s", (4,), "int8", None),
              ("5 clips", FIVE_CLIPS, "int8", "int8"),
              ("5 clips", FIVE_CLIPS, None, "int4"))


def run_batch(torch, engine, samples, label, seconds, kv_dtype, quantize,
              card):
    """Phase 5 for one batch: a warm-up of the same batch, then the
    counters set to 0 and the batch transcribed once more; checks the
    launch counts (K1 once per step, K2 once per layer and step, K3 in
    the 300 s bucket's prefill, K4/K5 as ``expected_launches`` says for
    the weights) and that pad rows emit nothing."""
    from qwen3_asr_rs_tpu_torch.features.mel import num_mel_frames

    fns = kernel_wrappers()
    layers = engine.config.text.num_hidden_layers
    engine.transcribe_batch(samples)
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.transcribe_batch(samples)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: fn.launches for n, fn in fns.items()}
    st = engine.last_stats
    steps, n_gen = st["decode_steps"], st["n_gen"]
    b, live = len(n_gen), len(samples)
    row = {"phase": "batch", "run": label, "kv": kv_dtype or "bf16",
           "quantize": quantize, "B": b, "live_rows": live,
           "bucket_chunks": engine._pick_bucket(
               max(num_mel_frames(len(x)) for x in samples)),
           "audio_s": sum(seconds), "wall_s": wall,
           "xRT": sum(seconds) / wall, "tokens": sum(n_gen),
           "tokens_per_s": sum(n_gen) / wall,
           "decode_tokens_per_s": (sum(n_gen) / st["decode_seconds"]
                                   if st["decode_seconds"] else None),
           "prefill_s": st["prefill_seconds"], "decode_steps": steps,
           "decode_ms_per_step": (1e3 * st["decode_seconds"] / steps
                                  if steps else None),
           "n_gen": n_gen,
           "k1_launches": got["decode_layers_fused"],
           "k2_launches": got["decode_attention"],
           "k3_launches": got["flash_attention"],
           "k4_launches": got["quant_matvec_int4"],
           "k5_launches": got["quant_matmul"], "card": card}
    emit(row)
    if len(results) != live or not all(isinstance(r.text, str)
                                       for r in results):
        raise AssertionError(f"batch {label}: {len(results)} results")
    if any(n_gen[live:]) or not all(n_gen[:live]):
        raise AssertionError(f"batch {label}: tokens per row {n_gen}")
    want = expected_launches(quantize, None, layers, steps, max(seconds))
    want["flash_attention"] = layers if max(seconds) == 300 else 0
    for n, w in want.items():
        if got[n] != w:
            raise AssertionError(f"batch {label}: {n} launched {got[n]} "
                                 f"times, expected {w}")
    return got


def batch_parity(torch, engine32, samples, kv_dtype):
    """Phase 6, batched: the kernel path's greedy tokens of a 3-row
    right-aligned batch teacher-force both paths; each step runs the
    kernel path and the plain per-layer path (dense attention) from the
    same slab state, and every row's logits are compared."""
    import numpy as np

    teacher = engine32.generate_batch(samples, [None] * len(samples),
                                      np.ones(len(samples), bool))
    _, cache, kv_start, p = engine32.prefill_batch(samples,
                                                   [None] * len(samples))
    dec = engine32.decoder
    k1 = kernel_wrappers()["decode_layers_fused"]
    k1_before = k1.launches
    n_steps = min(len(t) for t in teacher) - 1
    worst, agree = 0.0, 0
    with torch.inference_mode():
        for i in range(n_steps):
            ids = torch.tensor([t[i] for t in teacher], device=kv_start.device)
            state = type(cache)(*(None if t is None else t.clone() for t in (
                cache.k, cache.v, cache.k_scale, cache.v_scale)))
            os.environ["ASR_DECODE_IMPL"] = "fused"
            lk, _ = dec.decode_step_aligned(engine32.dec_params, ids, p + i,
                                            kv_start, cache)
            os.environ["ASR_DECODE_IMPL"] = "scan"
            os.environ["ASR_DECODE_ATTN"] = "dense"
            lp, _ = dec.decode_step_aligned(engine32.dec_params, ids, p + i,
                                            kv_start, state)
            del os.environ["ASR_DECODE_IMPL"], os.environ["ASR_DECODE_ATTN"]
            worst = max(worst, max_err(torch, lk, lp))
            agree += int((torch.argmax(lk, -1) == torch.argmax(lp, -1)).all())
    k1_launches = k1.launches - k1_before
    emit({"phase": "parity", "dtype": "float32", "batch": len(samples),
          "kv": kv_dtype or "bf16", "kv_start": kv_start.tolist(),
          "steps": n_steps, "k1_launches": k1_launches,
          "max_abs_logit_err": worst, "tol": PARITY_LOGITS_ATOL,
          "greedy_agreement": agree / max(n_steps, 1)})
    if not worst <= PARITY_LOGITS_ATOL:
        raise AssertionError(f"batch parity ({kv_dtype}) logits error {worst}")
    if k1_launches != n_steps:
        raise AssertionError(f"batch parity ({kv_dtype}): the kernel path "
                             f"launched K1 {k1_launches} times")


def parity(torch, engine32, clip, quantize):
    """Phase 6 for one float32 engine: its decode-kernel path's greedy
    tokens teacher-force both paths; per-step logits compared."""
    import numpy as np

    from qwen3_asr_rs_tpu_torch.runtime.engine import load_audio

    samples = load_audio(clip, 16000)
    teacher = engine32.generate(samples)  # kernel path's greedy tokens
    logits0, cache_k, true_len = engine32.prefill(samples)
    cache_p = type(cache_k)(k=cache_k.k.clone(), v=cache_k.v.clone())
    dec = engine32.decoder
    k1 = kernel_wrappers()["decode_layers_fused"]
    k1_before = k1.launches
    worst, agree = 0.0, 0
    with torch.inference_mode():
        for i, tok in enumerate(teacher[:-1]):
            ids = torch.tensor([tok], device="cuda")
            os.environ["ASR_DECODE_IMPL"] = "fused"
            lk, _ = dec.decode_step(engine32.dec_params, ids, true_len + i,
                                    cache_k)
            os.environ["ASR_DECODE_IMPL"] = "scan"
            os.environ["ASR_DECODE_ATTN"] = "dense"
            lp, _ = dec.decode_step(engine32.dec_params, ids, true_len + i,
                                    cache_p)
            del os.environ["ASR_DECODE_IMPL"], os.environ["ASR_DECODE_ATTN"]
            worst = max(worst, max_err(torch, lk, lp))
            agree += int(torch.argmax(lk) == torch.argmax(lp))
    n_steps = max(len(teacher) - 1, 1)
    k1_launches = k1.launches - k1_before
    emit({"phase": "parity", "dtype": "float32", "quantize": quantize,
          "steps": len(teacher) - 1, "k1_launches": k1_launches,
          "max_abs_logit_err": worst,
          "tol": PARITY_LOGITS_ATOL, "greedy_agreement": agree / n_steps,
          "logit_scale": float(np.abs(logits0.cpu().numpy()).max())})
    if not worst <= PARITY_LOGITS_ATOL:
        raise AssertionError(f"parity ({quantize}) logits error {worst}")
    if k1_launches != len(teacher) - 1:
        raise AssertionError(f"parity ({quantize}): the kernel path launched "
                             f"K1 {k1_launches} times")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "qwen3_asr_rs_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(qwen3_asr_rs_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    per_kernel = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": per_kernel,
          "ptxas": {n: [ln.strip() for ln in
                        (_build.BUILD_DIR / f"{n}.log").read_text().splitlines()
                        if "registers" in ln or "spill" in ln][:12]
                    for n in _build.KERNEL_SOURCES
                    if (_build.BUILD_DIR / f"{n}.log").exists()}})

    # weights: full 0.6B width, the JAX package's seeds and RNG order
    from qwen3_asr_rs_tpu_torch import AsrConfig
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np, init_encoder_params_np, to_torch)

    config = AsrConfig()  # Qwen3-ASR-0.6B dims
    t0 = time.perf_counter()
    enc_np = init_encoder_params_np(config.audio)
    dec_np = init_decoder_params_np(config.text)
    enc32 = to_torch(enc_np, torch.float32, "cuda")
    dec32 = to_torch(dec_np, torch.float32, "cuda")
    del enc_np, dec_np
    emit({"phase": "weights", "seconds": time.perf_counter() - t0})

    # 3. kernels
    kernel_rows = kernel_checks(torch, dec32)

    # 4. main path: bf16 weights, then int8 and int4 weights
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    clips = {}
    for seconds, seed in ((4, 1), (30, 2), (300, 3), (8, 4), (15, 5),
                          (22, 6)):
        path = tmp / f"clip_{seconds}s.wav"
        write_wav(path, seconds, seed)
        clips[seconds] = path
    launches = {}  # {path: {kernel: launches in that path's run}}
    for quantize, lm_bits, seconds in MAIN_PATHS:
        os.environ.pop("ASR_LM_BITS", None)
        if lm_bits:  # read by the quantizer when the engine is built
            os.environ["ASR_LM_BITS"] = str(lm_bits)
        engine = AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=128,
                           config=config, params=(enc32, dec32),
                           tokenizer=StubTokenizer(), device="cuda",
                           quantize=quantize)
        os.environ.pop("ASR_LM_BITS", None)
        label = (quantize or "bf16") + (f" lm{lm_bits}" if lm_bits else "")
        launches[label] = run_path(
            torch, engine, {c: clips[c] for c in seconds}, quantize, lm_bits,
            card)
        del engine
        torch.cuda.empty_cache()

    # 5. batch: bf16 and int8 KV with bf16 weights, then int8 weights with
    # int8 KV and int4 weights with bf16 KV
    from qwen3_asr_rs_tpu_torch.runtime.engine import load_audio

    audio = {c: load_audio(path, 16000) for c, path in clips.items()}
    for kv_dtype, quantize in dict.fromkeys(r[2:] for r in BATCH_RUNS):
        engine = AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=128,
                           config=config, params=(enc32, dec32),
                           tokenizer=StubTokenizer(), device="cuda",
                           kv_dtype=kv_dtype, quantize=quantize)
        for label, seconds, kv, quant in BATCH_RUNS:
            if (kv, quant) == (kv_dtype, quantize):
                name = (f"batch {label}"
                        + (f" {quantize} weights" if quantize else "")
                        + (" int8 KV" if kv else ""))
                launches[name] = run_batch(
                    torch, engine, [audio[c] for c in seconds], label,
                    seconds, kv, quantize, card)
        del engine
        torch.cuda.empty_cache()

    # 6. parity: float32 teacher forcing, kernel path vs plain path
    for quantize in (None, "int8", "int4"):
        parity(torch, AsrEngine(None, dtype=torch.float32, max_new_tokens=128,
                                config=config, params=(enc32, dec32),
                                tokenizer=StubTokenizer(), device="cuda",
                                quantize=quantize), clips[4], quantize)
        torch.cuda.empty_cache()
    for kv_dtype in (None, "int8"):
        batch_parity(torch, AsrEngine(None, dtype=torch.float32,
                                      max_new_tokens=128, config=config,
                                      params=(enc32, dec32),
                                      tokenizer=StubTokenizer(),
                                      device="cuda", kv_dtype=kv_dtype),
                     [audio[c] for c in (4, 8, 15)], kv_dtype)
        torch.cuda.empty_cache()

    summary = []
    for name in kernel_wrappers():
        rows = [r for r in kernel_rows if r["kernel"] == name
                and r["dtype"].startswith("bfloat16")]
        by_path = {p: c[name] for p, c in launches.items() if c[name]}
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            **({"covers": K1_COVERS} if name == "decode_layers_fused" else {}),
        })
        if not summary[-1]["launches"] > 0:
            raise AssertionError(f"kernel {name} never launched on a main path")
    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
