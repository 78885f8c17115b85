"""K4: the int4 lm_head matvec, ``x @ unpack(w_q4) * scales`` -> float32.

Replaces the Pallas kernel
``qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py::quant_matvec_int4``, which
``TextDecoder.logits`` runs for an int4 lm_head (``lm_head_q4``, quantize
'int4' or ``ASR_LM_BITS=4``) at the last prompt token and every decode
step. x (R, K); w_q4 (K, N_pad // 2) int8 in the tile-local packing of
``ops/quant.py::quantize_weight_int4_tiled`` (tile 8192: packed column
t*4096 + j holds columns t*8192 + j and t*8192 + 4096 + j); scales (N,)
float32 with N <= N_pad. Products in float32 from x's values (bf16 x:
exact), float32 accumulation, the scale applied to the whole sum; the
padded columns are not part of the (R, N) float32 result.

Kernel: ``csrc/quant_matvec_int4.cu`` (see the note there: bound by the
80 MB of packed weight at 0.6B, which it reads once per call whatever R
is): the nibbles converted to bf16 on the tensor cores (``mma.sync``)
against x staged as bf16 (float32 x as three bf16 terms that sum to it
exactly), up to 32 rows per pass, a K split from the shapes with a
deterministic last-block sum. The JAX package dequantizes outside its
Pallas call for R > 64 instead, which gives the same values within
float32 summation order.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import MATVEC_TILE, unpack_int4_tiled
from . import _build, counted

def quant_matvec_int4_plain(x, w_q4, scales, *, tile: int = MATVEC_TILE):
    """Plain PyTorch version: float32 product of x's values and the
    unpacked nibbles, sliced to the true width, times the scales."""
    w = unpack_int4_tiled(w_q4, tile, torch.float32)
    return (x.float() @ w)[:, : scales.shape[0]] * scales.float()


# Per device: the split-K counters of the column tiles (zero on entry,
# left zero by the kernel)
_counters: dict = {}
# Per (device, stream, rows, K, packed columns, dtype): the C entry and
# the split-K workspace of its launch plan, made once; calls ordered on
# one stream share it
_launches: dict = {}


def _lib():
    lib = _build.load("quant_matvec_int4")
    if not getattr(lib, "_bound", False):
        for fn in ("quant_matvec_int4_bf16", "quant_matvec_int4_f32"):
            _build.bind(lib, fn, 6, (ctypes.c_int,) * 4)
        lib.quant_matvec_int4_plan.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)])
        lib.quant_matvec_int4_plan.restype = None
        lib._bound = True
    return lib


def launch_plan(r: int, k: int, half: int, f32: bool) -> dict:
    """The kernel's launch plan for r rows (``q4_plan``): K rows per
    block, splits, workspace floats, staged rows per pass, whether the K
    range stays resident, shared-memory bytes."""
    plan = (ctypes.c_longlong * 6)()
    _lib().quant_matvec_int4_plan(r, k, half, int(f32), plan)
    return dict(zip(("kb", "splits", "ws_words", "rows", "resident",
                     "smem"), plan))


@counted
def quant_matvec_int4(x, w_q4, scales, *, tile: int = MATVEC_TILE):
    """(R, K) x -> (R, N) float32 logits (see module docstring).

    CPU tensors run ``quant_matvec_int4_plain``; CUDA tensors launch the
    kernel (``quant_matvec_int4.launches`` counts those launches).
    """
    if x.device.type == "cpu":
        return quant_matvec_int4_plain(x, w_q4, scales, tile=tile)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matvec_int4: device {x.device} not supported")
    r, k = x.shape
    n = scales.shape[0]
    half = w_q4.shape[-1]
    if tile != MATVEC_TILE or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"quant_matvec_int4: kernel takes tile {MATVEC_TILE} and bf16/f32 "
            f"x, got tile {tile}, {x.dtype}")
    if w_q4.shape != (k, half) or w_q4.dtype != torch.int8 or half % (
        tile // 2
    ) or not 0 < n <= 2 * half:
        raise ValueError(
            f"quant_matvec_int4: w_q4 must be (K={k}, N_pad/2) int8 with "
            f"N_pad a multiple of {tile} and >= N={n}, got "
            f"{tuple(w_q4.shape)} {w_q4.dtype}")
    if scales.dtype != torch.float32 or scales.ndim != 1:
        raise ValueError("quant_matvec_int4: scales must be (N,) float32")
    for t in (x, w_q4, scales):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("quant_matvec_int4: operands must be contiguous "
                             "tensors on one device")
    if k % 8:
        raise ValueError(f"quant_matvec_int4: K must be a multiple of 8, "
                         f"got {k}")
    out = torch.empty((r, n), dtype=torch.float32, device=x.device)
    stream = _build.stream_of(x)
    key = (x.device, stream.value, r, k, half, x.dtype)
    if key not in _launches:
        lib = _lib()
        plan = launch_plan(r, k, half, x.dtype == torch.float32)
        if x.device not in _counters:
            _counters[x.device] = torch.zeros(1 << 16, dtype=torch.int32,
                                              device=x.device)
        if half // 64 > _counters[x.device].numel():
            raise ValueError("quant_matvec_int4: too many columns")
        _launches[key] = (
            lib.quant_matvec_int4_bf16 if x.dtype == torch.bfloat16
            else lib.quant_matvec_int4_f32,
            torch.empty(max(plan["ws_words"], 1), dtype=torch.float32,
                        device=x.device))
    fn, ws = _launches[key]
    p = _build.ptr
    rc = fn(p(x), p(w_q4), p(scales), p(out), p(ws), p(_counters[x.device]),
            r, k, half, n, stream)
    _build.check(_lib(), rc, "quant_matvec_int4")
    quant_matvec_int4.launches += 1
    return out
