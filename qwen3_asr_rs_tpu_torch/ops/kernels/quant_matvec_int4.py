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
80 MB of packed weight at 0.6B). It takes any number of rows, in blocks
of 4 that each read the weight again; the JAX package dequantizes
outside its Pallas call for R > 64 instead, which gives the same values
within float32 summation order.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import MATVEC_TILE, unpack_int4_tiled
from . import _build

def quant_matvec_int4_plain(x, w_q4, scales, *, tile: int = MATVEC_TILE):
    """Plain PyTorch version: float32 product of x's values and the
    unpacked nibbles, sliced to the true width, times the scales."""
    w = unpack_int4_tiled(w_q4, tile, torch.float32)
    return (x.float() @ w)[:, : scales.shape[0]] * scales.float()


def _lib():
    lib = _build.load("quant_matvec_int4")
    if not getattr(lib, "_bound", False):
        for fn in ("quant_matvec_int4_bf16", "quant_matvec_int4_f32"):
            _build.bind(lib, fn, 4, (ctypes.c_int,) * 4)
        lib._bound = True
    return lib


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
    out = torch.empty((r, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    fn = (lib.quant_matvec_int4_bf16 if x.dtype == torch.bfloat16
          else lib.quant_matvec_int4_f32)
    p = _build.ptr
    rc = fn(p(x), p(w_q4), p(scales), p(out), r, k, half, n,
            _build.stream_of(x))
    _build.check(lib, rc, "quant_matvec_int4")
    quant_matvec_int4.launches += 1
    return out


quant_matvec_int4.launches = 0
