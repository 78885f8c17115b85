"""K5: weight-only int8 matmul, ``(x @ w_q) * scales``.

Replaces the Pallas kernel
``qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py::quant_matmul``, and is what
the port's int8 linears (``models/text_decoder.py::_linear``, prefill and
the per-layer decode path) and int8 lm_head (``TextDecoder.logits``) run
on; the JAX decoder computes the same contract through XLA. x (R, K),
w_q (K, N) int8, scales (N,) float32. Products in float32 from x's values
(bf16 x: exact), float32 accumulation, the per-column scale applied to
the whole sum, one rounding to ``out_dtype`` (default x.dtype).

The bf16 instance is the Pallas kernel's contract (it casts x to bf16);
the float32 instance keeps x in float32, which is the contract of the
JAX decoder's ``_linear`` and int8 lm_head in a float32 model.

Kernel: ``csrc/quant_matmul.cu``: a GEMV for R <= 8 (the lm_head at one
token is weight-bytes-bound, 156 MB at 0.6B) and a shared-memory tiled
kernel on the CUDA cores for prefill rows (see the note there).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def quant_matmul_plain(x, w_q, scales, *, out_dtype=None):
    """Plain PyTorch version: float32 product of x's values and the int8
    weights, times the scales, rounded once to ``out_dtype``."""
    y = x.float() @ w_q.float()
    return (y * scales.float()).to(out_dtype or x.dtype)


def _lib():
    lib = _build.load("quant_matmul")
    if not getattr(lib, "_bound", False):
        for fn in ("quant_matmul_bf16", "quant_matmul_bf16_f32",
                   "quant_matmul_f32"):
            _build.bind(lib, fn, 4, (ctypes.c_int,) * 3)
        lib._bound = True
    return lib


def quant_matmul(x, w_q, scales, *, out_dtype=None):
    """(R, K) x @ (K, N) int8 ``w_q`` x ``scales`` -> (R, N) ``out_dtype``.

    CPU tensors run ``quant_matmul_plain``; CUDA tensors launch the kernel
    (``quant_matmul.launches`` counts those launches). The kernel takes
    bf16 x with a bf16 or float32 output and float32 x with a float32
    output, N a multiple of 8, contiguous operands.
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_q, scales, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: device {x.device} not supported")
    r, k = x.shape
    n = w_q.shape[-1]
    names = {
        (torch.bfloat16, torch.bfloat16): "quant_matmul_bf16",
        (torch.bfloat16, torch.float32): "quant_matmul_bf16_f32",
        (torch.float32, torch.float32): "quant_matmul_f32",
    }
    if (x.dtype, out_dtype) not in names:
        raise ValueError(
            f"quant_matmul: x {x.dtype} -> {out_dtype} not supported")
    if w_q.shape != (k, n) or w_q.dtype != torch.int8 or n % 8:
        raise ValueError(
            f"quant_matmul: w_q must be (K={k}, N) int8 with N % 8 == 0, "
            f"got {tuple(w_q.shape)} {w_q.dtype}")
    if scales.shape != (n,) or scales.dtype != torch.float32:
        raise ValueError("quant_matmul: scales must be (N,) float32")
    for t in (x, w_q, scales):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("quant_matmul: operands must be contiguous "
                             "tensors on one device")
    out = torch.empty((r, n), dtype=out_dtype, device=x.device)
    lib = _lib()
    p = _build.ptr
    rc = getattr(lib, names[(x.dtype, out_dtype)])(
        p(x), p(w_q), p(scales), p(out), r, k, n, _build.stream_of(x))
    _build.check(lib, rc, "quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
