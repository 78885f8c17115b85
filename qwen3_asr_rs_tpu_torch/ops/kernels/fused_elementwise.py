"""K8: the ``deepseek_v3`` decoder's per-token elementwise passes, each one
Triton kernel: RMSNorm (``rms_norm``) and MLA's latent prologue
(``latent_rope``: the latent's RMSNorm and the interleaved rope of the
query's and the shared key's rope parts).

Not TPU kernels: the JAX package runs no such decoder. In a decode step
of 64 rows these passes are a few hundred KB each, bound by nothing but
their launches: written as torch ops, a norm is nine kernels and the
latent's prologue some twenty, a third of a captured decode step's
~3,600 launches at Kimi-VL-A3B's depth. One program per row keeps the
row in registers; the arithmetic is the plain versions' (float32, one
rounding to the output's dtype). CPU tensors run the plain versions;
CUDA tensors launch the kernels or raise. ``rms_norm.launches`` and
``latent_rope.launches`` count the launches.
"""

from __future__ import annotations

import torch

from ..norms import rms_norm as rms_norm_plain
from . import counted

_kernels: dict = {}


def _build_kernels():
    """The Triton kernels, built once (``triton`` is imported here: the
    CPU test suite imports this module without it)."""
    if _kernels:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_rows(x_ptr, w_ptr, y_ptr, eps, N: tl.constexpr,
                      BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        m = cols < N
        x = tl.load(x_ptr + row * N + cols, mask=m, other=0.0)
        x = x.to(tl.float32)
        r = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / N + eps)
        w = tl.load(w_ptr + cols, mask=m, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * N + cols,
                 (x * r * w).to(y_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def latent_rope_rows(q_ptr, ckv_ptr, cos_ptr, sin_ptr, w_ptr, qr_ptr,
                         lat_ptr, q_stride, eps, HEADS: tl.constexpr,
                         QK: tl.constexpr, NOPE: tl.constexpr,
                         R: tl.constexpr, D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        half = tl.arange(0, D // 2)
        c = tl.load(cos_ptr + row * D + half)
        s = tl.load(sin_ptr + row * D + half)
        # the query's rope parts: (heads, D / 2) pairs
        h = tl.arange(0, HEADS)
        base = q_ptr + row * q_stride + h[:, None] * QK + NOPE
        ev = tl.load(base + 2 * half[None, :]).to(tl.float32)
        od = tl.load(base + 2 * half[None, :] + 1).to(tl.float32)
        out = qr_ptr + row * (HEADS * D) + h[:, None] * D + half[None, :]
        ty = qr_ptr.dtype.element_ty
        tl.store(out, (ev * c[None, :] - od * s[None, :]).to(ty))
        tl.store(out + D // 2, (od * c[None, :] + ev * s[None, :]).to(ty))
        # the latent: RMSNorm of c_kv, then the roped shared key
        cols = tl.arange(0, R)
        x = tl.load(ckv_ptr + row * (R + D) + cols).to(tl.float32)
        r = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / R + eps)
        w = tl.load(w_ptr + cols).to(tl.float32)
        lat = lat_ptr + row * (R + D)
        ty = lat_ptr.dtype.element_ty
        tl.store(lat + cols, (x * r * w).to(ty))
        kev = tl.load(ckv_ptr + row * (R + D) + R + 2 * half).to(tl.float32)
        kod = tl.load(ckv_ptr + row * (R + D) + R + 2 * half + 1).to(
            tl.float32)
        tl.store(lat + R + half, (kev * c - kod * s).to(ty))
        tl.store(lat + R + D // 2 + half, (kod * c + kev * s).to(ty))

    _kernels.update(rms_norm=rms_norm_rows, latent_rope=latent_rope_rows)
    return _kernels


@counted
def rms_norm(x, weight, eps: float, out_dtype=None):
    """RMSNorm over the last axis (``ops/norms.py``'s), computed in
    float32 and rounded once to ``out_dtype`` (default x's): on CUDA one
    program per row of a contiguous x."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps).to(out_dtype)
    if not x.is_contiguous():
        raise ValueError("rms_norm: K8 takes a contiguous x")
    n = x.shape[-1]
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _build_kernels()["rms_norm"][(x.numel() // n,)](
        x, weight, y, float(eps), N=n,
        BLOCK=1 << (n - 1).bit_length(), num_warps=4 if n <= 1024 else 8)
    rms_norm.launches += 1
    return y


def rope_interleave(x, cos, sin):
    """transformers' ``apply_rotary_pos_emb_interleave`` on one tensor:
    the interleaved pairs gathered (evens, then odds), then rotate-half by
    cos/sin (..., D) broadcast over x's heads axis -2; float32, rounded
    to x's dtype."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    turned = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], -1)
    c, s = cos[..., None, :], sin[..., None, :]
    return (xf * c + turned * s).to(x.dtype)


def latent_rope_plain(q, ckv, cos, sin, ln_w, eps: float, nope: int):
    """Plain PyTorch version of ``latent_rope``."""
    r = ckv.shape[-1] - cos.shape[-1]
    c = rms_norm_plain(ckv[..., :r], ln_w, eps)
    k_rot = rope_interleave(ckv[..., r:][..., None, :], cos, sin)[..., 0, :]
    return (rope_interleave(q[..., nope:], cos, sin),
            torch.cat([c, k_rot], -1))


@counted
def latent_rope(q, ckv, cos, sin, ln_w, eps: float, nope: int):
    """MLA's prologue per token: (the query's rope parts turned (B, S,
    heads, D), the latent (B, S, R + D): RMSNorm of c_kv, then the
    shared key's rope part turned) from the query ``q`` (B, S, heads,
    nope + D), ``ckv`` (B, S, R + D) and cos/sin (B, S, D) or (S, D)
    float32 (the rotate-half tables: each half the same)."""
    if not q.is_cuda:
        return latent_rope_plain(q, ckv, cos, sin, ln_w, eps, nope)
    b, s, heads, qk = q.shape
    d = cos.shape[-1]
    r = ckv.shape[-1] - d
    if heads & (heads - 1) or r & (r - 1) or d & (d - 1):
        raise ValueError("latent_rope: heads, the latent and the rope width "
                         "must be powers of two")
    rows = b * s
    cos = cos.expand(b, s, d).reshape(rows, d).contiguous()
    sin = sin.expand(b, s, d).reshape(rows, d).contiguous()
    q2, ckv2 = q.reshape(rows, heads * qk), ckv.reshape(rows, r + d)
    if not (q2.is_contiguous() and ckv2.is_contiguous()):
        raise ValueError("latent_rope: q and ckv must be contiguous")
    q_rot = torch.empty((b, s, heads, d), dtype=q.dtype, device=q.device)
    lat = torch.empty((b, s, r + d), dtype=ckv.dtype, device=q.device)
    _build_kernels()["latent_rope"][(rows,)](
        q2, ckv2, cos, sin, ln_w, q_rot, lat, q2.stride(0), float(eps),
        HEADS=heads, QK=qk, NOPE=nope, R=r, D=d, num_warps=4)
    latent_rope.launches += 1
    return q_rot, lat
