"""Weight-only int8 / int4 quantizers, bit-exact with the JAX package.

Ports the non-kernel functions of
``qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py``: per-output-channel
symmetric int8 (``quantize_weight``), nibble-packed int4 whose packed
column j holds columns (j, j + N/2) (``quantize_weight_int4``, or with
``blocks`` within each of the blocks of the tensor-parallel layout,
``unpack_int4_blocked``), the same packing with one scale per group of
contraction rows and column (``quantize_weight_int4_grouped``,
quantize='int4g'), and the lm_head's tile-local int4 packing
(``quantize_weight_int4_tiled``), with their inverses, and the plain
int4 products (``int4_grouped_matmul`` reaches
no Pallas kernel in JAX either). Outputs are contiguous whatever the
input's strides (the lm_head is quantized through a transposed view).
The kernels that read these layouts are ``ops/kernels/quant_matmul.py``
(int8) and ``ops/kernels/quant_matvec_int4.py`` (tile-local int4); the
decode step (``ops/kernels/decode_layer.py``) reads the per-layer
layouts, int4g included.

Bit-exactness: ``absmax / 127`` (or ``/ 7``) and the division of the
weights by the scales run in float32, as in JAX, and ``torch.round``
rounds half to even, as ``jnp.round`` does. Packing is done on int32
values and mapped back to the int8 range explicitly, so it does not rely
on how an int8 shift wraps; nibbles are sign-extended through int32.
"""

from __future__ import annotations

import torch

MATVEC_TILE = 8192


def quantize_weight(w, axis: int = 0, amax=None):
    """Per-output-channel symmetric int8 quantization of (K, N) weights
    (or (L, K, N) stacks with ``axis=-2``).

    Returns (w_q int8, scales float32 with ``axis`` removed). ``axis`` is
    the contraction axis. ``amax``: each column's absolute maximum, when
    ``w`` is a piece of a weight whose contraction axis is split (by
    default ``w``'s own).
    """
    wf = w.float()
    if amax is None:
        amax = wf.abs().amax(dim=axis)
    scales = torch.clamp(amax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scales.unsqueeze(axis)), -127, 127)
    return w_q.to(torch.int8).contiguous(), scales


def _pack_nibbles(lo, hi):
    """int8 byte whose low nibble is ``lo`` and high nibble ``hi``
    (values in [-7, 7])."""
    p = (lo.int() & 0xF) | ((hi.int() & 0xF) << 4)  # 0..255
    return torch.where(p >= 128, p - 256, p).to(torch.int8).contiguous()


def quantize_weight_int4(w, axis: int = 0, blocks: int = 1):
    """Per-output-channel symmetric int4 quantization of (..., K, N)
    weights. Returns (packed int8 (..., K, N // 2), scales float32
    (..., N)); packed column j holds columns j (low nibble) and j + N/2
    (high nibble). Values are clipped to [-7, 7]. N must be even.

    ``blocks > 1`` packs within each of ``blocks`` contiguous column
    blocks (column j pairs with j + N / (2 blocks) inside its block) into
    (..., K, blocks, N // (2 blocks)): the tensor-parallel layout, where
    the block of one tp shard is a ``blocks = 1`` packing of its own
    columns (``unpack_int4_blocked``)."""
    if axis not in (0, -2) or (axis == 0 and w.ndim != 2):
        raise ValueError("quantize_weight_int4: the contraction axis is -2")
    wf = w.float()
    scales = torch.clamp(wf.abs().amax(dim=-2), min=1e-8) / 7.0
    q = torch.clamp(torch.round(wf / scales.unsqueeze(-2)), -7, 7)
    n = q.shape[-1]
    if n % 2:
        raise ValueError(f"int4 packing needs an even output dim, got {n}")
    if blocks == 1:
        return _pack_nibbles(q[..., : n // 2], q[..., n // 2:]), scales
    if n % (2 * blocks):
        raise ValueError(
            f"int4 packing needs output dim divisible by 2*blocks "
            f"({2 * blocks}), got {n}")
    qb = q.reshape(*q.shape[:-1], blocks, 2, n // (2 * blocks))
    return _pack_nibbles(qb[..., 0, :], qb[..., 1, :]), scales


def unpack_nibbles(packed):
    """(low, high) sign-extended nibbles of int8 bytes, as int32."""
    p = packed.int()
    return ((p & 0xF) ^ 8) - 8, p >> 4


def unpack_int4(packed, dtype=torch.float32):
    """Inverse of ``quantize_weight_int4``'s packing (original column
    order): (..., K, N // 2) int8 -> (..., K, N) ``dtype``."""
    lo, hi = unpack_nibbles(packed)
    return torch.cat([lo, hi], dim=-1).to(dtype)


def unpack_int4_blocked(packed, dtype=torch.float32):
    """Inverse of the blocked packing: (..., blocks, N // (2 blocks)) int8
    -> (..., N) ``dtype``, every op local to a block."""
    lo, hi = unpack_nibbles(packed)
    w = torch.cat([lo, hi], dim=-1)
    return w.reshape(*w.shape[:-2], -1).to(dtype)


class _MatmulF32(torch.autograd.Function):
    """``aten::mm.dtype`` (no derivative in torch) with the gradient JAX
    gives ``preferred_element_type=float32``: each operand's cotangent is
    a float32 product of the float32 cotangent and the other operand,
    cast to that operand's dtype."""

    @staticmethod
    def forward(ctx, a2, b):
        ctx.save_for_backward(a2, b)
        return torch.mm(a2, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a2, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().T).to(a2.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a2.float().T @ g).to(b.dtype)
        return ga, gb


def matmul_f32(a, b):
    """a (..., K) @ b (K, N) of one dtype as float32: float32 accumulation
    of the products and no rounding to that dtype (JAX's
    ``preferred_element_type=jnp.float32``). On CUDA a bf16 product keeps
    its float32 result through ``aten::mm.dtype`` (``_MatmulF32``, which
    gives it a gradient); elsewhere the operands are upcast (bf16 x bf16
    products are exact in float32)."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and a.dtype != torch.float32:
        y = _MatmulF32.apply(a2, b)
    else:
        y = a2.float() @ b.float()
    return y.reshape(*a.shape[:-1], b.shape[-1])


def int4_matmul_plain(x, w_q4, scales, out_dtype=None):
    """x (..., K) @ int4 ``w_q4`` (K, N // 2) (``quantize_weight_int4``'s
    packing) times the per-column ``scales`` -> (..., N) ``out_dtype``
    (default x.dtype). The JAX package's two half-width products on the
    sign-extended nibbles, each float32 (the nibbles are exact in x's
    dtype), concatenated, scaled, then rounded once."""
    lo, hi = unpack_nibbles(w_q4)
    y = torch.cat([matmul_f32(x, lo.to(x.dtype)),
                   matmul_f32(x, hi.to(x.dtype))], -1)
    return (y * scales.float()).to(out_dtype or x.dtype)


def int4_blocked_matmul(x, w_q4, scales):
    """x (..., K) @ a blocked int4 weight (K, blocks, N // (2 blocks))
    times the per-column ``scales`` (N,) -> (..., N) x.dtype: each block's
    two half-width float32 products (``int4_matmul_plain``), concatenated,
    scaled, then rounded once. A tp shard's block (blocks = 1) is a plain
    packing of its columns."""
    blocks = w_q4.shape[-2]
    if blocks == 1:
        return int4_matmul_plain(x, w_q4[..., 0, :], scales)
    n_b = scales.shape[-1] // blocks
    y = [int4_matmul_plain(x, w_q4[..., j, :], scales[j * n_b:(j + 1) * n_b],
                           torch.float32) for j in range(blocks)]
    return torch.cat(y, -1).to(x.dtype)


def int4_group_size(k: int, group_size: int) -> int:
    """The group size ``quantize_weight_int4_grouped`` uses for K rows:
    ``group_size``, or the largest divisor of K below it when K is not a
    multiple of it (tiny test shapes)."""
    if k % group_size == 0:
        return group_size
    return next(d for d in range(min(group_size, k), 0, -1) if k % d == 0)


def quantize_weight_int4_grouped(w, group_size: int = 128):
    """Group-wise symmetric int4 quantization of (..., K, N) weights: each
    ``group_size`` contraction rows get their own per-column scale.

    Returns (packed int8 (..., K, N // 2), with ``quantize_weight_int4``'s
    (j, j + N/2) nibble pairing, and scales float32 (..., K // g, N)),
    where g is ``int4_group_size(K, group_size)``. N must be even."""
    wf = w.float()
    k, n = wf.shape[-2:]
    if n % 2:
        raise ValueError(f"int4 packing needs an even output dim, got {n}")
    gs = int4_group_size(k, group_size)
    g = wf.reshape(*wf.shape[:-2], k // gs, gs, n)
    scales = torch.clamp(g.abs().amax(dim=-2), min=1e-8) / 7.0
    q = torch.clamp(torch.round(g / scales.unsqueeze(-2)), -7, 7)
    q = q.reshape(wf.shape)
    return _pack_nibbles(q[..., : n // 2], q[..., n // 2:]), scales


def dequantize_int4_grouped(packed, scales):
    """Dense float32 (K, N) of a grouped int4 weight: (K, N // 2) packed
    and (G, N) scales."""
    w = unpack_int4(packed)
    rows = w.shape[0] // scales.shape[0]
    return w * torch.repeat_interleave(scales.float(), rows, 0)


def int4_grouped_matmul(x, packed, scales):
    """x (..., K) @ a grouped int4 weight ((K, N // 2) packed, (G, N)
    float32 scales) -> (..., N) float32, in JAX's two regimes:

    * more than 8 rows (prefill): the group-scaled weight is made in x's
      dtype (nibble times ``scales.to(x.dtype)``, rounded there), then one
      product with a float32 result;
    * at most 8 rows (decode): float32 per-group partials of the nibbles
      (exact in x's dtype), times the float32 scales, summed over groups.
    """
    k = x.shape[-1]
    n_groups, n = scales.shape
    if x.numel() // k > 8:
        g = k // n_groups
        w = (unpack_int4(packed, x.dtype).reshape(n_groups, g, n)
             * scales.to(x.dtype)[:, None, :]).reshape(k, n)
        return matmul_f32(x, w)
    return int4_grouped_partials(x, packed, scales)


def int4_grouped_partials(x, packed, scales):
    """x (..., K) @ a grouped int4 weight -> (..., N) float32: float32
    per-group partials of the nibbles (exact in x's dtype), times the
    float32 (G, N) scales, summed over groups; low nibbles give columns
    [0, N/2), high nibbles [N/2, N). The decode kernel's arithmetic at
    any row count, and ``int4_grouped_matmul``'s at <= 8 rows."""
    k = x.shape[-1]
    n_groups, n = scales.shape
    g = k // n_groups
    lo, hi = unpack_nibbles(packed)
    xg = x.float().reshape(*x.shape[:-1], n_groups, g)
    sf = scales.float()
    y = []
    for half, s in ((lo, sf[:, : n // 2]), (hi, sf[:, n // 2:])):
        wg = half.to(x.dtype).float().reshape(n_groups, g, n // 2)
        y.append((torch.einsum("...gk,gkn->...gn", xg, wg) * s).sum(-2))
    return torch.cat(y, -1)


def quantize_weight_int4_tiled(w, tile: int = MATVEC_TILE):
    """Tile-local int4 packing of (K, N) weights for ``quant_matvec_int4``.

    N is zero-padded to a multiple of ``tile``; each tile packs its own
    columns (j, j + tile/2) into one int8. Returns (packed int8
    (K, N_pad // 2), scales float32 (N,) — unpadded).
    """
    wf = w.float()
    k, n = wf.shape
    n_pad = -(-n // tile) * tile
    scales = torch.clamp(wf.abs().amax(dim=0), min=1e-8) / 7.0
    q = torch.clamp(torch.round(wf / scales[None, :]), -7, 7)
    q = torch.nn.functional.pad(q, (0, n_pad - n))
    qt = q.reshape(k, n_pad // tile, 2, tile // 2)
    packed = _pack_nibbles(qt[:, :, 0], qt[:, :, 1])
    return packed.reshape(k, n_pad // 2), scales


def unpack_int4_tiled(packed, tile: int = MATVEC_TILE, dtype=torch.float32):
    """Inverse of ``quantize_weight_int4_tiled``'s packing:
    (K, N_pad // 2) int8 -> (K, N_pad) ``dtype`` (padded columns zero)."""
    k, half = packed.shape
    lo, hi = unpack_nibbles(packed.reshape(k, half // (tile // 2), tile // 2))
    return torch.cat([lo, hi], dim=-1).reshape(k, 2 * half).to(dtype)
