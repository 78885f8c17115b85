"""The partition and merge of K2's one-launch design, and the tile order
of K3's online softmax, emulated in plain torch on the CPU.

K2 (``csrc/decode_attention.cuh``) cuts the slot axis into chunks by the
split rule (``split_chunk``, mirrored from the C ``attn_chunk``), streams
each chunk in 64-slot tiles with one online-softmax update per tile,
publishes a (max, sum, acc) partial per query head, and the last block
folds the partials: split weights exp(m_s - M) against the max over the
splits and the self score, the weighted accumulators summed by eight
warps (ATTN_WARPS) over interleaved splits, then the self term and one
division. K3's bf16 kernel (``csrc/flash_attention.cu``) runs the Pallas
kernel's online softmax tile by tile, with P rounded to bf16 per key
tile: the port's ``flash_attention_tile_reference``, which the card
checks hold K3's bf16 output to element by element.

The merge emulation below and that reference repeat the arithmetic in
float32 and are held against the port's plain versions and the JAX
package's Pallas kernels in interpret mode (float32 at atol/rtol 1e-5:
the same math added in other orders; bf16 outputs element by element
within one bf16 rounding). The CUDA kernels themselves are held against
the plain versions and the reference on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.ops.pallas.decode_attention import (
    decode_attention_dma as jax_decode_attention_dma,
)
from qwen3_asr_rs_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from qwen3_asr_rs_tpu_torch.models.text_decoder import quantize_kv
from qwen3_asr_rs_tpu_torch.ops.kernels import decode_attention as da
from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_plain,
    flash_attention_tile_reference,
)

TOL = dict(atol=1e-5, rtol=1e-5)
T = torch.from_numpy
TILE = 64  # K2's slots per shared-memory tile
FOLD_WARPS = 8  # the warps of K2's fold (ATTN_WARPS)
# the kernel's block target on the H100 SXM (ATTN_TARGET_BLOCKS: two
# waves of its 132 SMs); the card test holds the mirror to the library's
BLOCKS = 2 * 132


# ------------------------------------------------------------- split rule

@pytest.mark.parametrize("b", [1, 2, 3, 8, 32, 64])
@pytest.mark.parametrize("hkv", [1, 2, 8])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 96, 360, 4992, 20000])
def test_split_rule_partitions_the_slab(b, hkv, s):
    """Chunks are multiples of 64 slots, cover [0, S) without overlap,
    number at most the block target (and so fit the fold's shared
    memory), and the workspace holds acc, (max, sum) and a counter."""
    chunk = da.split_chunk(b, hkv, s, BLOCKS)
    n = da.num_splits(b, hkv, s, BLOCKS)
    assert chunk >= da.MIN_CHUNK and chunk % da.MIN_CHUNK == 0
    bounds = [(i * chunk, min(i * chunk + chunk, s)) for i in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == c[0] for a, c in zip(bounds, bounds[1:]))
    assert n <= BLOCKS
    assert n <= max(1, math.ceil(BLOCKS / (b * hkv)))
    d, hq = 128, 2 * hkv
    assert da.workspace_words(b, hq, hkv, s, d, BLOCKS) == (
        b * hq * n * (d + 2) + b * hkv)


def test_split_rule_at_the_main_path_shapes():
    """The 0.6B decoder's 8 kv heads: the 4 s bucket's slab at B = 1 is
    6 chunks of 64 slots; the 300 s bucket's at B = 8 is 4 chunks of 1280
    (256 blocks, one round of two per SM on 132 SMs); at B = 32 one chunk
    per row and kv head."""
    def rule(b, s):
        return (da.split_chunk(b, 8, s, BLOCKS),
                da.num_splits(b, 8, s, BLOCKS))

    assert rule(1, 360) == (64, 6)
    assert rule(1, 4992) == (192, 26)
    assert rule(8, 4992) == (1280, 4)
    assert rule(32, 360) == (384, 1)
    assert all(rule(b, 4992)[1] * b * 8 <= BLOCKS
               for b in (1, 2, 4, 8, 16, 32))


# ------------------------------------------------------------- K2's merge

def merge_emulation(q, k_slabs, v_slabs, k_self, v_self, layer, start, end,
                    chunk, *, k_scales=None, v_scales=None, scale=None):
    """K2's one-launch arithmetic in float32: per (example, kv head,
    chunk) the live slots in 64-slot tiles with one online-softmax update
    per tile (K scale on the raw score, V scale on the PV probability,
    unscaled softmax sum), a (max, sum, acc) partial per head (an empty
    chunk: max -inf), then the fold."""
    b, hq, d = q.shape
    _, _, hkv, s_max, _ = k_slabs.shape
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    nsplit = -(-s_max // chunk)
    out = torch.empty((b, hq, d), dtype=torch.float32)
    for bi in range(b):
        for h in range(hkv):
            qf = q[bi, h * g:(h + 1) * g].float()
            parts = []
            for sp in range(nsplit):
                lo = max(sp * chunk, int(start[bi]))
                hi = min(sp * chunk + chunk, int(end[bi]), s_max)
                m = torch.full((g,), -math.inf)
                l = torch.zeros(g)
                acc = torch.zeros((g, d))
                for t0 in range(lo, hi, TILE):
                    sl = slice(t0, min(t0 + TILE, hi))
                    s = qf @ k_slabs[layer, bi, h, sl].float().T * scale
                    if k_scales is not None:
                        s = s * k_scales[layer, bi, h, sl]
                    mn = torch.maximum(m, s.amax(-1))
                    corr = torch.exp(m - mn)
                    p = torch.exp(s - mn[:, None])
                    l = l * corr + p.sum(-1)
                    if v_scales is not None:
                        p = p * v_scales[layer, bi, h, sl]
                    acc = acc * corr[:, None] + p @ v_slabs[
                        layer, bi, h, sl].float()
                    m = mn
                parts.append((m, l, acc))
            # the fold
            s_self = (qf * k_self[bi, h].float()).sum(-1) * scale
            mx = torch.stack([s_self] + [m for m, _, _ in parts]).amax(0)
            w = [torch.where(m == -math.inf, 0.0, torch.exp(m - mx))
                 for m, _, _ in parts]
            p_self = torch.exp(s_self - mx)
            l_tot = sum(wi * li for wi, (_, li, _) in zip(w, parts)) + p_self
            red = [torch.zeros((g, d)) for _ in range(FOLD_WARPS)]
            for sp, (wi, (_, _, acc)) in enumerate(zip(w, parts)):
                red[sp % FOLD_WARPS] += torch.where(wi[:, None] == 0, 0.0,
                                           wi[:, None] * acc)
            tot = p_self[:, None] * v_self[bi, h].float()[None]
            for r in red:
                tot = tot + r
            out[bi, h * g:(h + 1) * g] = tot / torch.clamp(l_tot, min=1e-30)[
                :, None]
    return out.to(q.dtype)


def _slab_case(rng, b, hq, hkv, s, d, int8):
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    ks = (rng.standard_normal((2, b, hkv, s, d)) * 0.5).astype(np.float32)
    vs = (rng.standard_normal((2, b, hkv, s, d)) * 0.5).astype(np.float32)
    k_self = rng.standard_normal((b, hkv, d)).astype(np.float32)
    v_self = rng.standard_normal((b, hkv, d)).astype(np.float32)
    scales = {}
    if int8:
        (kq, kscale), (vq, vscale) = quantize_kv(T(ks)), quantize_kv(T(vs))
        ks, vs = kq.numpy(), vq.numpy()
        scales = dict(k_scales=kscale, v_scales=vscale)
    return q, ks, vs, k_self, v_self, scales


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("chunk", [64, 128, 192, None])
@pytest.mark.parametrize("b,hq,hkv,d,starts,ends", [
    (3, 4, 2, 64, [0, 5, 200], [256, 131, 200]),
    (2, 16, 2, 128, [0, 70], [193, 71]),
])
def test_merge_emulation_matches_plain_and_pallas(rng, int8, chunk, b, hq,
                                                  hkv, d, starts, ends):
    """Chunk sizes from one tile to the split rule's; empty chunks, a row
    with start == end (the self key alone), live ranges ending inside a
    chunk and a tile; G = 2 and 8; int8 slabs with per-slot scales."""
    s = 256
    q, ks, vs, k_self, v_self, scales = _slab_case(rng, b, hq, hkv, s, d,
                                                   int8)
    st, en = np.asarray(starts, np.int32), np.asarray(ends, np.int32)
    chunk = chunk or da.split_chunk(b, hkv, s, BLOCKS)
    got = merge_emulation(T(q), T(ks), T(vs), T(k_self), T(v_self), 1, st,
                          en, chunk, **scales)
    plain = da.decode_attention_dma_plain(
        T(q), T(ks), T(vs), T(k_self), T(v_self), 1, T(st), T(en), **scales)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    jscales = {n: jnp.asarray(t.numpy()) for n, t in scales.items()}
    ref = jax_decode_attention_dma(
        jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(k_self),
        jnp.asarray(v_self), 1, jnp.asarray(st), jnp.asarray(en),
        block_s=128, interpret=True, **jscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_merge_emulation_ignores_dead_slots(rng):
    """Slots outside [start, end) are never scored: a dead slot's int8
    scale of 0 (a fresh slab) and its values cannot reach the output."""
    q, ks, vs, k_self, v_self, scales = _slab_case(rng, 2, 4, 2, 256, 64,
                                                   True)
    st, en = np.asarray([3, 0], np.int32), np.asarray([77, 250], np.int32)
    base = merge_emulation(T(q), T(ks), T(vs), T(k_self), T(v_self), 1, st,
                           en, 64, **scales)
    ks2, vs2 = ks.copy(), vs.copy()
    ks2[1, 0, :, 77:] = 127
    vs2[1, 0, :, :3] = -128
    scales["k_scales"][1, 0, :, 77:] = 0.0
    got = merge_emulation(T(q), T(ks2), T(vs2), T(k_self), T(v_self), 1, st,
                          en, 64, **scales)
    np.testing.assert_array_equal(got.numpy(), base.numpy())


# ------------------------------------------------------ K3's tile order

def _attendable(b, s, causal, kv_valid, kv_start):
    """(b, s) rows with at least one attendable key."""
    row = np.arange(s)
    ok = np.ones((b, s), bool)
    for i in range(b):
        lo = 0 if kv_start is None else kv_start[i]
        hi = s if kv_valid is None else kv_valid[i]
        ok[i] = (row >= lo) if causal else True
        ok[i] &= lo < hi
    return ok


@pytest.mark.parametrize("blocks", [(16, 16), (32, 16), (64, 64)])
@pytest.mark.parametrize("causal,kv_valid,kv_start", [
    (True, None, None), (False, [70, 41], None), (True, None, [0, 19]),
    (True, [90, 57], [3, 40])])
def test_flash_tile_emulation_matches_pallas_f32(rng, blocks, causal,
                                                 kv_valid, kv_start):
    """float32: the port's tile reference at the Pallas kernel's key
    block against the Pallas kernel at the same block sizes (the same
    tiles, up to leading tiles before kv_start, which K3 skips: they only
    reach rows that have no attendable key, and up to tiles past a causal
    q-tile's last row, wholly masked), within 1e-5."""
    b, s, hq, hkv, d = 2, 90, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    bq, bk = blocks
    got = flash_attention_tile_reference(
        T(q), T(k), T(v), kv_valid, kv_start, causal=causal,
        block_k=bk).numpy()
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if kv_valid is None else jnp.asarray(kv_valid, jnp.int32),
        None if kv_start is None else jnp.asarray(kv_start, jnp.int32),
        causal=causal, block_q=bq, block_k=bk, interpret=True))
    ok = _attendable(b, s, causal, kv_valid, kv_start)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[ok], ref[ok], **TOL)
    plain = flash_attention_plain(
        T(q), T(k), T(v),
        None if kv_valid is None else torch.tensor(kv_valid),
        None if kv_start is None else torch.tensor(kv_start),
        causal=causal).numpy()
    np.testing.assert_allclose(got[ok], plain[ok], **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_tile_emulation_bf16_p_matches_pallas(rng, causal):
    """bf16 inputs, K3's 64 x 64 tiles: P rounds to bf16 per key tile
    before the PV product, as in the Pallas kernel at the same blocks;
    the Pallas kernel's bf16 output is the reference's float32 output
    rounded, element by element (2^-8 of each value, and 2e-4 for a P
    entry whose rounding the two exponentials' last bits can flip)."""
    b, s, hq, hkv, d = 1, 200, 4, 2, 32
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    tq, tk, tv = (T(x).bfloat16() for x in (q, k, v))
    got = flash_attention_tile_reference(tq, tk, tv, causal=causal).numpy()
    ref = jax_flash_attention(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (tq, tk, tv)),
        causal=causal, block_q=64, block_k=64, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    assert (np.abs(ref - got) <= 2 ** -8 * np.abs(got) + 2e-4).all()
