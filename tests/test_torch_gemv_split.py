"""The tiling of K1's tensor-core GEMVs and of K4, emulated in plain torch
on the CPU.

With bf16 activations K1's GEMVs (``csrc/decode_layer.cu`` over
``csrc/gemv_mma.cuh``) and K4 (``csrc/quant_matvec_int4.cu``) run
``mma.sync.m16n8k16``: 16 output columns by 16 rows of K by 8 batch rows
per instruction, float32 accumulators. A block owns 64 loaded columns and
a K range of ``gemv_split_rows`` rows (the split rule, mirrored from the
C ``gm_split_rows``); each warp adds one 16-row fragment sum at a time to
its accumulators in K order; int4g sums each group's fragments into a
float32 partial and adds it times the group's scales, in group order;
the last block of a column tile adds the splits' partials in split order
and applies the per-column scales to the whole sum. K4 stages float32 x
as three bf16 terms whose sum is x exactly.

The emulations below repeat that arithmetic in float32 and are held
against the JAX package (``_mm`` of the Pallas megakernel's module, and
the Pallas ``quant_matvec_int4`` in interpret mode) and against the
port's plain versions at atol/rtol 1e-5: the same exact products (bf16 x
times weights that are exact in bf16) summed in another order. The
fragment layouts (which weight, x and output element each lane holds)
and the exact int8/int4 -> bf16 conversions are emulated bit for bit.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py), where the C split rule is
also held to this mirror.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.ops.pallas import quant_matmul as jq
from qwen3_asr_rs_tpu.ops.pallas.decode_layer import _mm as jax_mm
from qwen3_asr_rs_tpu_torch.ops import quant as tq
from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl
from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matvec_int4 import (
    quant_matvec_int4_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)
KS = 16            # K rows per mma.sync
GM_XPAD = 8        # bf16 padding per staged x row
# one 0.6B decoder layer's products: (name, K, output columns per source,
# sources): q|k|v merged, o, gate and up (two sources), down
LAYER = (("qkv_w", 1024, 4096, 1), ("o_w", 2048, 1024, 1),
         ("gateup_w", 1024, 3072, 2), ("down_w", 3072, 1024, 1))
KINDS = ("float", "int8", "int4", "int4g32", "int4g64", "int4g128")


def _group(kind: str) -> int:
    return int(kind[5:]) if kind.startswith("int4g") else 0


def launch_split(kind: str, k: int, n: int, nsrc: int, rows: int) -> int:
    """The K rows per block that K1's launch asks gemv_split_rows for: n
    output columns per source (int4: n / 2 loaded), nsrc sources, rows
    batch rows staged as 8, 16 or 32."""
    int4 = kind.startswith("int4")
    loaded = n // 2 if int4 else n
    nacc = nsrc * (2 if int4 else 1)
    wbytes = nsrc * (2 if kind == "float" else 1)
    g = _group(kind)
    granule = g if g > dl.GEMV_KS else dl.GEMV_KS
    nb8 = 1 if rows <= 8 else 2 if rows <= 16 else 4
    return dl.gemv_split_rows(k, -(-loaded // dl.GEMV_TN), rows, nacc, wbytes,
                              granule, nb8)


# ------------------------------------------------------------- split rule

@pytest.mark.parametrize("rows", [1, 8, 17, 32])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,k,n,nsrc", LAYER)
def test_split_rule_partitions_k(name, k, n, nsrc, kind, rows):
    """The K split covers K in whole granules (an int4g group is never
    cut), stays within one round of blocks and fills at least half of it
    unless K runs out or the caps bind, keeps the split-K partials within
    the weight bytes they sum and the last block's reduction within
    GEMV_EPI_ROWS rows x splits, and its staged x fits the shared-memory
    budget."""
    kb = launch_split(kind, k, n, nsrc, rows)
    g = _group(kind)
    granule = max(g, dl.GEMV_KS)
    assert kb % granule == 0 and (g == 0 or kb % g == 0)
    splits = -(-k // kb)
    int4 = kind.startswith("int4")
    tiles = -(-(n // 2 if int4 else n) // dl.GEMV_TN)
    nacc, wbytes = nsrc * (2 if int4 else 1), nsrc * (2 if kind == "float"
                                                     else 1)
    # the partials stay within the weight bytes they sum, the reduction
    # within its rows x splits ...
    assert 4 * rows * nacc <= wbytes * kb or kb >= k
    assert rows * splits <= max(dl.GEMV_EPI_ROWS, rows)
    # ... and, where those allow, the grid fills at least half a round of
    # two blocks per SM, and never more than one round
    finer = -(-k // (kb - granule)) if kb > granule else splits
    assert (tiles * splits >= min(dl.GEMV_TARGET_BLOCKS // 2,
                                  tiles * -(-k // granule))
            or 4 * rows * nacc > wbytes * (kb - granule)
            or rows * finer > dl.GEMV_EPI_ROWS)
    assert tiles * splits <= max(dl.GEMV_TARGET_BLOCKS, tiles)
    nb8 = 1 if rows <= 8 else 2 if rows <= 16 else 4
    assert 16 * nb8 * (kb + GM_XPAD) <= dl.GEMV_XS_MAX


def test_split_rule_at_the_main_path_shapes():
    """bf16 weights at B up to 8: q|k|v 4 splits of 256 rows over 64
    column tiles, o 16 of 128 over 16, gate|up 4 of 256 over 48, down 16
    of 192 over 16: 192 to 256 blocks, within one round of two per SM on
    132 SMs. At 32 rows o and down take 8 splits (256 and 384 rows): the
    last block of a column tile adds rows x splits partials in turn. int4
    down at B = 1 takes 24 splits of 128 rows."""
    def splits(kind, rows):
        return [(launch_split(kind, k, n, s, rows), -(-k // launch_split(
            kind, k, n, s, rows))) for _, k, n, s in LAYER]

    assert splits("float", 1) == splits("float", 8) == [
        (256, 4), (128, 16), (256, 4), (192, 16)]
    assert splits("float", 32) == [(256, 4), (256, 8), (256, 4), (384, 8)]
    assert launch_split("int4", 3072, 1024, 1, 1) == 128


# ------------------------------------------------------------ arithmetic

def _weights(rng, kind, k, n):
    """(port weight, port scales, dense unscaled float32 (K, N) values,
    JAX args) of one product."""
    w = 0.02 * rng.standard_normal((k, n)).astype(np.float32)
    wt = torch.from_numpy(w)
    if kind == "float":
        wb = wt.bfloat16()
        return wb, None, wb.float(), (jnp.asarray(w).astype(jnp.bfloat16),
                                      jnp.float32(1.0), {})
    if kind == "int8":
        q, s = tq.quantize_weight(wt)
        return q, s, q.float(), (jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                 {})
    g = _group(kind)
    if g:
        q, s = tq.quantize_weight_int4_grouped(wt, g)
        extra = dict(int4=True, gscale=jnp.asarray(s.numpy()), gsize=g)
        return q, s, tq.unpack_int4(q), (jnp.asarray(q.numpy()),
                                         jnp.float32(1.0), extra)
    q, s = tq.quantize_weight_int4(wt)
    return q, s, tq.unpack_int4(q), (jnp.asarray(q.numpy()),
                                     jnp.asarray(s.numpy()), dict(int4=True))


def gemv_emulation(x, dense, scales, group: int, kb: int):
    """K1's tensor-core GEMV in float32: x (R, K) bf16, dense (K, N) the
    unscaled weight values (exact in bf16), scales (N,) per column or
    (G, N) per group. Per split of kb rows: one float32 sum of 16 exact
    products per mma, added in K order (int4g: into the group's partial,
    which joins the sum times its scales when the group ends); the splits
    in split order; per-column scales on the whole sum."""
    xf = x.float()
    k = xf.shape[1]
    total = None
    for lo in range(0, k, kb):
        hi = min(k, lo + kb)
        acc = torch.zeros((xf.shape[0], dense.shape[1]))
        part = torch.zeros_like(acc)
        for k0 in range(lo, hi, KS):
            frag = xf[:, k0:k0 + KS] @ dense[k0:k0 + KS]
            if group:
                part = part + frag
                if (k0 + KS) % group == 0 or k0 + KS >= hi:
                    acc = acc + part * scales[k0 // group]
                    part = torch.zeros_like(acc)
            else:
                acc = acc + frag
        total = acc if total is None else total + acc
    if scales is not None and not group:
        total = total * scales
    return total


@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_gemv_emulation_matches_jax_and_plain(kind, rows):
    """Every product of one 0.6B layer (each source of gate|up alone),
    float32 results: the emulation with the launch's split against JAX
    ``_mm`` (bf16 compute dtype, float32 result) and the port's plain
    ``_mm``."""
    rng = np.random.default_rng(20 + rows)
    for name, k, n, nsrc in LAYER:
        x = torch.from_numpy(rng.standard_normal((rows, k)).astype(
            np.float32)).bfloat16()
        kb = launch_split(kind, k, n, nsrc, rows)
        for _ in range(nsrc):
            w, s, dense, (jw, js, extra) = _weights(rng, kind, k, n)
            got = gemv_emulation(x, dense, s, _group(kind), kb)
            ref = np.asarray(jax_mm(jnp.asarray(x.float().numpy()).astype(
                jnp.bfloat16), jw, js, jnp.bfloat16, **extra))
            np.testing.assert_allclose(got.numpy(), ref, **TOL)
            suffix = "" if s is None else "_q4" if kind.startswith(
                "int4") else "_q"
            layers = {name + suffix: w[None]}
            if s is not None:
                layers[f"{name}_s"] = s[None]
            plain = dl._mm(x, layers, name, 0, torch.float32)
            np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


# ----------------------------------------------------------------- K4

def bf16_terms(x):
    """float32 x as K4 stages it: three bf16 terms, each the rounding of
    what the previous ones leave, summing to x exactly (x normal)."""
    terms, rest = [], x.float()
    for _ in range(3):
        t = rest.bfloat16().float()
        terms.append(t)
        rest = rest - t
    return terms


def test_three_bf16_terms_are_exact():
    """Normal float32 values, tiny and huge ones and a walk over the
    23-bit mantissas, are recovered exactly (in float64: the kernel never
    adds the terms, it adds their exact products); a subnormal one within
    2^-134, half the smallest bf16 subnormal."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        (rng.standard_normal(512) * 1e-30).astype(np.float32),
        (rng.standard_normal(512) * 1e30).astype(np.float32),
        np.array([2.0 ** -126, 1.0 + 2.0 ** -23, -(2.0 - 2.0 ** -23), 3e38],
                 np.float32),
        ((np.arange(1, 1 << 16, dtype=np.uint32) * 257) & 0x7FFFFF
         | 0x3F800000).view(np.float32)])
    x = torch.from_numpy(vals)
    t0, t1, t2 = (t.double() for t in bf16_terms(x))
    assert torch.equal(t0 + t1 + t2, x.double())
    sub = torch.tensor([1e-40, -3e-42, 2.0 ** -130], dtype=torch.float32)
    t0, t1, t2 = (t.double() for t in bf16_terms(sub))
    assert ((t0 + t1 + t2) - sub.double()).abs().max() <= 2.0 ** -134


def k4_emulation(x, w_q4, scales, kb: int):
    """K4 in float32: per split of kb rows, per 16-row step, one float32
    fragment sum per bf16 term of x (bf16 x: itself; float32 x: three
    terms) in term order; the splits in order; the scale on the sum."""
    dense = tq.unpack_int4_tiled(w_q4)
    terms = [x.float()] if x.dtype == torch.bfloat16 else bf16_terms(x)
    k = x.shape[1]
    total = None
    for lo in range(0, k, kb):
        acc = torch.zeros((x.shape[0], dense.shape[1]))
        for k0 in range(lo, min(k, lo + kb), KS):
            for t in terms:
                acc = acc + t[:, k0:k0 + KS] @ dense[k0:k0 + KS]
        total = acc if total is None else total + acc
    return total[:, : scales.shape[0]] * scales


@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_emulation_matches_pallas(rows, dtype):
    """K4's split (2 to 4 splits of the 1024 rows over 128 column tiles of
    a two-tile N = 9000) against the Pallas matvec in interpret mode and
    the plain version, float32 logits."""
    rng = np.random.default_rng(30 + rows)
    k, n = 1024, 9000
    w = 0.02 * rng.standard_normal((k, n)).astype(np.float32)
    wq, s = jq.quantize_weight_int4_tiled(jnp.asarray(w))
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(
        np.float32)).to(dtype)
    nterm = 3 if dtype == torch.float32 else 1
    half = wq.shape[1]
    kb = dl.gemv_split_rows(k, half // dl.GEMV_TN, rows, 2, 1, dl.GEMV_KS,
                            -(-rows // 8) * nterm)
    assert -(-k // kb) >= 2
    wq_t, s_t = (torch.from_numpy(np.array(a)) for a in (wq, s))
    got = k4_emulation(x, wq_t, s_t, kb)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jq.quant_matvec_int4(jnp.asarray(x.float().numpy()).astype(
        jdt), wq, s, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        got.numpy(), quant_matvec_int4_plain(x, wq_t, s_t).numpy(), **TOL)


# ------------------------------------------------ conversions and layouts

def _bf16_of_bits(bits):
    """bf16 bit patterns (uint32, low 16 bits) as float32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def i8_bits(w, i):
    """gm_i8_bits: byte i of w (bytes already offset by 128) as float32
    bits of 2^23 + byte, minus 2^23 + 128."""
    b = (w >> (8 * i)) & 0xFF
    f = (np.uint32(0x4B000000) | b).view(np.float32) - np.float32(8388736.0)
    return np.asarray(f, np.float32).view(np.uint32)


def i8_pair(w, i, j):
    """gm_i8_pair: bf16 of signed bytes i (low half) and j (high half)."""
    x = w ^ np.uint32(0x80808080)
    return (i8_bits(x, i) >> 16) | (i8_bits(x, j) & np.uint32(0xFFFF0000))


def nib_pair(u):
    """gm_nib_pair: the signed nibbles at bits 0-3 and 16-19 of u as two
    bf16: 0x4300 | (q ^ 8) is 128 + q + 8, minus 136."""
    v = (u & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
    lo = _bf16_of_bits(v & 0xFFFF) - np.float32(136)
    hi = _bf16_of_bits(v >> 16) - np.float32(136)
    return lo, hi


def test_int8_and_int4_to_bf16_are_exact():
    """Every int8 value and every nibble converts to its own value."""
    v = np.arange(-128, 128)
    w = (v.astype(np.int64) & 0xFF).astype(np.uint32)
    words = w | (np.roll(w, 7) << 16)  # bytes 0 and 2
    pair = i8_pair(words, 0, 2)
    np.testing.assert_array_equal(_bf16_of_bits(pair & 0xFFFF), v)
    np.testing.assert_array_equal(_bf16_of_bits(pair >> 16), np.roll(v, 7))
    q = np.arange(-8, 8)
    u = (q.astype(np.int64) & 0xF).astype(np.uint32)
    lo, hi = nib_pair(u | (np.roll(u, 3) << 16) | 0xF0F0F0)
    np.testing.assert_array_equal(lo, q)
    np.testing.assert_array_equal(hi, np.roll(q, 3))


def _bytes_u16(tile, off):
    return int(tile[off]) | int(tile[off + 1]) << 8


def a_fragment_bytes(tile, kk, warp, lane, brow=80):
    """gm_bytes: the words w01 and w89 behind a lane's A operand of a
    byte tile (rows of ``brow`` bytes)."""
    g, t = lane >> 2, lane & 3
    p = (16 * kk + 2 * t) * brow + 16 * warp + 2 * g
    w01 = _bytes_u16(tile, p) | _bytes_u16(tile, p + brow) << 16
    w89 = _bytes_u16(tile, p + 8 * brow) | _bytes_u16(tile, p + 9 * brow) << 16
    return np.uint32(w01), np.uint32(w89)


def mma_a_layout(a_of, lane):
    """The four (m, k) pairs of a lane's A registers in mma.m16n8k16:
    a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)."""
    g, t = lane >> 2, lane & 3
    return [(a_of(m, k), a_of(m, k + 1)) for m, k in
            ((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8), (g + 8, 2 * t + 8))]


@pytest.mark.parametrize("int4", [False, True])
def test_byte_tile_fragments(int4):
    """A stage of 64 rows x 64 loaded byte columns (80-byte rows, as
    gm_load_stage lays it): every lane's converted A operand is the mma
    layout of the weights at the loaded columns gm_col gives its rows
    (m = g and g + 8 -> columns 2g and 2g + 1 of the warp's 16)."""
    rng = np.random.default_rng(5)
    wb = rng.integers(-128, 128, (64, 64)).astype(np.int8)
    tile = np.zeros(64 * 80, np.uint8)
    for r in range(64):
        tile[r * 80:r * 80 + 64] = wb[r].view(np.uint8)
    for warp in range(4):
        for kk in range(4):
            def col(m):
                return 16 * warp + 2 * (m % 8) + m // 8
            for lane in range(32):
                w01, w89 = a_fragment_bytes(tile, kk, warp, lane)
                if int4:
                    lo = [nib_pair(w01), nib_pair(w01 >> 8), nib_pair(w89),
                          nib_pair(w89 >> 8)]
                    hi = [nib_pair(w01 >> 4), nib_pair(w01 >> 12),
                          nib_pair(w89 >> 4), nib_pair(w89 >> 12)]
                    for regs, nib in ((lo, lambda b: ((b & 0xF) ^ 8) - 8),
                                      (hi, lambda b: b >> 4)):
                        want = mma_a_layout(lambda m, k: nib(int(
                            wb[16 * kk + k, col(m)])), lane)
                        got = [(int(a), int(b)) for a, b in regs]
                        assert got == want
                else:
                    regs = [i8_pair(w01, 0, 2), i8_pair(w01, 1, 3),
                            i8_pair(w89, 0, 2), i8_pair(w89, 1, 3)]
                    got = [(int(_bf16_of_bits(r & 0xFFFF)),
                            int(_bf16_of_bits(r >> 16))) for r in regs]
                    want = mma_a_layout(lambda m, k: int(
                        wb[16 * kk + k, col(m)]), lane)
                    assert got == want


def test_bf16_tile_fragments():
    """A bf16 stage (128-byte rows, 16-byte chunk c of row r stored at
    c ^ (r & 7)) read by ldmatrix.x4.trans at the addresses gm_frag_bf16
    gives: every lane holds the mma A layout of the warp's 16 columns in
    order, and the 8 addresses of each 8x8 matrix fall in 8 distinct
    16-byte bank groups."""
    w = np.arange(64 * 64).reshape(64, 64)  # element ids
    smem = np.empty(64 * 64, np.int64)
    for r in range(64):
        for c in range(8):
            smem[r * 64 + ((c ^ (r & 7)) << 3):][:8] = w[r, 8 * c:8 * c + 8]
    for warp in range(4):
        for kk in range(4):
            addr = []
            for lane in range(32):
                k = 16 * kk + (lane & 7) + ((lane >> 4) << 3)
                c = 2 * warp + ((lane >> 3) & 1)
                addr.append(k * 64 + ((c ^ (k & 7)) << 3))
            for j in range(4):
                groups = {(a % 64) >> 3 for a in addr[8 * j:8 * j + 8]}
                assert len(groups) == 8
            for lane in range(32):
                t, g = lane & 3, lane >> 2
                # .trans: lane gets stored rows 2t, 2t + 1 of column g
                regs = [(smem[addr[8 * j + 2 * t] + g],
                         smem[addr[8 * j + 2 * t + 1] + g]) for j in range(4)]
                want = mma_a_layout(
                    lambda m, k: w[16 * kk + k, 16 * warp + m], lane)
                assert regs == want


def test_x_fragment_and_accumulator_layout():
    """x staged as bf16 rows of kb + 8 elements: gm_frag_x gives the mma B
    layout (b0 rows 2t, 2t + 1 of batch row g, b1 rows 2t + 8, 2t + 9),
    the 8 rows of a fragment read fall in distinct banks, and an mma
    assembled from the lanes' registers lands each output (batch row
    gm_acc_row, column gm_col) at x @ W."""
    rng = np.random.default_rng(6)
    kb, rows = 128, 8
    xstride = kb + GM_XPAD
    x = rng.integers(-3, 4, (rows, kb)).astype(np.float64)
    xs = np.zeros(rows * xstride)
    for r in range(rows):
        xs[r * xstride:r * xstride + kb] = x[r]
    wb = rng.integers(-3, 4, (kb, 16)).astype(np.float64)  # one warp's
    out = np.zeros((rows, 16))
    for kk in range(kb // 16):
        kl = 16 * kk
        a = np.zeros((16, 16))
        b = np.zeros((16, 8))
        words = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            p = g * xstride + kl + 2 * t
            words.append(p // 2 % 32)
            b[2 * t, g], b[2 * t + 1, g] = xs[p], xs[p + 1]
            b[2 * t + 8, g], b[2 * t + 9, g] = xs[p + 8], xs[p + 9]
            for (m, k) in ((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                           (g + 8, 2 * t + 8)):
                a[m, k], a[m, k + 1] = wb[kl + k, m], wb[kl + k + 1, m]
        assert len(set(words)) == 32
        d = a @ b  # (16 columns, 8 rows)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for c in range(4):
                r = 2 * t + (c & 1)          # gm_acc_row
                m = g + 8 * (c >> 1)         # gm_col of a bf16 tile
                out[r, m] += d[m, r]
    np.testing.assert_array_equal(out, x @ wb)


# ------------------------------------------------------ gemv_single (CPU)

@pytest.mark.parametrize("kind,epilogue,nibbles", [
    (k, e, False) for e in ("store", "residual") for k in KINDS] + [
    (k, "swiglu", False) for k in ("float", "int8", "int4")] + [
    (k, "swiglu", True) for k in ("int4", "int4g32", "int4g64", "int4g128")])
def test_gemv_single_plain_is_k1_plain_stage(kind, epilogue, nibbles):
    """``gemv_single`` on CPU tensors (its plain version) is one stage of
    K1's plain version: the RMSNorm prologue rounded to bf16, the product
    as JAX ``_mm`` computes it, then the store, residual or SwiGLU
    epilogue with K1's roundings, equal in bf16 but for a rare flipped
    rounding (the two sides sum in another order). Its reference's slack
    is never negative."""
    rng = np.random.default_rng(40)
    k, n, rows = 128, 256, 3
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(
        np.float32)).bfloat16()
    norm_w = torch.from_numpy((1 + 0.1 * rng.standard_normal(k)).astype(
        np.float32)).bfloat16()
    res = torch.from_numpy(rng.standard_normal((rows, n)).astype(
        np.float32)).bfloat16()
    int4 = kind.startswith("int4")
    swiglu = epilogue == "swiglu"
    w, s, _, jargs = _weights(rng, kind, k, 2 * n if nibbles else n)
    kw = dict(int4=int4, epilogue=epilogue)
    if epilogue == "residual":
        kw["res"] = res
    else:
        kw["norm_w"] = norm_w
    if swiglu and not nibbles:
        w_up, s_up, _, jargs_up = _weights(rng, kind, k, n)
        kw.update(w_up=w_up, s_up=s_up)
    got = dl.gemv_single(x, w, s, **kw)
    xn = x if epilogue == "residual" else dl._rms(x, norm_w, 1e-6).to(
        torch.bfloat16)

    def mm(args):
        jw, js, extra = args
        return torch.from_numpy(np.asarray(jax_mm(
            jnp.asarray(xn.float().numpy()).astype(jnp.bfloat16), jw, js,
            jnp.bfloat16, **extra)).copy()).bfloat16()

    y = mm(jargs)
    if epilogue == "store":
        want = y
    elif epilogue == "residual":
        want = (res.float() + y.float()).bfloat16()
    else:
        gate, up = y.chunk(2, -1) if nibbles else (y, mm(jargs_up))
        g = gate.float()
        act = (g * torch.sigmoid(g)).bfloat16()
        want = (act.float() * up.float()).bfloat16()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # one bf16 rounding of a float32 sum taken in another order may flip
    flips = (got.float() != want.float()).float().mean()
    assert flips <= 0.01
    assert torch.allclose(got.float(), want.float(), atol=1e-2, rtol=2 ** -7)
    _, slack = dl.gemv_single_reference(x, w, s, **kw)
    assert (slack >= 0).all()


@pytest.mark.parametrize("int4", [False, True])
def test_ssq_parts_cover_each_row(int4):
    """The parts of a row's sum of squares that a residual GEMV leaves for
    the next RMSNorm (one per column tile of 64 loaded columns; int4: a
    loaded column's two outputs j and j + N/2) add up to the row's sum of
    squares, and the plain single GEMV returns them with its output."""
    rng = np.random.default_rng(41)
    y = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32))
    parts = dl.ssq_parts(y, dl.GEMV_TN, int4)
    assert parts.shape == (3, 1024 // dl.GEMV_TN // (2 if int4 else 1))
    torch.testing.assert_close(parts.sum(-1), (y * y).sum(-1), rtol=1e-5,
                               atol=0)
    first = (y[:, :64] ** 2).sum(-1)
    if int4:
        first = first + (y[:, 512:576] ** 2).sum(-1)
    torch.testing.assert_close(parts[:, 0], first, rtol=1e-6, atol=0)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(
        np.float32)).bfloat16()
    w, s, _, _ = _weights(rng, "int4" if int4 else "float", 256, 1024)
    out, got = dl.gemv_single(x, w, s, int4=int4, epilogue="residual",
                              res=y.bfloat16(), ssq=True)
    torch.testing.assert_close(got, dl.ssq_parts(out, dl.GEMV_TN, int4))
