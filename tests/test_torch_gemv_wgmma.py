"""K1's wgmma GEMV (bf16 weights, up to 32 rows), emulated in plain torch on
the CPU.

The kernel (``gemv_wgmma_kernel`` in ``csrc/decode_layer.cu`` over
``csrc/gemv_wgmma.cuh``) owns 64 weight columns per block and splits K
across the blocks of a thread-block cluster (``gemv_wgmma_plan``, the
Python mirror of the C ``gw_plan``): rank r sums rows [r kr, (r + 1) kr)
of K, one float32 sum of 16 exact products per ``wgmma`` k16 step added
in K order, pushes its partial of each batch row into the shared memory
of the rank that owns the row, and each owner adds the ranks' partials in
rank order (0 + p0 + p1 + ...) before the epilogue's roundings. The
emulations below repeat that arithmetic in float32 and are held against
the JAX package's ``_mm`` (the Pallas megakernel's product) at the 1.7B
decoder's shapes scaled down, and against the port's plain ``gemv_single``;
the plan, the route rule, the partials' placement and the accumulator
layout are checked as the C code computes them. The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py), where the C plan and rule are also held to these mirrors.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.ops.pallas.decode_layer import _mm as jax_mm
from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl

TOL = dict(atol=1e-5, rtol=1e-5)
KS = 16  # K rows per wgmma
# one 1.7B decoder layer's GEMVs: (name, K, output columns per segment,
# epilogue): q|k|v in three segments, o, gate and up, down
LAYER_17B = (("qkv", 2048, (2048, 1024, 1024), "store"),
             ("o", 2048, (2048,), "residual"),
             ("gateup", 2048, (6144,), "swiglu"),
             ("down", 6144, (2048,), "residual"))
LAYER_06B = (("qkv", 1024, (2048, 1024, 1024), "store"),
             ("o", 2048, (1024,), "residual"),
             ("gateup", 1024, (3072,), "swiglu"),
             ("down", 3072, (1024,), "residual"))
SCALE = 4  # the CPU emulation's cut of every width


def _plan(k, cols, epilogue, rows):
    tiles = sum(-(-c // dl.GW_TN) for c in cols)
    nsrc = 2 if epilogue == "swiglu" else 1
    return dl.gemv_wgmma_plan(k, tiles, nsrc, dl.gemv_nb8(rows)), tiles, nsrc


# ------------------------------------------------------------ the plan

def test_plan_at_the_cell_shapes():
    """At 32 rows the 1.7B layer's four GEMVs take clusters of 4, 8, 2 and
    8 ranks (256, 256, 192 and 256 blocks: two a SM at most), ranks of
    512, 256, 1024 and 768 rows of K and rings of 4 stages (at least 64
    KB of weights in flight a SM)."""
    got = [(p["cs"], p["kr"], p["stages"], p["smem"], t * p["cs"])
           for p, t, _ in (_plan(k, c, e, 32) for _, k, c, e in LAYER_17B)]
    assert got == [(4, 512, 4, 60032, 256), (8, 256, 4, 59520, 256),
                   (2, 1024, 4, 102528, 192), (8, 768, 4, 60544, 256)]
    for (_, _, stages, smem, blocks), (_, _, _, epi) in zip(got, LAYER_17B):
        per_sm = -(-blocks // dl.GW_SMS)
        assert per_sm * (smem + dl.GW_BLOCK_EXTRA) <= dl.GW_SM_SMEM
        nsrc = 2 if epi == "swiglu" else 1
        assert per_sm * stages * nsrc * dl.GW_W_BYTES >= 64 * 1024


@pytest.mark.parametrize("rows", [1, 8, 16, 17, 32])
@pytest.mark.parametrize("layer", ["1.7b", "0.6b"])
def test_plan_partitions_k(layer, rows):
    """Every GEMV of a layer: the cluster is the largest power of two up
    to 8 ranks (and K's stages) whose blocks stay within two a SM; the
    ranks cover K in whole stages, each rank but the last a full kr; the
    ring holds at most the rank's stages and GW_MAX_STAGES; the shared
    memory is the ring (weights and x's rows per stage), the partials,
    the rank's norm weights and the slack, and the blocks of an SM fit
    it."""
    for _, k, cols, epi in (LAYER_17B if layer == "1.7b" else LAYER_06B):
        p, tiles, nsrc = _plan(k, cols, epi, rows)
        cs, kr, stages = p["cs"], p["kr"], p["stages"]
        units = -(-k // dl.GW_KS)
        nst = kr // dl.GW_KS
        assert cs in (1, 2, 4, 8) and cs <= units
        assert tiles * cs <= dl.GW_TARGET_BLOCKS
        assert (cs == dl.GW_MAX_CLUSTER or 2 * cs > units
                or 2 * tiles * cs > dl.GW_TARGET_BLOCKS)
        assert kr % dl.GW_KS == 0 and (cs - 1) * kr < k <= cs * kr
        assert 1 <= stages <= min(nst, dl.GW_MAX_STAGES)
        nb8 = dl.gemv_nb8(rows)
        stage = nsrc * dl.GW_W_BYTES + 8 * nb8 * 128
        fixed = nsrc * 8 * nb8 * dl.GW_RPITCH * 4 + 2 * kr + dl.GW_SLACK
        assert p["smem"] == fixed + stages * stage
        per_sm = -(-(tiles * cs) // dl.GW_SMS)
        assert per_sm * (p["smem"] + dl.GW_BLOCK_EXTRA) <= dl.GW_SM_SMEM


@pytest.mark.parametrize("rows", [1, 8, 9, 16, 17, 24, 32])
@pytest.mark.parametrize("kind", ["", "_q", "_q4", "_q4g"])
def test_route_by_kind_and_rows(kind, rows):
    """The rule is fixed on the shapes: bf16 weights take the wgmma GEMV
    at every GEMV of both layers and every row count; every quantized kind
    takes the mma.sync GEMV."""
    for layer in (LAYER_17B, LAYER_06B):
        for _, k, cols, epi in layer:
            p, tiles, nsrc = _plan(k, cols, epi, rows)
            want = "wgmma" if kind == "" else "mma"
            assert dl.gemv_route(dl._KINDS[kind], rows, k, tiles, nsrc) == want
    # a plan too large for a block (its ranks' norm weights alone) falls
    # back to the mma.sync GEMV
    k_huge = dl.GW_MAX_CLUSTER * 2 ** 17
    assert dl.gemv_wgmma_plan(k_huge, 1, 1, 4)["smem"] > dl.GW_SMEM_MAX
    assert dl.gemv_route(0, 32, k_huge, 1, 1) == "mma"


# ------------------------------------------------------------ arithmetic

def wgmma_emulation(x, dense, kr: int, cs: int):
    """The wgmma GEMV's product in float32: x (R, K) bf16, dense (K, N)
    bf16 weight values. Rank r: one float32 sum of 16 exact products per
    k16 step over rows [r kr, (r + 1) kr), added in K order (an empty rank
    sums nothing); the owner adds the ranks' partials in rank order,
    starting from zero."""
    xf, wf = x.float(), dense.float()
    k = xf.shape[1]
    total = torch.zeros((xf.shape[0], wf.shape[1]))
    for r in range(cs):
        acc = torch.zeros_like(total)
        for k0 in range(r * kr, min(k, (r + 1) * kr), KS):
            acc = acc + xf[:, k0:k0 + KS] @ wf[k0:k0 + KS]
        total = total + acc
    return total


def epilogue_emulation(y, epilogue, res=None, up=None):
    """The epilogue's roundings on the float32 sums (``gemv_output``):
    store T(y); residual T(res + T(y)); SwiGLU T(T(silu(T(gate))) *
    T(up))."""
    bf = torch.bfloat16
    if epilogue == "store":
        return y.to(bf)
    if epilogue == "residual":
        return (res.float() + y.to(bf).float()).to(bf)
    g = y.to(bf).float()
    act = (g * (1.0 / (1.0 + torch.exp(-g)))).to(bf).float()
    return (act * up.to(bf).float()).to(bf)


def _rms_bf16(x, w, eps=1e-6):
    return dl._rms(x, w, eps).to(torch.bfloat16)


@pytest.mark.parametrize("rows", [1, 8, 17, 32])
@pytest.mark.parametrize("name,k,cols,epilogue", LAYER_17B)
def test_emulation_matches_jax_and_plain(name, k, cols, epilogue, rows):
    """The 1.7B layer's GEMVs with every width cut by 4: the emulated
    rank-order sum with the launch's plan against JAX ``_mm`` (bf16
    compute dtype, float32 result) to 1e-5, then the epilogue's roundings
    against the port's plain ``gemv_single``: equal in bf16 but for a rare
    flipped rounding (the plain version sums in another order)."""
    rng = np.random.default_rng(60 + rows)
    k //= SCALE
    cols = tuple(c // SCALE for c in cols)
    p, _, nsrc = _plan(k, cols, epilogue, rows)
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(
        np.float32)).bfloat16()
    norm_w = torch.from_numpy((1 + 0.1 * rng.standard_normal(k)).astype(
        np.float32)).bfloat16()
    normed = epilogue != "residual"
    xn = _rms_bf16(x, norm_w) if normed else x
    ws = [torch.from_numpy(0.02 * rng.standard_normal((k, c)).astype(
        np.float32)).bfloat16() for c in cols]
    if epilogue == "swiglu":
        ws.append(torch.from_numpy(0.02 * rng.standard_normal(
            (k, cols[0])).astype(np.float32)).bfloat16())
    ys = []
    for w in ws:
        y = wgmma_emulation(xn, w, p["kr"], p["cs"])
        ref = np.asarray(jax_mm(jnp.asarray(xn.float().numpy()).astype(
            jnp.bfloat16), jnp.asarray(w.float().numpy()).astype(
                jnp.bfloat16), jnp.float32(1.0), jnp.bfloat16))
        np.testing.assert_allclose(y.numpy(), ref, **TOL)
        ys.append(y)
    res = torch.from_numpy(rng.standard_normal((rows, cols[0])).astype(
        np.float32)).bfloat16()
    if epilogue == "store":
        got = epilogue_emulation(torch.cat(ys, 1), "store")
        plain = dl.gemv_single(x, ws, norm_w=norm_w)
    elif epilogue == "residual":
        got = epilogue_emulation(ys[0], "residual", res=res)
        plain = dl.gemv_single(x, ws[0], epilogue="residual", res=res)
    else:
        got = epilogue_emulation(ys[0], "swiglu", up=ys[1])
        plain = dl.gemv_single(x, ws[0], epilogue="swiglu", norm_w=norm_w,
                               w_up=ws[1])
    assert got.shape == plain.shape and got.dtype == plain.dtype
    assert (got.float() != plain.float()).float().mean() <= 0.01
    torch.testing.assert_close(got.float(), plain.float(), atol=1e-2,
                               rtol=2 ** -7)


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_rank_order_is_deterministic_and_complete(cs):
    """The owners' sum over ranks: in rank order it is one fixed float32
    value per element (the same inputs give the same bits); a rank's
    partial dropped, or added twice, moves the result by that partial
    (what the card's planted faults do)."""
    rng = np.random.default_rng(70 + cs)
    k, n, rows = 1024, 256, 32
    kr = -(-k // dl.GW_KS // cs) * dl.GW_KS
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(0.02 * rng.standard_normal((k, n)).astype(
        np.float32)).bfloat16()
    a, b = wgmma_emulation(x, w, kr, cs), wgmma_emulation(x, w, kr, cs)
    assert torch.equal(a, b)
    full = x.float() @ w.float()
    torch.testing.assert_close(a, full, **TOL)
    last = (x.float()[:, (cs - 1) * kr:] @ w.float()[(cs - 1) * kr:])
    if cs > 1:
        assert not torch.allclose(a - last, full, atol=1e-3)
        assert not torch.allclose(a + last, full, atol=1e-3)


# --------------------------------------------------- layouts and partials

def accumulator_coords(nb8: int):
    """(warp, lane, register) -> (weight column, batch row) of a
    wgmma.m64n(8 nb8)k16 float32 accumulator: register 4 j + 2 i + c of
    lane l of warp w is column 16 w + l / 4 + 8 i and row 8 j + 2 (l % 4)
    + c."""
    out = {}
    for w in range(4):
        for lane in range(32):
            for j in range(nb8):
                for i in range(2):
                    for c in range(2):
                        out[(w, lane, 4 * j + 2 * i + c)] = (
                            16 * w + lane // 4 + 8 * i, 8 * j + 2 * (lane % 4)
                            + c)
    return out


@pytest.mark.parametrize("nb8", [1, 2, 4])
def test_accumulators_cover_the_tile(nb8):
    """The 128 threads' 4 nb8 accumulators cover the 64 x 8 nb8 tile once
    each."""
    coords = accumulator_coords(nb8)
    assert len(coords) == 128 * 4 * nb8
    assert sorted(coords.values()) == [(m, n) for m in range(64)
                                       for n in range(8 * nb8)]


@pytest.mark.parametrize("nsrc", [1, 2])
@pytest.mark.parametrize("nb8", [1, 2, 4])
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_partials_land_once_in_their_owners(cs, nb8, nsrc):
    """Each rank's push of (source, row, column) lands at a word of the
    row's owner (rank n / (N / cs)) that no other push takes, inside the
    owner's partials (gw_red_bytes), and the owner's float4 reads of a
    row's 4 columns are 16-byte aligned and read its slots in rank
    order."""
    n_rows = 8 * nb8
    rp = n_rows // cs
    red_words = dl.GW_RPITCH * nsrc * n_rows
    seen = {}
    for rank in range(cs):
        for (w, lane, reg), (m, n) in accumulator_coords(nb8).items():
            for src in range(nsrc):
                owner, lr = n // rp, n % rp
                assert owner * rp <= n < (owner + 1) * rp
                word = ((rank * nsrc + src) * rp + lr) * dl.GW_RPITCH + m
                assert 0 <= word < red_words
                assert (owner, word) not in seen
                seen[(owner, word)] = (rank, src, n, m)
    for owner in range(cs):
        for lr in range(rp):
            for m0 in range(0, 64, 4):
                for src in range(nsrc):
                    words = [((r * nsrc + src) * rp + lr) * dl.GW_RPITCH + m0
                             for r in range(cs)]
                    assert all(wd % 4 == 0 for wd in words)
                    assert [seen[(owner, wd)][0] for wd in words] == list(
                        range(cs))


def test_x_staging_is_the_k_major_swizzle():
    """x's box of a stage (TMA, 128-byte swizzle) as wgmma's B operand,
    where a normed GEMV rounds it in place: 16-byte chunk c of batch row n
    at byte n * 128 + ((c ^ (n & 7)) << 4) of the stage's x rows, a
    permutation of each 1024-byte atom of 8 rows, and the K step kk's 32
    bytes of row n are chunks 2 kk and 2 kk + 1 (the descriptor's + 2 kk
    in 16-byte units)."""
    for n_rows in (8, 16, 32):
        places = [n * 128 + ((c ^ (n & 7)) << 4) for n in range(n_rows)
                  for c in range(8)]
        assert sorted(places) == list(range(0, n_rows * 128, 16))
        for atom in range(n_rows // 8):
            chunk = places[64 * atom:64 * atom + 64]
            assert min(chunk) == 1024 * atom and max(chunk) < 1024 * (atom + 1)


@pytest.mark.parametrize("tiles", [1, 5, 16, 32, 63, 64])
def test_rmsnorm_sum_keeps_tile_order(tiles):
    """The prologue's sum of a row's parts: 4 threads, thread j holding
    parts [j P, (j + 1) P) (P = ceil(tiles / 4), zeros past the last
    part), each adding its parts to the running sum that thread j - 1
    handed on, is the sequential sum in tile order bit for bit, as the
    mma.sync GEMV adds them."""
    rng = np.random.default_rng(90 + tiles)
    parts = torch.from_numpy(rng.random((8, tiles)).astype(np.float32) * 7)
    p = -(-tiles // 4)
    held = torch.zeros((8, 4, 16))
    for j in range(4):
        for i in range(16):
            t = j * p + i
            if i < p and t < tiles:
                held[:, j, i] = parts[:, t]
    run = torch.zeros(8)
    for j in range(4):
        for i in range(16):
            run = run + held[:, j, i]
    seq = torch.zeros(8)
    for t in range(tiles):
        seq = seq + parts[:, t]
    assert torch.equal(run, seq)


@pytest.mark.parametrize("rows", [17, 32])
def test_ssq_parts_at_the_tile_width(rows):
    """The residual epilogue's sums of squares keep their contract at the
    wgmma GEMV's tile: 64 columns (GW_TN == GEMV_TN), one part per tile
    in tile order, each the owner's 16 threads' sums of 4 columns (in
    column order) added by the xor tree; equal to ``ssq_parts`` to
    float32 rounding, so the next RMSNorm adds the parts in tile order
    whichever GEMV wrote them."""
    assert dl.GW_TN == dl.GEMV_TN
    rng = np.random.default_rng(80 + rows)
    y = torch.from_numpy(rng.standard_normal((rows, 512)).astype(
        np.float32)).bfloat16()
    yf = y.float()
    tiles = yf.shape[1] // dl.GW_TN
    parts = torch.zeros((rows, tiles))
    for t in range(tiles):
        sq = torch.zeros((rows, 16))
        for c in range(4):
            col = yf[:, t * 64 + c::4][:, :16]
            sq = sq + col * col
        for o in (8, 4, 2, 1):  # __shfl_xor_sync over the row's 16 lanes
            idx = torch.arange(16) ^ o
            sq = sq + sq[:, idx]
        assert torch.equal(sq[:, :1].expand(-1, 16), sq)
        parts[:, t] = sq[:, 0]
    torch.testing.assert_close(parts, dl.ssq_parts(y, dl.GEMV_TN, False),
                               rtol=1e-6, atol=0)
