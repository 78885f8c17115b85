"""The tiling of K5 (int8 ``quant_matmul``), emulated in plain torch on
the CPU.

With bf16 x, K5 (``csrc/quant_matmul.cu``) takes one of two tensor-core
routes from the shapes (``launch_plan``, the mirror of the C ``qm_plan``):
up to 32 rows the GEMV blocks of ``csrc/gemv_mma.cuh`` (``mma.sync``, 64
weight columns per block, the K split of ``gemv_split_rows``); above, a
block computes out^T = W^T x^T for 128 weight columns by 128 rows of x
with ``wgmma.m64n128k16``: the int8 weight converted exactly to bf16 into
a 128-byte-swizzled MN-major tile (the A operand), x from a swizzled
K-major stage (the B operand), a K split where the tiles cannot fill the
card. Either way each block adds one float32 sum of
16 exact products per instruction in K order, the splits are added in
split order, the per-column scale multiplies the whole sum and the
output rounds once.

The emulation below repeats that arithmetic in float32 and is held
against the Pallas ``quant_matmul`` in interpret mode and against the
port's ``quant_matmul_plain`` at atol/rtol 1e-5 (the same exact products
summed in another order), at ragged R, K and N and at the 0.6B linears'
shapes with R cut to a few dozen rows. The index maps of the kernels (the
grid, the accumulator fragments, the swizzled int8 stage and its bf16
conversion) are checked to cover every output and every weight exactly
once. The CUDA kernels
themselves are held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py), where the C plan is also held
to this mirror.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.ops.pallas import quant_matmul as jq
from qwen3_asr_rs_tpu_torch.ops import quant as tq
from qwen3_asr_rs_tpu_torch.ops.kernels import quant_matmul as qm

TOL = dict(atol=1e-5, rtol=1e-5)
KS = 16  # K rows per mma.sync / wgmma
# the 0.6B decoder's four int8 linears (merged q|k|v and gate|up), (K, N)
LINEARS = (("qkv_w", 1024, 4096), ("o_w", 2048, 1024),
           ("gateup_w", 1024, 6144), ("down_w", 3072, 1024))
LM_HEAD = (1024, 151936)


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("r", [1, 5, 8, 9, 16, 32, 33, 37, 64, 300, 432,
                               437, 3456, 4736])
@pytest.mark.parametrize("k,n", [(600, 136), (1000, 1032), *[
    kn[1:] for kn in LINEARS], LM_HEAD])
def test_plan_partitions_k_and_fills_one_round(r, k, n):
    """bf16 x: the GEMV blocks up to 32 rows, the wgmma tiles above; the
    splits cover K in whole 64-row stages, none empty; a wgmma grid of 128
    x 128 tiles splits K only where its tiles cannot fill a round of one
    block per SM, never beyond one round of two per SM, with 4 stages per
    split at least; the workspace holds every split's partials."""
    p = qm.launch_plan(r, k, n, False)
    assert p["route"] == ("gemv" if r <= 32 else "wgmma")
    kb, splits = p["kb"], p["splits"]
    assert kb % qm.TILE_K == 0 and splits == -(-k // kb)
    assert (splits - 1) * kb < k <= splits * kb
    assert p["ws_words"] == (r * n * splits if splits > 1 else 0)
    if p["route"] == "gemv":
        assert p["grid_x"] == -(-n // qm.GEMV_TN) and p["grid_y"] == splits
        return
    assert p["grid_y"] == -(-r // qm.TILE) and p["grid_x"] == -(-n // qm.TILE)
    tiles = p["grid_x"] * p["grid_y"]
    if tiles >= qm.TARGET_BLOCKS // 2:
        assert splits == 1
    else:
        assert tiles * splits <= qm.TARGET_BLOCKS
        assert splits == 1 or kb >= qm.MIN_STAGES * qm.TILE_K
    # two blocks fit on an SM (228 KB, 1 KB reserved per block)
    assert p["smem"] == qm.WGMMA_SMEM and 2 * (p["smem"] + 1024) <= 228 * 1024


def test_plan_at_the_main_path_shapes():
    """The 30 s prefill (432 rows) splits q|k|v in 2 and o and down in 8
    (256 blocks each); gate|up fills the card unsplit (192 blocks). The
    5-clip batch (3456 rows) and the 300 s prefill (4736) run unsplit. The
    lm_head's rows run the GEMV blocks, unsplit (2374 column tiles)."""
    def plans(r):
        return [(p["splits"], p["grid_x"] * p["grid_y"])
                for p in (qm.launch_plan(r, k, n, False)
                          for _, k, n in LINEARS)]

    assert plans(432) == [(2, 128), (8, 32), (1, 192), (8, 32)]
    assert plans(3456) == [(1, 864), (1, 216), (1, 1296), (1, 216)]
    assert plans(4736) == [(1, 1184), (1, 296), (1, 1776), (1, 296)]
    for r in (1, 8, 16, 32):
        p = qm.launch_plan(r, *LM_HEAD, False)
        assert (p["route"], p["splits"], p["grid_x"]) == ("gemv", 1, 2374)


def test_plan_routes_the_shapes_take():
    """float32 x takes only the CUDA cores, at any row count; bf16 x
    takes the GEMV blocks up to 32 rows and the wgmma tiles above, never
    the CUDA cores."""
    for r in (1, 8, 9, 33, 300):
        assert qm.launch_plan(r, 1000, 1032, True)["route"] == "cores"
    assert [qm.launch_plan(r, 1000, 1032, False)["route"]
            for r in (1, 8, 9, 32, 33, 300)] == ["gemv"] * 4 + ["wgmma"] * 2


def test_workspace_grows_per_stream_and_is_shared():
    """One split-K workspace per (device, stream): a call whose plan
    needs more grows it, a smaller one reuses it, another stream has its
    own."""
    dev = torch.device("cpu")
    saved = dict(qm._workspaces)
    qm._workspaces.clear()
    try:
        a = qm._workspace(dev, 1, 100)
        assert a.numel() == 100 and a.dtype == torch.float32
        assert qm._workspace(dev, 1, 40) is a
        b = qm._workspace(dev, 1, 300)
        assert b.numel() == 300 and qm._workspace(dev, 1, 100) is b
        c = qm._workspace(dev, 2, 0)
        assert c.numel() == 1 and qm._workspace(dev, 1, 0) is b
    finally:
        qm._workspaces.clear()
        qm._workspaces.update(saved)


# ------------------------------------------------------------ arithmetic

def quant_matmul_emulation(x, w_q, scales, plan, out_dtype=torch.float32):
    """K5's tensor-core routes in float32: per split of kb rows, one
    float32 sum of 16 exact products (bf16 x times int8 weights, exact in
    bf16) per instruction, added in K order; the splits in split order;
    the per-column scales on the whole sum; one rounding."""
    xf, dense = x.float(), w_q.float()
    k = xf.shape[1]
    total = None
    for lo in range(0, k, plan["kb"]):
        acc = torch.zeros((xf.shape[0], dense.shape[1]))
        for k0 in range(lo, min(k, lo + plan["kb"]), KS):
            acc = acc + xf[:, k0:k0 + KS] @ dense[k0:k0 + KS]
        total = acc if total is None else total + acc
    return (total * scales).to(out_dtype)


def _case(rng, r, k, n):
    w = 0.02 * rng.standard_normal((k, n)).astype(np.float32)
    w_q, s = tq.quantize_weight(torch.from_numpy(w))
    x = torch.from_numpy(rng.standard_normal((r, k)).astype(
        np.float32)).bfloat16()
    return x, w_q, s


@pytest.mark.parametrize("r,k,n", [(37, 600, 136), (40, 1000, 1032),
                                   (33, 1024, 4096), (48, 2048, 1024),
                                   (40, 1024, 6144), (36, 3072, 1024),
                                   (1, 600, 136), (8, 1000, 1032),
                                   (32, 1024, 4096), (17, 3072, 1024),
                                   (1, 1024, 4096), (8, 2048, 1024),
                                   (8, 1024, 6144), (1, 3072, 1024)])
def test_emulation_matches_pallas_and_plain(r, k, n):
    """The emulation with the launch's split (wgmma above 32 rows, GEMV
    blocks up to 32; ragged R, K and N, the 0.6B linears with R cut to
    a few dozen rows, and at an int8 serving step's 1 and 8 rows) against the Pallas kernel in interpret mode and the
    plain version, float32 results; rounded to bf16 it equals the plain
    bf16 output but for rare flipped roundings."""
    rng = np.random.default_rng(r * 7 + n)
    x, w_q, s = _case(rng, r, k, n)
    plan = qm.launch_plan(r, k, n, False)
    got = quant_matmul_emulation(x, w_q, s, plan)
    ref = np.asarray(jq.quant_matmul(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w_q.numpy()), jnp.asarray(s.numpy()),
        out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    plain = qm.quant_matmul_plain(x, w_q, s, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    got16 = quant_matmul_emulation(x, w_q, s, plan, torch.bfloat16)
    plain16 = qm.quant_matmul(x, w_q, s)  # CPU: the plain version
    assert plain16.dtype == torch.bfloat16
    assert (got16 != plain16).float().mean() <= 0.01
    assert torch.allclose(got16.float(), plain16.float(), atol=1e-5,
                          rtol=2 ** -7)


# ---------------------------------------------------------- index maps

def test_grid_covers_each_output_once():
    """Blocks (column tile, row tile, split) of every main-path plan write
    each (row, column) once per split; the split-K sum's threads (4
    columns each) cover each output once."""
    for r in (37, 432, 3456):
        for _, k, n in (*LINEARS, ("ragged", 600, 136)):
            p = qm.launch_plan(r, k, n, False)
            cols = qm.TILE if p["route"] == "wgmma" else qm.GEMV_TN
            count = np.zeros((p["splits"], r, n), np.int32)
            for z in range(p["splits"]):
                for y in range(p["grid_y"]):
                    for x in range(p["grid_x"]):
                        count[z, 128 * y:128 * (y + 1),
                              cols * x:cols * (x + 1)] += 1
            assert (count == 1).all()
            q = np.zeros((r, n), np.int32)
            for i in range(r * (n // 4)):
                rr, c = divmod(i, n // 4)
                q[rr, 4 * c:4 * c + 4] += 1
            assert (q == 1).all()


def test_wgmma_accumulators_cover_the_tile_once():
    """Accumulator 4 j + 2 i + c of consumer thread (warpgroup g, warp w,
    lane l) is weight column 64 g + 16 w + l / 4 + 8 i and row of x 8 j +
    2 (l % 4) + c: the wgmma m64n128 layout (row 16 w + l / 4 + 8 i of the
    warpgroup's A tile, column 8 j + 2 (l % 4) + c). Every (row, column)
    of the 128 x 128 tile once."""
    count = np.zeros((128, 128), np.int32)
    for g in range(2):
        for w in range(4):
            for lane in range(32):
                for j in range(16):
                    for i in range(2):
                        for c in range(2):
                            col = 64 * g + 16 * w + (lane >> 2) + 8 * i
                            count[8 * j + 2 * (lane & 3) + c, col] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("nb8", [1, 2, 4])
def test_gemv_accumulators_cover_the_block_once(nb8):
    """The GEMV blocks: accumulator c of batch group nb of lane l in warp
    w is row 8 nb + 2 (l % 4) + (c & 1) (gm_acc_row) and loaded column 16 w
    + 2 (l / 4) + (c >> 1) (gm_col of a byte tile): 8 NB8 rows by 64
    columns, each once."""
    count = np.zeros((8 * nb8, 64), np.int32)
    for w in range(4):
        for lane in range(32):
            for nb in range(nb8):
                for c in range(4):
                    count[8 * nb + 2 * (lane & 3) + (c & 1),
                          16 * w + 2 * (lane >> 2) + (c >> 1)] += 1
    assert (count == 1).all()


def w8_at(k, c):
    """qm_w8_at: byte offset of weight column c, K row k of an int8 stage
    (128-byte rows, 16-byte chunk c / 16 at chunk ^ (k & 7): the tensor
    map's 128-byte swizzle)."""
    return k * 128 + (((c >> 4) ^ (k & 7)) << 4) + (c & 15)


def a_at(k, m):
    """Byte offset of column m (of a warpgroup's 64) and K row k in its
    bf16 A tile: 128-byte rows, 16-byte chunk m / 8 at chunk ^ (k & 7), 2
    bytes per value (MN-major, 128-byte swizzle)."""
    return k * 128 + (((m >> 3) ^ (k & 7)) << 4) + 2 * (m & 7)


def _i8_pair(w, i, j):
    """gm_i8_pair: bf16 bits of signed bytes i (low half) and j (high)."""
    def bits(v, b):
        byte = (v >> (8 * b)) & 0xFF
        f = (np.uint32(0x4B000000) | byte).view(np.float32) - np.float32(
            8388736.0)
        return np.asarray(f, np.float32).view(np.uint32)
    x = np.uint32(w) ^ np.uint32(0x80808080)
    return (bits(x, i) >> 16) | (bits(x, j) & np.uint32(0xFFFF0000))


def test_w8_stage_converts_to_the_a_tiles():
    """An int8 stage of 64 K rows x 128 columns in the swizzled layout
    (a bijection onto its bytes) converted as qm_convert does it: thread t
    of warpgroup g takes 16 bytes of K row t / 4 (columns 64 g + 16 (t %
    4) ..) and writes them as two 16-byte bf16 chunks; every value of the
    warpgroup's A tile is its weight, exact, and each 16-byte bank group
    is read and written four times per 512 bytes a warp moves (no
    conflicts)."""
    offs = {w8_at(k, c) for k in range(64) for c in range(128)}
    assert offs == set(range(64 * 128))
    assert {a_at(k, m) for k in range(64) for m in range(64)} == set(
        range(0, 64 * 128, 2))
    rng = np.random.default_rng(9)
    wb = rng.integers(-128, 128, (64, 128)).astype(np.int8)
    stage = np.zeros(64 * 128, np.uint8)
    for k in range(64):
        for c in range(128):
            stage[w8_at(k, c)] = wb[k, c].view(np.uint8)
    for g in range(2):
        tile = np.zeros(64 * 128, np.uint8)
        for warp in range(4):
            reads, lo_writes = [], []
            for lane in range(32):
                t = 32 * warp + lane
                for i in range(t, 64 * 4, 128):
                    k, m = i >> 2, 16 * (i & 3)
                    src = w8_at(k, 64 * g + m)
                    u = stage[src:src + 16].view(np.uint32)
                    lo = [_i8_pair(u[0], 0, 1), _i8_pair(u[0], 2, 3),
                          _i8_pair(u[1], 0, 1), _i8_pair(u[1], 2, 3)]
                    hi = [_i8_pair(u[2], 0, 1), _i8_pair(u[2], 2, 3),
                          _i8_pair(u[3], 0, 1), _i8_pair(u[3], 2, 3)]
                    for half, words in ((0, lo), (1, hi)):
                        dst = k * 128 + ((((m >> 3) + half) ^ (k & 7)) << 4)
                        tile[dst:dst + 16] = np.array(
                            words, np.uint32).view(np.uint8)
                    if i < 128:
                        reads.append(src // 16 % 8)
                        lo_writes.append(k * 8 + (((m >> 3) ^ (k & 7))))
            assert np.bincount(reads, minlength=8).tolist() == [4] * 8
            assert np.bincount([w % 8 for w in lo_writes],
                               minlength=8).tolist() == [4] * 8
        vals = tile.view(np.uint16)
        for k in range(64):
            for m in range(64):
                bits = np.uint32(vals[a_at(k, m) // 2]) << 16
                assert float(bits.view(np.float32)) == float(
                    wb[k, 64 * g + m])


def test_a_tile_is_the_sw128_mn_major_layout():
    """The A tile as the wgmma descriptor reads it with the transpose bit
    (MN-major, 128-byte swizzle, one 64-column atom, 8-row groups 1024
    bytes apart, K step kk 2048 bytes on): element (m, k) of K step kk at
    a_at(16 kk + k, m), each K step inside its own 2048 bytes, swizzle
    rows aligned to 1024 bytes."""
    for kk in range(4):
        seen = set()
        for k in range(16):
            for m in range(64):
                logical = 2048 * kk + 128 * k + 2 * m  # start + 2048 kk
                row = logical >> 7
                phys = (logical & ~0x70) | ((((logical >> 4) & 7) ^ (row & 7))
                                            << 4)
                assert phys == a_at(16 * kk + k, m)
                seen.add(phys)
        assert seen == set(range(2048 * kk, 2048 * (kk + 1), 2))


def test_x_stage_is_the_sw128_k_major_layout():
    """x's stage (128 rows x 64 bf16 of K, by TMA with the 128-byte
    swizzle) as the wgmma B descriptor reads it: row n at 128 n, its
    16-byte chunk c at c ^ (n & 7), 8-row groups 1024 bytes apart (the
    stride offset), and K step kk 32 bytes on: every (row, k) of the
    stage once, each k16 step of a row within its 128-byte row."""
    seen = set()
    for n in range(128):
        for kk in range(4):
            for e in range(16):
                k = 16 * kk + e
                logical = n * 128 + 32 * kk + 2 * e  # start + 32 kk
                chunk = (logical >> 4) & 7
                phys = (logical & ~0x70) | ((chunk ^ ((logical >> 7) & 7))
                                            << 4)
                assert phys == n * 128 + (((k >> 3) ^ (n & 7)) << 4) + (
                    2 * (k & 7))
                assert phys // 128 == n
                seen.add(phys)
    assert seen == set(range(0, 128 * 128, 2))
