"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: they skip without a CUDA device. This file imports no
JAX, so it runs on a GPU machine without jax (tests/conftest.py imports
jax, hence ``--noconftest``); it shares chip_smoke.py's GEMV cases and
element check:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import pytest
import torch

import chip_smoke as smoke

from qwen3_asr_rs_tpu_torch.config import TextDecoderConfig
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_dma,
    decode_attention_dma_plain,
)
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
    decode_layers_fused,
    decode_layers_fused_plain,
)
from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_tile_reference,
)
from qwen3_asr_rs_tpu_torch.weights.convert import (
    init_decoder_params_np,
    to_torch,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_cuda_decode_attention_matches_plain(cuda, dtype, atol):
    g = torch.Generator(device=cuda).manual_seed(0)
    L, B, Hq, Hkv, S, D = 3, 2, 16, 8, 200, 128
    ks = torch.randn((L, B, Hkv, S, D), generator=g, device=cuda).to(dtype)
    vs = torch.randn_like(ks)
    q = torch.randn((B, Hq, D), generator=g, device=cuda).to(dtype)
    k_self = torch.randn((B, Hkv, D), generator=g, device=cuda).to(dtype)
    v_self = torch.randn_like(k_self)
    start = torch.tensor([0, 70], dtype=torch.int32, device=cuda)
    end = torch.tensor([133, 70], dtype=torch.int32, device=cuda)
    n = decode_attention_dma.launches
    got = decode_attention_dma(q, ks, vs, k_self, v_self, 2, start, end)
    assert decode_attention_dma.launches == n + 1
    ref = decode_attention_dma_plain(q, ks, vs, k_self, v_self, 2, start, end)
    assert (got.float() - ref.float()).abs().max() <= atol


@pytest.mark.cuda
def test_cuda_decode_layers_matches_plain(cuda):
    cfg = dataclasses.replace(TextDecoderConfig(), num_hidden_layers=2,
                              vocab_size=64)
    layers = to_torch(init_decoder_params_np(cfg), torch.float32,
                      cuda)["layers"]
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (2, 1, cfg.num_key_value_heads, 96, cfg.head_dim)
    kc = torch.randn(shape, generator=g, device=cuda)
    vc = 0.05 * torch.randn(shape, generator=g, device=cuda)
    x = 0.02 * torch.randn((1, cfg.hidden_size), generator=g, device=cuda)
    cos, sin = torch.ones((1, cfg.head_dim), device=cuda), torch.zeros(
        (1, cfg.head_dim), device=cuda)
    n, n_attn = decode_layers_fused.launches, decode_attention_dma.launches
    got = decode_layers_fused(x, cos, sin, layers, kc, vc, 3, 77, eps=1e-6)
    assert decode_layers_fused.launches == n + 1
    # the C entry counts its launches of K2's kernels: one per layer
    assert decode_attention_dma.launches == n_attn + 2
    idx = lambda v: torch.tensor([v], dtype=torch.int32, device=cuda)
    ref = decode_layers_fused_plain(x, cos, sin, layers, kc, vc, idx(3),
                                    idx(77), eps=1e-6)
    for a, b in zip(got, ref):
        assert (a - b).abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=False, kv_valid=[100])])
def test_cuda_flash_attention_matches_plain(cuda, kw):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((1, 300, 16, 128), generator=g, device=cuda)
    k = torch.randn((1, 300, 8, 128), generator=g, device=cuda)
    v = torch.randn((1, 300, 8, 128), generator=g, device=cuda)
    kv_valid = kw.get("kv_valid")
    kv_valid = None if kv_valid is None else torch.tensor(kv_valid, device=cuda)
    n = flash_attention.launches
    got = flash_attention(q, k, v, kv_valid, causal=kw["causal"])
    assert flash_attention.launches == n + 1
    ref = flash_attention_plain(q, k, v, kv_valid, causal=kw["causal"])
    assert (got - ref).abs().max() <= 1e-4


def _quant_layers(cuda, dtype, bits, merge):
    from qwen3_asr_rs_tpu_torch.weights.quantize import quantize_decoder_params

    cfg = dataclasses.replace(TextDecoderConfig(), num_hidden_layers=2,
                              vocab_size=64)
    params = to_torch(init_decoder_params_np(cfg), dtype, cuda)
    return cfg, quantize_decoder_params(params, bits=bits, merge=merge,
                                        lm_bits=8)["layers"]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,merge", [(8, True), (4, True), (8, False),
                                        (4, False)])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-5),
                                             (torch.bfloat16, 1e-2, 2 ** -4)])
def test_cuda_decode_layers_quantized_matches_plain(cuda, bits, merge, dtype,
                                                    atol, rtol):
    """K1 with int8/int4 weights, merged and per projection, real 0.6B
    widths, two layers (bf16: rounding-order flips, as in chip_smoke)."""
    cfg, layers = _quant_layers(cuda, dtype, bits, merge)
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (2, 1, cfg.num_key_value_heads, 96, cfg.head_dim)
    kc = torch.randn(shape, generator=g, device=cuda).to(dtype)
    vc = (0.05 * torch.randn(shape, generator=g, device=cuda)).to(dtype)
    x = (0.02 * torch.randn((1, cfg.hidden_size), generator=g,
                            device=cuda)).to(dtype)
    ang = 40 * torch.logspace(0, -6, cfg.head_dim // 2, device=cuda)
    cos = torch.cat([ang.cos(), ang.cos()])[None].contiguous()
    sin = torch.cat([ang.sin(), ang.sin()])[None].contiguous()
    n = decode_layers_fused.launches
    got = decode_layers_fused(x, cos, sin, layers, kc, vc, 3, 77, eps=1e-6)
    assert decode_layers_fused.launches == n + 1
    idx = lambda v: torch.tensor([v], dtype=torch.int32, device=cuda)
    ref = decode_layers_fused_plain(x, cos, sin, layers, kc, vc, idx(3),
                                    idx(77), eps=1e-6)
    for a, b in zip(got, ref):
        assert (a.float() - b.float()).abs().max() <= (
            atol + rtol * b.float().abs().max())


def _k1_case(cuda, dtype, b, s_max, end, seed, layers=2):
    """Real 0.6B widths, ``layers`` layers: float weights in ``dtype``,
    slabs of values at the scale of normed keys / values, x, cos/sin (B, D)
    at distinct positions per row."""
    cfg = dataclasses.replace(TextDecoderConfig(), num_hidden_layers=layers,
                              vocab_size=64)
    lay = to_torch(init_decoder_params_np(cfg), dtype, cuda)["layers"]
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = (layers, b, cfg.num_key_value_heads, s_max, cfg.head_dim)
    kc = torch.randn(shape, generator=g, device=cuda).to(dtype)
    vc = (0.05 * torch.randn(shape, generator=g, device=cuda)).to(dtype)
    x = (0.02 * torch.randn((b, cfg.hidden_size), generator=g,
                            device=cuda)).to(dtype)
    pos = end - 3 * torch.arange(b, device=cuda)[:, None]
    ang = pos * torch.logspace(0, -6, cfg.head_dim // 2, device=cuda)
    cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
    sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    return lay, kc, vc, x, cos, sin


def _int8(slab):
    from qwen3_asr_rs_tpu_torch.models.text_decoder import quantize_kv

    q, s = quantize_kv(slab)
    return q.contiguous(), s.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 3, 8, 32])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-5),
                                             (torch.bfloat16, 1e-2, 2 ** -4)])
def test_cuda_decode_layers_batched_matches_plain(cuda, b, dtype, atol, rtol):
    """K1 at B rows with per-row starts 0, 37, 74, ... and a shared end:
    one launch for all rows, K2 once per layer, and the four GEMVs of each
    layer on the wgmma GEMV with bf16 weights."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import gemv_wgmma

    lay, kc, vc, x, cos, sin = _k1_case(cuda, dtype, b, 200, 190, 7)
    start = (37 * torch.arange(b, device=cuda) % 150).to(torch.int32)
    n, n_attn = decode_layers_fused.launches, decode_attention_dma.launches
    n_wgmma = gemv_wgmma.launches
    got = decode_layers_fused(x, cos, sin, lay, kc, vc, start, 190, eps=1e-6)
    assert decode_layers_fused.launches == n + 1
    assert decode_attention_dma.launches == n_attn + 2
    assert gemv_wgmma.launches == n_wgmma + (
        8 if dtype == torch.bfloat16 else 0)
    end = torch.full((b,), 190, dtype=torch.int32, device=cuda)
    ref = decode_layers_fused_plain(x, cos, sin, lay, kc, vc, start, end,
                                    eps=1e-6)
    for a, r in zip(got, ref):
        assert (a.float() - r.float()).abs().max() <= (
            atol + rtol * r.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 32])
@pytest.mark.parametrize("bits,merge", [(8, True), (4, True), (4, False)])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-5),
                                             (torch.bfloat16, 1e-2, 2 ** -4)])
def test_cuda_decode_layers_batched_quantized_matches_plain(cuda, b, bits,
                                                            merge, dtype,
                                                            atol, rtol):
    """K1 at B rows with int8/int4 weights (row groups of 2 to 8 rows by
    the accumulators of the weight kind and layout) and per-row starts."""
    _, kc, vc, x, cos, sin = _k1_case(cuda, dtype, b, 200, 190, 11)
    lay = _quant_layers(cuda, dtype, bits, merge)[1]
    start = (41 * torch.arange(b, device=cuda) % 150).to(torch.int32)
    end = torch.full((b,), 190, dtype=torch.int32, device=cuda)
    n = decode_layers_fused.launches
    got = decode_layers_fused(x, cos, sin, lay, kc, vc, start, end, eps=1e-6)
    assert decode_layers_fused.launches == n + 1
    ref = decode_layers_fused_plain(x, cos, sin, lay, kc, vc, start, end,
                                    eps=1e-6)
    for a, r in zip(got, ref):
        assert (a.float() - r.float()).abs().max() <= (
            atol + rtol * r.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-5),
                                             (torch.bfloat16, 1e-2, 2 ** -4)])
def test_cuda_decode_layers_int8_kv_matches_plain(cuda, b, dtype, atol, rtol):
    """K1 on an int8 slab with per-slot scales (and int8 merged weights
    at B = 8)."""
    lay, kc, vc, x, cos, sin = _k1_case(cuda, dtype, b, 360, 301, 8)
    if b == 8:
        lay = _quant_layers(cuda, dtype, 8, True)[1]
    (kq, ks), (vq, vs) = _int8(kc), _int8(vc)
    start = (29 * torch.arange(b, device=cuda)).to(torch.int32)
    end = torch.full((b,), 301, dtype=torch.int32, device=cuda)
    n = decode_layers_fused.launches
    got = decode_layers_fused(x, cos, sin, lay, kq, vq, start, end, eps=1e-6,
                              k_scales=ks, v_scales=vs)
    assert decode_layers_fused.launches == n + 1
    ref = decode_layers_fused_plain(x, cos, sin, lay, kq, vq, start, end,
                                    eps=1e-6, k_scales=ks, v_scales=vs)
    for a, r in zip(got, ref):
        assert (a.float() - r.float()).abs().max() <= (
            atol + rtol * r.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_cuda_decode_attention_long_slab_matches_plain(cuda, dtype, atol, D,
                                                       int8):
    """K2 on a 4992-slot slab of int8 with per-slot scales or of the
    compute dtype, at D = 64 and 128 (one load of 2 to 16 bytes per lane
    and slot). Dead slots (past each row's end) have value and scale 0,
    as in a fresh slab."""
    g = torch.Generator(device=cuda).manual_seed(9)
    L, B, Hq, Hkv, S = 3, 3, 16, 8, 4992
    kc, vc = (torch.randn((L, B, Hkv, S, D), generator=g, device=cuda)
              for _ in range(2))
    if int8:
        (kc, ks), (vc, vs) = _int8(kc), _int8(vc)
        scales = dict(k_scales=ks, v_scales=vs)
    else:
        kc, vc, scales = kc.to(dtype), vc.to(dtype), {}
    end = torch.tensor([4737, 1, 3000], dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 0, 129], dtype=torch.int32, device=cuda)
    for b, e in enumerate(end.tolist()):
        for t in (kc, vc, *scales.values()):
            t[:, b, :, e:] = 0
    q = torch.randn((B, Hq, D), generator=g, device=cuda).to(dtype)
    k_self = torch.randn((B, Hkv, D), generator=g, device=cuda).to(dtype)
    v_self = torch.randn_like(k_self)
    n = decode_attention_dma.launches
    got = decode_attention_dma(q, kc, vc, k_self, v_self, 2, start, end,
                               **scales)
    assert decode_attention_dma.launches == n + 1
    ref = decode_attention_dma_plain(q, kc, vc, k_self, v_self, 2, start,
                                     end, **scales)
    assert torch.isfinite(got).all()
    assert (got.float() - ref.float()).abs().max() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_flash_attention_per_row_kv_start(cuda, dtype, atol):
    """K3 at B = 2 with a per-row kv_start (right-aligned prefill); rows
    before a row's start have no key and are not compared."""
    g = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randn((2, 300, 16, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, 300, 8, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, 300, 8, 128), generator=g, device=cuda).to(dtype)
    kv_start = torch.tensor([0, 117], dtype=torch.int32, device=cuda)
    n = flash_attention.launches
    got = flash_attention(q, k, v, None, kv_start, causal=True)
    assert flash_attention.launches == n + 1
    ref = flash_attention_plain(q, k, v, None, kv_start, causal=True)
    for b, s0 in enumerate(kv_start.tolist()):
        assert (got[b, s0:].float() - ref[b, s0:].float()).abs().max() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5, 16, 32, 64, 300, 437])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
def test_cuda_quant_matmul_matches_plain(cuda, rows, dtype, out_dtype):
    """K5: bf16 x on the tensor-core GEMV blocks (up to 32 rows) and the
    wgmma tiles (above, K split), float32 x on the CUDA cores; K = 1000
    not a multiple of the 64-row stage, N = 1032 not a multiple of the
    tiles nor of 16 (the weight's rows are 8-byte aligned: 8-byte copies).
    bf16 x is also held element by element against the float64 product
    with the output's one rounding (chip_smoke's ELEMENT_TOL)."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_plain)
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator(device=cuda).manual_seed(4)
    w_q, s = quantize_weight(0.02 * torch.randn((1000, 1032), generator=g,
                                                device=cuda))
    x = torch.randn((rows, 1000), generator=g, device=cuda).to(dtype)
    n = quant_matmul.launches
    got = quant_matmul(x, w_q, s, out_dtype=out_dtype)
    assert quant_matmul.launches == n + 1 and got.dtype == out_dtype
    ref = quant_matmul_plain(x, w_q, s, out_dtype=out_dtype).float()
    bound = 1e-4 + (2 ** -7 if out_dtype == torch.bfloat16 else 1e-5) * (
        ref.abs().max())
    assert (got.float() - ref).abs().max() <= bound
    if dtype == torch.bfloat16:
        dt = "bfloat16" + ("" if out_dtype == dtype else "->float32")
        atol, rtol = smoke.ELEMENT_TOL[("quant_matmul", dt)]
        excess = smoke.element_excess(torch, got, smoke.k5_reference(
            x, w_q, s), rtol)
        assert excess <= atol, excess
    # the workspace is reused: a second call is identical
    assert torch.equal(quant_matmul(x, w_q, s, out_dtype=out_dtype), got)


@pytest.mark.cuda
def test_cuda_quant_matmul_plan_mirror(cuda):
    """The C launch plan (qm_plan) equals the Python mirror
    (launch_plan): routes, tiles, splits, workspace and shared memory,
    for ragged shapes, the 0.6B linears and the lm_head."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import quant_matmul as qm

    for r in (1, 5, 8, 9, 16, 32, 33, 37, 437, 3456, 4736):
        for k, n in ((600, 136), (1000, 1032), (1024, 4096), (2048, 1024),
                     (1024, 6144), (3072, 1024), (1024, 151936)):
            for f32 in (False, True):
                assert (qm.kernel_plan(r, k, n, f32)
                        == qm.launch_plan(r, k, n, f32)), (r, k, n, f32)


@pytest.mark.cuda
def test_cuda_quant_matmul_shares_one_workspace(cuda):
    """K5's split-K calls on one stream share one workspace: a larger
    split plan grows it, and a smaller one after it (in the grown buffer)
    gives the same output as before."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import quant_matmul as qm
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight

    outs = {}
    for rows, k, n in ((37, 2048, 1024), (432, 3072, 1024), (37, 2048, 1024)):
        assert qm.launch_plan(rows, k, n, False)["splits"] > 1
        w_q, s = quantize_weight(0.02 * torch.randn(
            (k, n), generator=torch.Generator(device=cuda).manual_seed(k),
            device=cuda))
        x = torch.randn((rows, k), generator=torch.Generator(
            device=cuda).manual_seed(rows), device=cuda).bfloat16()
        got = qm.quant_matmul(x, w_q, s)
        if rows in outs:
            assert torch.equal(got, outs[rows])
        outs[rows] = got
        ref = qm.quant_matmul_plain(x, w_q, s).float()
        assert (got.float() - ref).abs().max() <= 1e-4 + 2 ** -7 * (
            ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 8, 32, 64, 65, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quant_matvec_int4_matches_plain(cuda, rows, dtype):
    """K4 at N = 9000 (two 8192 tiles, padded); every row count launches
    the kernel: up to 32 rows from one read of the weight, above that 32
    at a time over a resident K range."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matvec_int4 import (
        quant_matvec_int4, quant_matvec_int4_plain)
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight_int4_tiled

    g = torch.Generator(device=cuda).manual_seed(5)
    w_q4, s = quantize_weight_int4_tiled(
        0.02 * torch.randn((256, 9000), generator=g, device=cuda))
    x = torch.randn((rows, 256), generator=g, device=cuda).to(dtype)
    n = quant_matvec_int4.launches
    got = quant_matvec_int4(x, w_q4, s)
    assert quant_matvec_int4.launches == n + 1 and got.shape == (rows, 9000)
    ref = quant_matvec_int4_plain(x, w_q4, s)
    assert (got - ref).abs().max() <= 1e-4 + 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_cuda_bf16_mm_keeps_float32(cuda):
    """The bf16 lm_head product returns float32 sums (aten::mm.dtype)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn((2, 1024), generator=g, device=cuda).bfloat16()
    b = torch.randn((1024, 4096), generator=g, device=cuda).bfloat16()
    y = torch.mm(a, b, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    assert (y.bfloat16().float() != y).float().mean() > 0.9
    assert (y - a.float() @ b.float()).abs().max() <= 1e-3


def _int4g_layers(cuda, dtype, group, hidden=None):
    """Merged int4g layers, two layers at the 0.6B widths (or the 1.7B
    ones: hidden 2048, intermediate 6144)."""
    from qwen3_asr_rs_tpu_torch.weights.quantize import quantize_decoder_params

    cfg = dataclasses.replace(TextDecoderConfig(), num_hidden_layers=2,
                              vocab_size=64)
    if hidden:
        cfg = dataclasses.replace(cfg, hidden_size=hidden,
                                  intermediate_size=3 * hidden)
    params = to_torch(init_decoder_params_np(cfg), dtype, cuda)
    return cfg, quantize_decoder_params(params, bits=4, group_size=group,
                                        lm_bits=8)["layers"]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [32, 64, 128, 256])
@pytest.mark.parametrize("b,hidden,int8_slab", [(1, None, False),
                                                (8, None, True),
                                                (32, None, False),
                                                (3, 2048, False)])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-5),
                                             (torch.bfloat16, 1e-2, 2 ** -4)])
def test_cuda_decode_layers_int4g_matches_plain(cuda, group, b, hidden,
                                                int8_slab, dtype, atol, rtol):
    """K1 with merged int4g weights at every group size the kernel takes
    (below 128 the scales apply per 32-row stripe, from 128 on per K
    block), 0.6B and 1.7B widths, B up to 32, float and int8 slabs."""
    cfg, lay = _int4g_layers(cuda, dtype, group, hidden)
    g = torch.Generator(device=cuda).manual_seed(12)
    shape = (2, b, cfg.num_key_value_heads, 200, cfg.head_dim)
    kc = torch.randn(shape, generator=g, device=cuda).to(dtype)
    vc = (0.05 * torch.randn(shape, generator=g, device=cuda)).to(dtype)
    scales = {}
    if int8_slab:
        (kc, ks), (vc, vs) = _int8(kc), _int8(vc)
        scales = dict(k_scales=ks, v_scales=vs)
    x = (0.02 * torch.randn((b, cfg.hidden_size), generator=g,
                            device=cuda)).to(dtype)
    ang = 40 * torch.logspace(0, -6, cfg.head_dim // 2, device=cuda)
    cos = torch.cat([ang.cos(), ang.cos()])[None].expand(b, -1).contiguous()
    sin = torch.cat([ang.sin(), ang.sin()])[None].expand(b, -1).contiguous()
    start = (13 * torch.arange(b, device=cuda) % 150).to(torch.int32)
    end = torch.full((b,), 190, dtype=torch.int32, device=cuda)
    n = decode_layers_fused.launches
    got = decode_layers_fused(x, cos, sin, lay, kc, vc, start, end, eps=1e-6,
                              **scales)
    assert decode_layers_fused.launches == n + 1
    ref = decode_layers_fused_plain(x, cos, sin, lay, kc, vc, start, end,
                                    eps=1e-6, **scales)
    for a, r in zip(got, ref):
        assert (a.float() - r.float()).abs().max() <= (
            atol + rtol * r.float().abs().max())


@pytest.mark.cuda
def test_cuda_decode_layers_int4g_refuses_other_group_sizes(cuda):
    cfg, lay = _int4g_layers(cuda, torch.bfloat16, 16)
    x = torch.zeros((1, cfg.hidden_size), dtype=torch.bfloat16, device=cuda)
    cs = torch.zeros((1, cfg.head_dim), device=cuda)
    kc = torch.zeros((2, 1, cfg.num_key_value_heads, 8, cfg.head_dim),
                     dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="group size 16"):
        decode_layers_fused(x, cs, cs, lay, kc, kc, None, 4, eps=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 11])
@pytest.mark.parametrize("lm", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_layers_fold_matches_plain(cuda, b, lm, dtype):
    """K1 with the folded lm_head over the full 151,936-column vocabulary:
    each kernel token's logit, recomputed by the plain version, lies
    within float32 summation-order noise (1e-4 of the largest logit) of
    the plain maximum; ties go to the lowest index (an lm_head of equal
    rows gives token 0)."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import _rms
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight

    lay, kc, vc, x, cos, sin = _k1_case(cuda, dtype, b, 200, 190, 13)
    g = torch.Generator(device=cuda).manual_seed(14)
    lm_head = (0.02 * torch.randn((151936, 1024), generator=g,
                                  device=cuda)).to(dtype)
    final_ln = torch.ones(1024, dtype=dtype, device=cuda)
    if lm == "int8":
        lm_w, lm_s = quantize_weight(lm_head.float().T)
    else:
        lm_w, lm_s = lm_head, None
    start = (7 * torch.arange(b, device=cuda)).to(torch.int32)
    end = torch.full((b,), 190, dtype=torch.int32, device=cuda)
    kw = dict(eps=1e-6, fold_lm=True, final_ln_w=final_ln, lm_head=lm_w,
              lm_scales=lm_s)
    n = decode_layers_fused.launches
    tok, ks, vs = decode_layers_fused(x, cos, sin, lay, kc, vc, start, end,
                                      **kw)
    assert decode_layers_fused.launches == n + 1
    assert tok.dtype == torch.int32 and tok.shape == (b,)
    h, ks_ref, _ = decode_layers_fused_plain(x, cos, sin, lay, kc, vc, start,
                                             end, eps=1e-6)
    xn = _rms(h, final_ln, 1e-6).to(dtype).float()
    logits = (xn @ lm_w.float() * lm_s if lm == "int8"
              else xn @ lm_w.float().T)
    best = logits.max(-1).values
    picked = logits.gather(1, tok.long()[:, None])[:, 0]
    assert ((best - picked) <= 1e-4 * best.abs().max()).all()
    assert (ks.float() - ks_ref.float()).abs().max() <= 1e-2 + 2 ** -4 * (
        ks_ref.float().abs().max())
    # equal rows (int8: equal columns): every logit ties, token 0
    same = lm_head[:1].expand(151936, -1).contiguous()
    tie_w = quantize_weight(same.float().T)[0] if lm == "int8" else same
    tie_s = None if lm_s is None else torch.ones_like(lm_s)
    tok, _, _ = decode_layers_fused(x, cos, sin, lay, kc, vc, start, end,
                                    **dict(kw, lm_head=tie_w,
                                           lm_scales=tie_s))
    assert tok.tolist() == [0] * b


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,d,starts,ends", [
    (1, 584, 16, 8, 128, None, [450]),
    (2, 304, 16, 8, 128, [0, 37], [296, 120]),
    (1, 64, 4, 2, 64, None, [64]),
    (3, 136, 8, 4, 128, [5, 0, 60], [100, 136, 61]),
    (1, 4992, 16, 8, 128, None, [4737]),
])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_cuda_decode_attention_slab_matches_plain(cuda, b, s, hq, hkv, d,
                                                  starts, ends, dtype, atol):
    """K6, ``decode_attention_slab`` at a layer of a 3-layer slab and the
    single-layer ``decode_attention``, each counting its own launches."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_attention as da

    g = torch.Generator(device=cuda).manual_seed(15)
    k3, v3 = (torch.randn((3, b, hkv, s, d), generator=g,
                          device=cuda).to(dtype) for _ in range(2))
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dtype)
    k_self, v_self = (torch.randn((b, hkv, d), generator=g,
                                  device=cuda).to(dtype) for _ in range(2))
    start = None if starts is None else torch.tensor(
        starts, dtype=torch.int32, device=cuda)
    end = torch.tensor(ends, dtype=torch.int32, device=cuda)
    n_slab, n_one, n_dma = (da.decode_attention_slab.launches,
                            da.decode_attention.launches,
                            da.decode_attention_dma.launches)
    got = da.decode_attention_slab(q, k3, v3, k_self, v_self, 1, start, end)
    one = da.decode_attention(q, k3[2], v3[2], k_self, v_self, start, end)
    assert (da.decode_attention_slab.launches, da.decode_attention.launches,
            da.decode_attention_dma.launches) == (n_slab + 1, n_one + 1, n_dma)
    ref = da.decode_attention_slab_plain(q, k3, v3, k_self, v_self, 1, start,
                                         end)
    ref_one = da.decode_attention_plain(q, k3[2], v3[2], k_self, v_self,
                                        start, end)
    assert (got.float() - ref.float()).abs().max() <= atol
    assert (one.float() - ref_one.float()).abs().max() <= atol


def _bf16_bound(ref, atol=2e-2, rtol=2 ** -7):
    """chip_smoke's bf16 tolerance for K2 and K3: atol + rtol * max|ref|."""
    return atol + rtol * ref.float().abs().max()


def _assert_elementwise(got, ref, atol, rtol=2 ** -8):
    """chip_smoke's ELEMENT_TOL: |got - ref| <= atol + rtol * |ref| at
    every element, ref the float32 reference with the kernel's roundings
    up to its bf16 output."""
    excess = ((got.float() - ref).abs() - rtol * ref.abs()).max()
    assert excess <= atol, f"|err| - {rtol} |ref| reaches {float(excess)}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,d,kw", [
    (1, 300, 16, 8, 128, dict(causal=True)),
    (1, 4736, 16, 8, 128, dict(causal=True)),
    (2, 1000, 16, 8, 64, dict(causal=True, kv_start=[0, 333])),
    (2, 777, 16, 8, 128, dict(causal=False, kv_valid=[700, 129])),
    (1, 517, 4, 4, 128, dict(causal=True)),
    (3, 200, 8, 1, 64, dict(causal=False, kv_valid=[200, 1, 64])),
])
def test_cuda_flash_attention_bf16_tensor_cores(cuda, b, s, hq, hkv, d, kw):
    """K3's bf16 tensor-core path: causal at the 300 s bucket's 4736
    tokens and at 300, D = 64 with per-row kv_start, non-causal kv_valid,
    lengths that are no multiple of a tile, one query head per kv head
    (a block of 128 rows of one head) and eight (pairs of heads)."""
    g = torch.Generator(device=cuda).manual_seed(16)
    q = torch.randn((b, s, hq, d), generator=g, device=cuda).bfloat16()
    k = torch.randn((b, s, hkv, d), generator=g, device=cuda).bfloat16()
    v = torch.randn((b, s, hkv, d), generator=g, device=cuda).bfloat16()
    idx = {n: torch.tensor(kw[n], dtype=torch.int32, device=cuda)
           for n in ("kv_valid", "kv_start") if n in kw}
    n = flash_attention.launches
    got = flash_attention(q, k, v, idx.get("kv_valid"), idx.get("kv_start"),
                          causal=kw["causal"])
    assert flash_attention.launches == n + 1
    ref = flash_attention_plain(q, k, v, idx.get("kv_valid"),
                                idx.get("kv_start"), causal=kw["causal"])
    tiles = flash_attention_tile_reference(
        q, k, v, idx.get("kv_valid"), idx.get("kv_start"),
        causal=kw["causal"])
    assert torch.isfinite(got.float()).all()
    for i in range(b):
        # rows with no attendable key are discarded by callers
        s0 = kw.get("kv_start", [0] * b)[i] if kw["causal"] else 0
        if kw.get("kv_valid", [1] * b)[i] < 1:
            continue
        assert (got[i, s0:].float() - ref[i, s0:].float()).abs().max() <= (
            _bf16_bound(ref[i, s0:]))
        _assert_elementwise(got[i, s0:], tiles[i, s0:], 2e-3)


def _decoder_on_card(cfg, cuda, seed):
    """bf16 decoder weights at ``cfg``'s widths drawn on the card: the
    leaves of ``init_decoder_params_np`` (norm gains 1, the rest
    N(0, 0.02^2)), which the host would take minutes to draw at the 1.7B."""
    import numpy as np

    tmpl = init_decoder_params_np(dataclasses.replace(
        cfg, num_hidden_layers=1, vocab_size=1))
    g = torch.Generator(device=cuda).manual_seed(seed)

    def leaf(a, shape):
        if np.all(a == 1):
            return torch.ones(shape, dtype=torch.bfloat16, device=cuda)
        return (0.02 * torch.randn(shape, generator=g, device=cuda)).bfloat16()

    vh = (cfg.vocab_size, cfg.hidden_size)
    return {"embed": leaf(tmpl["embed"], vh),
            "layers": {n: leaf(a, (cfg.num_hidden_layers,) + a.shape[1:])
                       for n, a in tmpl["layers"].items()},
            "final_ln_w": leaf(tmpl["final_ln_w"], tmpl["final_ln_w"].shape),
            "lm_head": leaf(tmpl["lm_head"], vh)}


def _batched_prefill_runs(cuda, monkeypatch, b=32, p=432, seed=26):
    """``prefill_aligned`` at the offline cell's shape (``b`` right-aligned
    prompts of several lengths in a ``p``-slot bucket, the 1.7B's widths,
    random weights) three times under the tracer: bf16 by the auto
    dispatch, bf16 with ASR_ATTN_IMPL=dense, and float32 (weights and
    embeddings upcast) with ASR_ATTN_IMPL=dense. Returns ({run: (float32
    logits at slot P - 1, K3 launches, tracer counters)}, the auto run's
    [(q, k, v, keywords, output)] per layer, the live-slot mask (B, P))."""
    from qwen3_asr_rs_tpu_torch.config import synthetic_17b_config
    from qwen3_asr_rs_tpu_torch.models import text_decoder as td
    from qwen3_asr_rs_tpu_torch.utils import tracing

    cfg = synthetic_17b_config().text
    params = _decoder_on_card(cfg, cuda, seed)
    dec = td.TextDecoder(cfg, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    hidden = dec.embed(params, torch.randint(
        cfg.vocab_size, (b, p), generator=g, device=cuda))
    lens = [(40, 97, 160, 213, 300, 372, 431, 432)[i % 8] for i in range(b)]
    kv_start = torch.tensor([p - n for n in lens], dtype=torch.int32,
                            device=cuda)
    live = torch.arange(p, device=cuda)[None, :] >= kv_start[:, None].long()
    attend, calls = td.attention, []

    def recorded(q, k, v, **kw):
        out = attend(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    monkeypatch.setattr(td, "attention", recorded)
    monkeypatch.setattr(tracing, "_enabled", True)
    runs, per_layer = {}, None
    for label, impl, dtype in (("auto", "auto", torch.bfloat16),
                               ("dense", "dense", torch.bfloat16),
                               ("float32", "dense", torch.float32)):
        monkeypatch.setenv("ASR_ATTN_IMPL", impl)
        monkeypatch.setattr(tracing, "GLOBAL_TIMINGS", tracing.Timings())
        cache = td.KVCache.zeros(cfg, b, p, dtype, cuda)
        w = params if dtype == torch.bfloat16 else smoke.cast_tree(params,
                                                                     dtype)
        n = flash_attention.launches
        with torch.no_grad():
            logits, _ = dec.prefill_aligned(w, hidden.to(dtype), kv_start,
                                            cache)
        torch.cuda.synchronize()
        runs[label] = (logits, flash_attention.launches - n,
                       dict(tracing.GLOBAL_TIMINGS.counters))
        if label == "auto":
            per_layer = list(calls)
        calls.clear()
        del w, cache
    return runs, per_layer, live


def _live_gap(got, ref, live):
    """Per row: max |got - ref| over the live query slots minus
    ``_bf16_bound`` of ref's live slots (positive where a row breaks
    it)."""
    m = live[:, :, None, None]
    err = ((got.float() - ref.float()).abs() * m).amax((1, 2, 3))
    return err - (2e-2 + 2 ** -7 * (ref.float().abs() * m).amax((1, 2, 3)))


@pytest.mark.cuda
def test_cuda_batched_prefill_attends_through_k3(cuda, monkeypatch):
    """The offline cell's batched prefill (``_batched_prefill_runs``): the
    auto dispatch takes K3 in each of the 28 layers and
    ASR_ATTN_IMPL=dense takes none, and under the tracer each run's
    counter reads its 28 calls. In every layer K3's output on the live
    slots is within the bf16 bound of the K3 tests of the plain dense
    attention of the same q, k and v. Through 28 layers both bf16 runs
    drift from the float32 run by more than one kernel's bound at random
    weights (each layer's bf16 roundings compound), so the logits at
    slot P - 1 are held to that run: K3's run lies no further from it
    than 1.5 times the dense run's distance, its root-mean-square
    distance no more than 1.15 times the dense run's, and it lies within
    0.25 of the dense run (on an H100, seeds 26, 126 and 226: 0.987, 0.984
    and 0.993 of the dense run's RMS distance, 0.175, 0.170 and 0.220 from
    the dense run), so that a small error adding up over the layers
    fails. (The greedy
    first tokens of the bf16 runs are not compared: among 151,936 random
    logits a row's top two lie closer than that drift often enough that
    the two dense runs, bf16 and float32, disagree on some rows
    themselves.)"""
    runs, per_layer, live = _batched_prefill_runs(cuda, monkeypatch)
    layers = len(per_layer)
    (auto, k3, c_auto), (dense, k3_dense, c_dense), (f32, _, c_f32) = (
        runs["auto"], runs["dense"], runs["float32"])
    assert layers == 28 and (k3, k3_dense) == (layers, 0)
    assert c_auto == {"attention.flash": layers}
    assert c_dense == c_f32 == {"attention.dense": layers}
    assert all(t.dtype == torch.float32 for t in (auto, dense, f32))
    for i, (q, k, v, kw, out) in enumerate(per_layer):
        ref = flash_attention_plain(q, k, v, kw.get("kv_valid"),
                                    kw.get("kv_start"), causal=kw["causal"])
        gap = _live_gap(out, ref, live)
        assert gap.max() <= 0, f"layer {i}: rows {gap.tolist()}"
    e_auto, e_dense = ((x - f32).abs().max() for x in (auto, dense))
    assert e_auto <= 1.5 * e_dense, (float(e_auto), float(e_dense))
    r_auto, r_dense = ((x - f32).pow(2).mean().sqrt() for x in (auto, dense))
    assert r_auto <= 1.15 * r_dense, (float(r_auto), float(r_dense))
    assert (auto - dense).abs().max() <= 0.25


def _k2_case(cuda, seed, b, s, hq, hkv, d, starts, ends, dtype, int8):
    g = torch.Generator(device=cuda).manual_seed(seed)
    L = 2
    kc, vc = (torch.randn((L, b, hkv, s, d), generator=g, device=cuda)
              for _ in range(2))
    scales = {}
    if int8:
        (kc, ks), (vc, vs) = _int8(kc), _int8(vc)
        scales = dict(k_scales=ks, v_scales=vs)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dtype)
    k_self = torch.randn((b, hkv, d), generator=g, device=cuda).to(dtype)
    v_self = torch.randn_like(k_self)
    start = torch.tensor(starts, dtype=torch.int32, device=cuda)
    end = torch.tensor(ends, dtype=torch.int32, device=cuda)
    return (q, kc, vc, k_self, v_self, 1, start, end), scales


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,s,hq,hkv,d,starts,ends", [
    (8, 4992, 16, 8, 128, [0, 37, 129, 200, 5, 77, 150, 263], [4737] * 8),
    (2, 4992, 16, 2, 128, [0, 4000], [4737, 4000]),
    (3, 1000, 16, 2, 64, [0, 0, 900], [65, 999, 900]),
    (4, 360, 8, 8, 128, [0, 64, 100, 301], [301, 128, 101, 301]),
])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, None)])
def test_cuda_decode_attention_one_launch_matches_plain(cuda, int8, b, s, hq,
                                                        hkv, d, starts, ends,
                                                        dtype, atol):
    """K2 through its own entry: B = 8 at the 300 s bucket's slab, G = 8
    (Hq 16 over 2 kv heads), rows with start == end (only the self key),
    live ranges that end inside a split chunk and inside a 64-slot tile,
    bf16/f32 and int8 slabs."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_attention as da

    args, scales = _k2_case(cuda, 17, b, s, hq, hkv, d, starts, ends, dtype,
                            int8)
    blocks = da._lib().decode_attention_target_blocks()
    assert any(e % da.split_chunk(b, hkv, s, blocks) for e in ends)
    n = decode_attention_dma.launches
    got = decode_attention_dma(*args, **scales)
    assert decode_attention_dma.launches == n + 1
    ref = decode_attention_dma_plain(*args, **scales)
    assert torch.isfinite(got.float()).all()
    bound = _bf16_bound(ref) if atol is None else atol
    assert (got.float() - ref.float()).abs().max() <= bound
    if atol is None:  # bf16: the plain version from float32 queries
        ref32 = decode_attention_dma_plain(args[0].float(), *args[1:],
                                           **scales)
        _assert_elementwise(got, ref32, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_attention_fold_counters_return_to_zero(cuda, dtype):
    """The last block of each (kv head, example) leaves its fold counter
    at zero: back-to-back launches on one workspace give identical
    results, and python-int start/end (passed by value) give the same as
    index tensors."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_attention as da

    args, _ = _k2_case(cuda, 18, 4, 4992, 16, 8, 128, [7] * 4, [4000] * 4,
                       dtype, False)
    first = decode_attention_dma(*args)
    for _ in range(3):
        assert torch.equal(decode_attention_dma(*args), first)
    assert torch.equal(decode_attention_dma(*args[:6], 7, 4000), first)
    ws = [w for key, w in da._workspaces.items() if key[2:] == (4, 16, 8,
                                                                4992, 128)]
    n_part = 4 * 16 * da.num_splits(4, 8, 4992,
                                    da._lib().decode_attention_target_blocks())
    assert ws and all(int(w[n_part * 130:].view(torch.int32).abs().sum()) == 0
                      for w in ws)


@pytest.mark.cuda
def test_cuda_decode_attention_split_rule_mirror(cuda):
    """The Python mirror of the split rule and of the workspace size
    agrees with the C entries (which K2, K6 and K1 share)."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_attention as da

    lib = da._lib()
    blocks = lib.decode_attention_target_blocks()
    for b in (1, 2, 3, 8, 32, 33):
        for hkv in (1, 2, 8):
            for s in (1, 63, 64, 65, 360, 4992, 20000):
                assert lib.decode_attention_chunk(b, hkv, s) == (
                    da.split_chunk(b, hkv, s, blocks))
                assert lib.decode_attention_workspace(b, 16, hkv, s, 128) == (
                    da.workspace_words(b, 16, hkv, s, 128, blocks))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", smoke.GEMV_ROWS)
@pytest.mark.parametrize("kind,epilogue,nibbles", smoke.GEMV_CASES)
def test_cuda_gemv_single_elementwise(cuda, kind, epilogue, nibbles, rows):
    """The bf16 tensor-core GEMV, every weight kind and epilogue, held
    element by element against the float32 reference with its roundings
    (chip_smoke's ELEMENT_TOL): tight enough that a dropped K split or a
    skipped group scale fails (scripts/gemv_check_strength.py)."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl

    g = torch.Generator(device=cuda).manual_seed(19)
    x, w, s, kw = smoke.gemv_single_inputs(torch, g, kind, epilogue, nibbles,
                                           rows)
    n = dl.gemv_single.launches
    got = dl.gemv_single(x, w, s, **kw)
    assert dl.gemv_single.launches == n + 1
    ref, slack = dl.gemv_single_reference(x, w, s, **kw)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    excess = smoke.gemv_excess(torch, got, ref, slack)
    assert excess <= smoke.ELEMENT_TOL["gemv_single"][0], excess
    # the split-K counters return to zero: a second launch is identical
    assert torch.equal(dl.gemv_single(x, w, s, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", smoke.GEMV_ROWS)
@pytest.mark.parametrize("kind,epilogue,nibbles", smoke.GEMV_CASES)
def test_cuda_gemv_single_sums_of_squares(cuda, kind, epilogue, nibbles,
                                          rows):
    """The decode step's way: a normed GEMV takes each row's sum of
    squares in parts (the element check holds as with its own sums); a
    residual GEMV leaves the parts of its output, one per column tile,
    equal to the sums of the squares of what it wrote."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl

    g = torch.Generator(device=cuda).manual_seed(20)
    x, w, s, kw = smoke.gemv_single_inputs(torch, g, kind, epilogue, nibbles,
                                           rows)
    got = dl.gemv_single(x, w, s, ssq=True, **kw)
    if epilogue == "residual":
        got, parts = got
        torch.testing.assert_close(parts, dl.ssq_parts(
            got, dl.GEMV_TN, kind.startswith("int4")), rtol=1e-5, atol=1e-6)
    ref, slack = dl.gemv_single_reference(x, w, s, **kw)
    excess = smoke.gemv_excess(torch, got, ref, slack)
    assert excess <= smoke.ELEMENT_TOL["gemv_single"][0], excess


@pytest.mark.cuda
def test_cuda_gemv_split_rule_mirror(cuda):
    """The Python mirror of the tensor-core GEMVs' K split agrees with the
    C rule (gemv_split_rows), and K4's launch plan uses it up to 32
    rows."""
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl
    from qwen3_asr_rs_tpu_torch.ops.kernels import quant_matvec_int4 as q4

    lib = dl._lib()
    for k in (64, 1000, 1024, 2048, 3072, 6144):
        for tiles in (1, 16, 48, 64, 1216, 2374):
            for rows in (1, 8, 17, 32):
                for nacc, wbytes in ((1, 2), (1, 1), (2, 1), (4, 2), (2, 2)):
                    for granule in (64, 128, 256):
                        for nb8 in (1, 2, 4, 12):
                            args = (k, tiles, rows, nacc, wbytes, granule,
                                    nb8)
                            assert lib.gemv_split_rows(*args) == (
                                dl.gemv_split_rows(*args)), args
    for r in (1, 3, 8, 9, 32):
        for f32 in (False, True):
            for k, half in ((1024, 77824), (1024, 8192), (256, 8192)):
                plan = q4.launch_plan(r, k, half, f32)
                nb8 = -(-r // 8) * (3 if f32 else 1)
                assert plan["kb"] == dl.gemv_split_rows(
                    k, half // dl.GEMV_TN, r, 2, 1, dl.GEMV_KS, nb8)
                assert plan["splits"] == -(-k // plan["kb"])
                assert not plan["resident"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", smoke.GEMV_ROWS)
@pytest.mark.parametrize("label,k,cols,epilogue", smoke.WGMMA_SHAPES)
def test_cuda_gemv_wgmma_elementwise(cuda, label, k, cols, epilogue, rows):
    """The wgmma GEMV (forced at every row count) at the 1.7B and 0.6B
    shapes, every epilogue (q|k|v as three segments), held element by
    element against the float32 reference with its roundings
    (ELEMENT_TOL), with the step's sums of squares in parts (the residual
    leaves its parts, one per 64-column tile) and, normed, with its own;
    two launches give the same bits and the counter counts both."""
    g = torch.Generator(device=cuda).manual_seed(29)
    x, w, kw = smoke.gemv_wgmma_inputs(torch, g, k, cols, epilogue, rows)
    for ssq in (True, False) if "norm_w" in kw else (True,):
        _, excess, parts_err, same, counted = smoke.gemv_wgmma_case(
            torch, x, w, kw, "wgmma", ssq)
        assert excess <= smoke.ELEMENT_TOL["gemv_single"][0], excess
        assert parts_err is None or parts_err <= 1e-5, parts_err
        assert same and counted == 2


@pytest.mark.cuda
def test_cuda_gemv_wgmma_plan_mirror(cuda):
    """The Python mirrors of the wgmma GEMV's plan and of the route rule
    agree with the C entries (gemv_wgmma_plan, gemv_route)."""
    import ctypes

    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl

    lib = dl._lib()
    out = (ctypes.c_int * 4)()
    for k in (64, 1000, 1024, 2048, 3072, 6144, 18944, 40000):
        for tiles in (1, 16, 32, 48, 64, 96, 264, 1216):
            for nsrc in (1, 2):
                for nb8 in (1, 2, 4):
                    lib.gemv_wgmma_plan(k, tiles, nsrc, nb8,
                                        ctypes.addressof(out))
                    want = dl.gemv_wgmma_plan(k, tiles, nsrc, nb8)
                    assert list(out) == [want[f] for f in (
                        "cs", "kr", "stages", "smem")], (k, tiles, nsrc, nb8)
                for rows in (1, 8, 16, 17, 32):
                    for kind in range(4):
                        assert bool(lib.gemv_route(kind, rows, k, tiles,
                                                   nsrc)) == (
                            dl.gemv_route(kind, rows, k, tiles, nsrc)
                            == "wgmma"), (kind, rows, k, tiles, nsrc)


def _engine_two_layers(**kw):
    """AsrEngine at the real 0.6B widths, two decoder and two encoder
    layers, bf16, buckets (1, 2): prompts of two lengths."""
    from qwen3_asr_rs_tpu_torch.config import AsrConfig
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.weights.convert import init_encoder_params_np

    cfg = AsrConfig()
    text = dataclasses.replace(cfg.text, num_hidden_layers=2)
    audio = dataclasses.replace(cfg.audio, encoder_layers=2)
    cfg = dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config, text_config=text, audio_config=audio))
    return AsrEngine(None, dtype=torch.bfloat16, max_new_tokens=12,
                     chunk_buckets=(1, 2), config=cfg,
                     params=(init_encoder_params_np(audio),
                             init_decoder_params_np(text)),
                     tokenizer=smoke.StubTokenizer(), device="cuda", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"])
def test_cuda_graph_loop_matches_eager(cuda, kv, monkeypatch):
    """The decode loop's graph replays give the eager step's tokens, over
    a slab grow (ASR_DECODE_SEGMENT=4: caps [4, 12]) and in one stage
    (12: caps [12]), at B = 1 and 4, with a first-stage arena that grows
    between a 1-chunk and a 2-chunk prompt. A one-stage call keeps its
    graph for the next call of its key, a two-stage call frees its
    batch size's first stage and captures its second stage itself,
    while other batch sizes' graphs stay in the shared memory pool; K1
    counts one launch per step."""
    import numpy as np

    eng = _engine_two_layers(kv_dtype=kv)
    clips = [(np.random.default_rng(i).standard_normal(n) * 0.1).astype(
        np.float32) for i, n in enumerate((8000, 24000, 12000))]
    kept = set()  # (B, first clip, segment) whose graph the engine keeps
    for batch, segment in (([clips[0]], "12"), ([clips[1]], "12"),
                           (clips, "12"), (clips, "4"), ([clips[0]], "12"),
                           ([clips[1]], "12"), ([clips[1]], "4")):
        monkeypatch.setenv("ASR_DECODE_SEGMENT", segment)
        b = 1 if len(batch) == 1 else 4
        arena = eng._arenas[b][0].numel() if b in eng._arenas else 0
        eng.cuda_graphs = True
        n = decode_layers_fused.launches
        got = [r.raw_output for r in eng.transcribe_batch(batch)]
        st = eng.last_stats
        assert decode_layers_fused.launches - n == st["decode_steps"] == 11
        stages = 1 if segment == "12" else 2
        assert len(st["slab_lens"]) == stages
        assert st["replays"] + st["captures"] == 11
        key = (b, len(batch[0]), segment)
        assert st["captures"] == (0 if key in kept else stages)
        if stages == 2 or eng._arenas[b][0].numel() > arena:
            kept = {k for k in kept if k[0] != b}  # released or regrown
        if stages == 1:
            kept.add(key)
        assert (b in eng._arenas) == (stages == 1)
        eng.cuda_graphs = False
        assert [r.raw_output for r in eng.transcribe_batch(batch)] == got
        assert eng.last_stats["replays"] == 0


@pytest.mark.cuda
def test_cuda_capture_refuses_a_host_int_end(cuda):
    """A host int end would be frozen into a captured graph: the wrappers
    raise while the stream is capturing, and take a device tensor."""
    g = torch.Generator(device=cuda).manual_seed(0)
    ks = torch.randn((1, 1, 8, 64, 128), generator=g, device=cuda).to(
        torch.bfloat16)
    q = torch.randn((1, 16, 128), generator=g, device=cuda).to(torch.bfloat16)
    k_self = torch.randn((1, 8, 128), generator=g, device=cuda).to(
        torch.bfloat16)
    end = torch.tensor([40], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        decode_attention_dma(q, ks, ks, k_self, k_self, 0, None, end)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            with pytest.raises(ValueError, match="frozen"):
                decode_attention_dma(q, ks, ks, k_self, k_self, 0, None, 40)
            out = decode_attention_dma(q, ks, ks, k_self, k_self, 0, None, end)
        finally:
            graph.capture_end()
    graph.replay()
    torch.cuda.synchronize()
    want = decode_attention_dma_plain(q, ks, ks, k_self, k_self, 0, None, end)
    assert (out.float() - want.float()).abs().max() < 3e-2


@pytest.mark.cuda
def test_cuda_matmul_f32_gradient_matches_the_cpu(cuda):
    """``matmul_f32``'s CUDA bf16 branch (``aten::mm.dtype`` through
    ``_MatmulF32``) differentiates as the CPU branch's float32 upcast
    does: the float32 product and the bf16 gradients agree up to the
    order of float32 sums (a gradient may round to the neighbouring bf16
    value: rtol 2^-7)."""
    from qwen3_asr_rs_tpu_torch.ops.quant import matmul_f32

    g = torch.Generator().manual_seed(2)
    a = torch.randn((64, 1024), generator=g).bfloat16()
    b = torch.randn((1024, 256), generator=g).bfloat16()
    w = torch.randn((64, 256), generator=g)
    out = []
    for dev in (torch.device("cpu"), cuda):
        ad, bd = (t.to(dev, copy=True).requires_grad_() for t in (a, b))
        y = matmul_f32(ad, bd)
        assert y.dtype == torch.float32
        (y * w.to(dev)).sum().backward()
        out.append((y.detach().cpu(), ad.grad.cpu(), bd.grad.cpu()))
    (yc, ac, bc), (yg, ag, bg) = out
    torch.testing.assert_close(yg, yc, atol=1e-4, rtol=1e-5)
    for got, want in ((ag, ac), (bg, bc)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=2 ** -7)


@pytest.mark.cuda
def test_cuda_forward_full_raises_before_a_kernel_without_backward(cuda):
    """With a gradient required, ``forward_full`` on an int8 tree raises
    at the first K5 linear and launches nothing."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import TextDecoder
    from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    from qwen3_asr_rs_tpu_torch.weights.quantize import (
        quantize_decoder_params,
    )

    cfg = dataclasses.replace(TextDecoderConfig(), num_hidden_layers=1,
                              vocab_size=64)
    q = quantize_decoder_params(
        to_torch(init_decoder_params_np(cfg), torch.float32, cuda))
    hidden = torch.randn((1, 8, cfg.hidden_size), device=cuda,
                         requires_grad=True)
    n = quant_matmul.launches
    with pytest.raises(RuntimeError, match="K5 .* has no backward"):
        TextDecoder(cfg, device=cuda).forward_full(
            q, hidden, torch.arange(8, device=cuda))
    assert quant_matmul.launches == n


@pytest.mark.cuda
def test_cuda_forward_full_takes_dense_attention_under_a_gradient(cuda):
    """bf16 ``forward_full`` attends through K3 without a gradient and
    through the dense path (which has a backward) with one: the gradient
    reaches the input, and no K3 launch ran."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import TextDecoder

    cfg = dataclasses.replace(TextDecoderConfig(), num_hidden_layers=1,
                              vocab_size=64)
    params = to_torch(init_decoder_params_np(cfg), torch.bfloat16, cuda)
    dec = TextDecoder(cfg, device=cuda)
    hidden = torch.randn((2, 8, cfg.hidden_size), device=cuda).bfloat16()
    pos = torch.arange(8, device=cuda)
    n = flash_attention.launches
    with torch.no_grad():
        dec.forward_full(params, hidden, pos)
    assert flash_attention.launches == n + 1
    hidden.requires_grad_()
    dec.forward_full(params, hidden, pos).float().sum().backward()
    assert flash_attention.launches == n + 1
    assert torch.isfinite(hidden.grad.float()).all()
    assert hidden.grad.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,offset", [(1, 0), (8, 0), (16, 16)])
def test_cuda_draw_matches_plain(cuda, b, offset):
    """The draw kernel against its plain version on the card at the full
    vocabulary: bits and uniforms bit-equal, tokens equal but at a
    near-tie (chip_smoke's DRAW_TIE), a device step counter and a split
    chain (the key moves to fold_in(key, 0) after the draw)."""
    from qwen3_asr_rs_tpu_torch.ops import prng
    from qwen3_asr_rs_tpu_torch.ops.kernels.gumbel_argmax import (
        gumbel_argmax,
        gumbel_argmax_plain,
        threefry_noise,
        threefry_noise_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b, 151936), generator=g, device=cuda) * 3
    step = torch.tensor(5, device=cuda)
    chain = prng.KeyChain(prng.prng_key(3, cuda), ((step, 1), 2))
    for mode in ("bits", "uniform", "uniform_tiny"):
        assert torch.equal(threefry_noise(chain, x.shape, mode, offset),
                           threefry_noise_plain(chain, x.shape, mode, offset))
    tok = gumbel_argmax(x, chain, offset)
    ref = gumbel_argmax_plain(x, chain, offset)
    noisy = x + threefry_noise_plain(chain, x.shape, "gumbel", offset)
    for r in (tok != ref).nonzero().flatten().tolist():
        top = torch.topk(noisy[r], 2).values
        assert top[0] - top[1] <= smoke.DRAW_TIE * max(1.0, abs(float(top[0])))
    key = prng.prng_key(9, cuda)
    want = gumbel_argmax_plain(x, prng.fold_in(key, 1), offset)
    got = gumbel_argmax(x, prng.KeyChain(key, then_split=True), offset)
    assert torch.equal(key, prng.fold_in(prng.prng_key(9, cuda), 0))
    assert torch.equal(got, want)
