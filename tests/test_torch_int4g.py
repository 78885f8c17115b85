"""Group-wise int4 (quantize='int4g') in the port against the JAX package.

The quantizer is bit-equal to JAX's, with the group size clamped to a
divisor of K. ``int4_grouped_matmul`` matches JAX's in both of its
regimes; K1's plain version with int4g weights matches the Pallas
megakernel in interpret mode, on float and int8 slabs; unmerged int4g
stays on the plain per-layer decode path, as in JAX; and
``AsrEngine(quantize='int4g')`` gives the JAX engine's float32 greedy
tokens, alone and in a batch. Tolerances: float32 1e-5 (the same
products summed in other orders); bf16 as stated per test.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.models.text_decoder import quantize_kv as jquantize_kv
from qwen3_asr_rs_tpu.ops.pallas import quant_matmul as jq
from qwen3_asr_rs_tpu.ops.pallas.decode_layer import (
    decode_layers_fused as jax_decode_layers_fused,
)
from qwen3_asr_rs_tpu.weights import quantize as jquant
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.models import text_decoder as ttd
from qwen3_asr_rs_tpu_torch.ops import quant as tq
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
    decode_layers_fused,
    is_grouped,
)
from qwen3_asr_rs_tpu_torch.weights import quantize as tquant
from qwen3_asr_rs_tpu_torch.weights.convert import (
    init_decoder_params_np,
    to_torch,
)
from test_torch_batch import model_and_wavs  # noqa: F401 (fixture)
from test_torch_quant import _bits, _weights_with_ties

TOL = dict(atol=1e-5, rtol=1e-5)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k,n,group", [(64, 40, 128), (48, 40, 32),
                                       (256, 40, 128), (96, 8, 64)])
def test_grouped_quantizer_bit_equal_jax(rng, k, n, group):
    """Bit for bit, ties and an all-zero column included; K = 64 under
    group 128 clamps to 64, K = 48 under 32 to 24, K = 96 under 64 to 48."""
    w = _weights_with_ties(rng, k, n)
    ref = jq.quantize_weight_int4_grouped(jnp.asarray(w), group)
    got = tq.quantize_weight_int4_grouped(T(w), group)
    for r, g in zip(ref, got):
        assert _bits(g) == _bits(r)
    assert got[1].shape == (k // tq.int4_group_size(k, group), n)
    assert tq.int4_group_size(64, 128) == 64 and tq.int4_group_size(48, 32) == 24
    assert _bits(tq.dequantize_int4_grouped(*got)) == _bits(
        jq.dequantize_int4_grouped(*ref))
    # a stack of layers quantizes layer by layer
    stacked = tq.quantize_weight_int4_grouped(T(np.stack([w, -w])), group)
    for i, sign in enumerate((1, -1)):
        one = jq.quantize_weight_int4_grouped(jnp.asarray(sign * w), group)
        assert _bits(stacked[0][i]) == _bits(one[0])
        assert _bits(stacked[1][i]) == _bits(one[1])


@pytest.mark.parametrize("rows", [1, 8, 9, 37])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_int4_grouped_matmul_matches_jax(rng, rows, dtype):
    """Both regimes: <= 8 rows float32 partials times float32 scales,
    > 8 rows the group-scaled weight made in x's dtype. float32: 1e-5.
    bf16: the same exact products summed in float32 in other orders,
    within 1e-4 of the largest output, where taking the other regime's
    rounding of the weight (2^-9 of each) would be off by ~1e-3. XLA on
    the CPU has no batched bf16 x bf16 -> float32 product, so at <= 8
    rows JAX runs on the bf16 values held in float32, whose products are
    the same exact float32 numbers."""
    w = _weights_with_ties(rng, 96, 40)
    x = rng.standard_normal((1, rows, 96)).astype(np.float32)
    packed, scales = jq.quantize_weight_int4_grouped(jnp.asarray(w), 32)
    jx = jnp.asarray(x).astype(dtype)
    if dtype == jnp.bfloat16 and rows <= 8:
        jx = jx.astype(jnp.float32)
    ref = np.asarray(jq.int4_grouped_matmul(jx, packed, scales))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = tq.int4_grouped_matmul(T(x).to(tdt), T(packed), T(scales))
    assert got.dtype == torch.float32 and got.shape == (1, rows, 40)
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def _trees(merge, group=16):
    """(JAX, port) int4g decoder trees of the tiny config, lm_head int8."""
    jp = init_decoder_params(jconfig.tiny_test_config().text,
                             dtype=jnp.float32)
    tp = to_torch(init_decoder_params_np(tconfig.tiny_test_config().text),
                  torch.float32)
    kw = dict(bits=4, merge=merge, group_size=group)
    return (jquant.quantize_decoder_params(jp, **kw),
            tquant.quantize_decoder_params(tp, **kw))


def test_quantized_tree_shapes_and_lm_head_default(monkeypatch):
    jtree, ttree = _trees(True, 32)
    lay = ttree["layers"]
    assert lay["qkv_w_s"].shape == (2, 2, 128)   # K = 64: 2 groups of 32
    assert lay["down_w_s"].shape == (2, 4, 64)   # K = 128: 4 groups
    assert "lm_head_q" in ttree and is_grouped(lay)  # int8 lm_head default
    monkeypatch.setenv("ASR_LM_BITS", "4")
    assert "lm_head_q4" in _trees(True)[1]


@pytest.mark.parametrize("int8_slab", [False, True])
@pytest.mark.parametrize("b,start", [(1, None), (3, [0, 4, 11])])
@pytest.mark.parametrize("group", [16, 32])
def test_decode_layers_plain_int4g_matches_pallas(rng, int8_slab, b, start,
                                                  group):
    """K1's plain version with merged int4g weights against the Pallas
    megakernel (``ASR_DECODE_IMPL=fused``'s kernel) in interpret mode,
    float32, on a float and an int8 slab."""
    jtree, ttree = _trees(True, group)
    cfg = tconfig.tiny_test_config().text
    s_max, end = 40, 29
    shape = (cfg.num_hidden_layers, b, cfg.num_key_value_heads, s_max,
             cfg.head_dim)
    kc = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    vc = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    scales = {}
    if int8_slab:
        (kc, ks), (vc, vs) = (tuple(np.asarray(a) for a in jquantize_kv(
            jnp.asarray(t))) for t in (kc, vc))
        scales = dict(k_scales=ks, v_scales=vs)
    x = rng.standard_normal((b, cfg.hidden_size)).astype(np.float32)
    ang = rng.uniform(0, 6, (b, cfg.head_dim // 2)).astype(np.float32)
    cos = np.concatenate([np.cos(ang)] * 2, -1)
    sin = np.concatenate([np.sin(ang)] * 2, -1)
    st = None if start is None else np.asarray(start, np.int32)
    ref = jax_decode_layers_fused(
        jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jtree["layers"],
        jnp.asarray(kc), jnp.asarray(vc),
        None if st is None else jnp.asarray(st), jnp.int32(end),
        eps=cfg.rms_norm_eps, interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()},
    )
    before = decode_layers_fused.launches
    got = decode_layers_fused(
        T(x), T(cos), T(sin), ttree["layers"], T(kc), T(vc),
        None if st is None else T(st), end, eps=cfg.rms_norm_eps,
        **{k: T(v) for k, v in scales.items()},
    )
    assert decode_layers_fused.launches == before  # CPU: the plain version
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_unmerged_int4g_stays_on_the_plain_path(monkeypatch):
    """As JAX's dispatch sends unmerged int4g to its scan path, the port's
    decode kernel is not eligible for it, even when forced; merged int4g
    is."""
    cfg = tconfig.tiny_test_config().text
    dec = ttd.TextDecoder(cfg, 64)
    merged, unmerged = _trees(True)[1], _trees(False)[1]
    assert "q_w_q4" in unmerged["layers"] and is_grouped(unmerged["layers"])
    cpu = torch.device("cpu")
    monkeypatch.setenv("ASR_DECODE_IMPL", "fused")
    assert dec._use_fused_step(merged, cpu)
    assert not dec._use_fused_step(unmerged, cpu)

    def refuse(*args, **kwargs):
        raise AssertionError("the decode kernel ran")

    monkeypatch.setattr(ttd, "decode_layers_fused", refuse)
    cache = ttd.KVCache.zeros(cfg, 1, 16, dtype=torch.float32)
    logits, _ = dec.decode_step(unmerged, torch.tensor([5]), 3, cache)
    assert torch.isfinite(logits).all()
    with pytest.raises(AssertionError, match="kernel ran"):
        dec.decode_step(merged, torch.tensor([5]), 3, cache)


def test_engine_int4g_tokens_match_jax_tiny():
    from test_torch_engine import _engines, _tiny

    samples = (np.random.default_rng(1).standard_normal(20000) * 0.1).astype(
        np.float32)
    jeng, teng = _engines(_tiny, jnp.float32, torch.float32, 8, (2,), "int4g")
    assert is_grouped(teng.dec_params["layers"])
    assert teng.transcribe_samples(samples).raw_output == (
        jeng.transcribe_samples(samples).raw_output)


def test_engine_int4g_batch_tokens_match_jax_tiny():
    from test_torch_batch import CLIPS, _engines

    jeng, teng = _engines(None, "int4g")
    want = [r.raw_output for r in jeng.transcribe_batch(CLIPS[:3])]
    assert [r.raw_output for r in teng.transcribe_batch(CLIPS[:3])] == want
    assert teng.last_stats["n_gen"] == [4, 4, 4, 0]


def test_engine_int4g_tokens_match_jax_real_dims():
    """Two layers at the real 0.6B widths (group 128 divides every K),
    one clip and a batch of three."""
    from test_torch_engine import _engines, _real2

    clips = [(np.random.default_rng(s).standard_normal(n) * 0.1).astype(
        np.float32) for s, n in ((7, 12000), (8, 9000), (9, 15000))]
    jeng, teng = _engines(_real2, jnp.float32, torch.float32, 3, (1,),
                          "int4g")
    assert teng.dec_params["layers"]["qkv_w_s"].shape == (2, 8, 4096)
    assert teng.transcribe_samples(clips[0]).raw_output == (
        jeng.transcribe_samples(clips[0]).raw_output)
    assert [r.raw_output for r in teng.transcribe_batch(clips)] == [
        r.raw_output for r in jeng.transcribe_batch(clips)]


def test_cuda_engine_refuses_group_sizes_the_kernel_does_not_take(
        monkeypatch):
    """On CUDA an int4g group size the decode kernel cannot take raises at
    construction, never falling back to the plain path; checked here
    without a card through the group-size rule itself."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
        int4g_group_supported,
    )

    ks = (1024, 2048, 3072)  # 0.6B: H, Hq * D, I
    assert all(int4g_group_supported(g, ks) for g in (32, 64, 128, 256, 512))
    assert not any(int4g_group_supported(g) for g in (0, 16, 48, 96, 100))
    # a multiple of 128 that does not divide every K: the quantizer would
    # clamp qkv/o to another group size than down's
    assert int4g_group_supported(384) and not int4g_group_supported(384, ks)
    from qwen3_asr_rs_tpu_torch.runtime import engine as teng

    monkeypatch.setattr(teng.torch.cuda, "is_available", lambda: True)
    for gsize, cfg in (("96", tconfig.tiny_test_config()),
                       ("384", tconfig.AsrConfig())):
        monkeypatch.setenv("ASR_INT4_GROUP", gsize)
        with pytest.raises(ValueError, match=f"ASR_INT4_GROUP={gsize}"):
            teng.AsrEngine(None, config=cfg, params=({}, {}), device="cuda",
                           quantize="int4g", tokenizer=object())


def test_cli_int4g_and_fold_match_jax_cli(model_and_wavs, capsys, monkeypatch):
    """``ASR_QUANT=int4g`` through the port's CLI, one file and several
    (one batch), gives the JAX CLI's output; so does ``ASR_FOLD_LM=1``
    with the decode kernel's plain version (``ASR_DECODE_IMPL=fused``)."""
    from qwen3_asr_rs_tpu.cli import main as jax_main
    from qwen3_asr_rs_tpu_torch.cli import USAGE, main

    assert "int4g" in USAGE and "ASR_INT4_GROUP" in USAGE
    model, wavs = model_and_wavs
    for k, v in (("ASR_MAX_NEW_TOKENS", "4"), ("ASR_DTYPE", "float32"),
                 ("ASR_DEVICE", "cpu"), ("ASR_QUANT", "int4g"),
                 ("ASR_INT4_GROUP", "32")):
        monkeypatch.setenv(k, v)
    for argv in ([model, wavs[0]], [model, *wavs]):
        argv = [str(a) for a in argv]
        assert jax_main(argv) == 0
        want = capsys.readouterr().out
        assert main(argv) == 0
        assert capsys.readouterr().out == want
        monkeypatch.setenv("ASR_DECODE_IMPL", "fused")
        monkeypatch.setenv("ASR_FOLD_LM", "1")
        assert main(argv) == 0
        assert capsys.readouterr().out == want
        monkeypatch.delenv("ASR_DECODE_IMPL")
        monkeypatch.delenv("ASR_FOLD_LM")
