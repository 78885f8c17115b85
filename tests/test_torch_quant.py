"""Weight quantization in the port vs the JAX package (CPU).

Quantizers and quantized parameter trees are bit-equal to JAX's. The
quantized products (``_linear``, the K5/K4 plain versions, the K1 plain
version with int8/int4 trees) match the JAX functions, the Pallas ones in
interpret mode; float32 tolerances atol/rtol 1e-5 (the two sides add the
same products in different orders). The bf16 logits are float32 values
that were never rounded to bf16.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.models import text_decoder as jtd
from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.ops.pallas import quant_matmul as jq
from qwen3_asr_rs_tpu.ops.pallas.decode_layer import (
    decode_layers_fused as jax_decode_layers_fused,
)
from qwen3_asr_rs_tpu.weights import quantize as jquant
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.models import text_decoder as ttd
from qwen3_asr_rs_tpu_torch.models.text_decoder import KVCache, TextDecoder
from qwen3_asr_rs_tpu_torch.ops import quant as tq
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import decode_layers_fused
from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul,
    quant_matmul_plain,
)
from qwen3_asr_rs_tpu_torch.ops.kernels.quant_matvec_int4 import (
    quant_matvec_int4,
    quant_matvec_int4_plain,
)
from qwen3_asr_rs_tpu_torch.weights import quantize as tquant
from qwen3_asr_rs_tpu_torch.weights.convert import (
    init_decoder_params_np,
    to_torch,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def T(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    """Raw bytes of an array or tensor, for bit-for-bit comparison."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.view(np.int16)
    return a.dtype.str, a.shape, a.tobytes()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _weights_with_ties(rng, k, n):
    """Random (K, N) weights plus columns whose values divide by their
    scale into exact half-steps (ties that round half to even)."""
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    w[:, 0] = 0.0
    w[:6, 0] = np.array([127, 0.5, 1.5, 2.5, -3.5, -126.5]) / 64  # int8
    w[:, 1] = 0.0
    w[:5, 1] = np.array([7, 0.5, 1.5, -2.5, 6.5]) / 8  # int4
    w[:, -1] = 0.0  # an all-zero column: scale from the 1e-8 floor
    return w


@pytest.mark.parametrize("name", ["quantize_weight", "quantize_weight_int4",
                                  "quantize_weight_int4_tiled"])
@pytest.mark.parametrize("k,n", [(24, 40), (16, 8192 + 200)])
def test_quantizers_bit_equal_jax(rng, name, k, n):
    """Bit for bit, including exact half-step ties, an all-zero column,
    and N not a multiple of the 8192 tile."""
    w = _weights_with_ties(rng, k, n)
    ref = getattr(jq, name)(jnp.asarray(w))
    got = getattr(tq, name)(T(w))
    for r, g in zip(ref, got):
        assert _bits(g) == _bits(r)
    # the ties really are ties, and rounded half to even
    if name == "quantize_weight":
        assert got[0][:6, 0].tolist() == [127, 0, 2, 2, -4, -126]
    packed = got[0]
    if name == "quantize_weight_int4":
        assert _bits(tq.unpack_int4(packed)) == _bits(jq.unpack_int4(
            jnp.asarray(packed.numpy())))
        assert tq.unpack_int4(packed)[:5, 1].tolist() == [7, 0, 2, -2, 6]
    if name == "quantize_weight_int4_tiled":
        n_pad = packed.shape[1] * 2
        full = tq.unpack_int4_tiled(packed)
        assert full.shape == (k, n_pad) and not full[:, n:].any()
        # the same int4 values as the per-column packing, in column order
        torch.testing.assert_close(
            full[:, :n], tq.unpack_int4(tq.quantize_weight_int4(T(w))[0]),
            rtol=0, atol=0)


def test_unpack_stacked_and_blocked_raises(rng):
    w = _weights_with_ties(rng, 8, 32)
    stacked = np.stack([w, -w])
    packed, s = tq.quantize_weight_int4(T(stacked), axis=-2)
    for i in range(2):
        ref = jq.quantize_weight_int4(jnp.asarray(stacked[i]))
        assert _bits(packed[i]) == _bits(ref[0])
        assert _bits(s[i]) == _bits(ref[1])
    # blocked (the tensor-parallel layout): JAX's bytes, each block the
    # plain packing of its columns
    packed, s = tq.quantize_weight_int4(T(w), blocks=2)
    ref = jq.quantize_weight_int4(jnp.asarray(w), blocks=2)
    assert _bits(packed) == _bits(ref[0]) and _bits(s) == _bits(ref[1])
    assert _bits(packed[:, 1]) == _bits(
        tq.quantize_weight_int4(T(w[:, 16:]))[0])


def _cfgs(**changes):
    """(JAX, port) text configs: each package's ``tiny_test_config()``
    with the same changes."""
    return tuple(dataclasses.replace(m.tiny_test_config().text, **changes)
                 for m in (jconfig, tconfig))


def _dec_params(cfgs, dtype=jnp.float32):
    jp = init_decoder_params(cfgs[0], dtype=dtype)
    tp = to_torch(init_decoder_params_np(cfgs[1]),
                  torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return jp, tp


@pytest.mark.parametrize(
    "bits,merge,lm_bits,dtype",
    [(8, True, None, jnp.float32), (8, False, None, jnp.float32),
     (4, True, None, jnp.float32), (4, False, None, jnp.float32),
     (8, True, 4, jnp.float32), (4, True, 8, jnp.float32),
     (4, False, 8, jnp.bfloat16), ("lm8", None, None, jnp.float32),
     ("lm8", None, None, jnp.bfloat16)],
)
def test_quantized_trees_bit_equal_jax(bits, merge, lm_bits, dtype):
    jp, tp = _dec_params(_cfgs(vocab_size=9000), dtype)
    if bits == "lm8":
        ref, got = (jquant.quantize_lm_head_only(jp),
                    tquant.quantize_lm_head_only(tp))
    else:
        ref = jquant.quantize_decoder_params(jp, bits=bits, merge=merge,
                                             lm_bits=lm_bits)
        got = tquant.quantize_decoder_params(tp, bits=bits, merge=merge,
                                             lm_bits=lm_bits)
    ref, got = _flat(ref), _flat(got)
    assert ref.keys() == got.keys()
    for k in ref:
        assert _bits(got[k]) == _bits(ref[k]), k
        assert got[k].is_contiguous(), k  # the CUDA kernels' layout
    assert "lm_head" not in got
    assert "q_w" in _flat(tp["layers"])  # the input tree is left as it was


def test_lm_bits_env_and_biases_skip_merge(monkeypatch):
    jp, tp = _dec_params(_cfgs())
    monkeypatch.setenv("ASR_LM_BITS", "4")
    assert "lm_head_q4" in tquant.quantize_decoder_params(tp, bits=8)
    assert set(tquant.quantize_decoder_params(tp, bits=8)) == set(
        jquant.quantize_decoder_params(jp, bits=8))
    biased = dict(tp, layers=dict(tp["layers"], q_b=torch.zeros(2, 64)))
    layers = tquant.quantize_decoder_params(biased, bits=8)["layers"]
    assert "q_w_q" in layers and "qkv_w_q" not in layers


def test_unported_quant_modes_raise():
    """int4g (``group_size``) gives JAX's tree bit for bit, with JAX's
    ValueErrors; so does blocked int4 (``tp_blocks``, ported since)."""
    jp, tp = _dec_params(_cfgs())
    ref = _flat(jquant.quantize_decoder_params(jp, bits=4, group_size=128))
    got = _flat(tquant.quantize_decoder_params(tp, bits=4, group_size=128))
    assert ref.keys() == got.keys() and "lm_head_q" in got
    for k in ref:
        assert _bits(got[k]) == _bits(ref[k]), k
    with pytest.raises(ValueError, match="bits=4 only"):
        tquant.quantize_decoder_params(tp, bits=8, group_size=128)
    with pytest.raises(ValueError, match="tensor parallelism"):
        tquant.quantize_decoder_params(tp, bits=4, merge=False, tp_blocks=2,
                                       group_size=64)
    ref = _flat(jquant.quantize_decoder_params(jp, bits=4, merge=False,
                                               tp_blocks=2))
    got = _flat(tquant.quantize_decoder_params(tp, bits=4, merge=False,
                                               tp_blocks=2))
    assert ref.keys() == got.keys() and "lm_head_q" in got
    for k in ref:
        assert _bits(got[k]) == _bits(ref[k]), k
    with pytest.raises(ValueError, match="tp_blocks"):
        tquant.quantize_decoder_params(tp, bits=4, tp_blocks=2)
    with pytest.raises(ValueError, match="bits"):
        tquant.quantize_decoder_params(tp, bits=2)


# --------------------------------------------------------------------- #
# products


@pytest.mark.parametrize("rows", [1, 5, 37])
@pytest.mark.parametrize("kind", ["q", "q4"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_linear_matches_jax(rng, rows, kind, dtype):
    """``_linear``'s int8 and int4 branches against JAX's. float32: 1e-5.
    bf16: both sides form the same exact products and sum them in float32
    in different orders, then scale and round once; a rounding flip moves
    a value by one bf16 ulp (2^-8 of it, at most)."""
    w = _weights_with_ties(rng, 48, 40)
    x = rng.standard_normal((1, rows, 48)).astype(np.float32)
    if kind == "q":
        wq, s = jq.quantize_weight(jnp.asarray(w))
    else:
        wq, s = jq.quantize_weight_int4(jnp.asarray(w))
    jtree = {f"w_{kind}": wq, "w_s": s}
    ref = np.asarray(jtd._linear(jtree, "w", jnp.asarray(x).astype(dtype))
                     .astype(jnp.float32))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ttree = {k: T(v) for k, v in jtree.items()}
    before = quant_matmul.launches
    got = ttd._linear(ttree, "w", T(x).to(tdt))
    assert quant_matmul.launches == before  # CPU: the plain version
    assert got.dtype == tdt and got.shape == (1, rows, 40)
    got = got.float().numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=1e-6)
        assert (got == ref).mean() > 0.95


@pytest.mark.parametrize("rows", [1, 7, 20])
@pytest.mark.parametrize("out_dtype", [None, jnp.float32])
def test_quant_matmul_plain_matches_pallas(rng, rows, out_dtype):
    """K5's plain version on bf16 x against the Pallas kernel, which casts
    x to bf16; K = 600 is not a multiple of the 512 k-block."""
    w = _weights_with_ties(rng, 600, 136)
    x = rng.standard_normal((rows, 600)).astype(np.float32)
    wq, s = jq.quantize_weight(jnp.asarray(w))
    ref = jq.quant_matmul(jnp.asarray(x).astype(jnp.bfloat16), wq, s,
                          out_dtype=out_dtype, block_out=128, interpret=True)
    got = quant_matmul_plain(T(x).bfloat16(), T(wq), T(s),
                             out_dtype=None if out_dtype is None
                             else torch.float32)
    ref = np.asarray(ref.astype(jnp.float32))
    if out_dtype is None:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # and through the wrapper, which takes the plain version on the CPU
    got_w = quant_matmul(T(x).bfloat16(), T(wq), T(s), out_dtype=torch.float32)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(
        jq.quant_matmul(jnp.asarray(x).astype(jnp.bfloat16), wq, s,
                        out_dtype=jnp.float32, block_out=128,
                        interpret=True)), **TOL)


@pytest.mark.parametrize("rows", [1, 3, 70])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quant_matvec_int4_plain_matches_pallas(rng, rows, dtype):
    """K4's plain version against the Pallas matvec (R <= 64) and its
    dequantize path (R > 64); N = 9000 pads to two 8192 tiles."""
    w = _weights_with_ties(rng, 32, 9000)
    x = rng.standard_normal((rows, 32)).astype(np.float32)
    wq, s = jq.quantize_weight_int4_tiled(jnp.asarray(w))
    ref = np.asarray(jq.quant_matvec_int4(jnp.asarray(x).astype(dtype), wq, s,
                                          interpret=True))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    before = quant_matvec_int4.launches
    got = quant_matvec_int4(T(x).to(tdt), T(wq), T(s))
    assert quant_matvec_int4.launches == before
    assert got.dtype == torch.float32 and got.shape == (rows, 9000)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        quant_matvec_int4_plain(T(x).to(tdt), T(wq), T(s)).numpy(), ref, **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("s_max,start,end", [(48, None, 20), (40, 6, 33)])
def test_decode_layers_plain_quantized_matches_pallas(rng, bits, merge, s_max,
                                                      start, end):
    """K1's plain version with int8/int4, merged and per-projection trees
    against the Pallas megakernel in interpret mode, float32."""
    cfg, _ = cfgs = _cfgs()
    jp, tp = _dec_params(cfgs)
    jlayers = jquant.quantize_decoder_params(jp, bits=bits, merge=merge,
                                             lm_bits=8)["layers"]
    tlayers = tquant.quantize_decoder_params(tp, bits=bits, merge=merge,
                                             lm_bits=8)["layers"]
    shape = (cfg.num_hidden_layers, 1, cfg.num_key_value_heads, s_max,
             cfg.head_dim)
    kc = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    vc = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    x = rng.standard_normal((1, cfg.hidden_size)).astype(np.float32)
    ang = rng.uniform(0, 6, (1, cfg.head_dim // 2)).astype(np.float32)
    cos = np.concatenate([np.cos(ang)] * 2, -1)
    sin = np.concatenate([np.sin(ang)] * 2, -1)
    st = None if start is None else np.full((1,), start, np.int32)
    en = np.full((1,), end, np.int32)
    ref = jax_decode_layers_fused(
        jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jlayers,
        jnp.asarray(kc), jnp.asarray(vc),
        None if st is None else jnp.asarray(st), jnp.asarray(en),
        eps=cfg.rms_norm_eps, interpret=True,
    )
    before = decode_layers_fused.launches
    got = decode_layers_fused(T(x), T(cos), T(sin), tlayers, T(kc), T(vc),
                              None if st is None else T(st), T(en),
                              eps=cfg.rms_norm_eps)
    assert decode_layers_fused.launches == before
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# --------------------------------------------------------------------- #
# the decoder


def test_bf16_logits_are_float32_and_match_jax(rng):
    """The port's bf16 ``logits`` keep the float32 sums of the bf16
    products, as JAX's einsum with ``preferred_element_type=float32``:
    they are not all representable in bf16, and they lie within 2^-5 of
    one bf16 ulp of the largest logit of JAX's (the two sides sum the
    same exact products in different orders; rounding to bf16 would move
    logits by up to half an ulp)."""
    cfg, tcfg = cfgs = _cfgs(vocab_size=151936)
    jp, tp = _dec_params(cfgs, jnp.bfloat16)
    hidden = rng.standard_normal((1, 3, cfg.hidden_size)).astype(np.float32)
    ref = np.asarray(JDecoder(cfg, 64).logits(
        jp, jnp.asarray(hidden).astype(jnp.bfloat16)))
    got = TextDecoder(tcfg, 64).logits(tp, T(hidden).bfloat16())
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert (got.bfloat16().float() != got).float().mean() > 0.9
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    err = np.abs(got.numpy() - ref).max()
    assert err <= ulp * 2 ** -5, (err, ulp)


def test_jax_quantized_tree_carries_across_to_torch(rng):
    """A JAX-quantized bf16 tree keeps its int8 leaves and float32 scales
    through ``to_torch``, and a float32 one runs in the port's decoder
    with JAX's prefill and decode logits."""
    cfg, tcfg = _cfgs()
    jbf = jquant.quantize_decoder_params(
        init_decoder_params(cfg, dtype=jnp.bfloat16), bits=4)
    tbf = _flat(to_torch(jbf, torch.bfloat16))
    for k, v in _flat(jbf).items():
        assert _bits(tbf[k]) == _bits(v), k
    assert tbf["layers/qkv_w_q4"].dtype == torch.int8
    assert tbf["layers/qkv_w_s"].dtype == torch.float32
    assert tbf["embed"].dtype == torch.bfloat16

    jq8 = jquant.quantize_decoder_params(
        init_decoder_params(cfg, dtype=jnp.float32), bits=8, merge=False)
    tq8 = to_torch(jq8, torch.float32)
    p_len, true_len, s_max = 10, 8, 16
    hidden = (rng.standard_normal((1, p_len, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    jdec, tdec = JDecoder(cfg, max_position=64), TextDecoder(tcfg, 64)
    jlog, jcache = jdec.prefill(jq8, jnp.asarray(hidden), jnp.arange(p_len),
                                JCache.zeros(cfg, 1, s_max, jnp.float32),
                                jnp.int32(true_len))
    cache = KVCache.zeros(tcfg, 1, s_max, dtype=torch.float32)
    tlog, cache = tdec.prefill(tq8, T(hidden), torch.arange(p_len), cache,
                               true_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    tok = torch.argmax(tlog, -1)
    jlog, _ = jdec.decode_step(jq8, jnp.asarray(tok.numpy(), jnp.int32),
                               jnp.int32(true_len), jcache)
    tlog, _ = tdec.decode_step(tq8, tok, true_len, cache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


@pytest.mark.parametrize("mode", ["int8", "int4", "int8-unmerged",
                                  "int4-lm8", "lm8"])
@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_quantized_decoder_matches_jax(rng, monkeypatch, mode, impl):
    """Prefill and three decode steps (K1's plain version, or the plain
    per-layer path) with quantized trees against the JAX decoder's scan
    path, float32."""
    cfg, tcfg = cfgs = _cfgs()
    jp, tp = _dec_params(cfgs)
    if mode == "lm8":
        jq_, tq_ = jquant.quantize_lm_head_only(jp), tquant.quantize_lm_head_only(tp)
    else:
        kw = dict(bits=4 if mode.startswith("int4") else 8,
                  merge=mode != "int8-unmerged",
                  lm_bits=8 if mode == "int4-lm8" else None)
        jq_ = jquant.quantize_decoder_params(jp, **kw)
        tq_ = tquant.quantize_decoder_params(tp, **kw)
    p_len, true_len, s_max = 12, 9, 24
    hidden = (rng.standard_normal((1, p_len, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    jdec, tdec = JDecoder(cfg, max_position=64), TextDecoder(tcfg, 64)
    jlog, jcache = jdec.prefill(jq_, jnp.asarray(hidden), jnp.arange(p_len),
                                JCache.zeros(cfg, 1, s_max, jnp.float32),
                                jnp.int32(true_len))
    cache = KVCache.zeros(tcfg, 1, s_max, dtype=torch.float32)
    tlog, cache = tdec.prefill(tq_, T(hidden), torch.arange(p_len), cache,
                               true_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    monkeypatch.setenv("ASR_DECODE_ATTN", "kernel")
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1)
    for step in range(3):
        monkeypatch.setenv("ASR_DECODE_IMPL", "scan")
        jlog, jcache = jdec.decode_step(jq_, jtok, jnp.int32(true_len + step),
                                        jcache)
        monkeypatch.setenv("ASR_DECODE_IMPL", impl)
        tlog, cache = tdec.decode_step(tq_, ttok, true_len + step, cache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                                   **TOL)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)
        assert int(ttok[0]) == int(jtok[0])


@pytest.mark.parametrize("bits", [8, 4])
def test_merged_qkv_slices_are_contiguous(rng, bits):
    """The merged product's q/k/v come out as contiguous tensors, which
    the attention kernels take (the flash kernel refuses strided ones)."""
    _, cfg = cfgs = _cfgs()
    _, tp = _dec_params(cfgs)
    layers = tquant.quantize_decoder_params(tp, bits=bits)["layers"]
    layer = {k: v[0] for k, v in layers.items()}
    x = T(rng.standard_normal((1, 5, cfg.hidden_size)).astype(np.float32))
    q, k, v = ttd._qkv3(layer, x, cfg.num_attention_heads,
                        cfg.num_key_value_heads, cfg.head_dim)
    assert all(t.is_contiguous() for t in (q, k, v))
    assert v.shape == (1, 5, cfg.num_key_value_heads, cfg.head_dim)
