"""The int8 KV slab: the port against the JAX package (float32, CPU).

``quantize_kv`` must be bit-equal to JAX's; K2's and K1's plain versions
with int8 slabs match the Pallas kernels in interpret mode (atol/rtol
1e-5: the same float32 math, with the K/V scales folded as products in
another order); the decoder's int8 prefill and decode writes give JAX's
int8 slab values exactly and its scales and logits within 1e-5; the
engine with ``kv_dtype='int8'`` gives the JAX engine's greedy tokens
exactly at B = 1 and B = 4 (B = 2, 3, 4 also in test_torch_batch.py).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.config import tiny_test_config
from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
from qwen3_asr_rs_tpu.models.text_decoder import dequantize_kv as jdequantize
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.models.text_decoder import quantize_kv as jquantize
from qwen3_asr_rs_tpu.ops.pallas.decode_attention import (
    decode_attention_dma as jax_decode_attention_dma,
)
from qwen3_asr_rs_tpu.ops.pallas.decode_layer import (
    decode_layers_fused as jax_decode_layers_fused,
)
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.models.text_decoder import (
    KVCache,
    TextDecoder,
    dequantize_kv,
    quantize_kv,
)
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_dma,
)
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
    decode_layers_fused,
)
from qwen3_asr_rs_tpu_torch.weights import convert

TOL = dict(atol=1e-5, rtol=1e-5)
T = torch.from_numpy


def test_quantize_kv_bit_equal_to_jax_and_round_trip(rng):
    t = (rng.standard_normal((3, 4, 7, 16)) * 2.0).astype(np.float32)
    t[0, 0, 0] = 0.0                     # an all-zero row: the 1e-8 floor
    t[1, 1, 1, :] = np.arange(16) - 7.5  # exact .5 quotients: half to even
    q, s = quantize_kv(T(t))
    jq, js = jquantize(jnp.asarray(t))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = dequantize_kv(q, s, torch.float32).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jdequantize(jq, js, jnp.float32)))
    # symmetric int8: the error is at most half a step, absmax / 254
    assert (np.abs(back - t) <= s.numpy()[..., None] / 2 + 1e-6).all()


def _int8_slabs(rng, shape, ends):
    """int8 K/V slabs and scales from float ones; the slots of each row
    past its end stay dead, as in a fresh slab: value 0, scale 0."""
    k, v = ((rng.standard_normal(shape) * 0.3).astype(np.float32)
            for _ in range(2))
    out = []
    for t in (k, v):
        q, s = (np.asarray(a) for a in jquantize(jnp.asarray(t)))
        q, s = q.copy(), s.copy()
        for b, e in enumerate(ends):
            q[:, b, :, e:] = 0
            s[:, b, :, e:] = 0.0
        out += [q, s]
    return out  # kq, ks, vq, vs


@pytest.mark.parametrize("b,s,starts,ends", [
    (1, 256, None, [150]),
    (2, 256, [0, 37], [200, 100]),
    (3, 128, [0, 5, 9], [1, 60, 128]),
])
def test_decode_attention_plain_int8_matches_pallas(rng, b, s, starts, ends):
    L, hq, hkv, d = 2, 4, 2, 16
    q = (rng.standard_normal((b, hq, d)) * 0.5).astype(np.float32)
    k_self = (rng.standard_normal((b, hkv, d)) * 0.3).astype(np.float32)
    v_self = (rng.standard_normal((b, hkv, d)) * 0.3).astype(np.float32)
    kq, ks, vq, vs = _int8_slabs(rng, (L, b, hkv, s, d), ends)
    st = None if starts is None else np.asarray(starts, np.int32)
    en = np.asarray(ends, np.int32)
    ref = jax_decode_attention_dma(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(k_self),
        jnp.asarray(v_self), 1, None if st is None else jnp.asarray(st),
        jnp.asarray(en), k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        block_s=128, interpret=True,
    )
    n = decode_attention_dma.launches
    got = decode_attention_dma(T(q), T(kq), T(vq), T(k_self), T(v_self), 1,
                               None if st is None else T(st), T(en),
                               k_scales=T(ks), v_scales=T(vs))
    assert decode_attention_dma.launches == n  # CPU tensors: the plain version
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,start", [(1, None), (3, [0, 4, 11])])
def test_decode_layers_plain_int8_kv_matches_pallas(rng, b, start):
    cfg = tiny_test_config().text
    jparams = init_decoder_params(cfg, dtype=jnp.float32)
    layers = convert.to_torch(
        convert.init_decoder_params_np(tconfig.tiny_test_config().text),
        torch.float32)["layers"]
    s_max, end = 40, 29
    kq, ks, vq, vs = _int8_slabs(
        rng, (cfg.num_hidden_layers, b, cfg.num_key_value_heads, s_max,
              cfg.head_dim), [end] * b)
    x = rng.standard_normal((b, cfg.hidden_size)).astype(np.float32)
    ang = rng.uniform(0, 6, (b, cfg.head_dim // 2)).astype(np.float32)
    cos = np.concatenate([np.cos(ang)] * 2, -1)
    sin = np.concatenate([np.sin(ang)] * 2, -1)
    st = None if start is None else np.asarray(start, np.int32)
    ref = jax_decode_layers_fused(
        jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jparams["layers"],
        jnp.asarray(kq), jnp.asarray(vq),
        None if st is None else jnp.asarray(st), jnp.int32(end),
        eps=cfg.rms_norm_eps, interpret=True,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
    )
    got = decode_layers_fused(
        T(x), T(cos), T(sin), layers, T(kq), T(vq),
        None if st is None else T(st), end, eps=cfg.rms_norm_eps,
        k_scales=T(ks), v_scales=T(vs),
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("impl", ["scan", "fused"])
def test_decoder_int8_kv_matches_jax(rng, monkeypatch, impl):
    """Prefill and three decode steps on an int8 slab: int8 slab values
    equal to JAX's, scales and logits within 1e-5; prefill
    logits equal the unquantized slab's (prefill attends the fresh keys).
    ``fused``: K1's plain version; ``scan``: the dense int8 path."""
    cfg, tcfg = tiny_test_config().text, tconfig.tiny_test_config().text
    jp = init_decoder_params(cfg, dtype=jnp.float32)
    tp = convert.init_decoder_params(tcfg, dtype=torch.float32)
    jdec, tdec = JDecoder(cfg, max_position=64), TextDecoder(tcfg, 64)
    hidden = (rng.standard_normal((1, 9, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    jlog, jcache = jdec.prefill(jp, jnp.asarray(hidden), jnp.arange(9),
                                JCache.zeros(cfg, 1, 24, quantized=True),
                                jnp.int32(9))
    cache = KVCache.zeros(tcfg, 1, 24, dtype=torch.float32, quantized=True)
    assert cache.quantized and cache.k.dtype == torch.int8
    tlog, cache = tdec.prefill(tp, T(hidden), torch.arange(9), cache, 9)
    plain_log, _ = tdec.prefill(tp, T(hidden), torch.arange(9),
                                KVCache.zeros(tcfg, 1, 24, torch.float32), 9)
    np.testing.assert_array_equal(tlog.numpy(), plain_log.numpy())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)

    def same_slabs():
        # the fresh K/V differ from JAX's by float32 ulps, so their scales
        # do; the int8 values come out equal
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                getattr(cache, name).numpy(), np.asarray(getattr(jcache, name)))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(
                getattr(cache, name).numpy(),
                np.asarray(getattr(jcache, name)), **TOL)

    same_slabs()
    tok = torch.tensor([3])
    for step in range(3):
        monkeypatch.setenv("ASR_DECODE_IMPL", "scan")
        jlog, jcache = jdec.decode_step(jp, jnp.asarray(tok.numpy(), jnp.int32),
                                        jnp.int32(9 + step), jcache)
        monkeypatch.setenv("ASR_DECODE_IMPL", impl)
        tlog, cache = tdec.decode_step(tp, tok, 9 + step, cache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        same_slabs()
        tok = torch.argmax(tlog, -1)


@pytest.mark.parametrize("b", [1, 4])
def test_engine_int8_kv_tokens_match_jax(b):
    from test_torch_batch import CLIPS, _engines

    jeng, teng = _engines("int8")
    assert teng.kv_quant
    got = teng.transcribe_batch(CLIPS[:b])
    assert [r.raw_output for r in got] == [
        r.raw_output for r in jeng.transcribe_batch(CLIPS[:b])]


def test_asr_kv_env_and_unknown_values(monkeypatch):
    from test_torch_engine import _Tok, _tiny

    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine

    cfg = _tiny(tconfig)
    params = convert.init_encoder_params(cfg.audio), convert.init_decoder_params(
        cfg.text)

    def engine(kv_dtype=None):
        return AsrEngine(None, dtype=torch.float32, max_new_tokens=2,
                         chunk_buckets=(1,), config=cfg, params=params,
                         tokenizer=_Tok(), device="cpu", kv_dtype=kv_dtype)

    monkeypatch.setenv("ASR_KV", "int8")
    teng = engine()
    assert teng.kv_quant and teng._new_cache(1, 16).quantized
    assert not engine("bf16").kv_quant
    monkeypatch.setenv("ASR_KV", "bogus")
    with pytest.raises(ValueError, match="unknown kv_dtype 'bogus'"):
        engine()
    monkeypatch.delenv("ASR_KV")
    assert not engine().kv_quant
    with pytest.raises(ValueError, match="unknown kv_dtype 'fp8'"):
        engine("fp8")
