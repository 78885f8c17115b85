"""The folded lm_head (``ASR_FOLD_LM=1``) in the port against the JAX
package, float32 on the CPU: the decode kernel's plain version with the
final RMSNorm, the lm_head and the argmax folded in gives the tokens of
JAX's folded ``decode_step_token`` / ``decode_step_aligned_token`` (the
Pallas megakernel in interpret mode, ``ASR_DECODE_IMPL=fused``) and the
argmax of the unfolded logits, ties to the lowest index; an int4 lm_head
is not folded."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.weights import quantize as jquant
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.models import text_decoder as ttd
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import lm_fold_plain
from qwen3_asr_rs_tpu_torch.weights import quantize as tquant
from qwen3_asr_rs_tpu_torch.weights.convert import (
    init_decoder_params_np,
    to_torch,
)

T = torch.from_numpy


def _setup(rng, lm=None, b=1, vocab=None):
    """JAX and port decoders, params (``lm``: None, 'int8' or 'int4'
    weights) and a random float32 slab of 64 slots for ``b`` rows."""
    changes = {} if vocab is None else {"vocab_size": vocab}
    cfg, tcfg = (dataclasses.replace(m.tiny_test_config().text, **changes)
                 for m in (jconfig, tconfig))
    jp = init_decoder_params(cfg, dtype=jnp.float32)
    tp = to_torch(init_decoder_params_np(tcfg), torch.float32)
    if lm is not None:
        kw = dict(bits=4 if lm == "int4" else 8)
        jp = jquant.quantize_decoder_params(jp, **kw)
        tp = tquant.quantize_decoder_params(tp, **kw)
    shape = (cfg.num_hidden_layers, b, cfg.num_key_value_heads, 64,
             cfg.head_dim)
    kc = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    vc = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return (JDecoder(cfg, max_position=256), ttd.TextDecoder(tcfg, 256), jp,
            tp, kc, vc)


def _caches(kc, vc):
    return (JCache(k=jnp.asarray(kc), v=jnp.asarray(vc)),
            ttd.KVCache(k=T(kc.copy()), v=T(vc.copy())))


@pytest.mark.parametrize("lm", [None, "int8"])
def test_fold_token_step_matches_jax(rng, monkeypatch, lm):
    jdec, tdec, jp, tp, kc, vc = _setup(rng, lm)
    tok = jnp.asarray([42], jnp.int32)
    monkeypatch.setenv("ASR_DECODE_IMPL", "fused")
    monkeypatch.setenv("ASR_FOLD_LM", "1")
    jcache, tcache = _caches(kc, vc)
    want, jcache = jdec.decode_step_token(jp, tok, jnp.int32(37), jcache)
    assert tdec._fold(tp, torch.tensor([42]))
    got, tcache = tdec.decode_step_token(tp, torch.tensor([42]), 37, tcache)
    assert got.dtype == torch.int32 and got.tolist() == np.asarray(want).tolist()
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5, rtol=1e-5)
    monkeypatch.delenv("ASR_FOLD_LM")
    logits, _ = tdec.decode_step(tp, torch.tensor([42]), 37, _caches(kc, vc)[1])
    assert got.tolist() == torch.argmax(logits, -1).tolist()


@pytest.mark.parametrize("lm", [None, "int8"])
def test_fold_aligned_token_step_matches_jax(rng, monkeypatch, lm):
    jdec, tdec, jp, tp, kc, vc = _setup(rng, lm, b=3)
    tok = np.asarray([42, 7, 300], np.int32)
    kv_start = np.asarray([5, 12, 0], np.int32)
    monkeypatch.setenv("ASR_DECODE_IMPL", "fused")
    monkeypatch.setenv("ASR_FOLD_LM", "1")
    jcache, tcache = _caches(kc, vc)
    want, _ = jdec.decode_step_aligned_token(
        jp, jnp.asarray(tok), jnp.int32(40), jnp.asarray(kv_start), jcache)
    got, _ = tdec.decode_step_aligned_token(tp, T(tok).long(), 40,
                                            T(kv_start), tcache)
    assert got.tolist() == np.asarray(want).tolist()
    monkeypatch.delenv("ASR_FOLD_LM")
    logits, _ = tdec.decode_step_aligned(tp, T(tok).long(), 40, T(kv_start),
                                         _caches(kc, vc)[1])
    assert got.tolist() == torch.argmax(logits, -1).tolist()


@pytest.mark.parametrize("lm", [None, "int8"])
def test_fold_ties_take_the_lowest_index(rng, monkeypatch, lm):
    """An lm_head whose rows are all equal ties every logit (token 0); one
    whose only nonzero rows are two equal ones gives the lower of the two
    if their logit is positive, else 0. The JAX fold agrees."""
    jdec, tdec, jp, tp, kc, vc = _setup(rng, None)
    monkeypatch.setenv("ASR_DECODE_IMPL", "fused")
    monkeypatch.setenv("ASR_FOLD_LM", "1")
    v, h = tp["lm_head"].shape
    row = rng.standard_normal(h).astype(np.float32)
    two = np.zeros((v, h), np.float32)
    two[300] = two[700] = row
    for lm_head in (np.tile(row, (v, 1)), two, -two):
        jq, tq = dict(jp, lm_head=jnp.asarray(lm_head)), dict(
            tp, lm_head=T(lm_head.copy()))
        if lm == "int8":
            jq = jquant.quantize_lm_head_only(jq)
            tq = tquant.quantize_lm_head_only(tq)
        jcache, tcache = _caches(kc, vc)
        want, _ = jdec.decode_step_token(jq, jnp.asarray([9], jnp.int32),
                                         jnp.int32(20), jcache)
        got, _ = tdec.decode_step_token(tq, torch.tensor([9]), 20, tcache)
        assert got.tolist() == np.asarray(want).tolist()
        assert int(got[0]) in (0, 300)
    # lm_fold_plain alone: equal logits at 2 and 5, both the maximum
    h_row = torch.ones((1, h))
    w = torch.zeros((8, h))
    w[2] = w[5] = 1.0
    assert lm_fold_plain(h_row, torch.ones(h), w, None, 1e-6).tolist() == [2]
    wq, ws = w.T.to(torch.int8).contiguous(), torch.ones(8)
    assert lm_fold_plain(h_row, torch.ones(h), wq, ws, 1e-6).tolist() == [2]


def test_int4_lm_head_skips_the_fold(rng, monkeypatch):
    """As in JAX, an int4 lm_head (``lm_head_q4``) is not folded: the
    token step runs the unfolded kernel and K4's plain version."""
    _, tdec, _, tp, kc, vc = _setup(rng, "int4")
    assert "lm_head_q4" in tp
    monkeypatch.setenv("ASR_DECODE_IMPL", "fused")
    monkeypatch.setenv("ASR_FOLD_LM", "1")
    assert not tdec._fold(tp, torch.tensor([3]))
    got, _ = tdec.decode_step_token(tp, torch.tensor([3]), 20,
                                    _caches(kc, vc)[1])
    assert got.dtype == torch.int64  # torch.argmax of the logits
    monkeypatch.delenv("ASR_FOLD_LM")
    logits, _ = tdec.decode_step(tp, torch.tensor([3]), 20, _caches(kc, vc)[1])
    assert got.tolist() == torch.argmax(logits, -1).tolist()


@pytest.mark.parametrize("quantize", [None, "int8", "int4g"])
def test_engine_fold_tokens_equal_unfolded_and_jax(monkeypatch, quantize):
    """The engine with ``ASR_FOLD_LM=1`` (its decode steps return token
    ids from the fold) against itself unfolded and the JAX engine folded,
    one clip and a batch of three."""
    from test_torch_batch import CLIPS
    from test_torch_engine import _engines, _tiny

    monkeypatch.setenv("ASR_DECODE_IMPL", "fused")
    monkeypatch.setenv("ASR_FOLD_LM", "1")
    jeng, teng = _engines(_tiny, jnp.float32, torch.float32, 4, (4,),
                          quantize)
    folded = [teng.transcribe_samples(CLIPS[0]).raw_output] + [
        r.raw_output for r in teng.transcribe_batch(CLIPS[:3])]
    assert folded == [jeng.transcribe_samples(CLIPS[0]).raw_output] + [
        r.raw_output for r in jeng.transcribe_batch(CLIPS[:3])]
    monkeypatch.delenv("ASR_FOLD_LM")
    assert folded == [teng.transcribe_samples(CLIPS[0]).raw_output] + [
        r.raw_output for r in teng.transcribe_batch(CLIPS[:3])]
