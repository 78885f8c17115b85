"""Port audio encoder and text decoder blocks vs the JAX models (float32)."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.models.audio_encoder import AudioEncoder as JEncoder
from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.weights import quantize as jquant
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.config import (
    AudioEncoderConfig,
    audio_tokens,
    feat_extract_output_length,
)
from qwen3_asr_rs_tpu_torch.models.audio_encoder import AudioEncoder
from qwen3_asr_rs_tpu_torch.models.text_decoder import KVCache, TextDecoder
from qwen3_asr_rs_tpu_torch.weights import convert
from qwen3_asr_rs_tpu_torch.weights import quantize as tquant

T = torch.from_numpy


def _encoders():
    """(port config, JAX params, port params) of the tiny encoder, each
    package's params from its own config."""
    cfg = tconfig.tiny_test_config().audio
    return (cfg, init_encoder_params(jconfig.tiny_test_config().audio,
                                     dtype=jnp.float32),
            convert.init_encoder_params(cfg, dtype=torch.float32))


@pytest.mark.parametrize("num_frames,bucket_chunks", [(260, 3), (260, 16),
                                                      (100, 1)])
def test_encoder_matches_jax(rng, num_frames, bucket_chunks):
    cfg, jp, tp = _encoders()
    mel = np.zeros((cfg.num_mel_bins, bucket_chunks * cfg.chunk_frames),
                   np.float32)
    mel[:, :num_frames] = rng.standard_normal((cfg.num_mel_bins, num_frames))
    jflat, jn = JEncoder(jconfig.tiny_test_config().audio)(
        jp, jnp.asarray(mel), jnp.int32(num_frames))
    flat, n = AudioEncoder(cfg)(tp, T(mel), num_frames)
    assert n == int(jn)
    assert flat.shape == tuple(jflat.shape)
    np.testing.assert_allclose(flat[:n].numpy(), np.asarray(jflat)[:n],
                               atol=1e-5, rtol=1e-4)


def test_encoder_bucket_padding_invariance(rng):
    cfg, _, tp = _encoders()
    enc = AudioEncoder(cfg)
    num_frames = 260
    mel = rng.standard_normal((cfg.num_mel_bins, num_frames)).astype(np.float32)

    def run(bucket_chunks):
        mp = np.zeros((cfg.num_mel_bins, bucket_chunks * cfg.chunk_frames),
                      np.float32)
        mp[:, :num_frames] = mel
        flat, n = enc(tp, T(mp), num_frames)
        return flat[:n].numpy()

    np.testing.assert_allclose(run(3), run(16), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("group", [500, 7], ids=["one-group", "groups-of-7"])
def test_encoder_batch_matches_per_row_calls(rng, group):
    """``batch`` over rows of mixed true lengths (10 chunks: two windows,
    the second part padding) gives each row's ``__call__``; a stem in
    groups of fewer chunks than the batch holds changes nothing."""
    cfg, _, tp = _encoders()
    chunks = 10
    lengths = (1000, 650, 130)
    mel = np.zeros((len(lengths), cfg.num_mel_bins,
                    chunks * cfg.chunk_frames), np.float32)
    for row, n in zip(mel, lengths):
        row[:, :n] = rng.standard_normal((cfg.num_mel_bins, n))
    grouped = AudioEncoder(dataclasses.replace(cfg, conv_chunksize=group))
    flat, n_valid = grouped.batch(tp, T(mel), torch.tensor(lengths))
    assert flat.shape == (len(lengths), chunks * cfg.tokens_per_chunk,
                          cfg.output_dim)
    enc = AudioEncoder(cfg)
    for row, n, got, got_n in zip(mel, lengths, flat, n_valid):
        want, want_n = enc(tp, T(row), n)
        assert int(got_n) == want_n
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_stem_groups_keep_gradients(rng):
    """The grouped stem's gradients are the whole stem's (training calls
    ``batch`` with a gradient)."""
    cfg, _, _ = _encoders()
    mel = T(rng.standard_normal((2, cfg.num_mel_bins,
                                 3 * cfg.chunk_frames)).astype(np.float32))
    grads = []
    for group in (500, 4):
        params = convert.init_encoder_params(cfg, dtype=torch.float32)
        w = params["conv1_w"].requires_grad_()
        enc = AudioEncoder(dataclasses.replace(cfg, conv_chunksize=group))
        flat, _ = enc.batch(params, mel, torch.tensor([300, 170]))
        (flat.square().sum()).backward()
        grads.append(w.grad)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("count", ["encoder", "encoder_rows", "config"])
def test_valid_tokens_formula(count):
    """A clip's audio tokens, as the encoder, its per-row tensor form and
    ``config.audio_tokens`` (which sizes every prompt) give them."""
    cfg = AudioEncoderConfig()
    enc = AudioEncoder(cfg)
    tokens = {"encoder": enc.valid_tokens,
              "encoder_rows": lambda n: int(enc._valid_tokens_rows(
                  torch.tensor([n]))[0]),
              "config": lambda n: audio_tokens(cfg, n)}[count]
    for frames in [100, 260, 1000, 1040, 37, 99, 0]:
        tail = frames % 100
        expected = (frames // 100) * 13 + (
            feat_extract_output_length(tail) if tail else 0)
        assert tokens(frames) == expected


def _decoders(tied=True):
    """(JAX config, JAX params, port params, port config) of the tiny
    decoder, each package's from its own ``tiny_test_config()``."""
    cfg, tcfg = (dataclasses.replace(m.tiny_test_config().text,
                                     tie_word_embeddings=tied)
                 for m in (jconfig, tconfig))
    return (cfg, init_decoder_params(cfg, dtype=jnp.float32),
            convert.init_decoder_params(tcfg, dtype=torch.float32), tcfg)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("impl", ["auto", "fused", "scan"])
def test_prefill_and_decode_match_jax(rng, monkeypatch, tied, impl):
    """Prefill logits, slab contents, then three decode steps (logits and
    the slab writes) against the JAX decoder's scan path."""
    cfg, jp, tp, tcfg = _decoders(tied)
    p_len, true_len, s_max = 12, 9, 24
    hidden = (rng.standard_normal((1, p_len, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    jdec, tdec = JDecoder(cfg, max_position=64), TextDecoder(tcfg, 64)
    jlog, jcache = jdec.prefill(jp, jnp.asarray(hidden), jnp.arange(p_len),
                                JCache.zeros(cfg, 1, s_max, jnp.float32),
                                jnp.int32(true_len))
    cache = KVCache.zeros(tcfg, 1, s_max, dtype=torch.float32)
    tlog, cache = tdec.prefill(tp, T(hidden), torch.arange(p_len), cache,
                               true_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5, rtol=1e-5)

    monkeypatch.setenv("ASR_DECODE_IMPL", impl)
    monkeypatch.setenv("ASR_DECODE_ATTN", "kernel")  # K2's plain version
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1)
    for step in range(3):
        pos = true_len + step
        monkeypatch.setenv("ASR_DECODE_IMPL", "scan")
        jlog, jcache = jdec.decode_step(jp, jtok, jnp.int32(pos), jcache)
        monkeypatch.setenv("ASR_DECODE_IMPL", impl)
        tlog, cache = tdec.decode_step(tp, ttok, pos, cache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v),
                                   atol=1e-5, rtol=1e-5)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)
        assert int(ttok[0]) == int(jtok[0])


def test_decode_dense_attention_path_matches_kernel_path(rng, monkeypatch):
    _, _, tp, cfg = _decoders()
    tdec = TextDecoder(cfg, 64)
    cache = KVCache.zeros(cfg, 1, 32, dtype=torch.float32)
    cache.k.copy_(torch.randn(cache.k.shape, generator=torch.Generator()
                              .manual_seed(0)))
    cache.v.copy_(torch.randn(cache.v.shape, generator=torch.Generator()
                              .manual_seed(1)))
    tok = torch.tensor([7])
    outs = []
    for attn in ("dense", "kernel"):
        monkeypatch.setenv("ASR_DECODE_IMPL", "scan")
        monkeypatch.setenv("ASR_DECODE_ATTN", attn)
        c = KVCache(k=cache.k.clone(), v=cache.v.clone())
        outs.append(tdec.decode_step(tp, tok, 20, c)[0])
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def test_argmax_ties_break_on_first_index(monkeypatch):
    _, _, tp, cfg = _decoders()
    tdec = TextDecoder(cfg, 64)
    logits = torch.zeros(1, cfg.vocab_size)
    logits[0, [5, 9]] = 1.0
    monkeypatch.setattr(tdec, "decode_step",
                        lambda *a, **kw: (logits, None))
    tok, _ = tdec.decode_step_token(tp, torch.tensor([1]), 3, None)
    assert int(tok[0]) == int(np.argmax(logits.numpy()[0])) == 5


def test_unported_branches_raise(rng, monkeypatch):
    """Grouped int4 scales (int4g, a 3-D ``*_s``) run and match JAX's
    decode step, merged (K1's plain version) and unmerged (the per-layer
    path); blocked int4 (a 4-D ``*_q4``, the tensor-parallel layout) runs
    the per-layer path and matches JAX's decode step; the JAX engine's
    ``lm_fold_*`` copies raise, and so do per-row positions that are not
    one per row."""
    jcfg, jp, tp, cfg = _decoders()
    tdec, jdec = TextDecoder(cfg, 64), JDecoder(jcfg, max_position=64)
    kc = (rng.standard_normal((cfg.num_hidden_layers, 1,
                               cfg.num_key_value_heads, 16, cfg.head_dim))
          * 0.3).astype(np.float32)
    for merge in (True, False):
        kw = dict(bits=4, merge=merge, group_size=16, lm_bits=8)
        jq, tq = (jquant.quantize_decoder_params(jp, **kw),
                  tquant.quantize_decoder_params(tp, **kw))
        assert tq["layers"]["qkv_w_s" if merge else "q_w_s"].ndim == 3
        monkeypatch.setenv("ASR_DECODE_IMPL", "scan")
        jlog, _ = jdec.decode_step(jq, jnp.asarray([7], jnp.int32),
                                   jnp.int32(9), JCache(k=jnp.asarray(kc),
                                                        v=jnp.asarray(kc)))
        monkeypatch.setenv("ASR_DECODE_IMPL", "fused")
        tlog, _ = tdec.decode_step(tq, torch.tensor([7]), 9,
                                   KVCache(k=T(kc.copy()), v=T(kc.copy())))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                                   rtol=1e-5)
    cache = KVCache.zeros(cfg, 1, 16, dtype=torch.float32)
    q4 = rng.integers(-128, 128, (2, 64, 2, 16)).astype(np.int8)
    blocked = dict(tp, layers=dict(tp["layers"], q_w_q4=torch.from_numpy(q4),
                                   q_w_s=torch.full((2, 64), 0.01)))
    jblocked = dict(jp, layers=dict(jp["layers"], q_w_q4=jnp.asarray(q4),
                                    q_w_s=jnp.full((2, 64), 0.01)))
    jlog, _ = jdec.decode_step(jblocked, jnp.asarray([1], jnp.int32),
                               jnp.int32(3), JCache(k=jnp.asarray(kc),
                                                    v=jnp.asarray(kc)))
    tlog, _ = tdec.decode_step(blocked, torch.tensor([1]), 3,
                               KVCache(k=T(kc.copy()), v=T(kc.copy())))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=1e-5)
    folded = dict(tp, lm_fold_w=tp["lm_head"])
    with pytest.raises(NotImplementedError, match="lm_fold"):
        tdec.decode_step(folded, torch.tensor([1]), 3, cache)
    with pytest.raises(ValueError, match="one per row"):
        tdec.decode_step(tp, torch.tensor([1, 2]), torch.tensor([3, 4, 5]),
                         cache)
