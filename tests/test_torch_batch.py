"""Batched offline transcription: the port against the JAX package.

float32 on the tiny config: ``AsrEngine.transcribe_batch`` (right-aligned
prompts, one shared bucket, born-done pad rows, per-row EOS) gives the
JAX engine's greedy tokens exactly and the port's own single-utterance
tokens; the right-aligned prefill and decode steps, the per-row rotary
lookup and K1's plain version at B = 3 with per-row starts match JAX
within 1e-5; the multi-file CLI prints what the JAX CLI prints.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.config import tiny_test_config
from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.ops.pallas.decode_layer import (
    decode_layers_fused as jax_decode_layers_fused,
)
from qwen3_asr_rs_tpu.ops.rotary import RotaryTable as JRotary
from qwen3_asr_rs_tpu.runtime.engine import AsrEngine as JaxEngine
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.config import feat_extract_output_length
from qwen3_asr_rs_tpu_torch.features.mel import (
    log_mel_from_padded,
    pad_waveform,
)
from qwen3_asr_rs_tpu_torch.models.text_decoder import KVCache, TextDecoder
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
    decode_layers_fused,
)
from qwen3_asr_rs_tpu_torch.ops.rotary import RotaryTable
from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
from qwen3_asr_rs_tpu_torch.runtime.prompt import AUDIO_OFFSET, build_prompt
from qwen3_asr_rs_tpu_torch.weights import convert
from test_torch_engine import _Tok, _tiny
from test_torch_spec_decode import _draft_cfg, _draft_tuple

TOL = dict(atol=1e-5, rtol=1e-5)
T = torch.from_numpy

# clips of 1.0, 1.9, 1.25 and 0.56 s: one 4-chunk bucket, four prompt
# lengths, so every row of a batch starts at another slot
CLIPS = [(np.random.default_rng(i).standard_normal(n) * 0.1).astype(np.float32)
         for i, n in enumerate((16000, 30000, 20000, 9000))]


@functools.lru_cache(maxsize=None)
def _engines(kv_dtype, quantize=None):
    """(JAX engine, port engine) on one 4-chunk bucket, float32, 4 new
    tokens, the same seeded weights (quantized alike)."""
    cfg = _tiny()
    params = (init_encoder_params(cfg.audio, dtype=jnp.float32),
              init_decoder_params(cfg.text, dtype=jnp.float32))
    kw = dict(max_new_tokens=4, chunk_buckets=(4,), params=params,
              tokenizer=_Tok(), kv_dtype=kv_dtype, quantize=quantize)
    return (JaxEngine(model_dir=None, dtype=jnp.float32, config=cfg, **kw),
            AsrEngine(None, dtype=torch.float32, device="cpu",
                      config=_tiny(tconfig), **kw))


@functools.lru_cache(maxsize=None)
def _singles(kv_dtype):
    teng = _engines(kv_dtype)[1]
    return tuple(teng.transcribe_samples(c).raw_output for c in CLIPS)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_batch_tokens_match_jax_and_singles(n, kv_dtype):
    jeng, teng = _engines(kv_dtype)
    want = [r.raw_output for r in jeng.transcribe_batch(CLIPS[:n])]
    got = teng.transcribe_batch(CLIPS[:n])
    assert [r.raw_output for r in got] == want
    assert all(len(w.split()) == 4 for w in want)  # random weights: no EOS
    assert want == list(_singles(kv_dtype)[:n])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_batch_quantized_weights_match_jax(quantize, kv_dtype):
    """int8 / int4 weight trees under the batch, with a float and an int8
    slab: the JAX engine's greedy tokens, pad row included."""
    jeng, teng = _engines(kv_dtype, quantize)
    want = [r.raw_output for r in jeng.transcribe_batch(CLIPS[:3])]
    assert [r.raw_output for r in teng.transcribe_batch(CLIPS[:3])] == want
    assert teng.last_stats["n_gen"] == [4, 4, 4, 0]


def test_batch_of_three_pads_to_four_with_a_born_done_row():
    teng = _engines(None)[1]
    out = teng.transcribe_batch(CLIPS[:3])
    assert len(out) == 3
    assert teng.last_stats["n_gen"] == [4, 4, 4, 0]
    assert teng.last_stats["decode_steps"] == 3


def test_batch_languages_and_edge_cases():
    teng = _engines(None)[1]
    with pytest.raises(ValueError, match="languages"):
        teng.transcribe_batch(CLIPS[:2], languages=["english"])
    assert teng.transcribe_batch([]) == []
    forced = teng.transcribe_batch(CLIPS[:2], ["english", None])
    assert forced[0].language == "forced" and forced[1].language != "forced"


def _per_clip_embed(eng, clips, aligned, draft):
    """The per-clip loop the batched ``_embed_prompts`` replaced: each
    clip's own log-mel and ``encoder.__call__``, injected row by row."""
    cf = eng.config.audio.chunk_frames
    tpc = eng.config.audio.tokens_per_chunk
    bucket = eng._chunk_bucket(clips)
    p = eng._prompt_bucket(bucket)
    ids = torch.zeros((len(clips), p), dtype=torch.long)
    mels, runs, true_lens = [], [], []
    for i, clip in enumerate(clips):
        wave, n = pad_waveform(clip, bucket_frames=bucket * cf)
        mels.append((log_mel_from_padded(torch.from_numpy(wave), n,
                                         eng.mel_filters), n))
        tail = n % cf
        n_audio = (n // cf) * tpc + (feat_extract_output_length(tail)
                                     if tail else 0)
        prompt = build_prompt(n_audio, None, eng.tokenizer)
        start = p - len(prompt) if aligned else 0
        ids[i, start: start + len(prompt)] = torch.tensor(prompt)
        runs.append((start + AUDIO_OFFSET, n_audio))
        true_lens.append(len(prompt))
    models = [(eng.encoder, eng.enc_params, eng.decoder, eng.dec_params)]
    if draft is not None:
        models.append((draft.encoder, draft.enc_params, draft.decoder,
                       draft.dec_params))
    hidden = []
    for enc, enc_params, dec, dec_params in models:
        h = dec.embed(dec_params, ids)
        for i, ((mel, n), (at, n_audio)) in enumerate(zip(mels, runs)):
            embeds, _ = enc(enc_params, mel, n)
            h[i, at: at + n_audio] = embeds[:n_audio]
        hidden.append(h)
    return hidden, true_lens


@functools.lru_cache(maxsize=None)
def _draft_engine():
    """The tiny port engine with a smaller cross-model draft (its own
    encoder, embeddings and widths), on 1- and 4-chunk buckets."""
    cfg, dcfg = _tiny(tconfig), _draft_cfg()
    return AsrEngine(None, dtype=torch.float32, device="cpu",
                     max_new_tokens=4, chunk_buckets=(1, 4), config=cfg,
                     params=(convert.init_encoder_params_np(cfg.audio),
                             convert.init_decoder_params_np(cfg.text)),
                     tokenizer=_Tok(), draft_model=_draft_tuple(dcfg))


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "draft"])
@pytest.mark.parametrize("clips,aligned", [
    ((0, 1, 2, 2), True), ((3,), False)], ids=["b3-padded-to-4", "b1"])
def test_embed_prompts_matches_the_per_clip_loop(monkeypatch, clips,
                                                 aligned, draft):
    """One batched log-mel and one ``encoder.batch`` per model (the
    draft's too) give the per-clip loop's hidden states and true prompt
    lengths: three clips of mixed lengths padded to four rows by
    repeating the last, right-aligned, and a lone clip left-aligned."""
    eng = _draft_engine()
    bundle = eng.draft_bundle if draft else None
    clips = [CLIPS[i] for i in clips]
    calls = []

    def counted(batch):
        def call(params, mel, n_frames):
            calls.append(mel.shape[0])
            return batch(params, mel, n_frames)
        return call

    for model in [eng.encoder] + ([bundle.encoder] if draft else []):
        monkeypatch.setattr(model, "batch", counted(model.batch))
    hidden, true_lens, d_hidden = eng._embed_prompts(
        clips, [None] * len(clips), aligned=aligned, draft=bundle)
    assert calls == [len(clips)] * (2 if draft else 1)
    want, want_lens = _per_clip_embed(eng, clips, aligned, bundle)
    assert true_lens == want_lens
    np.testing.assert_allclose(hidden.numpy(), want[0].numpy(), **TOL)
    if draft:
        np.testing.assert_allclose(d_hidden.numpy(), want[1].numpy(), **TOL)
    else:
        assert d_hidden is None


def test_lookup_batch_matches_jax(rng):
    cfg = tiny_test_config().text
    kw = dict(head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
              mrope_section=cfg.mrope_section(), max_position=64)
    pos = rng.integers(0, 64, (3, 5))
    jc, js = JRotary(**kw).lookup_batch(jnp.asarray(pos))
    tc, ts = RotaryTable(**kw).lookup_batch(T(pos))
    assert tc.shape == (3, 5, cfg.head_dim)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("impl,attn", [("scan", "dense"), ("scan", "kernel"),
                                       ("fused", "dense")])
def test_prefill_and_decode_aligned_match_jax(rng, monkeypatch, impl, attn,
                                              quantized):
    """Right-aligned prefill logits and slab, then three aligned decode
    steps (logits, slab) against the JAX decoder's scan path, with a
    float or an int8 slab; ``fused`` runs K1's plain version, ``kernel``
    K2's."""
    cfg, tcfg = tiny_test_config().text, tconfig.tiny_test_config().text
    jp = init_decoder_params(cfg, dtype=jnp.float32)
    tp = convert.init_decoder_params(tcfg, dtype=torch.float32)
    jdec, tdec = JDecoder(cfg, max_position=64), TextDecoder(tcfg, 64)
    b, p, s_max = 3, 12, 20
    kv_start = np.asarray([0, 3, 7], np.int32)
    hidden = (rng.standard_normal((b, p, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    jlog, jcache = jdec.prefill_aligned(
        jp, jnp.asarray(hidden), jnp.asarray(kv_start),
        JCache.zeros(cfg, b, s_max, jnp.float32, quantized=quantized))
    cache = KVCache.zeros(tcfg, b, s_max, torch.float32, quantized=quantized)
    tlog, cache = tdec.prefill_aligned(tp, T(hidden), T(kv_start), cache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(cache.k.numpy().astype(np.float32),
                               np.asarray(jcache.k, np.float32), **TOL)

    tok = torch.argmax(tlog, -1)
    for step in range(3):
        monkeypatch.setenv("ASR_DECODE_IMPL", "scan")
        monkeypatch.setenv("ASR_DECODE_ATTN", "dense")
        jlog, jcache = jdec.decode_step_aligned(
            jp, jnp.asarray(tok.numpy(), jnp.int32), jnp.int32(p + step),
            jnp.asarray(kv_start), jcache)
        monkeypatch.setenv("ASR_DECODE_IMPL", impl)
        monkeypatch.setenv("ASR_DECODE_ATTN", attn)
        tlog, cache = tdec.decode_step_aligned(tp, tok, p + step,
                                               T(kv_start), cache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_allclose(cache.v.numpy().astype(np.float32),
                                   np.asarray(jcache.v, np.float32), **TOL)
        tok = torch.argmax(tlog, -1)
        assert tok.tolist() == np.asarray(jnp.argmax(jlog, -1)).tolist()


def test_decode_layers_plain_batched_matches_pallas(rng):
    """K1's plain version at B = 3 with per-row starts and a shared end
    against the Pallas megakernel in interpret mode."""
    cfg = tiny_test_config().text
    jparams = init_decoder_params(cfg, dtype=jnp.float32)
    layers = convert.to_torch(
        convert.init_decoder_params_np(tconfig.tiny_test_config().text),
        torch.float32)["layers"]
    b, s_max, end = 3, 48, 40
    start = np.asarray([0, 10, 25], np.int32)
    shape = (cfg.num_hidden_layers, b, cfg.num_key_value_heads, s_max,
             cfg.head_dim)
    kc = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    vc = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    x = rng.standard_normal((b, cfg.hidden_size)).astype(np.float32)
    ang = rng.uniform(0, 6, (b, cfg.head_dim // 2)).astype(np.float32)
    cos = np.concatenate([np.cos(ang)] * 2, -1)
    sin = np.concatenate([np.sin(ang)] * 2, -1)
    ref = jax_decode_layers_fused(
        jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jparams["layers"],
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(start), jnp.int32(end),
        eps=cfg.rms_norm_eps, interpret=True,
    )
    n = decode_layers_fused.launches
    got = decode_layers_fused(T(x), T(cos), T(sin), layers, T(kc), T(vc),
                              T(start), end, eps=cfg.rms_norm_eps)
    assert decode_layers_fused.launches == n
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.fixture
def model_and_wavs(tmp_path):
    from test_audio_io import write_wav_pcm16
    from test_weights_roundtrip import write_word_tokenizer

    from qwen3_asr_rs_tpu.weights.export import save_checkpoint

    cfg = _tiny()
    model = tmp_path / "model"
    save_checkpoint(model, init_encoder_params(cfg.audio, dtype=jnp.float32),
                    init_decoder_params(cfg.text, dtype=jnp.float32), cfg)
    write_word_tokenizer(model)
    wavs = []
    for i, clip in enumerate(CLIPS[:3]):
        wavs.append(tmp_path / f"clip{i}.wav")
        write_wav_pcm16(wavs[-1], clip, 16000)
    return model, wavs


def test_cli_multi_file_matches_jax_cli(model_and_wavs, capsys, monkeypatch):
    from qwen3_asr_rs_tpu.cli import main as jax_main
    from qwen3_asr_rs_tpu_torch.cli import main

    model, wavs = model_and_wavs
    monkeypatch.setenv("ASR_MAX_NEW_TOKENS", "4")
    monkeypatch.setenv("ASR_DTYPE", "float32")
    monkeypatch.setenv("ASR_DEVICE", "cpu")
    argv = [str(a) for a in (model, *wavs, "--language", "english")]
    for kv in ("bf16", "int8"):
        monkeypatch.setenv("ASR_KV", kv)
        rc = main(argv)
        out = capsys.readouterr().out
        assert rc == 0 and out.count("File: ") == 3
        assert out.count("Language: forced") == 3
        assert jax_main(argv) == 0
        assert out == capsys.readouterr().out
