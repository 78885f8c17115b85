"""The whole slice: port AsrEngine and CLI vs the JAX engine and CLI.

float32 greedy tokens must be equal exactly, on tiny_test_config() and on
two layers at the real 0.6B widths. bf16 first-step logits agree within
a stated tolerance. Each engine gets its own package's config, made by
the same recipe (``_tiny``, ``_real2``).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.features.mel import log_mel_from_padded
from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.runtime.engine import AsrEngine as JaxEngine
from qwen3_asr_rs_tpu.runtime.prompt import AUDIO_OFFSET
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine


class _Tok:
    def encode(self, s):
        return [101] * 4

    def decode(self, ids):
        return " ".join(map(str, ids))


def _with_layers(cfg, text_layers=None, audio_layers=None, vocab=None):
    text, audio = cfg.text, cfg.audio
    if text_layers:
        text = dataclasses.replace(text, num_hidden_layers=text_layers)
    if vocab:
        text = dataclasses.replace(text, vocab_size=vocab)
    if audio_layers:
        audio = dataclasses.replace(audio, encoder_layers=audio_layers)
    return dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config, text_config=text, audio_config=audio))


def _tiny(module=jconfig):
    """``tiny_test_config()`` of a package's config ``module`` with the
    full vocabulary: prompt special-token ids (151643+) must be in-vocab."""
    return _with_layers(module.tiny_test_config(), vocab=151936)


def _real2(module=jconfig):
    """The real 0.6B widths, two decoder and two encoder layers."""
    return _with_layers(module.AsrConfig(), text_layers=2, audio_layers=2)


def _engines(recipe, jdtype, tdtype, max_new, buckets, quantize=None):
    """(JAX engine, port engine) on the configs ``recipe(module)`` gives
    for each package's config module, with the same weights."""
    cfg, tcfg = recipe(jconfig), recipe(tconfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    enc = init_encoder_params(cfg.audio, dtype=jnp.float32)
    dec = init_decoder_params(cfg.text, dtype=jnp.float32)
    jeng = JaxEngine(model_dir=None, dtype=jdtype, max_new_tokens=max_new,
                     chunk_buckets=buckets, config=cfg,
                     params=(enc, dec) if jdtype == jnp.float32 else
                     tuple(__import__("jax").tree_util.tree_map(
                         lambda a: a.astype(jdtype), p) for p in (enc, dec)),
                     tokenizer=_Tok(), quantize=quantize)
    teng = AsrEngine(None, dtype=tdtype, max_new_tokens=max_new,
                     chunk_buckets=buckets, config=tcfg, params=(enc, dec),
                     tokenizer=_Tok(), device="cpu", quantize=quantize)
    return jeng, teng


def _jax_prefill_logits(jeng, samples):
    """The JAX engine's pre-decode graph, step by step (engine.py:656-830)."""
    cfg = jeng.config
    cf, tpc = cfg.audio.chunk_frames, cfg.audio.tokens_per_chunk
    from qwen3_asr_rs_tpu.features.mel import num_mel_frames, pad_waveform
    from qwen3_asr_rs_tpu.runtime.prompt import build_prompt

    chunks = jeng._pick_bucket(num_mel_frames(len(samples)))
    p = jeng._prompt_bucket(chunks)
    wave, n_true = pad_waveform(samples, bucket_frames=chunks * cf)
    n_audio = int(jeng.encoder.valid_tokens(jnp.int32(n_true)))
    prompt = build_prompt(n_audio, None, None)
    ids = np.zeros(p, np.int32)
    ids[: len(prompt)] = prompt
    mel = log_mel_from_padded(jnp.asarray(wave), n_true,
                              jeng.frontend.mel_filters)
    audio, _ = jeng.encoder(jeng.enc_params, mel, jnp.int32(n_true))
    hidden = jeng.decoder.embed(jeng.dec_params, jnp.asarray(ids)[None])
    hidden = hidden.at[0, AUDIO_OFFSET:AUDIO_OFFSET + n_audio].set(
        audio[:n_audio].astype(hidden.dtype))
    logits, _ = jeng.decoder.prefill(
        jeng.dec_params, hidden, jnp.arange(p),
        JCache.zeros(cfg.text, 1, p, dtype=hidden.dtype), jnp.int32(len(prompt)))
    return np.asarray(logits)


@pytest.fixture
def samples():
    return (np.random.default_rng(1).standard_normal(20000) * 0.1).astype(
        np.float32)


def test_tiny_slice_f32_tokens_and_logits_match_jax(samples):
    jeng, teng = _engines(_tiny, jnp.float32, torch.float32, 8, (2,))
    ref = jeng.transcribe_samples(samples)
    got = teng.transcribe_samples(samples)
    assert got.raw_output == ref.raw_output
    assert (got.language, got.text) == (ref.language, ref.text)
    logits, _, _ = teng.prefill(samples)
    np.testing.assert_allclose(logits.numpy(),
                               _jax_prefill_logits(jeng, samples),
                               atol=1e-5, rtol=1e-5)
    # one decode step per emitted token, except the last
    assert teng.last_stats["decode_steps"] == len(got.raw_output.split()) - 1


def test_real_dims_two_layers_f32_tokens_match_jax():
    """Real 0.6B widths (head_dim 128, hidden 1024, ffn 3072, 16Q/8KV,
    vocab 151936), two layers each, as __graft_entry__.py's parity gate."""
    samples = (np.random.default_rng(7).standard_normal(12000) * 0.1).astype(
        np.float32)
    jeng, teng = _engines(_real2, jnp.float32, torch.float32, 3, (1,))
    assert teng.transcribe_samples(samples).raw_output == (
        jeng.transcribe_samples(samples).raw_output)


def test_tiny_slice_bf16_first_step_logits(samples):
    """bf16 rounds at different places in the two frameworks (both keep
    the lm_head's logits in float32); through two layers the first-step
    logits stay within 0.02 absolute at |logits| < 2."""
    jeng, teng = _engines(_tiny, jnp.bfloat16, torch.bfloat16, 2, (2,))
    ref = _jax_prefill_logits(jeng, samples).astype(np.float32)
    logits, _, _ = teng.prefill(samples)
    assert np.abs(ref).max() < 2
    np.testing.assert_allclose(logits.numpy(), ref, atol=2e-2, rtol=0)


@pytest.mark.parametrize("quantize", ["int8", "int4", "lm8"])
def test_tiny_slice_quantized_f32_tokens_match_jax(samples, quantize):
    """AsrEngine(quantize=...) against the JAX engine: float32 greedy
    tokens equal, prefill logits within 1e-5 (the int4 lm_head through
    K4's plain version and the Pallas matvec in interpret mode)."""
    jeng, teng = _engines(_tiny, jnp.float32, torch.float32, 8, (2,),
                          quantize)
    assert "lm_head" not in teng.dec_params
    assert teng.transcribe_samples(samples).raw_output == (
        jeng.transcribe_samples(samples).raw_output)
    logits, _, _ = teng.prefill(samples)
    np.testing.assert_allclose(logits.numpy(),
                               _jax_prefill_logits(jeng, samples),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quantize", ["int8", "int4", "lm8"])
def test_real_dims_two_layers_quantized_f32_tokens_match_jax(quantize):
    samples = (np.random.default_rng(7).standard_normal(12000) * 0.1).astype(
        np.float32)
    jeng, teng = _engines(_real2, jnp.float32, torch.float32, 3, (1,),
                          quantize)
    assert teng.transcribe_samples(samples).raw_output == (
        jeng.transcribe_samples(samples).raw_output)


def test_unmerged_and_unported_quant_modes(samples, monkeypatch):
    """Unmerged int8 and int4g (the per-layer decode path in both
    packages) give the JAX engine's tokens; unknown modes raise."""
    monkeypatch.setenv("ASR_MERGE_QKV", "0")
    jeng, teng = _engines(_tiny, jnp.float32, torch.float32, 4, (2,),
                          "int8")
    assert "q_w_q" in teng.dec_params["layers"]
    assert teng.transcribe_samples(samples).raw_output == (
        jeng.transcribe_samples(samples).raw_output)
    jeng, teng = _engines(_tiny, jnp.float32, torch.float32, 4, (2,),
                          "int4g")
    assert teng.dec_params["layers"]["q_w_s"].ndim == 3
    assert teng.transcribe_samples(samples).raw_output == (
        jeng.transcribe_samples(samples).raw_output)
    with pytest.raises(ValueError, match="unknown quantize"):
        teng._quantize_params(teng.dec_params, "int3")


def test_engine_limits_and_unported_paths(samples):
    _, teng = _engines(_tiny, jnp.float32, torch.float32, 4, (1, 2))
    with pytest.raises(ValueError, match="largest bucket"):
        teng.transcribe_samples(np.zeros(16000 * 3, np.float32))
    # a batch of two identical rows gives each row the same tokens
    pair = teng.transcribe_batch([samples, samples])
    assert len(pair) == 2 and pair[0].raw_output == pair[1].raw_output
    assert teng.transcribe_batch([]) == []
    assert teng.transcribe_batch([samples])[0].raw_output == (
        teng.transcribe_samples(samples).raw_output)


# --------------------------------------------------------------------- #
# CLI on a synthetic checkpoint


@pytest.fixture
def model_and_wav(tmp_path):
    from test_audio_io import write_wav_pcm16
    from test_weights_roundtrip import write_word_tokenizer

    from qwen3_asr_rs_tpu.weights.export import save_checkpoint

    cfg = _tiny()
    model = tmp_path / "model"
    save_checkpoint(model, init_encoder_params(cfg.audio, dtype=jnp.float32),
                    init_decoder_params(cfg.text, dtype=jnp.float32), cfg)
    write_word_tokenizer(model)
    wav = tmp_path / "a.wav"
    write_wav_pcm16(wav, np.random.default_rng(3).standard_normal(16800) * 0.1,
                    24000)
    return model, wav


def _run_cli(main, argv, capsys):
    rc = main([str(a) for a in argv])
    out, err = capsys.readouterr()
    return rc, out, err


def test_cli_matches_jax_cli(model_and_wav, capsys, monkeypatch):
    from qwen3_asr_rs_tpu.cli import main as jax_main
    from qwen3_asr_rs_tpu_torch.cli import main

    model, wav = model_and_wav
    monkeypatch.setenv("ASR_MAX_NEW_TOKENS", "4")
    monkeypatch.setenv("ASR_DTYPE", "float32")
    monkeypatch.setenv("ASR_DEVICE", "cpu")
    rc, out, _ = _run_cli(main, [model, wav], capsys)
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("Language: ") and lines[1].startswith("Text:")
    jrc, jout, _ = _run_cli(jax_main, [model, wav], capsys)
    assert (rc, out) == (jrc, jout)
    for quant, lm_bits in (("int8", "4"), ("int4", "8")):
        monkeypatch.setenv("ASR_QUANT", quant)
        monkeypatch.setenv("ASR_LM_BITS", lm_bits)
        rc, qout, _ = _run_cli(main, [model, wav], capsys)
        jrc, jout, _ = _run_cli(jax_main, [model, wav], capsys)
        assert rc == 0 and (rc, qout) == (jrc, jout)
    monkeypatch.delenv("ASR_QUANT")
    monkeypatch.delenv("ASR_LM_BITS")

    rc, out, _ = _run_cli(main, [model, wav, "english"], capsys)
    assert rc == 0 and out.startswith("Language: forced\n")
    rc, out, _ = _run_cli(main, [model, wav, wav], capsys)
    assert rc == 0 and out.count("File: ") == 2


def test_cli_errors(model_and_wav, capsys, monkeypatch, tmp_path):
    from qwen3_asr_rs_tpu_torch.cli import main

    model, wav = model_and_wav
    monkeypatch.setenv("ASR_DEVICE", "cpu")
    cases = [
        ([model], "Usage"),
        ([model, tmp_path / "missing.wav"], "Error: Audio file not found"),
        ([tmp_path / "nomodel", wav], "Error: Model directory not found"),
        ([model, wav, "--draft", "fp8"], "Error: unknown --draft mode"),
        ([model, wav, "--language"], "Error: --language needs a value"),
    ]
    for argv, msg in cases:
        rc, out, err = _run_cli(main, argv, capsys)
        assert rc == 1 and msg in err and out == "", argv
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF....WAVEjunk")
    rc, out, err = _run_cli(main, [model, bad], capsys)
    assert rc == 1 and err.startswith("Error: ") and err.count("\n") == 1


def test_cli_warns_on_existing_language_like_file(model_and_wav, capsys,
                                                  monkeypatch, caplog):
    """A second trailing argument that names an existing file without a
    "." is taken as audio, with the JAX CLI's warning that suggests
    --language."""
    import logging
    import shutil

    from qwen3_asr_rs_tpu.cli import main as jax_main
    from qwen3_asr_rs_tpu_torch.cli import main

    model, wav = model_and_wav
    monkeypatch.setenv("ASR_MAX_NEW_TOKENS", "2")
    monkeypatch.setenv("ASR_DTYPE", "float32")
    monkeypatch.setenv("ASR_DEVICE", "cpu")
    lang_file = wav.parent / "english"
    shutil.copy(wav, lang_file)
    want = (f"treating {str(lang_file)!r} as an audio file because it "
            "exists; pass --language")
    logs = {}
    for name, fn in (("port", main), ("jax", jax_main)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="asr"):
            rc, out, _ = _run_cli(fn, [model, wav, lang_file], capsys)
        assert rc == 0 and out.count("File: ") == 2, name
        logs[name] = [r.getMessage() for r in caplog.records
                      if r.levelno == logging.WARNING and r.name == "asr"]
        assert any(m.startswith(want) for m in logs[name]), (name, logs)
    assert logs["port"] == logs["jax"]


def _error_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith("Error:")]


@pytest.fixture
def words_model_and_wav(model_and_wav, tmp_path):
    """The synthetic checkpoint with an embedding / lm_head table that is
    zero but for the rows of "hello" (14) and "world" (15), u and -u: every
    token the model emits is one of the two words."""
    from qwen3_asr_rs_tpu.weights.export import save_checkpoint
    from test_weights_roundtrip import write_word_tokenizer

    cfg = _tiny()
    _, wav = model_and_wav
    table = np.zeros((cfg.text.vocab_size, cfg.text.hidden_size), np.float32)
    table[14] = np.random.default_rng(4).standard_normal(cfg.text.hidden_size)
    table[15] = -table[14]
    dec = dict(init_decoder_params(cfg.text, dtype=jnp.float32),
               embed=jnp.asarray(table), lm_head=jnp.asarray(table))
    model = tmp_path / "words_model"
    save_checkpoint(model, init_encoder_params(cfg.audio, dtype=jnp.float32),
                    dec, cfg)
    write_word_tokenizer(model)
    return model, wav


def test_cli_timestamps_match_jax_cli(words_model_and_wav, capsys,
                                      monkeypatch):
    """--timestamps: the `[start - end] text` segment line and the
    indented word lines, single file and batched, as the JAX CLI prints."""
    from qwen3_asr_rs_tpu.cli import main as jax_main
    from qwen3_asr_rs_tpu_torch.cli import main

    model, wav = words_model_and_wav
    monkeypatch.setenv("ASR_MAX_NEW_TOKENS", "3")
    monkeypatch.setenv("ASR_DTYPE", "float32")
    monkeypatch.setenv("ASR_DEVICE", "cpu")
    for argv in ([model, wav, "--timestamps"],
                 [model, wav, wav, "--timestamps"]):
        rc, out, _ = _run_cli(main, argv, capsys)
        jrc, jout, _ = _run_cli(jax_main, argv, capsys)
        assert rc == 0 and (rc, out) == (jrc, jout)
        assert out.count("\n[0.00 - 0.70] ") == len(argv) - 2
        assert out.count("\n  [") == 3 * (len(argv) - 2)


def test_cli_sampling_flags_match_jax_cli(model_and_wav, capsys,
                                          monkeypatch):
    """The sampling flags' errors are the JAX CLI's; a sampled run is
    deterministic per seed; flags without a temperature decode greedily."""
    from qwen3_asr_rs_tpu.cli import main as jax_main
    from qwen3_asr_rs_tpu_torch.cli import main

    model, wav = model_and_wav
    monkeypatch.setenv("ASR_MAX_NEW_TOKENS", "3")
    monkeypatch.setenv("ASR_DTYPE", "float32")
    monkeypatch.setenv("ASR_DEVICE", "cpu")
    for extra in (["--top-p", "0"], ["--temperature", "-1"],
                  ["--top-k=-2", "--temperature", "1"], ["--top-k", "abc"],
                  ["--temperature=x"], ["--seed"]):
        rc, out, err = _run_cli(main, [model, wav, *extra], capsys)
        jrc, jout, jerr = _run_cli(jax_main, [model, wav, *extra], capsys)
        assert rc == jrc == 1 and out == jout == "", extra
        assert _error_lines(err) == _error_lines(jerr) != [], extra
    sampled = [model, wav, "--temperature", "0.8", "--top-k", "20",
               "--top-p=0.9", "--seed", "3"]
    rc, out, _ = _run_cli(main, sampled, capsys)
    assert rc == 0 and (rc, out) == _run_cli(main, sampled, capsys)[:2]
    greedy_out = _run_cli(main, [model, wav], capsys)[1]
    rc, out, _ = _run_cli(main, [model, wav, "--seed", "5"], capsys)
    jrc, jout, _ = _run_cli(jax_main, [model, wav, "--seed", "5"], capsys)
    assert rc == jrc == 0 and out == jout == greedy_out


def test_cli_metrics_keys_match_jax_cli(model_and_wav, capsys, monkeypatch,
                                        tmp_path):
    """ASR_METRICS=<path>: the stage timers as JSON, the JAX CLI's keys."""
    from collections import defaultdict

    import json

    from qwen3_asr_rs_tpu.cli import main as jax_main
    from qwen3_asr_rs_tpu.utils import tracing as jtracing
    from qwen3_asr_rs_tpu_torch.cli import main
    from qwen3_asr_rs_tpu_torch.utils import tracing

    model, wav = model_and_wav
    monkeypatch.setenv("ASR_MAX_NEW_TOKENS", "2")
    monkeypatch.setenv("ASR_DTYPE", "float32")
    monkeypatch.setenv("ASR_DEVICE", "cpu")
    data = {}
    for name, fn, mod in (("port", main, tracing), ("jax", jax_main,
                                                   jtracing)):
        for attr in ("totals", "counts"):
            monkeypatch.setattr(mod.GLOBAL_TIMINGS, attr,
                                defaultdict(getattr(mod.GLOBAL_TIMINGS,
                                                    attr).default_factory))
        path = tmp_path / f"{name}.json"
        monkeypatch.setenv("ASR_METRICS", str(path))
        assert _run_cli(fn, [model, wav, wav], capsys)[0] == 0
        data[name] = json.loads(path.read_text())
    assert set(data["port"]) == set(data["jax"]) == {"device_dispatch"}
    assert data["port"]["device_dispatch"]["count"] == 1
    assert set(data["port"]["device_dispatch"]) == {"total_ms", "count"}
