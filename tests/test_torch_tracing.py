"""Stage timers and spans, the metrics dump and error rates:
the port's ``utils/tracing.py`` and ``utils/wer.py`` against the JAX
package's.

The cases of ``tests/test_tracing.py`` and of
``tests/test_wer_and_server.py::test_edit_distance/test_wer_cer``, run on
both packages; the summaries of the same timings agree; the engine's
``device_dispatch`` timer counts each transcription. The tracer: off, a
span enters no profiler annotation, reads no clock and writes nothing;
on (``ASR_TRACE=1``) spans nest; under a CPU profiler each span is a
host event over the operators run inside it, and the registry counts
the profiles its spans came from; the engine's prefill spans count per
call and per padded row and sum to no more than its
``prefill_seconds``; the CLI's ``ASR_METRICS`` dump carries them under
``ASR_TRACE=1`` and only then.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.utils import tracing as jtracing
from qwen3_asr_rs_tpu.utils import wer as jwer
from qwen3_asr_rs_tpu_torch.utils import tracing, wer


def test_stage_timer_accumulates():
    t = tracing.Timings()
    with tracing.stage_timer("alpha", t):
        pass
    with tracing.stage_timer("alpha", t):
        pass
    with tracing.stage_timer("beta", t):
        pass
    assert t.counts["alpha"] == 2
    assert t.counts["beta"] == 1
    assert "alpha" in t.summary()


def test_summary_matches_jax():
    t, j = tracing.Timings(), jtracing.Timings()
    for stage, sec in (("a", 0.5), ("b", 1.25), ("a", 0.25)):
        t.add(stage, sec)
        j.add(stage, sec)
    assert t.summary() == j.summary()


def test_dump_metrics(tmp_path):
    with tracing.stage_timer("gamma_stage"):
        pass
    out = tmp_path / "m.json"
    data = tracing.dump_metrics(str(out))
    assert "gamma_stage" in data
    on_disk = json.loads(out.read_text())
    assert on_disk["gamma_stage"]["count"] >= 1
    assert set(on_disk["gamma_stage"]) == {"total_ms", "count"}


def test_engine_times_each_dispatch():
    from test_torch_engine import _engines, _tiny

    _, teng = _engines(_tiny, jnp.float32, torch.float32, 2, (2,))
    before = tracing.GLOBAL_TIMINGS.counts["device_dispatch"]
    clip = (np.random.default_rng(2).standard_normal(16000) * 0.1).astype(
        np.float32)
    teng.transcribe_samples(clip)
    teng.transcribe_batch([clip, clip])
    assert tracing.GLOBAL_TIMINGS.counts["device_dispatch"] == before + 2


# ------------------------------------------------------------ the tracer

ROOT = Path(__file__).resolve().parents[1]
PREFILL_SPANS = ("prefill.encode", "prefill.mel", "prefill.encoder",
                 "prefill.decoder")


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry in place of ``GLOBAL_TIMINGS``, the tracer off."""
    t = tracing.Timings()
    monkeypatch.setattr(tracing, "GLOBAL_TIMINGS", t)
    monkeypatch.setattr(tracing, "_enabled", False)
    monkeypatch.setattr(tracing, "_in_profile", False)
    return t


EMPTY = {"spans": {}, "counters": {}, "profiles": 0, "unprofiled": 0}


def _boom(*a, **k):
    raise AssertionError("entered while the tracer is off")


def test_off_spans_enter_no_annotation_and_read_no_clock(registry,
                                                         monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _boom)
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(
        perf_counter=_boom))
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    assert not registry.spans
    monkeypatch.undo()
    monkeypatch.setattr(tracing, "GLOBAL_TIMINGS", registry)
    monkeypatch.setattr(tracing, "_enabled", False)
    with tracing.stage_timer("stage"):
        with tracing.span("a"):
            pass
    assert dict(registry.counts) == {"stage": 1}
    assert tracing.snapshot() == EMPTY


def test_enabled_spans_nest(registry, monkeypatch):
    monkeypatch.setattr(tracing, "_enabled", True)
    for _ in range(2):
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(64).sum()
    monkeypatch.setattr(tracing, "_enabled", False)
    snap = tracing.snapshot()
    assert {n: s["count"] for n, s in snap["spans"].items()} == {
        "outer": 2, "inner": 2}
    assert snap["spans"]["outer"]["seconds"] >= \
        snap["spans"]["inner"]["seconds"] > 0
    assert (snap["profiles"], snap["unprofiled"]) == (0, 4)
    with tracing.span("after"):
        pass
    assert tracing.snapshot() == snap


@pytest.mark.parametrize("value", ["1", None])
def test_asr_trace_is_read_at_import(value):
    env = {k: v for k, v in os.environ.items() if k != "ASR_TRACE"}
    if value is not None:
        env["ASR_TRACE"] = value
    code = ("import json\n"
            "from qwen3_asr_rs_tpu_torch.utils import tracing\n"
            "with tracing.span('s'):\n"
            "    pass\n"
            "print(json.dumps([tracing._enabled, tracing.snapshot()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    on, snap = json.loads(out.strip().splitlines()[-1])
    assert on == (value == "1")
    if on:
        assert snap["spans"]["s"]["count"] == 1
        assert snap["unprofiled"] == 1
    else:
        assert snap == EMPTY


def test_spans_on_the_profilers_clock(registry):
    """With the tracer otherwise off, a profiler turns it on: each span
    and stage timer is a host event of its name (not a user annotation,
    for which Kineto would add a device event) over the operators run
    inside it, and the registry records the spans."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.stage_timer("t.stage"):
            with tracing.span("t.outer"):
                torch.ones(256).sum()
                with tracing.span("t.inner"):
                    torch.ones(128).mul(2)
    ev = {}
    for e in prof.profiler.kineto_results.events():
        ev.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e))

    def inside(name, outer):
        (a, b, _), = ev[outer]
        return all(a <= s and t <= b for s, t, _ in ev[name])

    for name in ("t.stage", "t.outer", "t.inner"):
        (_, _, e), = ev[name]
        assert e.device_type() == torch.autograd.DeviceType.CPU
        if hasattr(e, "is_user_annotation"):
            assert not e.is_user_annotation()
    assert inside("t.outer", "t.stage") and inside("t.inner", "t.outer")
    assert inside("aten::sum", "t.outer") and inside("aten::mul", "t.inner")
    snap = tracing.snapshot()
    assert set(snap["spans"]) == {"t.outer", "t.inner"}
    assert (snap["profiles"], snap["unprofiled"]) == (1, 0)
    with tracing.span("t.after"):
        pass
    assert "t.after" not in tracing.snapshot()["spans"]


def test_each_profile_is_counted_once(registry):
    """A profile counts on its first span or stage timer; a stage timer
    run with no profiler ends it, so a second profile counts again."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.stage_timer("t.stage"):
            with tracing.span("t.a"):
                pass
        with tracing.span("t.b"):
            pass
    assert registry.profiles == 1
    with profile(activities=[ProfilerActivity.CPU]):
        pass  # no span ran in it: not counted
    with tracing.stage_timer("t.stage"):  # no profiler: the first ended
        pass
    assert registry.profiles == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("t.a"):
            pass
    snap = tracing.snapshot()
    assert (snap["profiles"], snap["unprofiled"]) == (2, 0)
    assert snap["spans"]["t.a"]["count"] == 2


def _tiny_engine(**kw):
    from qwen3_asr_rs_tpu_torch import config as tconfig
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np,
        init_encoder_params_np,
    )
    from test_torch_engine import _Tok

    cfg = tconfig.tiny_test_config()
    cfg = dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config, text_config=dataclasses.replace(
            cfg.text, vocab_size=151936)))
    return AsrEngine(None, dtype=torch.float32, max_new_tokens=3,
                     chunk_buckets=(2,), config=cfg,
                     params=(init_encoder_params_np(cfg.audio),
                             init_decoder_params_np(cfg.text)),
                     tokenizer=_Tok(), device="cpu", **kw)


@pytest.mark.parametrize("n_clips,rows,kw", [
    (1, 1, {}), (3, 4, {}), (1, 1, {"speculative": "bf16", "spec_k": 2})],
    ids=["b1", "b3-padded-to-4", "speculative"])
def test_engine_prefill_spans(registry, monkeypatch, n_clips, rows, kw):
    eng = _tiny_engine(**kw)
    rng = np.random.default_rng(5)
    clips = [(rng.standard_normal(12000 + 2000 * i) * 0.1).astype(np.float32)
             for i in range(n_clips)]
    monkeypatch.setattr(tracing, "_enabled", True)
    eng.transcribe_batch(clips)
    monkeypatch.setattr(tracing, "_enabled", False)
    spans = tracing.snapshot()["spans"]
    # the mel and the encoder run once per call over all its rows
    assert len(eng.last_stats["n_gen"]) == rows
    assert {n: spans[n]["count"] for n in PREFILL_SPANS} == {
        "prefill.encode": 1, "prefill.mel": 1, "prefill.encoder": 1,
        "prefill.decoder": 1}
    assert spans["wait.prefill"]["count"] == spans["wait.read_out"][
        "count"] == 1
    parts = sum(spans[n]["seconds"] for n in (
        "prefill.encode", "prefill.decoder", "wait.prefill") if n in spans)
    assert 0 < parts <= eng.last_stats["prefill_seconds"]
    assert spans["prefill.mel"]["seconds"] + spans["prefill.encoder"][
        "seconds"] <= spans["prefill.encode"]["seconds"]


def test_dump_metrics_adds_spans_only_while_enabled(registry, monkeypatch):
    with tracing.stage_timer("stage"):
        pass
    registry.add_span("prefill.encode", 0.25)
    assert set(tracing.dump_metrics()) == {"stage"}
    monkeypatch.setattr(tracing, "_enabled", True)
    data = tracing.dump_metrics()
    assert data["prefill.encode"] == {"total_ms": 250.0, "count": 1}
    assert data["stage"]["count"] == 1


def test_cli_metrics_carry_spans_under_asr_trace(tmp_path):
    """``ASR_TRACE=1`` with ``ASR_METRICS``: the CLI's JSON holds the stage
    timers and the engine's spans (one batched call of two files), and
    the attention counter: each layer of the audio tower's call and of
    the decoder prefill attends once, on the CPU by the dense path."""
    from test_audio_io import write_wav_pcm16
    from test_weights_roundtrip import write_word_tokenizer

    from qwen3_asr_rs_tpu.config import tiny_test_config
    from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
    from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
    from qwen3_asr_rs_tpu.weights.export import save_checkpoint

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config, text_config=dataclasses.replace(
            cfg.text, vocab_size=151936)))
    model = tmp_path / "model"
    save_checkpoint(model, init_encoder_params(cfg.audio, dtype=jnp.float32),
                    init_decoder_params(cfg.text, dtype=jnp.float32), cfg)
    write_word_tokenizer(model)
    wav = tmp_path / "a.wav"
    write_wav_pcm16(wav, np.random.default_rng(3).standard_normal(16800)
                    * 0.1, 24000)
    metrics = tmp_path / "m.json"
    env = dict(os.environ, ASR_TRACE="1", ASR_METRICS=str(metrics),
               ASR_DEVICE="cpu", ASR_DTYPE="float32", ASR_MAX_NEW_TOKENS="2",
               OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "qwen3_asr_rs_tpu_torch",
                    str(model), str(wav), str(wav)], cwd=ROOT, env=env,
                   capture_output=True, text=True, timeout=300, check=True)
    data = json.loads(metrics.read_text())
    assert data["device_dispatch"]["count"] == 1
    assert {n: data[n]["count"] for n in PREFILL_SPANS} == {
        "prefill.encode": 1, "prefill.mel": 1, "prefill.encoder": 1,
        "prefill.decoder": 1}
    counters = {n: v for n, v in data.items() if set(v) == {"count"}}
    assert counters == {"attention.dense": {
        "count": cfg.audio.encoder_layers + cfg.text.num_hidden_layers}}
    assert all(set(v) == {"total_ms", "count"} for n, v in data.items()
               if n not in counters)


@pytest.mark.parametrize("mod", [wer, jwer], ids=["port", "jax"])
def test_edit_distance(mod):
    assert mod.edit_distance([], []) == 0
    assert mod.edit_distance(list("abc"), list("abc")) == 0
    assert mod.edit_distance(list("kitten"), list("sitting")) == 3
    assert mod.edit_distance(["a"], []) == 1


@pytest.mark.parametrize("mod", [wer, jwer], ids=["port", "jax"])
def test_wer_cer(mod):
    assert mod.wer("the quick brown fox", "the quick brown fox") == 0.0
    assert mod.wer("the quick brown fox", "the slow brown fox") == 0.25
    assert mod.wer("", "") == 0.0
    assert mod.wer("", "word") == 1.0
    assert mod.cer("你好世界", "你好地界") == 0.25


def test_wer_matches_jax_on_random_strings(rng):
    words = ["a", "b", "c", "dd", "你", "好"]
    for _ in range(30):
        ref = " ".join(rng.choice(words, rng.integers(0, 8)))
        hyp = " ".join(rng.choice(words, rng.integers(0, 8)))
        assert wer.wer(ref, hyp) == jwer.wer(ref, hyp)
        assert wer.cer(ref, hyp) == jwer.cer(ref, hyp)
