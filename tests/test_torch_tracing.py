"""Stage timers, the metrics dump and error rates: the port's
``utils/tracing.py`` and ``utils/wer.py`` against the JAX package's.

The cases of ``tests/test_tracing.py`` and of
``tests/test_wer_and_server.py::test_edit_distance/test_wer_cer``, run on
both packages; the summaries of the same timings agree; the engine's
``device_dispatch`` timer counts each transcription; ``torch_profile``
writes a trace on the CPU.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import json

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


def test_torch_profile_writes_a_trace(tmp_path):
    with tracing.torch_profile(str(tmp_path / "prof")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


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
