"""The metrics that read the program's spans: each reads a synthetic
record and snapshot to its share, reads None untraced, with no such span,
from a program without the tracer's snapshot, or where the registry holds
more than one profile's spans (``ASR_TRACE=1``, a second profile); the
trace reduction names an idle gap under a span, with no operator over
it, by the span."""

from __future__ import annotations

import pytest

from tiny import BENCH

from harness import spans as spans_mod
from harness.spec import load_module
from harness.trace import reduce_events

SNAP = {"spans": {
    "prefill.encode": {"seconds": 0.5, "count": 1},
    "prefill.mel": {"seconds": 0.1, "count": 32},
    "prefill.encoder": {"seconds": 0.3, "count": 32},
    "prefill.decoder": {"seconds": 0.25, "count": 1},
    "wait.prefill": {"seconds": 0.05, "count": 1},
    "wait.done_flags": {"seconds": 0.2, "count": 32},
    "wait.read_out": {"seconds": 0.01, "count": 1},
}}
WANT = {"encode_share_pct.offline": 25.0,
        "prefill_decoder_share_pct.offline": 12.5,
        "host_wait_pct.offline": 13.0}


def _metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_metrics_read_their_share(name, monkeypatch):
    rec = {"trace": {"window_s": 2.0, "busy_s": 0.8}, "window_s": 51.0}
    monkeypatch.setattr(spans_mod, "program_spans", lambda: SNAP["spans"])
    assert _metric(name).read(rec) == pytest.approx(WANT[name])
    assert _metric(name).read({"trace": None, "window_s": 51.0}) is None
    monkeypatch.setattr(spans_mod, "program_spans", lambda: {})
    assert _metric(name).read(rec) is None


def test_program_spans_reads_the_programs_registry(monkeypatch):
    from qwen3_asr_rs_tpu_torch.utils import tracing

    t = tracing.Timings()
    t.add_span("wait.done_flags", 0.5)
    t.profiles = 1
    monkeypatch.setattr(tracing, "GLOBAL_TIMINGS", t)
    assert spans_mod.program_spans() == {
        "wait.done_flags": {"seconds": 0.5, "count": 1}}
    rec = {"trace": {"window_s": 5.0}}
    assert _metric("host_wait_pct.offline").read(rec) == pytest.approx(10.0)
    monkeypatch.delattr(tracing, "snapshot")  # a program without it
    assert spans_mod.program_spans() == {}
    assert _metric("host_wait_pct.offline").read(rec) is None


def test_a_gap_under_a_span_is_named_by_the_span():
    ev = [(False, "device_dispatch", 0.0, 100.0),
          (False, "prefill.mel", 5.0, 45.0),
          (False, "aten::mm", 10.0, 20.0),
          (True, "k", 0.0, 10.0), (True, "k", 40.0, 60.0),
          (True, "k", 90.0, 100.0)]
    gaps = dict(reduce_events(ev, 1e-4, "test")["idle_gaps"])
    # 10..40: its middle (25) lies in prefill.mel with no operator over it
    assert gaps["prefill.mel"] == pytest.approx(30e-6)
    # 60..90: only the outer span covers it
    assert gaps["device_dispatch"] == pytest.approx(30e-6)
    assert "python" not in gaps


@pytest.mark.parametrize("profiles,asr_trace", [(0, True), (1, True),
                                                (2, False)],
                         ids=["asr-trace-only", "asr-trace-and-profile",
                              "two-profiles"])
def test_spans_beyond_one_profile_read_none(monkeypatch, profiles,
                                            asr_trace):
    """Spans recorded with no profiler (``ASR_TRACE=1``) or in a second
    profile are not the traced slice's: every share reads None."""
    from torch.profiler import ProfilerActivity, profile

    from qwen3_asr_rs_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "GLOBAL_TIMINGS", tracing.Timings())
    monkeypatch.setattr(tracing, "_enabled", asr_trace)
    monkeypatch.setattr(tracing, "_in_profile", False)
    with tracing.stage_timer("device_dispatch"):
        with tracing.span("prefill.encode"):
            pass
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.stage_timer("device_dispatch"):
                with tracing.span("prefill.encode"):
                    pass
        with tracing.stage_timer("device_dispatch"):
            pass
    snap = tracing.snapshot()
    assert (snap["profiles"], snap["unprofiled"] > 0) == (profiles,
                                                         asr_trace)
    assert snap["spans"]["prefill.encode"]["count"] == profiles + asr_trace
    rec = {"trace": {"window_s": 1.0}}
    for name in WANT:
        assert _metric(name).read(rec) is None


def test_one_profile_reads_its_spans(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from qwen3_asr_rs_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "GLOBAL_TIMINGS", tracing.Timings())
    monkeypatch.setattr(tracing, "_enabled", False)
    monkeypatch.setattr(tracing, "_in_profile", False)
    with tracing.stage_timer("device_dispatch"):  # an untraced batch
        with tracing.span("prefill.encode"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.stage_timer("device_dispatch"):
            with tracing.span("prefill.encode"):
                pass
    with tracing.stage_timer("device_dispatch"):  # batches after it
        pass
    seconds = tracing.snapshot()["spans"]["prefill.encode"]["seconds"]
    assert _metric("encode_share_pct.offline").read(
        {"trace": {"window_s": 1.0}}) == pytest.approx(100.0 * seconds)
