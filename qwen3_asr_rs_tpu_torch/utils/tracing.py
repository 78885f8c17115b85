"""Stage timers and spans.

Port of ``qwen3_asr_rs_tpu/utils/tracing.py``, extended. One registry,
``GLOBAL_TIMINGS`` (a ``Timings``), holds two kinds of record:

- stage timers (``stage_timer``), always on: each stage's host wall
  seconds and count (``totals``, ``counts``), exported as JSON by
  ``dump_metrics`` (the CLI's ``ASR_METRICS=<path>``) with the JAX CLI's
  keys;
- spans (``span(name)``): host wall seconds and count of a named block
  (``spans``, ``span_counts``);
- counters (``count(name, n)``): a sum, or the largest, of what the
  program counted (``counters``), such as the routed experts' ``moe.*``
  that the decoder adds once per call from its device counters
  (``read_counts``).

Spans and counters are recorded only while the tracer is on: under
``ASR_TRACE=1`` (read at import) or while a torch profiler records
(``torch._C._autograd._profiler_enabled()``). Off, a span is one test of
that state and nothing else: no clock read, no profiler annotation, no
registry write. ``snapshot()`` reads the spans and counters, with the
number of profiles they were recorded in and of those recorded with no
profiler, so that a reader can tell whether they cover one profile and
nothing else; ``dump_metrics`` adds them to its JSON under
``ASR_TRACE=1``.

While a profiler records, a span and a stage timer also enter a profiler
annotation of their name, so that Kineto timestamps them beside the
device's events. That is the only way onto the device trace's clock:
Kineto's event times (``start_ns()``) are epoch nanoseconds, not
``time.perf_counter_ns()``'s (the offset is about 1.8e18 ns), and the
tracer writes no timestamps of its own. The annotation is a
``RecordFunction`` of function scope (``_RecordFunctionFast``), a host
event only: ``torch.profiler.record_function`` opens a user scope, for
which Kineto adds a ``gpu_user_annotation`` device event over the
kernels launched inside it, which a trace reduction would count as
device work; it also costs about 10 us per use even with no profiler.

No span may be entered inside a function that a CUDA graph captures: a
replay runs none of its Python.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Iterator

import torch

logger = logging.getLogger("qwen3_asr_rs_tpu_torch.trace")

_profiling = torch._C._autograd._profiler_enabled
_enabled = os.environ.get("ASR_TRACE") == "1"
_NULL = contextlib.nullcontext()
_in_profile = False  # the last annotation check found a profiler recording


class Timings:
    """Accumulates per-stage wall times and the spans' (no locks: a
    thread's add may interleave with another's)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans = defaultdict(float)
        self.span_counts = defaultdict(int)
        self.counters = defaultdict(int)
        self.profiles = 0    # profiles that spans or stage timers ran in
        # spans and counter additions recorded with no profiler recording
        self.unprofiled = 0

    def add(self, stage: str, seconds: float):
        self.totals[stage] += seconds
        self.counts[stage] += 1

    def add_span(self, name: str, seconds: float):
        self.spans[name] += seconds
        self.span_counts[name] += 1

    def summary(self) -> str:
        lines = []
        for stage in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{stage}: {self.totals[stage]*1000:.1f} ms"
                f" ({self.counts[stage]}x)"
            )
        return "; ".join(lines)


GLOBAL_TIMINGS = Timings()


def snapshot() -> dict:
    """{"spans": {name: {"seconds", "count"}}, "counters": {name: n},
    "profiles": n, "unprofiled": m} of ``GLOBAL_TIMINGS``: ``profiles``
    counts the profiles that spans or stage timers ran in (a profile is
    seen to end when one runs with no profiler), ``unprofiled`` the spans
    and counter additions recorded with none (``ASR_TRACE=1``)."""
    t = GLOBAL_TIMINGS
    return {
        "spans": {name: {"seconds": s, "count": t.span_counts[name]}
                  for name, s in t.spans.items()},
        "counters": dict(t.counters),
        "profiles": t.profiles,
        "unprofiled": t.unprofiled,
    }


def dump_metrics(path: str | None = None) -> dict:
    """Export accumulated stage metrics as a dict (and JSON file if
    asked): per-stage totals and counts, and under ``ASR_TRACE=1`` each
    span's too. The CLI honors ``ASR_METRICS=<path>``."""
    import json

    data = {
        stage: {
            "total_ms": round(GLOBAL_TIMINGS.totals[stage] * 1000, 3),
            "count": GLOBAL_TIMINGS.counts[stage],
        }
        for stage in GLOBAL_TIMINGS.totals
    }
    if _enabled:
        snap = snapshot()
        for name, s in snap["spans"].items():
            data[name] = {"total_ms": round(s["seconds"] * 1000, 3),
                          "count": s["count"]}
        for name, n in snap["counters"].items():
            data[name] = {"count": n}
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2)
        logger.info("metrics written to %s", path)
    return data


def _in_a_profile() -> bool:
    """Whether a profiler records; counts each profile the first time
    this finds it recording."""
    global _in_profile
    if not _profiling():
        _in_profile = False
        return False
    if not _in_profile:
        _in_profile = True
        GLOBAL_TIMINGS.profiles += 1
    return True


def _annotation(name: str):
    """An entered profiler annotation of ``name`` while a profiler
    records, else None; counts each profile on its first annotation."""
    if not _in_a_profile():
        return None
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class _Span:
    __slots__ = ("name", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = _annotation(self.name)
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        GLOBAL_TIMINGS.add_span(self.name, time.perf_counter() - self._t0)
        if self._rf is None:
            GLOBAL_TIMINGS.unprofiled += 1
        else:
            self._rf.__exit__(*exc)


def span(name: str):
    """A context manager that records the block's host seconds under
    ``name`` while the tracer is on (see the module's docstring)."""
    if not (_enabled or _profiling()):
        return _NULL
    return _Span(name)


def count(name: str, n: int, largest: bool = False) -> None:
    """Add ``n`` to the counter ``name`` (``largest``: keep the larger of
    the two) while the tracer is on (see the module's docstring); off,
    nothing."""
    if not (_enabled or _profiling()):
        return
    c = GLOBAL_TIMINGS.counters
    c[name] = max(c[name], int(n)) if largest else c[name] + int(n)
    if not _in_a_profile():
        GLOBAL_TIMINGS.unprofiled += 1


@contextlib.contextmanager
def stage_timer(stage: str, timings: Timings | None = None) -> Iterator[None]:
    rf = _annotation(stage)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        (timings or GLOBAL_TIMINGS).add(stage, dt)
        if rf is not None:
            rf.__exit__(None, None, None)
        logger.debug("%s took %.1f ms", stage, dt * 1000)
