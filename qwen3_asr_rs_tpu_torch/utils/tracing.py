"""Lightweight stage tracing / timing.

Port of ``qwen3_asr_rs_tpu/utils/tracing.py``: every stage is wall-clock
timed and aggregated (``stage_timer``, ``GLOBAL_TIMINGS``), the totals
export as JSON (``dump_metrics``, the CLI's ``ASR_METRICS=<path>``), and
a ``torch.profiler`` trace of any block can be written for the card
(``torch_profile``, in place of the JAX package's ``jax_profile``).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Iterator

logger = logging.getLogger("qwen3_asr_rs_tpu_torch.trace")


class Timings:
    """Accumulates per-stage wall times."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def add(self, stage: str, seconds: float):
        self.totals[stage] += seconds
        self.counts[stage] += 1

    def summary(self) -> str:
        lines = []
        for stage in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{stage}: {self.totals[stage]*1000:.1f} ms"
                f" ({self.counts[stage]}x)"
            )
        return "; ".join(lines)


GLOBAL_TIMINGS = Timings()


def dump_metrics(path: str | None = None) -> dict:
    """Export accumulated stage metrics as a dict (and JSON file if
    asked): per-stage totals and counts. The CLI honors
    ``ASR_METRICS=<path>``."""
    import json

    data = {
        stage: {
            "total_ms": round(GLOBAL_TIMINGS.totals[stage] * 1000, 3),
            "count": GLOBAL_TIMINGS.counts[stage],
        }
        for stage in GLOBAL_TIMINGS.totals
    }
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2)
        logger.info("metrics written to %s", path)
    return data


@contextlib.contextmanager
def stage_timer(stage: str, timings: Timings | None = None) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        (timings or GLOBAL_TIMINGS).add(stage, dt)
        logger.debug("%s took %.1f ms", stage, dt * 1000)


@contextlib.contextmanager
def torch_profile(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host and, where a card is
    present, CUDA activity) of the block into ``<logdir>/trace.json``,
    viewable in Perfetto or chrome://tracing."""
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
