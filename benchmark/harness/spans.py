"""The program's own spans over the traced slice, as shares of it.

The program's tracer (``qwen3_asr_rs_tpu_torch/utils/tracing.py``)
records spans while a torch profiler records, so that after a traced run
its registry holds the spans of the traced slice and nothing else: the
slice's set-up (``trace.Slice.warm``) runs no program code. The registry
says how many profiles its spans came from and how many spans it
recorded with no profiler (``ASR_TRACE=1``); unless that is one profile
and none, it holds more than the slice, and the shares read None. So do
a program without the tracer's ``snapshot`` and a run with no trace.

The spans are host seconds of a profiled batch, in which the profiler
slows the host's eager launches (the encoder loop's about twice) and
not the card: a share reads higher for a layer that launches many
small operations than it would untraced.
"""

from __future__ import annotations

from typing import Callable, Optional


def program_spans() -> dict:
    """{name: {"seconds", "count"}} of the program's spans where they
    cover one profile and nothing else, or {}."""
    from qwen3_asr_rs_tpu_torch.utils import tracing

    snapshot = getattr(tracing, "snapshot", None)
    if snapshot is None:
        return {}
    snap = snapshot()
    if snap["profiles"] != 1 or snap["unprofiled"]:
        return {}
    return snap["spans"]


def share_pct(rec: dict, keep: Callable[[str], bool]) -> Optional[float]:
    """100 x the seconds of the program's spans whose names ``keep``
    accepts over the traced slice's host-clock length, or None untraced
    or where no such span was recorded."""
    t = rec.get("trace")
    if not t or not t.get("window_s"):
        return None
    seconds = [s["seconds"] for name, s in program_spans().items()
               if keep(name)]
    if not seconds:
        return None
    return 100.0 * sum(seconds) / t["window_s"]
