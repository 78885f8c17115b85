"""What the routed-expert metrics read: the expert kernel's device
seconds in the traced slice, and the least time of the work that the
program's ``moe.*`` counters say it did.

The counters are the program's tracer's (``qwen3_asr_rs_tpu_torch/utils/
tracing.py``), which records them only while a profiler records, as its
spans (``harness/spans.py``): they cover the traced slice where the
registry says one profile and nothing else, and read as none otherwise.

A metric's ``read`` gets the run's record alone, which names neither the
cell nor holds every device operation (``rec["trace"]["device_ops"]``
keeps the largest ``trace.TOP``). So the work is counted by the
architecture of the cell that ``runner.run_cell`` is running, and the
kernel's seconds are summed over every device event of that run's
profile (``run_context``: the ``cell`` and the trace ``sl`` of the
``run_cell`` frame that reads the metric), however the process was
started; outside a ``run_cell`` they read None.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Optional

from . import trace, work

KERNEL = "moe_experts_kernel"  # in the names of K7's expert products

_ops_of: dict = {}  # id(profile) -> {device op name: seconds}


def run_context() -> dict:
    """The locals of the ``runner.run_cell`` call that reads this metric
    (its ``cell``, its trace slice ``sl``), or {} outside one."""
    from . import runner

    code = runner.run_cell.__code__
    f = sys._getframe(1)
    while f is not None:
        if f.f_code is code:
            return f.f_locals
        f = f.f_back
    return {}


def device_ops(sl) -> dict:
    """{name: summed device seconds} of every device event of the slice's
    profile, none left out (read once per profile)."""
    key = id(sl.prof)
    if key not in _ops_of:
        ops: dict = defaultdict(float)
        for is_dev, name, a, b in trace._events(sl.prof):
            if is_dev:
                ops[name] += (b - a) / 1e6
        _ops_of.clear()
        _ops_of[key] = dict(ops)
    return _ops_of[key]


def expert_seconds(rec: dict) -> Optional[float]:
    """Summed device seconds of the expert kernel's launches (the device
    operations whose names hold ``KERNEL``) in the traced slice, or
    None."""
    sl = run_context().get("sl")
    if not rec.get("trace") or sl is None or sl.prof is None:
        return None
    seconds = sum(s for name, s in device_ops(sl).items() if KERNEL in name)
    return seconds or None


def counters() -> dict:
    """The program's counters where they cover one profile and nothing
    else, or {}."""
    from qwen3_asr_rs_tpu_torch.utils import tracing

    snapshot = getattr(tracing, "snapshot", None)
    if snapshot is None:
        return {}
    snap = snapshot()
    if snap["profiles"] != 1 or snap["unprofiled"]:
        return {}
    return snap.get("counters", {})


def expert_bound_s() -> Optional[float]:
    """The least seconds of the routed experts' work in the counters
    (decode and prefill bounded apart, then summed), or None."""
    c = counters()
    cell = run_context().get("cell")
    if cell is None or "moe.decode_rows" not in c:
        return None
    arch = cell.architecture()
    total = 0.0
    for phase in ("decode", "prefill"):
        nbytes, ops = arch.expert_work(
            cell.config, c[f"moe.{phase}_experts_touched"],
            c[f"moe.{phase}_rows"])
        total += work.bound_s(nbytes, ops)
    return total
