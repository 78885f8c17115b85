"""A slice of a run under ``torch.profiler``, reduced to device busy time,
the device operations that took most time, and the idle gaps by what the
host was doing.

Busy time is the union of the device events' intervals (kernels, copies,
sets), as ``chip_smoke.py``'s ``busy_us`` takes it: kernels launched with
programmatic dependent launch overlap their predecessor, so a sum of
durations would count that overlap twice. An idle gap is a stretch of the
slice in which no device event ran; it is named after the innermost host
event (a PyTorch operator or a CUDA runtime call) that spans its middle,
or "python" where none does.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional

TOP = 10  # entries of each breakdown list


class Slice:
    """``start()`` ... ``stop()`` around the traced part of a window;
    ``summary()`` afterwards. ``warm()`` in set-up starts and stops the
    profiler once, so that the tracer's own first start is not in the
    window."""

    def __init__(self):
        self.what = ""  # the driver says which part of the window
        self.prof = None
        self.t0 = self.t1 = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self) -> None:
        import torch

        with self._profile():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> Optional[dict]:
        """{"busy_s", "window_s", "device_ops", "idle_gaps", "what"}, or
        None when nothing was traced."""
        if self.prof is None or self.t1 is None:
            return None
        return reduce_events(_events(self.prof), self.t1 - self.t0,
                             self.what)


def _events(prof) -> list:
    """(is_device, name, start_us, end_us) of every event of a profile,
    read from the raw Kineto results (building FunctionEvents for
    hundreds of thousands of kernels would take minutes)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.device_type() == DeviceType.CUDA, e.name(), start,
                    start + e.duration_ns() / 1e3))
    return out


def merge(intervals: list) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def reduce_events(events: list, window_s: float, what: str) -> dict:
    """Busy seconds, the top device operations by summed seconds and the
    idle seconds by host activity, over the slice's events (is_device,
    name, start_us, end_us); ``window_s`` is the slice's length by the
    host clock."""
    dev = [(a, b, n) for d, n, a, b in events if d]
    host = [(a, b, n) for d, n, a, b in events if not d]
    busy = merge([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    by_op: dict = defaultdict(float)
    for a, b, n in dev:
        by_op[n] += (b - a) / 1e6
    gaps = []
    if busy:
        lo = min([a for a, _, _ in host] + [busy[0][0]])
        hi = max([b for _, b, _ in host] + [busy[-1][1]])
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    idle: dict = defaultdict(float)
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    for (_, length), name in zip(mids, _host_at(host, [m for m, _ in mids])):
        idle[name] += length / 1e6
    return {
        "what": what,
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "device_ops": sorted(([n, s] for n, s in by_op.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                            key=lambda x: -x[1])[:TOP],
    }


def _host_at(host: list, times: list) -> list:
    """For each of the sorted ``times``, the innermost (shortest) host
    event (start, end, name) spanning it, or "python": one sweep, keeping
    the events that have started and not ended (a few: the nesting of
    operators on each thread)."""
    host = sorted(host)
    names, live, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            live.append(host[i])
            i += 1
        live = [e for e in live if e[1] >= t]
        names.append(min(live, key=lambda e: e[1] - e[0])[2] if live
                     else "python")
    return names
