"""What the host did during a window, for finding where the spread of a
host-bound cell comes from: the main thread's and the process's CPU
seconds against the wall, the machine's steal time, involuntary context
switches, and the garbage collector's pauses. Printed on standard error
(``host:``); no metric reads it.

If the main thread's CPU seconds follow the wall from run to run, the
host ran the same work faster or slower (clock, a shared core); if they
hold while the wall moves, the thread waited (preempted, stolen, or on
the device).
"""

from __future__ import annotations

import gc
import os
import resource
import time


def _steal_and_total() -> tuple:
    """(steal, total) jiffies of the machine from /proc/stat, or (0, 0)."""
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return 0, 0
    return (cpu[7] if len(cpu) > 7 else 0), sum(cpu[:8])


class HostLoad:
    """``start()`` before the window, ``stop()`` after it: a dict of
    what the host did in between."""

    def __init__(self):
        self.gc_s = 0.0
        self.gc_n = 0
        self._gc_t = None

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_n += 1
            self._gc_t = None

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.thread0 = time.thread_time()
        self.proc0 = os.times()
        self.steal0 = _steal_and_total()
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._on_gc)

    def stop(self) -> dict:
        gc.callbacks.remove(self._on_gc)
        wall = time.perf_counter() - self.t0
        proc = os.times()
        steal, total = (b - a for a, b in zip(self.steal0,
                                               _steal_and_total()))
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {
            "wall_s": wall,
            "main_cpu_s": time.thread_time() - self.thread0,
            "proc_cpu_s": (proc.user - self.proc0.user
                           + proc.system - self.proc0.system),
            "steal_pct": 100.0 * steal / total if total else 0.0,
            "nivcsw": ru.ru_nivcsw - self.ru0.ru_nivcsw,
            "gc_s": self.gc_s, "gc_n": self.gc_n,
            "cpus": len(os.sched_getaffinity(0)),
        }


def line(host: dict) -> str:
    """The ``host:`` line of standard error (a list as its items)."""
    return "host: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else
        f"{k} {' '.join(map(str, v))}" if isinstance(v, list) else f"{k} {v}"
        for k, v in host.items())
