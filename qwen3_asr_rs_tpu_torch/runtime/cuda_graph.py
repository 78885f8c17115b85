"""A decode step captured as a CUDA graph, and its kernels' launches.

``StepGraph`` captures one call of a step function on a side stream
(``torch.cuda.CUDAGraph``) and replays it. ``capture`` runs the same
step once eagerly on that stream first, so that every kernel wrapper's
per-stream scratch exists and every C launcher has set its attributes
before the capture: nothing is allocated or configured for the first
time mid-capture. The engine, the serving batcher and the streaming
sessions all capture through it. Whatever the step reads and writes must live at fixed
addresses (the engine's decode state and slabs), and its positions must
be device tensors: a host int would be frozen into the graph
(``_build.check_not_frozen``).

Launch counts: a kernel wrapper adds to its ``launches`` counter in
Python, which a replay does not run. The capture records how much each
counter in ``ops.kernels.COUNTED`` moved while the step was captured
(the launches the graph holds), takes that back, and every replay adds
it again, so that the counters count launches on the card, replayed or
not. A caller may append any object with a ``launches`` counter to
``COUNTED`` (the card checks count the lm_head products so).
"""

from __future__ import annotations

import torch

from ..ops.kernels import COUNTED


class StepGraph:
    """One capture of ``fn`` (on ``stream``, allocating from the graph
    memory pool ``pool``, kept as ``.pool``); ``replay()`` enqueues it on
    the current stream. The graph keeps ``fn``: its kernels read the
    addresses of the tensors the step's closure holds, which must live as
    long as the graph."""

    def __init__(self, fn, stream, pool):
        self.fn = fn
        self.pool = pool
        counted = list(COUNTED)
        before = [w.launches for w in counted]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    fn()
                finally:
                    graph.capture_end()
            self.launches = [(w, w.launches - n)
                             for w, n in zip(counted, before)
                             if w.launches != n]
        finally:
            for w, n in zip(counted, before):
                w.launches = n
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        for w, n in self.launches:
            w.launches += n


def capture(fn, stream, pool) -> StepGraph:
    """Run ``fn`` once eagerly on ``stream`` (a real step: it creates the
    wrappers' per-stream scratch), then capture it into the graph memory
    pool ``pool``; the current stream waits for both. Returns the
    graph."""
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        fn()
    graph = StepGraph(fn, stream, pool)
    main.wait_stream(stream)
    return graph
