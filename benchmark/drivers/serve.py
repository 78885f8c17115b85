"""The serving entry: the program's ``BatchingWorker`` (the in-process
worker behind every HTTP handler of ``runtime/server.py``) and its
``submit``, driven as an open loop.

Set-up builds the engine over the benchmark's weights, the worker with
the mix's ``server`` numbers, warms the batcher over the chunk buckets
of the mix's clip lengths (``ContinuousBatcher.warmup``), checks that
the program serves the configuration's precision (again after the
window) and starts the worker's thread. The window submits each request at its due time,
whatever the earlier ones are doing, then waits for every request (up to
``GRACE_S`` past the window). A request's latency runs from its due time
to its result (``Request.finish_time``); the harness keeps the due
times, because ``Request.submit_time`` is when the object was built. A
request that fails or never finishes counts as failed, with the time
waited for it as its latency. A traced run profiles a replay of the
window's first ``trace_slice_s`` of requests after it (``_traced_replay``).
"""

from __future__ import annotations

import gc
import time

from harness import work
from harness.host import HostLoad
from harness.program import check_precision
from harness.program import engine as make_engine
from harness.program import token_ids

GRACE_S = 60.0
IDLE_S = 0.2  # for the worker to finish its last drain and go idle


def warm_buckets(config: dict, buckets, longest: int) -> list:
    """The chunk buckets up to the one that holds ``longest`` samples."""
    cf = config["thinker_config"]["audio_config"]["n_window"] * 2
    chunks = -(-work.audio_tokens(config, longest)[0] // cf)
    top = min(c for c in buckets if c >= chunks)
    return [c for c in buckets if c <= top]


class Session:
    def __init__(self, ctx):
        from qwen3_asr_rs_tpu_torch.runtime.server import BatchingWorker

        srv = ctx.cell.mix["server"]
        self.engine = make_engine(ctx, srv["max_new_tokens"])
        self.worker = BatchingWorker(
            self.engine, max_batch=srv["max_batch"],
            segment_steps=srv["segment_steps"],
            max_new_tokens=srv["max_new_tokens"])
        batcher = self.worker.batcher
        batcher.warmup(buckets=warm_buckets(
            ctx.cell.config, self.engine.chunk_buckets,
            max(len(c.samples) for c in ctx.traffic.requests)))
        check_precision(self.engine, ctx.cell.config, batcher)
        self.worker.start()

    def window(self, ctx) -> dict:
        from qwen3_asr_rs_tpu_torch.runtime.serving import Request

        clips = ctx.traffic.requests
        reqs = [Request(c.samples, None, max_new_tokens=c.max_new)
                for c in clips]
        batcher = self.worker.batcher
        steps0 = batcher.stats["steps"]
        host = HostLoad()
        host.start()
        t0 = time.monotonic()
        lateness = self._send(clips, reqs, t0)
        deadline = t0 + ctx.seconds + GRACE_S
        for r in reqs:
            r.event.wait(max(0.0, deadline - time.monotonic()))
        t_end = time.monotonic()
        load = host.stop()
        steps = batcher.stats["steps"] - steps0
        check_precision(self.engine, ctx.cell.config, batcher)
        if ctx.trace is not None:
            self._traced_replay(ctx, clips)
        cfg = ctx.cell.config
        lat, items, flops, tokens, failed = [], [], 0.0, 0, 0
        for c, r in zip(clips, reqs):
            due = t0 + c.due_s
            done = r.event.is_set() and r.error is None
            if not done:
                failed += 1
                lat.append(1e3 * (t_end - due))
                continue
            lat.append(1e3 * (r.finish_time - due))
            toks = token_ids(r.result)
            tokens += len(toks)
            frames, _ = work.audio_tokens(cfg, len(c.samples))
            flops += work.request_flops(
                cfg, frames, work.prompt_len(cfg, len(c.samples)), len(toks),
                ctx.cell.bench_dir)
            items.append({"samples": c.samples, "tokens": toks,
                          "cap": c.max_new, "seconds": c.seconds})
        finished = [r.finish_time for r in reqs if r.finish_time is not None]
        return {
            "attempted": len(reqs), "failed": failed,
            "latencies_ms": lat,
            "lateness_ms": [1e3 * x for x in lateness],
            "window_s": max(finished, default=t_end) - t0,
            "audio_s": sum(it["seconds"] for it in items),
            "flops": flops,
            "program": {"steps": steps, "slots": batcher.n_slots,
                        "tokens": tokens},
            "items": items,
            "host": load,
        }

    def _send(self, clips, reqs, t0: float) -> list:
        """Submit each request at its due time after ``t0``; returns how
        late each submission was (seconds)."""
        late = []
        for c, r in zip(clips, reqs):
            wait = t0 + c.due_s - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self.worker.submit(r)
            late.append(time.monotonic() - t0 - c.due_s)
        return late

    def _traced_replay(self, ctx, clips) -> None:
        """The traced slice: the window's first ``trace_slice_s`` of
        requests sent again, at their due times, once the window's own
        have finished, the profiler started and stopped with the worker
        idle (starting or stopping it while the worker's thread replays
        its CUDA graphs hung the run)."""
        from qwen3_asr_rs_tpu_torch.runtime.serving import Request

        span = ctx.cell.mix["trace_slice_s"]
        first = [c for c in clips if c.due_s < span]
        reqs = [Request(c.samples, None, max_new_tokens=c.max_new)
                for c in first]
        time.sleep(IDLE_S)
        ctx.trace.what = (f"the window's first {span} s of requests "
                          f"({len(first)}) sent again after it, from and "
                          "to an idle worker")
        ctx.trace.start()
        self._send(first, reqs, time.monotonic())
        for r in reqs:
            r.event.wait(GRACE_S)
        time.sleep(IDLE_S)
        ctx.trace.stop()

    def close(self) -> None:
        self.worker.stop()
        self.worker.join(timeout=GRACE_S)
        self.worker = self.engine = None
        gc.collect()
