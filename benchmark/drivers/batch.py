"""The offline entry: the program's ``AsrEngine.transcribe_batch``, called
back to back on batches of clips (a closed loop: one job over a corpus).

Set-up builds the engine over the benchmark's weights with the mix's
``max_new_tokens``, captures the decode graphs of the mix's batch size
and chunk bucket (``AsrEngine.warmup``), transcribes the pool's first
batch once, untimed, and checks that the engine serves the
configuration's precision (again after the window). The window starts
batch after batch, cycling through the pool, while it has run less
than ``seconds``; it ends when the last one returns, so a rate covers
all the work and all the time.
The engine's ``last_stats`` of each call (host-clock prefill seconds,
CUDA-event decode seconds, decode steps, tokens per row) are the
program's readings; ``account`` hands each call's whole to the decoder
architecture's count of its decode steps. A traced run profiles the
window's second batch whole.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from harness import work
from harness.host import HostLoad
from harness.program import check_precision
from harness.program import engine as make_engine
from harness.program import token_ids


class Session:
    def __init__(self, ctx):
        eng = ctx.cell.mix["engine"]
        self.max_new = eng["max_new_tokens"]
        self.engine = make_engine(ctx, self.max_new)
        self.engine.warmup(batch_sizes=tuple(eng["warmup_batch_sizes"]),
                           buckets=tuple(eng["warmup_chunk_buckets"]))
        self.engine.transcribe_batch(
            [c.samples for c in ctx.traffic.batches[0]])
        check_precision(self.engine, ctx.cell.config)

    def window(self, ctx) -> dict:
        batches = ctx.traffic.batches
        cfg = ctx.cell.config
        done, walls = [], []
        host = HostLoad()
        host.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            tb = time.perf_counter()
            clips = batches[len(done) % len(batches)]
            traced = ctx.trace is not None and len(done) == 1
            if traced:
                ctx.trace.what = (f"the window's second batch whole "
                                  f"({len(clips)} clips)")
                ctx.trace.start()
            out = self.engine.transcribe_batch([c.samples for c in clips])
            if traced:
                ctx.trace.stop()
            done.append((clips, [token_ids(r) for r in out],
                         dict(self.engine.last_stats)))
            walls.append(time.perf_counter() - tb)
        t_end = time.perf_counter()
        load = host.stop()
        v = sorted(walls)
        load.update(batch_s_min=v[0], batch_s_med=v[len(v) // 2],
                    batch_s_max=v[-1], prefill_s_each=[
                        round(st["prefill_seconds"], 4) for _, _, st in done])
        check_precision(self.engine, cfg)
        prog, flops, audio = account(cfg, done, self.max_new,
                                     ctx.cell.bench_dir)
        rng = np.random.default_rng([ctx.seed % 2 ** 63, 1])
        clips, toks, _ = done[int(rng.integers(len(done)))]
        items = [{"samples": c.samples, "tokens": t, "cap": self.max_new,
                  "seconds": c.seconds} for c, t in zip(clips, toks)]
        n = sum(len(c) for c, _, _ in done)
        return {"attempted": n, "failed": 0, "window_s": t_end - t0,
                "audio_s": audio, "flops": flops, "program": prog,
                "items": items, "host": load}

    def close(self) -> None:
        self.engine = None
        gc.collect()


def account(config: dict, done: list, max_new: int, bench_dir) -> tuple:
    """(the program's readings, the operations of the real work, the
    audio seconds) of the window's calls ``done``: (clips, each clip's
    tokens, the call's ``last_stats``) each, counted by the
    configuration's architecture under ``bench_dir``."""
    prog = {"prefill_seconds": 0.0, "decode_gpu_seconds": 0.0,
            "decode_steps": 0, "decode_bound_s": 0.0}
    flops = audio = 0.0
    for clips, toks, st in done:
        prog["prefill_seconds"] += st["prefill_seconds"]
        prog["decode_gpu_seconds"] += st.get("decode_gpu_seconds", 0.0)
        prog["decode_steps"] += st["decode_steps"]
        lens = [work.prompt_len(config, len(c.samples)) for c in clips]
        n_gen = st["n_gen"][: len(clips)]
        prog["decode_bound_s"] += decode_bound_s(config, lens, n_gen,
                                                 max_new, st, bench_dir)
        for c, p, t in zip(clips, lens, toks):
            frames, _ = work.audio_tokens(config, len(c.samples))
            flops += work.request_flops(config, frames, p, len(t),
                                        bench_dir)
            audio += c.seconds
    return prog, flops, audio


def decode_bound_s(config: dict, prompt_lens: list, n_gen: list,
                   max_new: int, stats: dict, bench_dir) -> float:
    """The least time of a call's decode steps: step s (making token
    s + 2) runs over the rows still live, row r reading prompt_lens[r] + s
    stale slots; a row that stopped at an end token after n tokens was
    live for steps 0..n-1, one that reached the cap for all of them.
    ``stats``, the call's ``last_stats``, goes to the count of each step
    by the configuration's architecture under ``bench_dir``."""
    total = 0.0
    for s in range(max_new - 1):
        live = [p + s for p, g in zip(prompt_lens, n_gen)
                if g >= max_new or s < g]
        if live:
            total += work.bound_s(*work.decode_step_work(
                config, live, stats=stats, step=s, bench_dir=bench_dir))
    return total
