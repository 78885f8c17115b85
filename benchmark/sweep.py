"""The sweep that finds the highest arrival rate a serving cell sustains.

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 4,6,8,10

One set-up, then for each rate one window of the cell's mix at that rate
(the mix file's rate replaced), every request waited for. A rate is
sustained when every request due in the window completes and the backlog
does not grow (``judge``). Prints one JSON line per rate. The cell's
file then carries 0.8 times the highest sustained rate; the sweep is run
once, when a cell is defined, and not by the benchmark's own runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness.caches import fix_cache_dirs  # noqa: E402

fix_cache_dirs()

from harness.runner import Context  # noqa: E402
from harness.spec import load_any_cell  # noqa: E402
from harness.stats import percentile  # noqa: E402
from harness.weights import make_weights  # noqa: E402


def at_rate(mix: dict, rate: float) -> dict:
    return dict(mix, arrival=dict(mix["arrival"], rate_per_s=rate))


def judge(rec: dict, due: list) -> dict:
    """The rate's latencies, and whether it is sustained. The backlog at
    a request's due time is the number of earlier requests not finished
    by then; it grows when its mean over the last quarter of the window
    exceeds its mean over the second quarter by half and by 2."""
    lat = rec["latencies_ms"]
    done = [d + x / 1e3 for d, x in zip(due, lat)]
    backlog = [sum(f > t for f in done[:i]) for i, t in enumerate(due)]
    q = len(lat) // 4

    def mean(v):
        return sum(v) / max(1, len(v))

    b2, b4 = mean(backlog[q: 2 * q]), mean(backlog[3 * q:])
    early, late = percentile(lat[q: 2 * q], 50), percentile(lat[3 * q:], 50)
    return {"attempted": rec["attempted"], "failed": rec["failed"],
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "q2_p50_ms": early, "q4_p50_ms": late,
            "q2_backlog": b2, "q4_backlog": b4,
            "lateness_max_ms": max(rec["lateness_ms"]),
            "slot_fill_pct": 100.0 * rec["program"]["tokens"] / max(
                1, rec["program"]["steps"] * rec["program"]["slots"]),
            "sustained": (rec["failed"] == 0 and late <= 2 * early
                          and b4 <= 1.5 * b2 + 2)}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cell = load_any_cell(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    gen = cell.generator()
    # set-up over the longest clips any rate sends
    first = gen.generate(at_rate(cell.mix, max(rates)), args.seed,
                         args.seconds)
    enc, dec = make_weights(cell.config, args.seed, "cuda",
                            cell.bench_dir)
    ctx = Context(cell, args.seed, args.seconds, "cuda", enc, dec, first)
    t0 = time.perf_counter()
    session = cell.driver().Session(ctx)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for rate in rates:
        ctx.traffic = gen.generate(at_rate(cell.mix, rate), args.seed,
                                   args.seconds)
        rec = session.window(ctx)
        due = [c.due_s for c in ctx.traffic.requests]
        print(json.dumps({"rate_per_s": rate, **judge(rec, due)}),
              flush=True)
    session.close()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
