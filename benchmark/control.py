"""Readings of the check for setting a cell's limits: the program's own
runs, and the control's beside them.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds a,b,c

Each seed is a whole run of the cell (``harness.runner.run_cell``, as
``run.py`` makes it) with a window of ``--seconds`` at the cell's own
load. The control is the reference put in the program's place one step
below the configurations' bf16: every product with a weight from float8
e4m3 operands (``Reference(matmul="fp8")``), read at each position of the
program's served sequences (a served model's control need not decode).
The program's own int8 paths were the first choice and do not separate
(PERF.md §2). Prints one JSON line per run, then per reading the largest
of the program's runs and the smallest of the control's. The benchmark's
own runs never run the control; ``tests/test_bench_control.py`` runs it
on a card.
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

from harness import check  # noqa: E402
from harness.runner import run_cell  # noqa: E402
from harness.spec import load_any_cell  # noqa: E402

PREFIX = "control_"


def readings(cell, seeds, seconds: float) -> list:
    """[(seed, the program's readings, its correct, the control's
    readings, the control's correct)] of one run per seed."""
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        result, values = run_cell(cell, seed, seconds, False, "cuda",
                                  control_matmul="fp8")
        mine = {k: v for k, v in values.items() if not k.startswith(PREFIX)}
        ctrl = {k[len(PREFIX):]: v for k, v in values.items()
                if k.startswith(PREFIX)}
        ctrl_ok = check.judge(ctrl, cell.check["limits"])[0]
        print(json.dumps({
            "cell": cell.name, "seed": seed, "readings": mine,
            "correct": result["correct"], "control_readings": ctrl,
            "control_correct": ctrl_ok, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "run_s": time.perf_counter() - t0}), flush=True)
        out.append((seed, mine, result["correct"], ctrl, ctrl_ok))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = load_any_cell(args.workload)
    runs = readings(cell, [int(s) for s in args.seeds.split(",")],
                    args.seconds)
    summary = {"cell": cell.name, "limits": cell.check["limits"]}
    for name in runs[0][1]:
        summary[f"program_max_{name}"] = max(r[1][name] for r in runs)
        summary[f"control_min_{name}"] = min(r[3][name] for r in runs)
    summary["control_correct"] = [r[4] for r in runs]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
