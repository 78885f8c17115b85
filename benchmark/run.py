"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It makes the cell's traffic and weights from the seed, sets up the
program (``qwen3_asr_rs_tpu_torch``), measures for ``--seconds``, checks
the served tokens against the plain float32 reference, and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last the compared
numbers beside their limits (``checks``), which also end standard
error. Without enough CUDA devices it exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness.caches import fix_cache_dirs  # noqa: E402

fix_cache_dirs()

import torch  # noqa: E402

from harness import check, work  # noqa: E402
from harness.runner import run_cell  # noqa: E402
from harness.spec import load_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, values = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    dev = result["device"]
    print(f"yardstick: {work.PEAK_BF16_FLOPS / 1e12:g} TFLOP/s bf16, "
          f"{work.HBM_BYTES_PER_S / 1e12:g} TB/s; card: {dev['kind']}, "
          f"power limit {dev.get('power_limit', 'unknown')}", file=sys.stderr)
    check.print_checks(result["checks"], {
        k: v for k, v in values.items() if k not in result["checks"]})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
