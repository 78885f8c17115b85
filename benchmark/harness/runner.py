"""One run of one cell: traffic and weights from the seed, the driver's
set-up and window, then the check against the reference and the metrics.

The order matters. Set-up ends just before the first timed request
(``setup_s`` counts from the process's start). After the window the
device's memory peak is read, the program is freed, the loaded modules
are searched for JAX, and only then does the reference run, so that
neither its time nor its memory lands in the program's numbers.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time
from typing import Optional

import numpy as np

from . import check
from .host import line as host_line
from .spec import Cell
from .trace import Slice
from .weights import make_weights

# top-level module names that no run may load (compared whole: the
# program's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_asr_rs_tpu")


@dataclasses.dataclass
class Context:
    """What a driver sees: the cell, the seed, the window's length, the
    device, the weights, the generated traffic and the trace slice (None
    untraced)."""

    cell: Cell
    seed: int
    seconds: float
    device: str
    enc: dict
    dec: dict
    traffic: object
    trace: Optional[Slice] = None


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def sample_items(items: list, k, seed: int) -> list:
    """``k`` of the finished requests ("all": every one), drawn from the
    seed: one from each of k runs of consecutive items, and the longest
    clip in place of its run's draw."""
    if k == "all" or len(items) <= k:
        return list(items)
    rng = np.random.default_rng([seed % 2 ** 63, 2])
    runs = np.array_split(np.arange(len(items)), k)
    picks = [int(rng.choice(r)) for r in runs]
    longest = max(range(len(items)), key=lambda i: items[i]["seconds"])
    for j, r in enumerate(runs):
        if longest in r:
            picks[j] = longest
    return [items[i] for i in picks]


def card() -> dict:
    """The card's name and power limit (nvidia-smi), printed beside every
    number; {} where nvidia-smi is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    name, limit = (x.strip() for x in out.split(",", 1))
    return {"nvidia_smi_name": name, "power_limit": limit}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             control_matmul: Optional[str] = None) -> tuple:
    """(the result of one run: the JSON object the command prints, every
    reading of the check), or raises. ``t_start``: the process's start
    on the perf_counter clock (default: now). ``control_matmul``: the
    control's precision, a reference in it read beside the program's
    tokens (``check.readings``; the benchmark's runs leave it None)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    marks = [("imports", time.perf_counter())]
    traffic = cell.generator().generate(cell.mix, seed, seconds)
    marks.append(("traffic", time.perf_counter()))
    enc, dec = make_weights(cell.config, seed, device, cell.bench_dir)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("weights", time.perf_counter()))
    sl = None
    if trace:
        sl = Slice()
        sl.warm()
    ctx = Context(cell, seed, seconds, device, enc, dec, traffic, sl)
    session = cell.driver().Session(ctx)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("program", time.perf_counter()))
    rec = {"setup_s": marks[-1][1] - t_start}
    print("setup: " + ", ".join(f"{n} {t - at:.2f} s" for (n, t), at in zip(
        marks, [t_start] + [t for _, t in marks])), file=sys.stderr)
    rec.update(session.window(ctx))
    if "host" in rec:
        print(host_line(rec.pop("host")), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    session.close()
    del session, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run loaded {bad}: no run may load "
                         f"{', '.join(FORBIDDEN)}")
    rec["trace"] = sl.summary() if sl is not None else None

    items = sample_items(rec.pop("items"), cell.check["sample"], seed)
    refs = cell.reference()
    ref = refs.Reference(cell.config, enc, dec, device)
    ctrl = None if control_matmul is None else refs.Reference(
        cell.config, enc, dec, device, matmul=control_matmul)
    values = check.readings(ref, items, cell.config["eos_token_ids"], ctrl)
    ok, checks = check.judge(values, cell.check["limits"])

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.metric(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if cuda:
        dev.update(card())
    out = {"correct": bool(ok and rec["failed"] == 0),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if rec["trace"] is not None:
        t = rec["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"],
                   traced=t["what"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = checks
    return out, values
