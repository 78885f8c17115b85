"""Finding a cell and its files by name.

``BENCHMARK.json`` names the cells, configurations and metrics; every
piece that belongs to one of them is a file of its own under
``benchmark/``, found by the name alone:

    configs/<config>.json        the configuration as it is run
    traffic/<traffic>.json       a mix: its generator, driver and numbers
    generators/<generator>.py    makes a mix's requests from the seed
    drivers/<driver>.py          the entry that the window drives
    checks/<cell>.json           what ``correct`` compares, and the limits
    held/<cell>.json             a cell held out of BENCHMARK.json: its
                                 entries, for the tools and the tests
    metrics/<metric>.py          reads one metric from the run's record
    reference/<reference>.py     the plain float32 model of a config
    architectures/<arch>.py      a decoder's weight layout and work counts,
                                 named by a config's ``architecture``
                                 (default ``qwen3_asr``)

A later cell or metric adds files and entries; none of these is edited.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """The module of one file, by its path (metric file names hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    stem = path.stem.replace(".", "_").replace("-", "_")
    digest = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:8]
    modname = name or f"bench_{stem}_{digest}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[modname] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def architecture(config: dict, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module of ``config``'s decoder architecture: its
    ``architecture`` (default ``qwen3_asr``), under ``bench_dir``."""
    return _architecture(config.get("architecture", "qwen3_asr"), bench_dir)


@functools.lru_cache(maxsize=None)
def _architecture(name: str, bench_dir: Path) -> ModuleType:
    # asked once per decode step of the window's accounting, where
    # load_module's resolve and hash took ~50 us a call
    return load_module(bench_dir / "architectures" / f"{name}.py")


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    name: str
    chips: int
    config: dict          # configs/<config>.json
    mix: dict             # traffic/<traffic>.json
    check: dict           # checks/<cell>.json
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    bench_dir: Path

    def generator(self) -> ModuleType:
        return load_module(self.bench_dir / "generators"
                           / f"{self.mix['generator']}.py")

    def driver(self) -> ModuleType:
        return load_module(self.bench_dir / "drivers"
                           / f"{self.mix['driver']}.py")

    def reference(self) -> ModuleType:
        return load_module(self.bench_dir / "reference"
                           / f"{self.config['reference']}.py")

    def metric(self, name: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{name}.py")

    def architecture(self) -> ModuleType:
        return architecture(self.config, self.bench_dir)


def reports(metric: dict, cell: str, cell_e2e: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed in the metric's
    ``workloads``; without that key, an end-to-end metric is every
    cell's and a per-layer one is every cell's that reports its
    ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in cell_e2e
    return True


def with_held(bench: dict, bench_dir: Path = BENCH_DIR) -> dict:
    """``bench`` with the entries of every held-back cell
    (``held/<cell>.json``) added where their names are new. The runs read
    BENCHMARK.json alone; ``sweep.py``, ``control.py`` and the tests also
    take the held cells, whose proof is still open."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in bench.items()}
    for path in sorted((bench_dir / "held").glob("*.json")):
        held = read_json(path)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            have = {e["name"] for e in out[key]}
            out[key] += [e for e in held.get(key, []) if e["name"] not in have]
    return out


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              bench: Optional[dict] = None) -> Cell:
    """The cell called ``name`` in BENCHMARK.json (at the checkout's root
    beside ``bench_dir``; ``bench``: its contents given instead), with its
    files read."""
    if bench is None:
        bench = read_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=read_json(bench_dir.parent / cfg_entry["file"]),
        mix=read_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        check=read_json(bench_dir / "checks" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


def load_any_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """``load_cell`` over BENCHMARK.json with the held-back cells added."""
    bench = read_json(bench_dir.parent / "BENCHMARK.json")
    return load_cell(name, bench_dir, with_held(bench, bench_dir))
