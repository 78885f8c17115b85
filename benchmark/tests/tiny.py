"""Tiny cells for the CPU tests: the real cells' drivers, generators,
reference and metrics over a miniature configuration in float32
(``tiny_test_config``'s widths with the real vocabulary, so that the
prompt's token ids exist), short windows and few requests."""

from __future__ import annotations

import copy
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import Cell, load_any_cell, read_json  # noqa: E402

REAL = {"serve": "asr06-serve-poisson", "batch": "asr17-batch-b32"}


def tiny_config() -> dict:
    cfg = read_json(BENCH / "configs" / "qwen3-asr-0.6b.json")
    cfg = copy.deepcopy(cfg)
    cfg["name"] = "tiny"
    cfg["dtype"] = "float32"
    # the layers' share of the residual stream grows with scale x width:
    # at 64 wide, 0.3 gives about what 0.02 gives at the real widths,
    # where a token's own embedding does not decide the next token
    cfg["weight_init"] = {"scale": 0.3}
    cfg["thinker_config"]["audio_config"].update(
        d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, downsample_hidden_size=32, output_dim=64)
    cfg["thinker_config"]["text_config"].update(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16)
    return cfg


def tiny_mix(kind: str) -> dict:
    if kind == "serve":
        return {"generator": "clips", "driver": "serve",
                "arrival": {"kind": "poisson", "rate_per_s": 3.0},
                "lengths_s": [
                    {"share": 0.8, "dist": "lognormal", "median": 2.0,
                     "sigma": 0.5, "min": 1.0, "max": 4.0},
                    {"share": 0.2, "dist": "uniform", "min": 5.0,
                     "max": 9.0}],
                "max_new_tokens": {"per_audio_s": 3.5, "plus": 4},
                "amplitude": 0.1,
                "server": {"max_batch": 4, "segment_steps": 4,
                           "max_new_tokens": 48},
                "trace_slice_s": 1.0}
    return {"generator": "clips", "driver": "batch",
            "arrival": {"kind": "closed", "batch": 4, "pool": 2},
            "lengths_s": [{"share": 1.0, "dist": "lognormal", "median": 3.0,
                           "sigma": 0.5, "min": 1.0, "max": 6.0}],
            "amplitude": 0.1,
            "engine": {"max_new_tokens": 8, "warmup_batch_sizes": [4],
                       "warmup_chunk_buckets": [8]}}


def tiny_cell(kind: str, limit: float = 1e-3) -> Cell:
    """The ``kind`` ('serve' or 'batch') cell at tiny size, reporting the
    metrics of the real cell of that kind."""
    real = load_any_cell(REAL[kind])
    return Cell(name=f"tiny-{kind}", chips=1, config=tiny_config(),
                mix=tiny_mix(kind),
                check={"sample": 4, "limits": {"max_gap": limit}},
                end_to_end=real.end_to_end, per_layer=real.per_layer,
                bench_dir=BENCH)


def copy_bench(tmp_path: Path) -> tuple:
    """(the copy of ``benchmark/`` under ``tmp_path``, without its tests,
    {path: bytes} of every file in it): an addition is made there, and
    the bytes show that it changed no file that was there."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    b = tmp_path / "benchmark"
    return b, {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
