"""The control of each cell's check, on a card at the cell's own size: the
reference in float8 e4m3 products (one step below the configurations'
bf16), read at the positions of the program's own runs, has to come out
not correct on three seeds, and the program correct. Skips without a
CUDA card; on one:

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""

from __future__ import annotations

import pytest

from tiny import BENCH, ROOT  # noqa: F401  (puts the harness on the path)

from harness.spec import load_any_cell, load_module

CELLS = ["asr06-serve-poisson", "asr17-batch-b32"]
SEEDS = [2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903]
SECONDS = 10.0  # the cell's own load, long enough for its longest clips


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA card")
    control = load_module(BENCH / "control.py")
    runs = control.readings(load_any_cell(name), SEEDS, SECONDS)
    assert [r[4] for r in runs] == [False] * len(SEEDS), runs
    assert [r[2] for r in runs] == [True] * len(SEEDS), runs
