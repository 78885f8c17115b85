"""No module that the benchmark runs imports JAX or the JAX package, and
the yardstick imports nothing of the program.

Top-level names are compared whole: the program, ``qwen3_asr_rs_tpu_torch``,
begins with the JAX package's name, so a prefix test would be wrong.
"""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "qwen3_asr_rs_tpu"}
PROGRAM = "qwen3_asr_rs_tpu_torch"
# the benchmark's own code that must not depend on the program
YARDSTICK = ("reference", "generators", "metrics", "architectures",
             "harness/work.py", "harness/check.py", "harness/trace.py",
             "harness/stats.py", "harness/weights.py", "harness/spec.py")

RUN_FILES = sorted(p for p in BENCH.rglob("*.py")
                   if "tests" not in p.relative_to(BENCH).parts)


def imported_tops(path) -> set:
    """Top-level names of every import in a file, and of every
    ``import_module`` / ``__import__`` call with a literal name."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            tops.add(node.args[0].value.split(".")[0])
    return tops


def test_the_walk_sees_the_benchmark():
    names = {p.relative_to(BENCH).as_posix() for p in RUN_FILES}
    assert {"run.py", "drivers/serve.py", "drivers/batch.py",
            "reference/qwen3_asr.py", "generators/clips.py",
            "architectures/qwen3_asr.py"} <= names


@pytest.mark.parametrize("path", RUN_FILES,
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_import(path):
    tops = imported_tops(path)
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


@pytest.mark.parametrize(
    "path", [p for p in RUN_FILES
             if p.relative_to(BENCH).as_posix().startswith(YARDSTICK)],
    ids=lambda p: p.relative_to(BENCH).as_posix())
def test_yardstick_imports_nothing_of_the_program(path):
    assert PROGRAM not in imported_tops(path)


def test_prefix_is_not_a_match():
    """The program's own name is allowed; only whole names are refused."""
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert PROGRAM.startswith("qwen3_asr_rs_tpu")


def test_loaded_modules_after_a_driver_import():
    """What the drivers pull in at run time (the program's engine, server
    and batcher) loads no JAX module: the same whole-name test as the
    one each run makes after its window."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from harness.spec import load_any_cell\n"
        "from harness.runner import forbidden_modules\n"
        "import qwen3_asr_rs_tpu_torch.runtime.server\n"
        "import qwen3_asr_rs_tpu_torch.runtime.serving\n"
        "for name in ('asr06-serve-poisson', 'asr17-batch-b32'):\n"
        "    c = load_any_cell(name); c.driver(); c.generator(); c.reference()\n"
        "    [c.metric(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "print(forbidden_modules())\n" % (str(BENCH), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
