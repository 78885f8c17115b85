"""The PyTorch port imports nothing of JAX (nor optax or orbax) or of the
JAX package, and builds nothing at import.

Every module of ``qwen3_asr_rs_tpu_torch`` and ``chip_smoke.py`` is
checked twice: its source, every import statement in it (function-level
ones too) parsed with ``ast``; and ``sys.modules`` in a subprocess that
imports the modules one by one, so that whichever module first pulls in
``qwen3_asr_rs_tpu`` or ``jax`` is the one that fails.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import ast
import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "qwen3_asr_rs_tpu_torch"

MODULES = [
    "qwen3_asr_rs_tpu_torch",
    "qwen3_asr_rs_tpu_torch.cli",
    "qwen3_asr_rs_tpu_torch.runtime.engine",
    "qwen3_asr_rs_tpu_torch.runtime.cuda_graph",
    "qwen3_asr_rs_tpu_torch.runtime.sampling",
    "qwen3_asr_rs_tpu_torch.runtime.longform",
    "qwen3_asr_rs_tpu_torch.runtime.streaming",
    "qwen3_asr_rs_tpu_torch.utils.tracing",
    "qwen3_asr_rs_tpu_torch.weights.loader",
    "qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer",
    "qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention",
    "qwen3_asr_rs_tpu_torch.features",
    "qwen3_asr_rs_tpu_torch.models",
    "qwen3_asr_rs_tpu_torch.ops",
    "qwen3_asr_rs_tpu_torch.training",
    "qwen3_asr_rs_tpu_torch.weights.export",
]


def _module_name(path: Path) -> str:
    parts = path.relative_to(REPO).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


# every module of the port (a sorted file listing: the same on every
# worker), but ``__main__``, which runs the CLI when imported
ALL_MODULES = sorted(_module_name(p) for p in PORT.rglob("*.py")
                     if p.name != "__main__.py")
FORBIDDEN = ("qwen3_asr_rs_tpu", "jax", "jaxlib", "optax", "orbax")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("module", MODULES)
def test_import_does_not_pull_in_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in ('jax', 'jaxlib', 'optax', 'orbax', 'triton')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "from qwen3_asr_rs_tpu_torch.ops.kernels import _build\n"
        "assert not _build._libs, 'a kernel library was loaded at import'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("source", [str(p.relative_to(REPO)) for p in sorted(
    PORT.rglob("*.py"))] + ["chip_smoke.py"])
def test_sources_import_nothing_of_jax_or_the_jax_package(source):
    """Absolute imports only: the port's own are relative, or name
    ``qwen3_asr_rs_tpu_torch``."""
    tree = ast.parse((REPO / source).read_text(), source)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{source} imports {bad}"


@functools.lru_cache(maxsize=None)
def _first_imports() -> dict:
    """{module: forbidden modules that appeared in sys.modules when it was
    imported}, importing every module of the port in order in one fresh
    interpreter, then chip_smoke."""
    code = (
        "import importlib, json, sys\n"
        f"forbidden = {FORBIDDEN!r}\n"
        "def bad():\n"
        "    return sorted(m for m in sys.modules if any(\n"
        "        m == f or m.startswith(f + '.') for f in forbidden))\n"
        "out = {}\n"
        f"for name in {ALL_MODULES + ['chip_smoke']!r}:\n"
        "    before = set(bad())\n"
        "    importlib.import_module(name)\n"
        "    out[name] = sorted(set(bad()) - before)\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", ALL_MODULES + ["chip_smoke"])
def test_importing_brings_no_jax_package_module(module):
    assert _first_imports()[module] == []


def test_kernel_sources_exist_for_every_build_target():
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build

    for name in _build.KERNEL_SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
