"""The PyTorch port imports without JAX and builds nothing at import."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "qwen3_asr_rs_tpu_torch",
    "qwen3_asr_rs_tpu_torch.cli",
    "qwen3_asr_rs_tpu_torch.runtime.engine",
    "qwen3_asr_rs_tpu_torch.weights.loader",
    "qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer",
    "qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention",
]


@pytest.mark.parametrize("module", MODULES)
def test_import_does_not_pull_in_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in ('jax', 'jaxlib', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "from qwen3_asr_rs_tpu_torch.ops.kernels import _build\n"
        "assert not _build._libs, 'a kernel library was loaded at import'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_kernel_sources_exist_for_every_build_target():
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build

    for name in _build.KERNEL_SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
