"""The decoder architecture sits behind one seam, ``models/decoders.py``:
the text config's decoder comes from ``DECODERS``, and a mode that not
every decoder runs is refused by ``require``. Outside ``models/`` the
package names no architecture's own types, and ``runtime/`` reads no
kernel launch counter but through ``ops.kernels.COUNTED``.

The structural test reads every module's source with ``ast``."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import ast
import importlib
from pathlib import Path

import pytest

from qwen3_asr_rs_tpu_torch.config import DeepseekV3TextConfig, TextDecoderConfig
from qwen3_asr_rs_tpu_torch.errors import ArchitectureNotSupported
from qwen3_asr_rs_tpu_torch.models.decoders import (
    DECODERS,
    MODES,
    decoder_class,
    require,
)
from qwen3_asr_rs_tpu_torch.models.text_decoder import TextDecoder

PORT = Path(__file__).resolve().parents[1] / "qwen3_asr_rs_tpu_torch"
PACKAGE = PORT.name

# the routed decoder's own names, which only ``models/`` may use
ROUTED_NAMES = {"deepseek_v3_decoder", "DeepseekV3Decoder", "RouteCounts",
                "LatentCache", "is_routed", "refuse"}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dense_decoder_runs_every_mode(mode):
    assert decoder_class(TextDecoderConfig()) is TextDecoder
    require(TextDecoderConfig(), mode)


def test_routed_decoder_runs_no_mode_and_unknown_modes_raise():
    text = DeepseekV3TextConfig()
    assert set(DECODERS) == {TextDecoderConfig, DeepseekV3TextConfig}
    for mode in MODES:
        with pytest.raises(ArchitectureNotSupported,
                           match=f"^{mode} does not run the deepseek_v3"):
            require(text, mode)
    with pytest.raises(ArchitectureNotSupported,
                       match="^quantize='int8' does not run"):
        require(text, "quantized weights", "quantize='int8'")
    with pytest.raises(ValueError, match="unknown mode"):
        require(TextDecoderConfig(), "no such mode")


def _module(path: Path) -> str:
    parts = path.relative_to(PORT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imported(path: Path, node: ast.ImportFrom) -> str:
    """The absolute module of a ``from ... import`` in ``path``."""
    if node.level == 0:
        return node.module or ""
    package = _module(path).split(".")
    if path.name != "__init__.py":
        package = package[:-1]
    base = package[:len(package) - (node.level - 1)]
    return ".".join(base + ([node.module] if node.module else []))


def test_only_models_name_an_architecture_and_runtime_reads_no_counter():
    from qwen3_asr_rs_tpu_torch.ops import kernels

    named, counters = [], []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT)
        tree = ast.parse(path.read_text(), str(rel))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mod = _imported(path, node)
                names = {mod.rsplit(".", 1)[-1]} | {a.name for a in
                                                     node.names}
            elif isinstance(node, ast.Import):
                names = {p for a in node.names for p in a.name.split(".")}
            elif isinstance(node, ast.Name):
                names = {node.id}
            elif isinstance(node, ast.Attribute):
                names = {node.attr}
            else:
                continue
            if rel.parts[0] != "models" and names & ROUTED_NAMES:
                named.append((str(rel), sorted(names & ROUTED_NAMES)))
            if rel.parts[0] != "runtime":
                continue
            if isinstance(node, ast.Attribute) and node.attr == "launches" \
                    and rel.name != "cuda_graph.py":
                counters.append((str(rel), "reads .launches"))
            if isinstance(node, ast.ImportFrom) and mod.startswith(
                    f"{PACKAGE}.ops.kernels."):
                if rel.name == "cuda_graph.py":
                    counters.append((str(rel), mod))
                source = importlib.import_module(mod)
                for a in node.names:
                    obj = getattr(source, a.name)
                    if any(obj is c for c in kernels.COUNTED) \
                            and not callable(obj):
                        counters.append((str(rel), a.name))
    assert not named, named
    assert not counters, counters
