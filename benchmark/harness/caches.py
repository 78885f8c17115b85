"""Every build and kernel cache inside the checkout, at fixed paths
(``build/`` at its root, which git ignores), so that only a checkout's
first run builds and compiles, and two checkouts share nothing. Called
before torch is imported."""

from __future__ import annotations

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def fix_cache_dirs() -> None:
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ.setdefault("USE_FLAX", "0")
