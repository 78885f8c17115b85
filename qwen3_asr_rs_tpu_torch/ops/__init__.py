"""Tensor ops: norms, rotary embeddings, attention; CUDA kernels in
``kernels``, whose wrappers import (and build) nothing until they run."""

from .attention import dense_attention
from .norms import layer_norm, rms_norm
from .rotary import RotaryTable, apply_rotary

__all__ = [
    "layer_norm",
    "rms_norm",
    "RotaryTable",
    "apply_rotary",
    "dense_attention",
]
