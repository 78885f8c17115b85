"""Checkpoint loading and export, and synthetic parameters (torch
tensors, JAX layouts)."""

from .loader import load_checkpoint, load_model_params

__all__ = ["load_checkpoint", "load_model_params"]
