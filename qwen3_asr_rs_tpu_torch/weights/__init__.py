"""Checkpoint loading and synthetic parameters (torch tensors, JAX layouts)."""
