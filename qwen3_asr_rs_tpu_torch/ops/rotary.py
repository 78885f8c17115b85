"""MRoPE rotary position embedding (port of ``qwen3_asr_rs_tpu/ops/rotary.py``).

Per-frequency angle tables are built once on the host in float64 and
kept as float32 tensors on the device; a position lookup is a gather.
MRoPE maps each rotary frequency to one of three position rows through a
contiguous (src/layers.rs:524-538) or interleaved (src/layers.rs:540-562)
section map. For Qwen3-ASR all three rows are identical, which reduces
to standard RoPE, but the general path is kept.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def build_contiguous_dim_map(sections: Sequence[int], total: int) -> np.ndarray:
    """dim_map[j] = mrope row for frequency j; sections laid out contiguously."""
    out = []
    for dim, size in enumerate(sections):
        for _ in range(size):
            if len(out) >= total:
                break
            out.append(dim)
    while len(out) < total:
        out.append(len(sections) - 1)
    return np.asarray(out, dtype=np.int64)


def build_interleaved_dim_map(sections: Sequence[int], total: int) -> np.ndarray:
    """Round-robin over rows until each row's section quota is used up."""
    n_dims = len(sections)
    counts = [0] * n_dims
    out: list[int] = []
    while len(out) < total:
        prev = len(out)
        for dim in range(n_dims):
            if len(out) >= total:
                break
            if counts[dim] < sections[dim]:
                out.append(dim)
                counts[dim] += 1
        if len(out) == prev:
            break
    return np.asarray(out, dtype=np.int64)


class RotaryTable:
    """Precomputed rotary angle tables with MRoPE section lookup."""

    def __init__(
        self,
        head_dim: int,
        rope_theta: float = 1_000_000.0,
        mrope_section: Sequence[int] = (24, 20, 20),
        interleaved: bool = False,
        max_position: int = 8192,
        device: str | torch.device = "cpu",
    ):
        self.head_dim = head_dim
        self.half_dim = head_dim // 2
        self.max_position = max_position
        inv_freq = 1.0 / rope_theta ** (
            2.0 * np.arange(self.half_dim, dtype=np.float64) / head_dim
        )
        if interleaved:
            dim_map = build_interleaved_dim_map(mrope_section, self.half_dim)
        else:
            dim_map = build_contiguous_dim_map(mrope_section, self.half_dim)
        angles = np.arange(max_position, dtype=np.float64)[:, None] * inv_freq[None, :]
        self.cos_table = torch.from_numpy(np.cos(angles).astype(np.float32)).to(device)
        self.sin_table = torch.from_numpy(np.sin(angles).astype(np.float32)).to(device)
        self.dim_map = torch.from_numpy(dim_map).to(device)

    def lookup(self, position_ids):
        """cos/sin, each (seq, head_dim) float32, for position ids of shape
        ``(seq,)`` (identical MRoPE rows, the ASR case) or ``(3, seq)``."""
        position_ids = torch.as_tensor(position_ids, device=self.cos_table.device)
        if position_ids.ndim == 1:
            return self.lookup_batch(position_ids)
        # per-frequency row select: pos[t, j] = position_ids[dim_map[j], t]
        pos = position_ids[self.dim_map, :].T  # (seq, half_dim)
        j = torch.arange(self.half_dim, device=pos.device)[None, :]
        cos_half = self.cos_table[pos, j]
        sin_half = self.sin_table[pos, j]
        return (torch.cat([cos_half, cos_half], dim=-1),
                torch.cat([sin_half, sin_half], dim=-1))

    def lookup_batch(self, position_ids):
        """cos/sin (..., head_dim) float32 for positions of any shape, such
        as per-example positions (B, S) of a right-aligned batch (pos =
        slot - kv_start). All MRoPE rows are identical for ASR, so a plain
        row gather is exact."""
        position_ids = torch.as_tensor(position_ids, device=self.cos_table.device)
        cos_half = self.cos_table[position_ids]
        sin_half = self.sin_table[position_ids]
        return (torch.cat([cos_half, cos_half], dim=-1),
                torch.cat([sin_half, sin_half], dim=-1))

    def lookup_pos(self, pos: int):
        """cos/sin (1, head_dim) for one host-known position (decode)."""
        cos_half = self.cos_table[pos:pos + 1]
        sin_half = self.sin_table[pos:pos + 1]
        return (torch.cat([cos_half, cos_half], dim=-1),
                torch.cat([sin_half, sin_half], dim=-1))

    def lookup_at(self, pos):
        """cos/sin (n, head_dim) at device positions: a 0-d (n = 1) or
        (n,) integer tensor. A decode step captured in a CUDA graph reads
        its position here, as a gather on the device: a host int would be
        frozen into the graph."""
        return self.lookup_batch(pos.reshape(-1).long())


def apply_rotary(x, cos, sin):
    """Rotate ``x`` (B, S, H, D) by cos/sin of shape (S, D) or (B, S, D).

    Rotate-half convention (src/layers.rs:361-375):
    out = x * cos + [-x2, x1] * sin, in f32, cast back to x.dtype.
    """
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    if cos.ndim == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return (xf * c + rotated * s).to(x.dtype)
