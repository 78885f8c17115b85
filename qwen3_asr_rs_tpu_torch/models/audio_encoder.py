"""Whisper-style chunked audio encoder in PyTorch.

Port of ``qwen3_asr_rs_tpu/models/audio_encoder.py``: 100-frame chunks,
3x Conv2d stride-2 pad-1 stem with exact GELU, (c, f, t) -> (t, c*f) +
conv_out, per-chunk sinusoid positions, windows of ``chunks_per_window``
chunks run as a batch through the layers with a per-window key-prefix
validity count, then ln_post -> proj1 -> GELU -> proj2. The flat output
is chunk-major with all valid tokens a prefix, so callers take
``out[:n_valid]``. Linear weights are (in, out) as in JAX. ``batch``
encodes a batch of bucketed mels (an offline call's clips, a training
batch), each row with its own true frame count.

Under tensor parallelism (``tp``, when the head count divides it: the
spec tree of ``parallel/sharding.encoder_param_specs``) each rank holds
its heads' q/k/v and fc1 columns with their biases, and its rows of out
and fc2: the two row-parallel products are all-reduced, and their
replicated biases are added once, after the sum.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import AudioEncoderConfig, audio_tokens
from ..ops.attention import attention
from ..ops.norms import layer_norm
from ..parallel.comm import copy_to_tp, reduce_from_tp
from ..weights.convert import unstack_layers

Tree = Any


def sinusoid_position_embedding(max_len: int, dim: int) -> np.ndarray:
    """Whisper sinusoid table: sin in the first half, cos in the second
    (src/audio_encoder.rs:283-301). Built in float64 on host."""
    half = dim // 2
    log_timescale_increment = np.log(10000.0) / (half - 1)
    inv_timescales = np.exp(-np.arange(half, dtype=np.float64) *
                            log_timescale_increment)
    angles = np.arange(max_len, dtype=np.float64)[:, None] * inv_timescales[None, :]
    table = np.zeros((max_len, dim), dtype=np.float32)
    table[:, :half] = np.sin(angles)
    table[:, half:] = np.cos(angles)
    return table


def conv_stem_output_time(chunk_frames: int) -> int:
    """Conv output time length for a (zero-padded) full chunk."""
    n = chunk_frames
    for _ in range(3):
        n = (n + 2 * 1 - 3) // 2 + 1  # kernel 3, stride 2, pad 1
    return n


class AudioEncoder:
    """Stateless encoder; parameters are passed to every call.

    ``remat``: with grad enabled, checkpoint each encoder layer (the
    backward recomputes it from its input; JAX's ``nothing_saveable`` per
    scanned layer). ``tp``: this rank's view of the mesh's 'tp' axis
    (``parallel/comm.mesh_axis``) for tensor-parallel layers; None (also
    when the heads do not divide over it) runs the whole layer."""

    def __init__(self, cfg: AudioEncoderConfig,
                 device: str | torch.device = "cpu", remat: bool = False,
                 tp=None):
        self.cfg = cfg
        self.remat = remat
        self.tp = (tp if tp is not None
                   and cfg.encoder_attention_heads % tp.size == 0 else None)
        self.heads = cfg.encoder_attention_heads // (
            1 if self.tp is None else self.tp.size)
        self.pos_table = torch.from_numpy(
            sinusoid_position_embedding(cfg.max_source_positions, cfg.d_model)
        ).to(device)

    def valid_tokens(self, n_true_frames: int) -> int:
        """Total valid output tokens for a true mel frame count
        (``config.audio_tokens``)."""
        return audio_tokens(self.cfg, n_true_frames)

    def _valid_tokens_rows(self, n_frames):
        """``valid_tokens`` of a (B,) integer tensor, on its device."""
        cf = self.cfg.chunk_frames
        tail = n_frames % cf
        for _ in range(3):
            tail = torch.where(tail > 0, torch.div(tail - 1, 2,
                                                   rounding_mode="floor") + 1,
                               0)
        return (n_frames // cf) * self.cfg.tokens_per_chunk + tail

    def __call__(self, params: Tree, mel, n_true_frames: int):
        """Encode a bucketed mel spectrogram.

        mel: (num_mel_bins, F) with F a multiple of chunk_frames; padded
        frames are 0.0. Returns (flat_tokens (num_chunks * tpc,
        output_dim), n_valid).
        """
        cfg = self.cfg
        cf = cfg.chunk_frames
        tpc = cfg.tokens_per_chunk
        n_mels, frames = mel.shape
        if frames % cf:
            raise ValueError(f"mel frames {frames} not a chunk multiple")
        num_chunks = frames // cf

        # (C, 1, mel_bins, chunk_frames)
        x = self._stem(params, mel.reshape(n_mels, num_chunks, cf)
                       .permute(1, 0, 2)[:, None])

        # windows of chunks as a batch; one window when the audio fits
        cpw = min(cfg.chunks_per_window, num_chunks)
        num_windows = -(-num_chunks // cpw)
        pad_chunks = num_windows * cpw - num_chunks
        if pad_chunks:
            x = F.pad(x, (0, 0, 0, 0, 0, pad_chunks))
        win_tokens = cpw * tpc
        xw = x.reshape(num_windows, win_tokens, cfg.d_model)

        # valid tokens form a prefix of every window
        n_valid = self.valid_tokens(n_true_frames)
        win_counts = torch.clamp(
            n_valid - torch.arange(num_windows, device=mel.device) * win_tokens,
            0, win_tokens,
        ).to(torch.int32)

        h = self._head(params, self._layers(params, xw, win_counts))
        flat = h.reshape(num_windows * win_tokens, cfg.output_dim)
        return flat[: num_chunks * tpc], n_valid

    def batch(self, params: Tree, mel, n_frames):
        """Encode a batch of bucketed mels, each row with its own true
        frame count (JAX ``jax.vmap(encoder, in_axes=(None, 0, 0))``: the
        engine's clips, the training batch): mel (B, num_mel_bins, F),
        n_frames (B,) integer tensor. Every row's windows run as one batch
        through the layers, with ``__call__``'s per-window key counts.
        Returns (flat_tokens (B, num_chunks * tpc, output_dim), n_valid
        (B,))."""
        cfg = self.cfg
        cf = cfg.chunk_frames
        tpc = cfg.tokens_per_chunk
        bsz, n_mels, frames = mel.shape
        if frames % cf:
            raise ValueError(f"mel frames {frames} not a chunk multiple")
        num_chunks = frames // cf

        x = self._stem(params, mel.reshape(bsz, n_mels, num_chunks, cf)
                       .permute(0, 2, 1, 3)
                       .reshape(bsz * num_chunks, 1, n_mels, cf))
        cpw = min(cfg.chunks_per_window, num_chunks)
        num_windows = -(-num_chunks // cpw)
        x = x.reshape(bsz, num_chunks, tpc, cfg.d_model)
        pad_chunks = num_windows * cpw - num_chunks
        if pad_chunks:
            x = F.pad(x, (0, 0, 0, 0, 0, pad_chunks))
        win_tokens = cpw * tpc
        xw = x.reshape(bsz * num_windows, win_tokens, cfg.d_model)

        n_valid = self._valid_tokens_rows(n_frames.to(mel.device).long())
        win_counts = torch.clamp(
            n_valid[:, None]
            - torch.arange(num_windows, device=mel.device) * win_tokens,
            0, win_tokens,
        ).reshape(-1).to(torch.int32)

        h = self._head(params, self._layers(params, xw, win_counts))
        flat = h.reshape(bsz, num_windows * win_tokens, cfg.output_dim)
        return flat[:, : num_chunks * tpc], n_valid

    def _stem(self, params: Tree, x):
        """(N, 1, mel_bins, chunk_frames) chunks -> (N, tpc, d_model): the
        conv stem, conv_out and the per-chunk positions, in groups of at
        most ``conv_chunksize`` chunks (the conv activations of a whole
        batch's chunks at once would be gigabytes; chunks are
        independent, so the grouping changes no value)."""
        x = x.to(params["conv1_w"].dtype)
        parts = [self._stem_group(params, g)
                 for g in x.split(self.cfg.conv_chunksize)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _stem_group(self, params: Tree, x):
        for i in (1, 2, 3):
            x = F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                         stride=2, padding=1)
            x = F.gelu(x, approximate="none")

        c_chunks, ch, fr, t = x.shape
        x = x.permute(0, 3, 1, 2).reshape(c_chunks, t, ch * fr)
        x = x @ params["conv_out_w"] + params["conv_out_b"]
        if t != self.cfg.tokens_per_chunk:
            raise ValueError(
                f"conv stem gave {t} tokens, expected "
                f"{self.cfg.tokens_per_chunk}")
        return x + self.pos_table[:t][None].to(x.dtype)

    def _layers(self, params: Tree, xw, win_counts):
        remat = self.remat and torch.is_grad_enabled()
        for layer in unstack_layers(params["layers"]):
            if remat:
                xw = checkpoint(self._encoder_layer, layer, xw, win_counts,
                                use_reentrant=False)
            else:
                xw = self._encoder_layer(layer, xw, win_counts)
        return xw

    def _head(self, params: Tree, xw):
        """ln_post -> proj1 -> GELU -> proj2."""
        h = layer_norm(xw, params["ln_post_w"], params["ln_post_b"], eps=1e-5)
        h = F.gelu(h @ params["proj1_w"] + params["proj1_b"],
                   approximate="none")
        return h @ params["proj2_w"] + params["proj2_b"]

    def _encoder_layer(self, layer: Tree, x, win_counts):
        """Pre-norm bidirectional MHA + GELU FFN (src/layers.rs:202-243)."""
        nh, hd, tp = self.heads, self.cfg.head_dim, self.tp
        b, s, _ = x.shape

        residual = x
        h = copy_to_tp(layer_norm(x, layer["attn_ln_w"], layer["attn_ln_b"],
                                  eps=1e-5), tp)
        q = (h @ layer["q_w"] + layer["q_b"]).reshape(b, s, nh, hd)
        k = (h @ layer["k_w"] + layer["k_b"]).reshape(b, s, nh, hd)
        v = (h @ layer["v_w"] + layer["v_b"]).reshape(b, s, nh, hd)
        attn = attention(q, k, v, kv_valid=win_counts).reshape(b, s, nh * hd)
        x = residual + (reduce_from_tp(attn @ layer["out_w"], tp)
                        + layer["out_b"])

        residual = x
        h = copy_to_tp(layer_norm(x, layer["ffn_ln_w"], layer["ffn_ln_b"],
                                  eps=1e-5), tp)
        h = F.gelu(h @ layer["fc1_w"] + layer["fc1_b"], approximate="none")
        h = reduce_from_tp(h @ layer["fc2_w"], tp) + layer["fc2_b"]
        return residual + h
