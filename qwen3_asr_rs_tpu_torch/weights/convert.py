"""Parameter trees as torch tensors, in the JAX package's layouts.

The port keeps the JAX parameter pytrees exactly: nested dicts with the
same keys, per-layer tensors stacked along a leading ``(L, ...)`` axis,
linear weights stored ``(in, out)`` so forwards are ``x @ w``, and
``embed``/``lm_head`` stored ``(V, H)``. A tied ``lm_head`` is the same
tensor object as ``embed``, as in JAX.

``init_encoder_params``/``init_decoder_params`` repeat the JAX package's
synthetic initialisers (``models/audio_encoder.py:214-270``,
``models/text_decoder.py:1333-1371``) in numpy with the same seeds and
the same ``np.random.default_rng`` call order, so a machine without jax
builds bit-identical weights.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..config import AudioEncoderConfig, TextDecoderConfig

Tree = Any


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """``fn(name, leaf)`` for every leaf, ``name`` its dict key (None at
    the top), mapping a shared leaf (tied embeddings) once so the result
    shares it too."""
    done: dict[int, Any] = {}

    def go(node, name):
        if isinstance(node, dict):
            return {k: go(v, k) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(go(v, name) for v in node)
        if id(node) not in done:
            done[id(node)] = fn(name, node)
        return done[id(node)]

    return go(tree, None)


def unstack_layers(layers: Tree) -> list:
    """The stacked (L, ...) layer tree as L per-layer dicts of views, by
    one ``unbind`` per leaf: its backward stacks the L gradients in one
    copy, where indexing ``leaf[l]`` per layer would add a zero-filled
    full-size gradient per layer (L^2 / 2 times the leaf's bytes)."""
    names = list(layers)
    return [dict(zip(names, ts))
            for ts in zip(*(layers[n].unbind(0) for n in names))]


def to_torch(tree: Tree, dtype: torch.dtype | None = None,
             device: str | torch.device = "cpu") -> Tree:
    """numpy arrays (or anything ``np.asarray`` takes, e.g. jax arrays)
    or tensors -> torch tensors on ``device``, float leaves cast to
    ``dtype``. Quantized trees (``weights/quantize.py``) carry across
    unchanged: integer leaves keep their dtype and the ``*_s`` scale
    leaves stay float32. The JAX engine's ``lm_fold_*`` leaves (a
    padded copy of the lm_head for the TPU fold) are dropped."""

    def conv(name, x):
        if not isinstance(x, torch.Tensor):
            a = np.ascontiguousarray(np.asarray(x))
            a = a if a.flags.writeable else a.copy()
            if a.dtype.name == "bfloat16":  # ml_dtypes' bf16 (jax arrays)
                x = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
            else:
                x = torch.from_numpy(a)
        if not x.is_floating_point():
            return x.to(device=device)
        if name is not None and name.endswith("_s"):
            return x.to(device=device, dtype=torch.float32)
        return x.to(device=device, dtype=dtype or x.dtype)

    return _drop_lm_fold(tree_map(conv, tree))


def key_to_torch(data, device: str | torch.device = "cpu") -> torch.Tensor:
    """A JAX threefry key's data (``jax.random.key_data``, or a raw
    ``PRNGKey``: a ``uint32 (..., 2)`` array) as the port's key tensor
    (``ops/prng.py``): the same two words, int64."""
    a = np.asarray(data)
    if a.dtype != np.uint32 or a.shape[-1:] != (2,):
        raise ValueError(f"a threefry key is uint32 (..., 2), got "
                         f"{a.dtype} {a.shape}")
    return torch.from_numpy(a.astype(np.int64)).to(device)


def _drop_lm_fold(tree: Tree) -> Tree:
    """The tree without the JAX engine's ``lm_fold_w``/``lm_fold_s``: a
    padded, transposed lm_head copy for the TPU fold, derived from the
    lm_head, which the port's fold reads where it lies."""
    if isinstance(tree, tuple):
        return tuple(_drop_lm_fold(t) for t in tree)
    if isinstance(tree, dict):
        return {k: v for k, v in tree.items() if not k.startswith("lm_fold_")}
    return tree


def _conv_stem_freq(num_mel_bins: int) -> int:
    n = num_mel_bins
    for _ in range(3):
        n = (n + 2 * 1 - 3) // 2 + 1  # kernel 3, stride 2, pad 1
    return n


def init_encoder_params_np(cfg: AudioEncoderConfig, seed: int = 1,
                           scale: float = 0.02) -> Tree:
    """float32 numpy twin of the JAX ``init_encoder_params``."""
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.encoder_ffn_dim
    dh = cfg.downsample_hidden_size
    nl = cfg.encoder_layers
    freq_after = _conv_stem_freq(cfg.num_mel_bins)

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    # dict literal order == the JAX function's RNG call order
    return {
        "conv1_w": w(dh, 1, 3, 3),
        "conv1_b": zeros(dh),
        "conv2_w": w(dh, dh, 3, 3),
        "conv2_b": zeros(dh),
        "conv3_w": w(dh, dh, 3, 3),
        "conv3_b": zeros(dh),
        "conv_out_w": w(dh * freq_after, d),
        "conv_out_b": zeros(d),
        "layers": {
            "attn_ln_w": ones(nl, d),
            "attn_ln_b": zeros(nl, d),
            "q_w": w(nl, d, d),
            "q_b": zeros(nl, d),
            "k_w": w(nl, d, d),
            "k_b": zeros(nl, d),
            "v_w": w(nl, d, d),
            "v_b": zeros(nl, d),
            "out_w": w(nl, d, d),
            "out_b": zeros(nl, d),
            "ffn_ln_w": ones(nl, d),
            "ffn_ln_b": zeros(nl, d),
            "fc1_w": w(nl, d, ff),
            "fc1_b": zeros(nl, ff),
            "fc2_w": w(nl, ff, d),
            "fc2_b": zeros(nl, d),
        },
        "ln_post_w": ones(d),
        "ln_post_b": zeros(d),
        "proj1_w": w(d, d),
        "proj1_b": zeros(d),
        "proj2_w": w(d, cfg.output_dim),
        "proj2_b": zeros(cfg.output_dim),
    }


def init_decoder_params_np(cfg: TextDecoderConfig, seed: int = 0,
                           scale: float = 0.02) -> Tree:
    """float32 numpy twin of the JAX ``init_decoder_params``."""
    rng = np.random.default_rng(seed)
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    inter, v, nl = cfg.intermediate_size, cfg.vocab_size, cfg.num_hidden_layers

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    def ones(*shape):
        return np.ones(shape, np.float32)

    embed = w(v, h)
    return {
        "embed": embed,
        "layers": {
            "input_ln_w": ones(nl, h),
            "q_w": w(nl, h, nq * d),
            "k_w": w(nl, h, nkv * d),
            "v_w": w(nl, h, nkv * d),
            "o_w": w(nl, nq * d, h),
            "q_norm_w": ones(nl, d),
            "k_norm_w": ones(nl, d),
            "post_ln_w": ones(nl, h),
            "gate_w": w(nl, h, inter),
            "up_w": w(nl, h, inter),
            "down_w": w(nl, inter, h),
        },
        "final_ln_w": ones(h),
        "lm_head": embed if cfg.tie_word_embeddings else w(v, h),
    }


def init_encoder_params(cfg: AudioEncoderConfig, seed: int = 1,
                        dtype: torch.dtype = torch.bfloat16,
                        scale: float = 0.02,
                        device: str | torch.device = "cpu") -> Tree:
    """Synthetic encoder weights as torch tensors (== JAX's, cast)."""
    return to_torch(init_encoder_params_np(cfg, seed, scale), dtype, device)


def init_decoder_params(cfg: TextDecoderConfig, seed: int = 0,
                        dtype: torch.dtype = torch.bfloat16,
                        scale: float = 0.02,
                        device: str | torch.device = "cpu") -> Tree:
    """Synthetic decoder weights as torch tensors (== JAX's, cast)."""
    return to_torch(init_decoder_params_np(cfg, seed, scale), dtype, device)


def from_torch(tree: Tree) -> Tree:
    """torch tensors (any device, with or without grad) -> numpy arrays,
    the inverse of ``to_torch`` for comparing a port tree with a JAX
    one. The arrays are copies (a training step updates its tensors in
    place); bf16 leaves become float32 (exact: numpy has no bf16)."""

    def conv(_, x):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()

    return tree_map(conv, tree)


def train_state_from_numpy(params: Tree, optimizer,
                           dtype: torch.dtype = torch.float32,
                           device: str | torch.device = "cuda"):
    """A ``training.TrainState`` from the JAX package's numpy parameters
    (``{"encoder": ..., "decoder": ...}``): the leaves cast to ``dtype``
    on ``device``, each its own trainable tensor (a tied lm_head too),
    and a fresh optimizer from the factory ``optimizer``
    (``training.adamw(1e-3)``, ...)."""
    from ..training.train_step import TrainState

    return TrainState.create(to_torch(params, dtype, device), optimizer)
