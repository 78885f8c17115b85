"""Random weights of a configuration, made on the device from the seed.

The layout is the checkpoint tree that the program's ``AsrEngine(params=)``
takes (the JAX package's: per-layer leaves stacked on a leading axis,
linear weights (in, out), ``embed`` and ``lm_head`` (V, H), a tied
``lm_head`` the same tensor as ``embed``). The audio encoder's leaves are
here; the decoder's are its architecture's (``decoder_leaves`` of
``architectures/<architecture>.py``). Every leaf is a view of one buffer,
filled by one draw from a ``torch.Generator`` on the device, in the type
the weights are served in: weights and biases N(0, scale^2), norm gains
1 + N(0, scale^2). The reference reads the same tensors.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from .spec import BENCH_DIR, architecture

ALIGN = 64  # elements: every leaf starts 128-byte aligned in bf16

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _freq_after_stem(num_mel_bins: int) -> int:
    n = num_mel_bins
    for _ in range(3):
        n = (n + 2 - 3) // 2 + 1  # kernel 3, stride 2, pad 1
    return n


def encoder_leaves(a: dict) -> dict:
    """{name: (shape, kind)} of the audio encoder; kind 'w' a weight or
    bias, 'g' a norm gain. Layer leaves sit under 'layers/'."""
    d, ff, dh = a["d_model"], a["encoder_ffn_dim"], a["downsample_hidden_size"]
    nl, out = a["encoder_layers"], a["output_dim"]
    f = _freq_after_stem(a["num_mel_bins"])
    leaves = {
        "conv1_w": ((dh, 1, 3, 3), "w"), "conv1_b": ((dh,), "w"),
        "conv2_w": ((dh, dh, 3, 3), "w"), "conv2_b": ((dh,), "w"),
        "conv3_w": ((dh, dh, 3, 3), "w"), "conv3_b": ((dh,), "w"),
        "conv_out_w": ((dh * f, d), "w"), "conv_out_b": ((d,), "w"),
        "ln_post_w": ((d,), "g"), "ln_post_b": ((d,), "w"),
        "proj1_w": ((d, d), "w"), "proj1_b": ((d,), "w"),
        "proj2_w": ((d, out), "w"), "proj2_b": ((out,), "w"),
    }
    for n, shape, kind in (
            ("attn_ln_w", (d,), "g"), ("attn_ln_b", (d,), "w"),
            ("q_w", (d, d), "w"), ("q_b", (d,), "w"),
            ("k_w", (d, d), "w"), ("k_b", (d,), "w"),
            ("v_w", (d, d), "w"), ("v_b", (d,), "w"),
            ("out_w", (d, d), "w"), ("out_b", (d,), "w"),
            ("ffn_ln_w", (d,), "g"), ("ffn_ln_b", (d,), "w"),
            ("fc1_w", (d, ff), "w"), ("fc1_b", (ff,), "w"),
            ("fc2_w", (ff, d), "w"), ("fc2_b", (d,), "w")):
        leaves[f"layers/{n}"] = ((nl,) + shape, kind)
    return leaves


def _views(buf: torch.Tensor, leaves: dict, at: int, gains: list):
    tree: dict = {}
    for name, (shape, kind) in leaves.items():
        n = math.prod(shape)
        view = buf[at: at + n].view(shape)
        if kind == "g":
            gains.append(view)
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = view
        at += -(-n // ALIGN) * ALIGN
    return tree, at


def _numel(leaves: dict) -> int:
    return sum(-(-math.prod(s) // ALIGN) * ALIGN for s, _ in leaves.values())


def make_weights(config: dict, seed: int, device,
                 bench_dir: Path = BENCH_DIR) -> tuple:
    """(encoder tree, decoder tree) of ``config`` (a configs/*.json
    object) from ``seed``: one draw into one buffer of the configuration's
    ``dtype``, the encoder's leaves first, then those of the decoder's
    architecture (found under ``bench_dir``)."""
    enc_l = encoder_leaves(config["thinker_config"]["audio_config"])
    dec_l = architecture(config, bench_dir).decoder_leaves(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    buf = torch.empty(_numel(enc_l) + _numel(dec_l),
                      dtype=DTYPES[config["dtype"]], device=device)
    buf.normal_(0.0, float(config["weight_init"]["scale"]), generator=gen)
    gains: list = []
    enc, at = _views(buf, enc_l, 0, gains)
    dec, _ = _views(buf, dec_l, at, gains)
    for g in gains:
        g.add_(1.0)
    if "lm_head" not in dec:
        dec["lm_head"] = dec["embed"]
    return enc, dec
