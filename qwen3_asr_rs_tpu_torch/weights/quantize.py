"""Weight-only int8 / int4 quantization of the decoder parameter tree.

Port of ``qwen3_asr_rs_tpu/weights/quantize.py`` with the same key names
and merge rules, bit for bit: every decoder linear ``{name}_w`` becomes
``{name}_w_q`` (int8) or ``{name}_w_q4`` (nibble-packed int4) plus
``{name}_w_s`` (float32 scales: per output column, ``(L, N)``, or with
``group_size`` per group of contraction rows and column, ``(L, G, N)``),
and the lm_head becomes ``lm_head_q`` / ``lm_head_q4`` (stored (H, V))
plus ``lm_head_s``. Embeddings and norms keep their dtype.

With ``merge`` (the default), q|k|v and gate|up are column-concatenated
before quantizing into ``qkv_w_*`` / ``gateup_w_*``; merging is skipped
when projection biases exist. Per-column scales make the merged
quantization equal to the separate one, column by column.

With ``tp_blocks > 1`` (int4 under tensor parallelism, unmerged) the
column-parallel linears are packed block-locally per tp shard
(``quantize_weight_int4(blocks=)``, ``(L, K, blocks, N // (2 blocks))``)
and the lm_head is int8.

With ``tp`` (int8, unmerged) the tree is one rank's pieces of a
tensor-parallel decoder, cut by ``parallel.decoder_param_specs``, and
the result is that rank's pieces of the whole tree quantized, cut by
``parallel.quantized_decoder_param_specs``, bit for bit: the
column-parallel linears and the vocab-parallel lm_head hold whole
columns and quantize locally; the row-parallel o and down hold a slice
of each column's contraction dim, so each column's absolute maximum is
reduced over tp (one MAX all-reduce per weight) before the local
quantize.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ..ops.quant import (
    quantize_weight,
    quantize_weight_int4,
    quantize_weight_int4_grouped,
    quantize_weight_int4_tiled,
)

Tree = Any

QUANT_LAYER_WEIGHTS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")

# output (column)-parallel linears under tensor parallelism: their int4
# packing is block-local per tp shard (``tp_blocks``)
COL_PARALLEL = ("q_w", "k_w", "v_w", "gate_w", "up_w")

MERGED_GROUPS = {
    "qkv_w": ("q_w", "k_w", "v_w"),
    "gateup_w": ("gate_w", "up_w"),
}


def _quantize_lm_head(lm, bits: int, out: dict) -> None:
    """(V, H) lm_head -> (H, V) int8 or tile-packed int4 + (V,) scales."""
    if bits == 4:
        out["lm_head_q4"], out["lm_head_s"] = quantize_weight_int4_tiled(lm.T)
    else:
        out["lm_head_q"], out["lm_head_s"] = quantize_weight(lm.T)
    del out["lm_head"]


def quantize_decoder_params(params: Tree, bits: int = 8, merge: bool = True,
                            lm_bits: int | None = None, tp_blocks: int = 1,
                            group_size: int | None = None, tp=None) -> Tree:
    """A new decoder tree with int8 (``bits=8``) or int4 (``bits=4``)
    linears; ``params`` is left as it was.

    ``group_size`` (int4 only, quantize='int4g') gives every
    ``group_size`` contraction rows their own scales (``(L, G, N)``
    ``*_s``; the group size is clamped to a divisor of each K).

    The lm_head width follows ``lm_bits``, by default ``$ASR_LM_BITS`` or
    else ``bits`` (8 under ``group_size``): 8 stores int8 (``lm_head_q``),
    4 the tile-local int4 packing of the int4 matvec (``lm_head_q4``),
    under either layer width.

    ``tp_blocks > 1`` (bits=4, merge=False: the tensor-parallel layout)
    packs the column-parallel linears block-locally per tp shard and
    forces an int8 lm_head, as JAX does.

    ``tp`` (a ``parallel.comm.Axis``; bits=8, merge=False, an int8
    lm_head): ``params`` holds this rank's tensor-parallel pieces (see
    the module docstring). Every rank of the axis calls it.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if tp is not None and (bits != 8 or merge or lm_bits != 8):
        raise ValueError(
            "quantizing tensor-parallel pieces requires bits=8, "
            "merge=False and lm_bits=8")
    if tp_blocks > 1 and (bits != 4 or merge):
        raise ValueError("tp_blocks > 1 requires bits=4 and merge=False")
    if group_size is not None:
        if bits != 4:
            raise ValueError("group_size applies to bits=4 only")
        if tp_blocks > 1:
            raise ValueError(
                "group-wise int4 is not supported under tensor parallelism "
                "(blocked tp packing is per-channel)"
            )
    layers = dict(params["layers"])
    merge = merge and not any(
        f"{n[:-2]}_b" in layers for n in QUANT_LAYER_WEIGHTS
    )
    plan: dict[str, torch.Tensor] = {}
    if merge:
        for merged_name, parts in MERGED_GROUPS.items():
            plan[merged_name] = torch.cat([layers.pop(p) for p in parts], -1)
        plan["o_w"] = layers.pop("o_w")
        plan["down_w"] = layers.pop("down_w")
    else:
        for name in QUANT_LAYER_WEIGHTS:
            plan[name] = layers.pop(name)

    for name, w in plan.items():  # w: (L, in, out)
        if bits == 4 and group_size is not None:
            layers[f"{name}_q4"], s = quantize_weight_int4_grouped(w, group_size)
        elif bits == 4:
            blocks = tp_blocks if name in COL_PARALLEL else 1
            layers[f"{name}_q4"], s = quantize_weight_int4(w, axis=-2,
                                                           blocks=blocks)
        else:
            amax = None
            if tp is not None and name not in COL_PARALLEL:
                from ..parallel.comm import all_reduce

                amax = all_reduce(w.float().abs().amax(-2), tp,
                                  torch.distributed.ReduceOp.MAX)
            layers[f"{name}_q"], s = quantize_weight(w, axis=-2, amax=amax)
        layers[f"{name}_s"] = s
    del plan

    out = dict(params)
    out["layers"] = layers
    if lm_bits is None:
        default_lm = 8 if group_size is not None else bits
        lm_bits = int(os.environ.get("ASR_LM_BITS", default_lm))
    if tp_blocks > 1:
        lm_bits = 8  # the int4 lm_head's tiles do not shard over tp
    if lm_bits not in (4, 8):
        raise ValueError(f"lm_bits must be 4 or 8, got {lm_bits}")
    _quantize_lm_head(params["lm_head"], lm_bits, out)
    out.pop("lm_fold_w", None)
    out.pop("lm_fold_s", None)
    return out


def quantize_lm_head_only(params: Tree) -> Tree:
    """Float decoder layers + int8 lm_head (``quantize='lm8'``)."""
    out = dict(params)
    _quantize_lm_head(params["lm_head"], 8, out)
    out.pop("lm_fold_w", None)
    out.pop("lm_fold_s", None)
    return out


def is_quantized(params: Tree) -> bool:
    """Whether the lm_head is quantized (int8 or int4)."""
    return "lm_head_q" in params or "lm_head_q4" in params


def quant_bits(params: Tree) -> int:
    """0 (float layers), 8 or 4: the width of a decoder tree's layers."""
    layers = params.get("layers", {})
    if "q_w_q4" in layers or "qkv_w_q4" in layers:
        return 4
    if "q_w_q" in layers or "qkv_w_q" in layers:
        return 8
    return 0
