"""Parameter sharding specs (Megatron-style tensor parallelism).

Port of ``qwen3_asr_rs_tpu/parallel/sharding.py``, with the same spec
trees leaf for leaf. Decoder layout over the 'tp' mesh axis:

  * q/k/v projections: output (head) dim sharded  -> column parallel
  * o projection:      input (head) dim sharded   -> row parallel
  * gate/up:           intermediate dim sharded   -> column parallel
  * down:              intermediate dim sharded   -> row parallel
  * embed / lm_head:   vocab dim sharded
  * norms:             replicated

The encoder is sharded the same way when its head count divides tp,
otherwise replicated. Every leaf a spec tree does not list is replicated.

``P`` is the port's own ``PartitionSpec``: a tuple of mesh axis names (or
None), one per leading tensor dim. ``shard_params`` cuts every leaf down
to this rank's piece (plain local tensors, not DTensors): the models run
on those pieces with their local head counts and call the collectives of
``parallel/comm.py`` themselves. ``gather_params`` is its inverse: the
whole tensors back from every rank's pieces (what a checkpoint holds).
"""

from __future__ import annotations

from typing import Any

import torch

from ..weights.quantize import COL_PARALLEL, QUANT_LAYER_WEIGHTS
from .comm import all_gather, mesh_axis
from .mesh import MESH_DIMS

PyTree = Any


class P(tuple):
    """A partition spec: ``P(None, "tp")`` shards dim 1 over the 'tp'
    axis and replicates dim 0; trailing dims not named are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P({', '.join(map(repr, self))})"


def decoder_param_specs(tp_heads_ok: bool = True) -> dict:
    """Spec tree matching the decoder parameter layout."""
    col = P(None, None, "tp") if tp_heads_ok else P()
    row = P(None, "tp", None) if tp_heads_ok else P()
    rep2 = P(None, None)
    return {
        "embed": P("tp", None),
        "layers": {
            "input_ln_w": rep2,
            "post_ln_w": rep2,
            "q_norm_w": rep2,
            "k_norm_w": rep2,
            "q_w": col,
            "k_w": col,
            "v_w": col,
            "o_w": row,
            "gate_w": col,
            "up_w": col,
            "down_w": row,
        },
        "final_ln_w": P(None),
        "lm_head": P("tp", None),
    }


def quantized_decoder_param_specs(tp_heads_ok: bool = True) -> dict:
    """Spec tree of an int8-quantized decoder tree: ``{name}_q`` takes its
    float weight's spec; per-output-column scales ``{name}_s`` (L, out)
    are sharded for column-parallel weights and replicated for
    row-parallel ones (the scale commutes with the sum over input shards).
    The lm_head is stored (H, V) with (V,) scales, so vocab parallelism
    moves to dim 1 / dim 0."""
    base = decoder_param_specs(tp_heads_ok)
    col_s = P(None, "tp") if tp_heads_ok else P()
    rep_s = P(None, None)
    layers = {k: v for k, v in base["layers"].items()
              if k not in QUANT_LAYER_WEIGHTS}
    for name in QUANT_LAYER_WEIGHTS:
        layers[f"{name}_q"] = base["layers"][name]
        layers[f"{name}_s"] = col_s if name in COL_PARALLEL else rep_s
    return {
        "embed": base["embed"],
        "layers": layers,
        "final_ln_w": base["final_ln_w"],
        "lm_head_q": P(None, "tp"),
        "lm_head_s": P("tp"),
    }


def int4_decoder_param_specs(tp_heads_ok: bool = True) -> dict:
    """Spec tree of a blocked-int4 decoder tree: column-parallel weights
    are packed block-locally per tp shard ((L, K, blocks, half_b), the
    block dim sharded: each shard holds a ``blocks = 1`` packing of its
    own columns); row-parallel weights pack along the replicated output
    dim and shard their input dim. The lm_head is int8 (forced by
    ``quantize_decoder_params`` under ``tp_blocks``)."""
    base = decoder_param_specs(tp_heads_ok)
    col_blk = P(None, None, "tp", None) if tp_heads_ok else P()
    row = P(None, "tp", None) if tp_heads_ok else P()
    col_s = P(None, "tp") if tp_heads_ok else P()
    rep_s = P(None, None)
    layers = {k: v for k, v in base["layers"].items()
              if k not in QUANT_LAYER_WEIGHTS}
    for name in QUANT_LAYER_WEIGHTS:
        is_col = name in COL_PARALLEL
        layers[f"{name}_q4"] = col_blk if is_col else row
        layers[f"{name}_s"] = col_s if is_col else rep_s
    return {
        "embed": base["embed"],
        "layers": layers,
        "final_ln_w": base["final_ln_w"],
        "lm_head_q": P(None, "tp"),
        "lm_head_s": P("tp"),
    }


def encoder_param_specs(num_heads: int, tp_size: int) -> dict:
    """Spec tree of the encoder; tensor parallel only if heads tile onto
    tp (q/k/v and fc1 column parallel with their biases, out and fc2 row
    parallel with replicated biases)."""
    ok = tp_size > 0 and num_heads % tp_size == 0
    col = P(None, None, "tp") if ok else P()
    row = P(None, "tp", None) if ok else P()
    rep1, rep2 = P(None), P(None, None)
    colb = P(None, "tp") if ok else P()
    return {
        "conv1_w": P(), "conv1_b": P(),
        "conv2_w": P(), "conv2_b": P(),
        "conv3_w": P(), "conv3_b": P(),
        "conv_out_w": rep2, "conv_out_b": rep1,
        "layers": {
            "attn_ln_w": rep2, "attn_ln_b": rep2,
            "ffn_ln_w": rep2, "ffn_ln_b": rep2,
            "q_w": col, "q_b": colb,
            "k_w": col, "k_b": colb,
            "v_w": col, "v_b": colb,
            "out_w": row, "out_b": rep2,
            "fc1_w": col, "fc1_b": colb,
            "fc2_w": row, "fc2_b": rep2,
        },
        "ln_post_w": rep1, "ln_post_b": rep1,
        "proj1_w": rep2, "proj1_b": rep1,
        "proj2_w": rep2, "proj2_b": rep1,
    }


def model_param_specs(encoder_heads: int, tp_size: int) -> dict:
    """The spec tree of a float ``{"encoder", "decoder"}`` tree: the cut
    of ``make_train_step(mesh=).init`` and of a float engine's weights."""
    return {"encoder": encoder_param_specs(encoder_heads, tp_size),
            "decoder": decoder_param_specs()}


def match_specs(params: PyTree, specs: PyTree) -> PyTree:
    """Align a spec tree to a param tree, defaulting missing keys to P()."""
    if isinstance(params, dict):
        return {
            k: match_specs(
                v, specs.get(k, P()) if isinstance(specs, dict) else P()
            )
            for k, v in params.items()
        }
    return specs if not isinstance(specs, dict) else P()


def _local_piece(t, mesh, spec):
    """This rank's piece of ``t`` under ``spec``: each named dim cut into
    the axis's size and the rank's chunk kept (a copy, so that the full
    tensor can be freed); ``t`` itself when the spec shards nothing."""
    out = t
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in MESH_DIMS:
            raise ValueError(f"unknown mesh axis {axis!r} in spec {spec}")
        n = mesh.size(MESH_DIMS.index(axis))
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(
                f"dim {d} of a {tuple(t.shape)} leaf does not divide over "
                f"{axis} = {n}")
        step = t.shape[d] // n
        out = out.narrow(d, mesh.get_local_rank(axis) * step, step)
    if out is t:
        return t
    return out.clone(memory_format=torch.contiguous_format)


def shard_params(params: PyTree, mesh, specs: PyTree) -> PyTree:
    """Every leaf cut to this rank's piece by its spec (``match_specs``:
    unlisted leaves are replicated and returned as they are)."""

    def walk(p, s):
        if isinstance(p, dict):
            return {
                k: walk(v, s.get(k, P()) if isinstance(s, dict) else P())
                for k, v in p.items()
            }
        return _local_piece(p, mesh, s if not isinstance(s, dict) else P())

    return walk(params, specs)


def _whole(t, mesh, spec):
    """``_local_piece``'s inverse: ``t`` all-gathered along each dim whose
    axis has more than one rank, the pieces joined in rank order."""
    for d, axis in enumerate(spec):
        group = None if axis is None else mesh_axis(mesh, axis)
        if group is not None:
            t = torch.cat(all_gather(t, group), dim=d)
    return t


def gather_params(params: PyTree, mesh, specs: PyTree) -> PyTree:
    """The whole tree back from this rank's pieces (``shard_params``'
    inverse, ``match_specs``' defaults): every leaf sharded over an axis
    of more than one rank is all-gathered over it. A collective: every
    rank of the mesh calls it on the same tree."""

    def walk(p, s):
        if isinstance(p, dict):
            return {
                k: walk(v, s.get(k, P()) if isinstance(s, dict) else P())
                for k, v in p.items()
            }
        return _whole(p, mesh, s if not isinstance(s, dict) else P())

    return walk(params, specs)


def named_shardings(mesh, specs: PyTree) -> PyTree:
    """A spec tree mapped to DTensor placements: per leaf, one placement
    per mesh dim, ``Shard(d)`` where the spec names that axis at tensor
    dim d, else ``Replicate()`` (for callers who build DTensors)."""
    from torch.distributed.tensor import Replicate, Shard

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        return tuple(Shard(s.index(axis)) if axis in s else Replicate()
                     for axis in mesh.mesh_dim_names)

    return walk(specs)
