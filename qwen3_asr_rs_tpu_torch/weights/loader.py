"""Checkpoint loading: HF safetensors -> stacked torch parameter trees.

Port of ``qwen3_asr_rs_tpu/weights/loader.py``. Single-file
``model.safetensors`` and sharded ``model.safetensors.index.json``
checkpoints both load; HF names map onto the JAX package's tree layout
(layers stacked on a leading axis, linears transposed from HF
``(out, in)`` to ``(in, out)``, missing attention biases as zeros), and
bf16 tensors stay bf16 unless another dtype is asked for.

Safetensors files are read by a small numpy reader of the format (an
8-byte little-endian header length, a JSON header of
``{name: {dtype, shape, data_offsets}}``, then the raw bytes), so the
port does not need the ``safetensors`` package.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ..config import AsrConfig
from ..errors import WeightsError

logger = logging.getLogger(__name__)

Tree = Any

ENCODER_PREFIX = "thinker.audio_tower"
DECODER_PREFIX = "thinker.model"
LM_HEAD_KEY = "thinker.lm_head.weight"

# safetensors dtype tag -> (numpy storage dtype, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),  # raw bits, viewed as bf16
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}


def read_safetensors(path: str | Path) -> Dict[str, torch.Tensor]:
    """All tensors of one ``.safetensors`` file as CPU torch tensors."""
    path = Path(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise WeightsError(f"{path}: truncated safetensors header")
        n = int.from_bytes(raw, "little")
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise WeightsError(f"{path}: bad safetensors header: {e}") from e
        data_start = 8 + n
        file_size = path.stat().st_size
        out = {}
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            if meta["dtype"] not in _DTYPES:
                raise WeightsError(
                    f"{path}: tensor {name} has unsupported dtype "
                    f"{meta['dtype']}"
                )
            np_dt, t_dt = _DTYPES[meta["dtype"]]
            lo, hi = meta["data_offsets"]
            shape = tuple(meta["shape"])
            count = int(np.prod(shape))
            if data_start + hi > file_size or hi - lo != (
                count * np.dtype(np_dt).itemsize
            ):
                raise WeightsError(f"{path}: tensor {name} out of bounds")
            f.seek(data_start + lo)
            arr = np.fromfile(f, dtype=np_dt, count=count).reshape(shape)
            t = torch.from_numpy(arr)
            out[name] = t.view(t_dt) if t_dt == torch.bfloat16 else t
    return out


def load_checkpoint(model_dir: str | Path) -> Dict[str, torch.Tensor]:
    """Load all tensors from single-file or sharded safetensors."""
    model_dir = Path(model_dir)
    index_path = model_dir / "model.safetensors.index.json"
    single_path = model_dir / "model.safetensors"

    if index_path.exists():
        with open(index_path) as f:
            index = json.load(f)
        shard_files = sorted(set(index["weight_map"].values()))
        logger.info("Loading %d safetensors shards", len(shard_files))
        files = [model_dir / s for s in shard_files]
    elif single_path.exists():
        files = [single_path]
    else:
        raise WeightsError(
            f"No model.safetensors or model.safetensors.index.json in {model_dir}"
        )

    tensors: Dict[str, torch.Tensor] = {}
    for path in files:
        tensors.update(read_safetensors(path))
    logger.info("Loaded %d weight tensors", len(tensors))
    return tensors


def load_model_params(
    model_dir: str | Path,
    config: AsrConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> tuple[Tree, Tree]:
    """Load (encoder_params, decoder_params) onto ``device``.

    Mapping (stack, transpose, cast) runs on the host; each unique
    tensor then moves to ``device`` once (a tied lm_head stays the same
    tensor as embed).
    """
    from ..models.decoders import require
    from .convert import tree_map

    require(config.text, "checkpoint loading")
    tensors = load_checkpoint(model_dir)
    enc = map_encoder_params(tensors, config, dtype)
    dec = map_decoder_params(tensors, config, dtype)
    del tensors
    return (
        tree_map(lambda _, t: t.to(device), enc),
        tree_map(lambda _, t: t.to(device), dec),
    )


def _get(tensors, name, dtype):
    if name not in tensors:
        raise WeightsError(f"Missing weight: {name}")
    return tensors[name].to(dtype)


def _linear_t(tensors, name, dtype):
    """HF (out, in) -> (in, out)."""
    return _get(tensors, f"{name}.weight", dtype).t().contiguous()


def _bias_or_zeros(tensors, name, out_features, dtype):
    key = f"{name}.bias"
    if key in tensors:
        return tensors[key].to(dtype)
    return torch.zeros((out_features,), dtype=dtype)


def map_encoder_params(
    tensors: Dict[str, torch.Tensor],
    config: AsrConfig,
    dtype: torch.dtype = torch.bfloat16,
    prefix: str = ENCODER_PREFIX,
) -> Tree:
    cfg = config.audio
    p: Dict[str, Any] = {}
    for i in (1, 2, 3):
        p[f"conv{i}_w"] = _get(tensors, f"{prefix}.conv2d{i}.weight", dtype)
        p[f"conv{i}_b"] = _get(tensors, f"{prefix}.conv2d{i}.bias", dtype)
    p["conv_out_w"] = _linear_t(tensors, f"{prefix}.conv_out", dtype)
    p["conv_out_b"] = _bias_or_zeros(
        tensors, f"{prefix}.conv_out", cfg.d_model, dtype
    )

    def stack_layers(fn):
        return torch.stack([fn(f"{prefix}.layers.{i}") for i in
                            range(cfg.encoder_layers)])

    d = cfg.d_model
    layers = {
        "attn_ln_w": stack_layers(
            lambda l: _get(tensors, f"{l}.self_attn_layer_norm.weight", dtype)
        ),
        "attn_ln_b": stack_layers(
            lambda l: _get(tensors, f"{l}.self_attn_layer_norm.bias", dtype)
        ),
        "ffn_ln_w": stack_layers(
            lambda l: _get(tensors, f"{l}.final_layer_norm.weight", dtype)
        ),
        "ffn_ln_b": stack_layers(
            lambda l: _get(tensors, f"{l}.final_layer_norm.bias", dtype)
        ),
        "fc1_w": stack_layers(lambda l: _linear_t(tensors, f"{l}.fc1", dtype)),
        "fc1_b": stack_layers(
            lambda l: _bias_or_zeros(tensors, f"{l}.fc1", cfg.encoder_ffn_dim,
                                     dtype)
        ),
        "fc2_w": stack_layers(lambda l: _linear_t(tensors, f"{l}.fc2", dtype)),
        "fc2_b": stack_layers(
            lambda l: _bias_or_zeros(tensors, f"{l}.fc2", d, dtype)
        ),
    }
    for proj in ("q", "k", "v", "out"):
        layers[f"{proj}_w"] = stack_layers(
            lambda l, pn=proj: _linear_t(
                tensors, f"{l}.self_attn.{pn}_proj", dtype
            )
        )
        layers[f"{proj}_b"] = stack_layers(
            lambda l, pn=proj: _bias_or_zeros(
                tensors, f"{l}.self_attn.{pn}_proj", d, dtype
            )
        )
    p["layers"] = layers

    p["ln_post_w"] = _get(tensors, f"{prefix}.ln_post.weight", dtype)
    p["ln_post_b"] = _get(tensors, f"{prefix}.ln_post.bias", dtype)
    p["proj1_w"] = _linear_t(tensors, f"{prefix}.proj1", dtype)
    p["proj1_b"] = _bias_or_zeros(tensors, f"{prefix}.proj1", d, dtype)
    p["proj2_w"] = _linear_t(tensors, f"{prefix}.proj2", dtype)
    p["proj2_b"] = _bias_or_zeros(
        tensors, f"{prefix}.proj2", cfg.output_dim, dtype
    )
    return p


def map_decoder_params(
    tensors: Dict[str, torch.Tensor],
    config: AsrConfig,
    dtype: torch.dtype = torch.bfloat16,
    prefix: str = DECODER_PREFIX,
) -> Tree:
    cfg = config.text
    embed = _get(tensors, f"{prefix}.embed_tokens.weight", dtype)

    def stack_layers(fn):
        return torch.stack([fn(f"{prefix}.layers.{i}") for i in
                            range(cfg.num_hidden_layers)])

    nq_d = cfg.num_attention_heads * cfg.head_dim
    nkv_d = cfg.num_key_value_heads * cfg.head_dim
    norms = {
        "input_ln_w": "input_layernorm",
        "post_ln_w": "post_attention_layernorm",
        "q_norm_w": "self_attn.q_norm",
        "k_norm_w": "self_attn.k_norm",
    }
    linears = {
        "q_w": "self_attn.q_proj",
        "k_w": "self_attn.k_proj",
        "v_w": "self_attn.v_proj",
        "o_w": "self_attn.o_proj",
        "gate_w": "mlp.gate_proj",
        "up_w": "mlp.up_proj",
        "down_w": "mlp.down_proj",
    }
    layers = {
        ours: stack_layers(
            lambda l, hf=hf: _get(tensors, f"{l}.{hf}.weight", dtype)
        )
        for ours, hf in norms.items()
    }
    layers.update({
        ours: stack_layers(lambda l, hf=hf: _linear_t(tensors, f"{l}.{hf}",
                                                      dtype))
        for ours, hf in linears.items()
    })
    # optional attention biases (absent for Qwen3; kept for generality)
    if f"{prefix}.layers.0.self_attn.q_proj.bias" in tensors:
        for name, n in (("q", nq_d), ("k", nkv_d), ("v", nkv_d)):
            layers[f"{name}_b"] = stack_layers(
                lambda l, name=name, n=n: _bias_or_zeros(
                    tensors, f"{l}.self_attn.{name}_proj", n, dtype
                )
            )

    if cfg.tie_word_embeddings:
        lm_head = embed
    else:
        # `thinker.model` -> `thinker.lm_head` (src/text_decoder.rs:71-79)
        lm_head = _get(tensors, LM_HEAD_KEY, dtype)

    return {
        "embed": embed,
        "layers": layers,
        "final_ln_w": _get(tensors, f"{prefix}.norm.weight", dtype),
        "lm_head": lm_head,
    }
