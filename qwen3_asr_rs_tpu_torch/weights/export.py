"""Checkpoint export: parameter trees -> HF-format safetensors.

Port of ``qwen3_asr_rs_tpu/weights/export.py``, the exact inverse of
``loader.py``'s mapping (stacked layers are unstacked, (in, out) linears
are transposed back to HF (out, in)). A tied checkpoint writes ``embed``
only, as JAX's export does, so a separately trained lm_head
(``training/train_step.py``) is not written. Output is one
``model.safetensors`` or, with ``max_shard_bytes``, shards and a
``model.safetensors.index.json``.

Files are written by ``write_safetensors``, a writer of the format that
``loader.read_safetensors`` reads (an 8-byte little-endian header
length, a space-padded JSON header, then the raw bytes of each tensor
in header order), so that the port needs no ``safetensors`` package.

On a mesh (``mesh=``: the trees are this rank's pieces, cut by
``parallel.model_param_specs`` as ``make_train_step(mesh=).init`` and a
float engine cut them) every rank gathers the whole tensors, the mesh's
lead rank alone writes the files, and a barrier over the mesh follows.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

import torch

from ..config import AsrConfig
from ..parallel.comm import barrier, is_lead
from ..parallel.mesh import mesh_dims
from ..parallel.sharding import gather_params, model_param_specs
from .loader import _DTYPES, DECODER_PREFIX, ENCODER_PREFIX, LM_HEAD_KEY

Tree = Any

_TAGS = {t_dt: tag for tag, (_, t_dt) in _DTYPES.items()}


def write_safetensors(path: str | Path, tensors: Dict[str, torch.Tensor]
                      ) -> None:
    """Write ``tensors`` (any device) to one ``.safetensors`` file, one
    tensor at a time through host memory."""
    header: dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors tag")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            host = t.detach().to("cpu").contiguous().reshape(-1)
            f.write(host.view(torch.uint8).numpy().tobytes())


def encoder_to_hf(params: Tree, prefix: str = ENCODER_PREFIX) -> Dict:
    t: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        t[f"{prefix}.conv2d{i}.weight"] = params[f"conv{i}_w"]
        t[f"{prefix}.conv2d{i}.bias"] = params[f"conv{i}_b"]
    t[f"{prefix}.conv_out.weight"] = params["conv_out_w"].T
    t[f"{prefix}.conv_out.bias"] = params["conv_out_b"]

    lp = params["layers"]
    n_layers = lp["attn_ln_w"].shape[0]
    name_map = {
        "attn_ln_w": "self_attn_layer_norm.weight",
        "attn_ln_b": "self_attn_layer_norm.bias",
        "ffn_ln_w": "final_layer_norm.weight",
        "ffn_ln_b": "final_layer_norm.bias",
        "q_w": "self_attn.q_proj.weight", "q_b": "self_attn.q_proj.bias",
        "k_w": "self_attn.k_proj.weight", "k_b": "self_attn.k_proj.bias",
        "v_w": "self_attn.v_proj.weight", "v_b": "self_attn.v_proj.bias",
        "out_w": "self_attn.out_proj.weight",
        "out_b": "self_attn.out_proj.bias",
        "fc1_w": "fc1.weight", "fc1_b": "fc1.bias",
        "fc2_w": "fc2.weight", "fc2_b": "fc2.bias",
    }
    for i in range(n_layers):
        for ours, hf in name_map.items():
            arr = lp[ours][i]
            if ours.endswith("_w") and arr.ndim == 2:
                arr = arr.T  # back to HF (out, in)
            t[f"{prefix}.layers.{i}.{hf}"] = arr

    t[f"{prefix}.ln_post.weight"] = params["ln_post_w"]
    t[f"{prefix}.ln_post.bias"] = params["ln_post_b"]
    t[f"{prefix}.proj1.weight"] = params["proj1_w"].T
    t[f"{prefix}.proj1.bias"] = params["proj1_b"]
    t[f"{prefix}.proj2.weight"] = params["proj2_w"].T
    t[f"{prefix}.proj2.bias"] = params["proj2_b"]
    return t


def decoder_to_hf(
    params: Tree, config: AsrConfig, prefix: str = DECODER_PREFIX
) -> Dict:
    t: Dict[str, torch.Tensor] = {}
    t[f"{prefix}.embed_tokens.weight"] = params["embed"]
    lp = params["layers"]
    n_layers = lp["input_ln_w"].shape[0]
    name_map = {
        "input_ln_w": "input_layernorm.weight",
        "post_ln_w": "post_attention_layernorm.weight",
        "q_norm_w": "self_attn.q_norm.weight",
        "k_norm_w": "self_attn.k_norm.weight",
        "q_w": "self_attn.q_proj.weight",
        "k_w": "self_attn.k_proj.weight",
        "v_w": "self_attn.v_proj.weight",
        "o_w": "self_attn.o_proj.weight",
        "gate_w": "mlp.gate_proj.weight",
        "up_w": "mlp.up_proj.weight",
        "down_w": "mlp.down_proj.weight",
        "q_b": "self_attn.q_proj.bias",
        "k_b": "self_attn.k_proj.bias",
        "v_b": "self_attn.v_proj.bias",
    }
    for i in range(n_layers):
        for ours, hf in name_map.items():
            if ours not in lp:
                continue
            arr = lp[ours][i]
            if ours.endswith("_w") and arr.ndim == 2 and ours not in (
                "input_ln_w", "post_ln_w", "q_norm_w", "k_norm_w"
            ):
                arr = arr.T
            t[f"{prefix}.layers.{i}.{hf}"] = arr
    t[f"{prefix}.norm.weight"] = params["final_ln_w"]
    if not config.text.tie_word_embeddings:
        t[LM_HEAD_KEY] = params["lm_head"]
    return t


def save_checkpoint(
    model_dir: str | Path,
    enc_params: Tree,
    dec_params: Tree,
    config: AsrConfig,
    max_shard_bytes: int | None = None,
    mesh=None,
) -> None:
    """Write config.json + model.safetensors[.index.json] in HF layout.
    ``mesh``: the trees are this rank's pieces on it (see the module
    docstring); every rank of the mesh calls this."""
    from ..models.decoders import require

    require(config.text, "checkpoint export")
    if mesh is None:
        _save(model_dir, enc_params, dec_params, config, max_shard_bytes)
        return
    specs = model_param_specs(config.audio.encoder_attention_heads,
                              mesh_dims(mesh)[1])
    enc_params = gather_params(enc_params, mesh, specs["encoder"])
    dec_params = gather_params(dec_params, mesh, specs["decoder"])
    try:
        if is_lead(mesh):
            _save(model_dir, enc_params, dec_params, config,
                  max_shard_bytes)
    finally:
        barrier(mesh)


def _save(model_dir, enc_params: Tree, dec_params: Tree, config: AsrConfig,
          max_shard_bytes: int | None) -> None:
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)

    tensors = {}
    tensors.update(encoder_to_hf(enc_params))
    tensors.update(decoder_to_hf(dec_params, config))

    if max_shard_bytes is None:
        write_safetensors(model_dir / "model.safetensors", tensors)
    else:
        shards: list[dict] = [{}]
        sizes = [0]
        for name, arr in tensors.items():
            nbytes = arr.numel() * arr.element_size()
            if sizes[-1] + nbytes > max_shard_bytes and shards[-1]:
                shards.append({})
                sizes.append(0)
            shards[-1][name] = arr
            sizes[-1] += nbytes
        n = len(shards)
        weight_map = {}
        for i, shard in enumerate(shards):
            fname = f"model-{i+1:05d}-of-{n:05d}.safetensors"
            write_safetensors(model_dir / fname, shard)
            for name in shard:
                weight_map[name] = fname
        with open(model_dir / "model.safetensors.index.json", "w") as f:
            json.dump(
                {"metadata": {"total_size": int(sum(sizes))},
                 "weight_map": weight_map},
                f,
            )

    with open(model_dir / "config.json", "w") as f:
        json.dump(config_to_dict(config), f)


def config_to_dict(config: AsrConfig) -> dict:
    def clean(obj):
        if dataclasses.is_dataclass(obj):
            return {k: clean(v) for k, v in dataclasses.asdict(obj).items()}
        if isinstance(obj, tuple):
            return list(obj)
        return obj

    return {
        "thinker_config": {
            "audio_config": clean(config.audio),
            "text_config": clean(config.text),
            "audio_start_token_id": config.thinker_config.audio_start_token_id,
            "audio_end_token_id": config.thinker_config.audio_end_token_id,
            "audio_token_id": config.thinker_config.audio_token_id,
        }
    }
