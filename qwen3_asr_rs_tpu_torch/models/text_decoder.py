"""Qwen3 text decoder in PyTorch: the main-path subset.

Port of ``qwen3_asr_rs_tpu/models/text_decoder.py`` for single-utterance
greedy transcription: GQA attention with per-head QK RMSNorm, rotate-half
RoPE/MRoPE, SwiGLU, pre-norm residual layers, final RMSNorm and a tied or
untied lm_head. Parameters are the JAX package's tree (layers stacked on
a leading axis, linears (in, out)), and the KV cache is the same
preallocated ``(L, B, Hkv, S, D)`` slab, updated in place.

Decode steps read the stale slab ``[0, pos)`` plus the current token as
an explicit self term, then write every layer's fresh K/V at slot
``pos``. On CUDA the step runs the decode kernel
(``ops/kernels/decode_layer.py``); ``ASR_DECODE_IMPL=scan`` selects the
plain per-layer loop, whose attention is the K2 kernel
(``ASR_DECODE_ATTN=kernel``, the CUDA default) or the masked dense path
(``dense``, the CPU default). Quantized, merged, aligned-batch and
speculative parameters and calls are not ported yet and raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from qwen3_asr_rs_tpu.config import TextDecoderConfig

from ..ops.attention import attention
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.decode_layer import decode_layers_fused
from ..ops.norms import rms_norm
from ..ops.rotary import RotaryTable, apply_rotary

Tree = Any

# parameter names of JAX-package branches this port does not run yet:
# int8/int4 weights and scales, merged projections, the folded lm_head
_UNPORTED_SUFFIXES = ("_q", "_q4", "_s")
_UNPORTED_PREFIXES = ("qkv_w", "gateup_w", "lm_fold_")


@dataclasses.dataclass
class KVCache:
    """Preallocated slab cache: k, v (num_layers, batch, Hkv, max_len, D)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: TextDecoderConfig, batch: int, max_len: int,
              dtype: torch.dtype = torch.bfloat16,
              device: str | torch.device = "cpu") -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
                 max_len, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def check_params(params: Tree) -> None:
    """Raise NotImplementedError for parameter trees of unported branches
    (int8/int4 weights, merged projections, folded lm_head)."""
    names = list(params) + list(params.get("layers", {}))
    bad = [n for n in names if n.endswith(_UNPORTED_SUFFIXES)
           or n.startswith(_UNPORTED_PREFIXES)]
    if bad:
        raise NotImplementedError(
            f"quantized/merged decoder parameters {bad} are not ported to "
            "the PyTorch package yet"
        )


def _qkv(layer: Tree, name: str, x, num_heads: int, head_dim: int):
    """Project and split into heads: (B, S, H*D) -> (B, S, H, D)."""
    b, s, _ = x.shape
    out = x @ layer[f"{name}_w"]
    bias = layer.get(f"{name}_b")
    if bias is not None:
        out = out + bias
    return out.reshape(b, s, num_heads, head_dim)


def _mlp(layer: Tree, x):
    gate = x @ layer["gate_w"]
    return (torch.nn.functional.silu(gate) * (x @ layer["up_w"])) @ layer["down_w"]


class TextDecoder:
    """Stateless decoder; parameters are passed to every call."""

    def __init__(self, cfg: TextDecoderConfig, max_position: int = 8192,
                 device: str | torch.device = "cpu"):
        self.cfg = cfg
        self.rotary = RotaryTable(
            head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta,
            mrope_section=cfg.mrope_section(),
            interleaved=cfg.mrope_interleaved(),
            max_position=max_position,
            device=device,
        )

    def embed(self, params: Tree, input_ids):
        """Token embedding lookup (reference src/text_decoder.rs:90-92)."""
        return params["embed"][input_ids]

    def _layer(self, layer: Tree, x, cos, sin, l: int, cache: KVCache):
        """One prefill layer: writes the fresh K/V at slots [0, S) of layer
        ``l`` and attends causally over the fresh keys."""
        cfg = self.cfg
        residual = x
        h = rms_norm(x, layer["input_ln_w"], cfg.rms_norm_eps)
        q = _qkv(layer, "q", h, cfg.num_attention_heads, cfg.head_dim)
        k = _qkv(layer, "k", h, cfg.num_key_value_heads, cfg.head_dim)
        v = _qkv(layer, "v", h, cfg.num_key_value_heads, cfg.head_dim)
        q = rms_norm(q, layer["q_norm_w"], cfg.rms_norm_eps)
        k = rms_norm(k, layer["k_norm_w"], cfg.rms_norm_eps)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

        s = x.shape[1]
        cache.k[l, :, :, :s] = k.transpose(1, 2).to(cache.k.dtype)
        cache.v[l, :, :, :s] = v.transpose(1, 2).to(cache.v.dtype)

        attn = attention(q, k, v, causal=True)
        b = attn.shape[0]
        x = residual + attn.reshape(b, s, -1) @ layer["o_w"]
        residual = x
        h = rms_norm(x, layer["post_ln_w"], cfg.rms_norm_eps)
        return residual + _mlp(layer, h)

    def logits(self, params: Tree, hidden):
        """Final norm + lm head; float32 logits (B, S, V)."""
        h = rms_norm(hidden, params["final_ln_w"], self.cfg.rms_norm_eps)
        if h.dtype == torch.float32:
            return h @ params["lm_head"].T
        # a (V, H) bf16 GEMV accumulates in f32 and rounds to bf16 here,
        # where the JAX einsum keeps f32 logits
        return (h @ params["lm_head"].T).float()

    @torch.inference_mode()
    def prefill(self, params: Tree, hidden, position_ids, cache: KVCache,
                true_len: int):
        """Full-sequence prefill of (B, P, H) embeddings. Writes
        cache[0:P] in place; returns (logits at true_len - 1 (B, V), cache).
        The padded suffix [true_len, P) is causal garbage that later
        decode steps overwrite."""
        check_params(params)
        cos, sin = self.rotary.lookup(position_ids)
        layers = params["layers"]
        for l in range(layers["q_w"].shape[0]):
            hidden = self._layer({k: v[l] for k, v in layers.items()},
                                 hidden, cos, sin, l, cache)
        last = hidden[:, true_len - 1: true_len]
        return self.logits(params, last)[:, 0], cache

    def _use_fused_step(self, params: Tree, b: int, device) -> bool:
        """The decode kernel runs for a shared scalar slot, B = 1, no
        attention biases, and head_dim 128 on CUDA (ASR_DECODE_IMPL=
        scan|fused overrides 'auto')."""
        impl = os.environ.get("ASR_DECODE_IMPL", "auto")
        if impl == "scan":
            return False
        eligible = b == 1 and "q_b" not in params["layers"]
        if impl == "fused":
            return eligible
        return eligible and device.type == "cuda" and self.cfg.head_dim == 128

    @torch.inference_mode()
    def decode_step(self, params: Tree, token_ids, pos: int, cache: KVCache):
        """Single greedy decode step at host-known position ``pos``.
        Returns (logits (B, V) float32, cache updated in place)."""
        if not isinstance(pos, int):
            raise NotImplementedError(
                "per-example decode positions (aligned batches) are not "
                "ported yet: pos must be an int"
            )
        check_params(params)
        b = token_ids.shape[0]
        hidden = self.embed(params, token_ids)  # (B, H)
        cos, sin = self.rotary.lookup_pos(pos)  # (1, D)
        if self._use_fused_step(params, b, hidden.device):
            hidden, ks, vs = decode_layers_fused(
                hidden, cos.expand(b, -1).contiguous(),
                sin.expand(b, -1).contiguous(), params["layers"],
                cache.k, cache.v, None, pos, eps=self.cfg.rms_norm_eps,
            )
        else:
            hidden, ks, vs = self._decode_scan(params, hidden, cos, sin,
                                               cache, pos)
        self._write_token_kv(cache, ks, vs, pos)
        return self.logits(params, hidden[:, None])[:, 0], cache

    def decode_step_token(self, params: Tree, token_ids, pos: int,
                          cache: KVCache):
        """Greedy decode step emitting the next token ids (B,) int64;
        ties break on the first index, as jnp.argmax does."""
        logits, cache = self.decode_step(params, token_ids, pos, cache)
        return torch.argmax(logits, dim=-1), cache

    @staticmethod
    def _write_token_kv(cache: KVCache, ks, vs, pos: int) -> None:
        """Write one token's fresh K/V (L, B, Hkv, D) at slot ``pos``."""
        cache.k[:, :, :, pos] = ks.to(cache.k.dtype)
        cache.v[:, :, :, pos] = vs.to(cache.v.dtype)

    def _decode_scan(self, params: Tree, hidden, cos, sin, cache: KVCache,
                     pos: int):
        """Plain per-layer decode over the stale slab [0, pos).
        Returns (hidden (B, H), ks, vs (L, B, Hkv, D))."""
        impl = os.environ.get("ASR_DECODE_ATTN", "auto")
        if impl == "auto":
            impl = "kernel" if hidden.is_cuda else "dense"
        if impl not in ("kernel", "dense"):
            raise ValueError(f"unknown ASR_DECODE_ATTN {impl!r}")
        layers = params["layers"]
        ks, vs = [], []
        h = hidden[:, None]  # (B, 1, H)
        for l in range(layers["q_w"].shape[0]):
            layer = {k: v[l] for k, v in layers.items()}
            h, k_f, v_f = self._decode_layer(layer, l, h, cos, sin, cache,
                                             pos, impl)
            ks.append(k_f)
            vs.append(v_f)
        return h[:, 0], torch.stack(ks), torch.stack(vs)

    def _decode_layer(self, layer: Tree, l: int, h, cos, sin, cache: KVCache,
                      pos: int, impl: str):
        """One decode layer; attention through K2 ('kernel') or the masked
        dense einsums of the JAX scan path ('dense')."""
        cfg = self.cfg
        b = h.shape[0]
        nq, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        residual = h
        x = rms_norm(h, layer["input_ln_w"], cfg.rms_norm_eps)
        q = _qkv(layer, "q", x, nq, hd)
        k = _qkv(layer, "k", x, nkv, hd)
        v = _qkv(layer, "v", x, nkv, hd)
        q = rms_norm(q, layer["q_norm_w"], cfg.rms_norm_eps)
        k = rms_norm(k, layer["k_norm_w"], cfg.rms_norm_eps)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        if impl == "kernel":
            out = decode_attention(
                q[:, 0].contiguous(), cache.k, cache.v,
                k[:, 0].to(cache.k.dtype).contiguous(),
                v[:, 0].to(cache.v.dtype).contiguous(), l, None, pos,
            )
        else:
            out = self._dense_self_attention(q, k, v, cache.k[l], cache.v[l],
                                             pos)
        out = out.reshape(b, 1, nq * hd).to(h.dtype)
        h = residual + out @ layer["o_w"]
        residual = h
        x = rms_norm(h, layer["post_ln_w"], cfg.rms_norm_eps)
        return residual + _mlp(layer, x), k[:, 0], v[:, 0]

    def _dense_self_attention(self, q, k, v, k_lay, v_lay, pos: int):
        """Masked dense decode attention (JAX ``_decode_layer_masked``):
        slab slots [0, pos) plus the self term; probabilities normalized
        first and rounded to the slab dtype before the V products."""
        b, _, nq, hd = q.shape
        nkv = k.shape[2]
        groups = nq // nkv
        scale = hd ** -0.5
        qg = q.reshape(b, 1, nkv, groups, hd).float()
        sc = torch.einsum("bqhgd,bhkd->bhgqk", qg, k_lay.float()) * scale
        live = torch.arange(k_lay.shape[2], device=q.device) < pos
        sc = torch.where(live, sc, -1e9)
        s_self = torch.einsum("bqhgd,bqhd->bhgq", qg,
                              k.to(q.dtype).float())[..., None] * scale
        all_sc = torch.cat([sc, s_self], -1)
        p = torch.exp(all_sc - all_sc.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        out = torch.einsum("bhgqk,bhkd->bqhgd",
                           p[..., :-1].to(v_lay.dtype).float(), v_lay.float())
        out = out + torch.einsum("bhgq,bqhd->bqhgd", p[..., -1],
                                 v.to(q.dtype).float())
        return out
