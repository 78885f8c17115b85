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
(``dense``, the CPU default).

Weight-quantized trees (``weights/quantize.py``: int8 ``*_q`` or int4
``*_q4`` weights with float32 per-column ``*_s`` scales, merged
``qkv_w``/``gateup_w`` or per projection) run every path: the int8
linears and the int8 lm_head through the K5 kernel
(``ops/kernels/quant_matmul.py``), the int4 lm_head through K4
(``ops/kernels/quant_matvec_int4.py``), the int4 linears in plain torch
as two half-width products, as in JAX. Every quantized product stays
float32 until its scale is applied and only then rounds to the compute
dtype. Grouped int4 scales, blocked int4, the folded lm_head,
aligned-batch and speculative calls are not ported yet and raise
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
from ..ops.kernels.quant_matmul import quant_matmul
from ..ops.kernels.quant_matvec_int4 import quant_matvec_int4
from ..ops.norms import rms_norm
from ..ops.quant import int4_matmul_plain, matmul_f32
from ..ops.rotary import RotaryTable, apply_rotary

Tree = Any


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
    """Raise NotImplementedError for parameter trees of unported branches:
    grouped int4 scales (a 3-D ``*_s``), blocked int4 (a 4-D ``*_q4``),
    the folded lm_head (``lm_fold_*``) and float merged projections."""
    layers = params.get("layers", {})
    bad = [n for n in params if n.startswith("lm_fold_")]
    bad += [n for n in ("qkv_w", "gateup_w") if n in layers]
    bad += [n for n, t in layers.items()
            if (n.endswith("_s") and t.ndim != 2)
            or (n.endswith("_q4") and t.ndim != 3)]
    if bad:
        raise NotImplementedError(
            f"decoder parameters {bad} (int4g grouped scales, blocked int4, "
            "folded lm_head or float merged projections) are not ported to "
            "the PyTorch package yet"
        )


def _linear(tree: Tree, name: str, x):
    """x @ W for a float weight, an int8 (``{name}_q``, ``{name}_s``) pair
    or a nibble-packed int4 (``{name}_q4``, ``{name}_s``) pair.

    int8 runs K5 (``quant_matmul``; its plain version on the CPU). int4 is
    the JAX package's two half-width products on the sign-extended
    nibbles (``ops/quant.py::int4_matmul_plain``). Both apply the per-column scale to the float32 product, then round to
    x.dtype once.
    """
    if f"{name}_q" in tree:
        x2 = x.reshape(-1, x.shape[-1])
        y = quant_matmul(x2.contiguous(), tree[f"{name}_q"], tree[f"{name}_s"])
        return y.reshape(*x.shape[:-1], -1)
    if f"{name}_q4" in tree:
        return int4_matmul_plain(x, tree[f"{name}_q4"], tree[f"{name}_s"])
    return x @ tree[name]


def _qkv(layer: Tree, name: str, x, num_heads: int, head_dim: int):
    """Project and split into heads: (B, S, H*D) -> (B, S, H, D)."""
    b, s, _ = x.shape
    out = _linear(layer, f"{name}_w", x)
    bias = layer.get(f"{name}_b")
    if bias is not None:
        out = out + bias
    return out.reshape(b, s, num_heads, head_dim)


def _qkv3(layer: Tree, x, nq: int, nkv: int, head_dim: int):
    """q, k, v (B, S, heads, D): one product through the merged
    ``qkv_w`` when the quantizer merged the projections (the slices are
    copied out: the attention kernels take contiguous operands)."""
    if "qkv_w_q" in layer or "qkv_w_q4" in layer:
        b, s, _ = x.shape
        q, k, v = torch.split(_linear(layer, "qkv_w", x),
                              [nq * head_dim, nkv * head_dim, nkv * head_dim],
                              -1)
        return tuple(t.reshape(b, s, n, head_dim).contiguous()
                     for t, n in ((q, nq), (k, nkv), (v, nkv)))
    return (_qkv(layer, "q", x, nq, head_dim), _qkv(layer, "k", x, nkv, head_dim),
            _qkv(layer, "v", x, nkv, head_dim))


def _gate_up(layer: Tree, x):
    """silu(gate(x)) * up(x), through the merged ``gateup_w`` if present."""
    silu = torch.nn.functional.silu
    if "gateup_w_q" in layer or "gateup_w_q4" in layer:
        gate, up = _linear(layer, "gateup_w", x).chunk(2, -1)
        return silu(gate) * up
    return silu(_linear(layer, "gate_w", x)) * _linear(layer, "up_w", x)


def _mlp(layer: Tree, x):
    return _linear(layer, "down_w", _gate_up(layer, x))


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
        q, k, v = _qkv3(layer, h, cfg.num_attention_heads,
                        cfg.num_key_value_heads, cfg.head_dim)
        q = rms_norm(q, layer["q_norm_w"], cfg.rms_norm_eps)
        k = rms_norm(k, layer["k_norm_w"], cfg.rms_norm_eps)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

        s = x.shape[1]
        cache.k[l, :, :, :s] = k.transpose(1, 2).to(cache.k.dtype)
        cache.v[l, :, :, :s] = v.transpose(1, 2).to(cache.v.dtype)

        attn = attention(q, k, v, causal=True)
        b = attn.shape[0]
        x = residual + _linear(layer, "o_w", attn.reshape(b, s, -1))
        residual = x
        h = rms_norm(x, layer["post_ln_w"], cfg.rms_norm_eps)
        return residual + _mlp(layer, h)

    def logits(self, params: Tree, hidden):
        """Final norm + lm head; float32 logits (B, S, V), never rounded
        to the compute dtype (JAX: ``preferred_element_type=float32``).
        int4 lm_head: K4; int8 lm_head: K5 with a float32 output."""
        h = rms_norm(hidden, params["final_ln_w"], self.cfg.rms_norm_eps)
        b, s, hd = h.shape
        h2 = h.reshape(b * s, hd).contiguous()
        if "lm_head_q4" in params:
            y = quant_matvec_int4(h2, params["lm_head_q4"], params["lm_head_s"])
        elif "lm_head_q" in params:
            y = quant_matmul(h2, params["lm_head_q"], params["lm_head_s"],
                             out_dtype=torch.float32)
        else:
            y = matmul_f32(h2, params["lm_head"].T)
        return y.reshape(b, s, -1)

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
        for l in range(cache.k.shape[0]):
            hidden = self._layer({k: v[l] for k, v in layers.items()},
                                 hidden, cos, sin, l, cache)
        last = hidden[:, true_len - 1: true_len]
        return self.logits(params, last)[:, 0], cache

    def _use_fused_step(self, params: Tree, b: int, device) -> bool:
        """The decode kernel runs for a shared scalar slot, B = 1, no
        attention biases, and head_dim 128 on CUDA, for float, int8 and
        int4 weights, merged or not (ASR_DECODE_IMPL=scan|fused overrides
        'auto')."""
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
        for l in range(cache.k.shape[0]):
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
        q, k, v = _qkv3(layer, x, nq, nkv, hd)
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
        h = residual + _linear(layer, "o_w", out)
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
