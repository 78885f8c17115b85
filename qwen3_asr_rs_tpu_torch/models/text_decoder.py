"""Qwen3 text decoder in PyTorch: transcription and the training forward.

Port of ``qwen3_asr_rs_tpu/models/text_decoder.py`` for greedy
transcription of one utterance or of a right-aligned batch: GQA attention
with per-head QK RMSNorm, rotate-half RoPE/MRoPE, SwiGLU, pre-norm
residual layers, final RMSNorm and a tied or untied lm_head. Parameters
are the JAX package's tree (layers stacked on a leading axis, linears
(in, out)), and the KV cache is the same preallocated ``(L, B, Hkv, S,
D)`` slab, updated in place: in the compute dtype, or int8 with float32
per-slot scales (``KVCache.zeros(quantized=True)``, the engine's
``ASR_KV=int8``), quantized on every write and dequantized (folded into
the kernels) at the attention site.

Decode steps read each row's stale slab range (``[0, pos)`` for one
utterance, ``[kv_start_b, slot)`` for a right-aligned batch, where every
row writes the same slot) plus the current token as an explicit self
term, then write every layer's fresh K/V at that slot. The position or
slot is a host int or a 0-d device tensor: the engine's decode loop
captures a step in a CUDA graph, whose replays advance the slot on the
device. ``KVCache.grow`` copies a slab into a longer one (the engine's
segmented slab). On CUDA the step runs the decode kernel
(``ops/kernels/decode_layer.py``) at any B;
``ASR_DECODE_IMPL=scan`` selects the plain per-layer loop, whose
attention is the K2 kernel (``ASR_DECODE_ATTN=kernel``, the CUDA
default) or the masked dense path (``dense``, the CPU default).

Weight-quantized trees (``weights/quantize.py``: int8 ``*_q`` or int4
``*_q4`` weights with float32 per-column ``*_s`` scales, or int4 with
``(L, G, N)`` group scales (int4g), merged ``qkv_w``/``gateup_w`` or per
projection) run every path: the int8 linears and the int8 lm_head
through the K5 kernel (``ops/kernels/quant_matmul.py``), the int4
lm_head through K4 (``ops/kernels/quant_matvec_int4.py``), the int4
linears in plain torch as two half-width products and the int4g linears
as ``int4_grouped_matmul``, as in JAX. Every quantized product stays
float32 until its scale is applied and only then rounds to the compute
dtype. Merged int4g runs the decode kernel; unmerged int4g
(``ASR_MERGE_QKV=0``) runs the plain per-layer decode, as JAX's dispatch
sends it to its scan path.

With ``ASR_FOLD_LM=1`` the token steps (``decode_step_token``,
``decode_step_aligned_token``) fold the final RMSNorm, the bf16/f32 or
int8 lm_head and the argmax into the decode kernel, which then returns
token ids; an int4 lm_head is not folded (K4 runs), as in JAX.

Serving (``runtime/serving.py``) adds three entries: ``decode_step`` at
per-row positions (a (B,) ``pos``: per-row rotary, K2 at each row's own
end, the fresh K/V scattered to each row's slot; the decode kernel
needs a shared slot, as JAX's dispatch does), ``prefill`` with per-row
true lengths, and ``prefill_chunk`` (a block of the prompt at [start,
start + P) over a cache holding [0, start), in plain torch as JAX's
einsums). Streaming (``runtime/streaming.py``) extends its slab with
``prefill_chunk``; speculative decoding verifies a drafted block with
``score_chunk`` (the same chunk layers, an argmax or the float32 logits
at every position). Both chunk entries take ``start`` as a host int or a
0-d device tensor (a verify captured in a CUDA graph: the K/V write, the
rotary rows and the mask are then computed on the device). Blocked int4
trees (``tp_blocks``: column weights ``(L, K, blocks, N / (2 blocks))``)
run ``int4_blocked_matmul``, block by block.

Tensor parallelism (``tp``: the mesh's 'tp' axis, ``parallel/comm.py``):
the parameters are this rank's Megatron shards (``parallel/sharding.py``)
and ``self.cfg`` holds the local head counts and MLP width. Each layer
copies its normed input to the column-parallel products (q/k/v,
gate/up) and all-reduces the row-parallel ones (o, down): two
all-reduces per layer, forward. The embedding lookup is vocab-parallel
(one all-reduce) and the lm_head's logits are gathered (one all-gather).
Every entry holds this: ``forward_full``, the prefills, the decode steps
and the chunk layers. The decode kernel holds a whole layer, and the
all-reduce falls inside it, so it is declined under tp, as JAX's is; K2,
K3 and K5 run on each rank's local heads and shards.

Training (``training/train_step.py``) runs ``forward_full``: the prefill
layer's math without a slab, differentiable, each layer optionally
checkpointed (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..config import TextDecoderConfig
from ..ops.attention import attention
from ..ops.kernels import forbid_backward
from ..ops.kernels.decode_attention import decode_attention_dma
from ..ops.kernels.decode_layer import decode_layers_fused, is_grouped
from ..ops.kernels.quant_matmul import quant_matmul
from ..ops.kernels.quant_matvec_int4 import quant_matvec_int4
from ..ops.norms import rms_norm
from ..ops.quant import (
    int4_blocked_matmul,
    int4_grouped_matmul,
    int4_matmul_plain,
    matmul_f32,
)
from ..ops.rotary import RotaryTable, apply_rotary
from ..parallel.comm import (
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    vocab_parallel_embed,
)
from ..weights.convert import unstack_layers

Tree = Any


@dataclasses.dataclass
class KVCache:
    """Preallocated slab cache: k, v (num_layers, batch, Hkv, max_len, D).

    Quantized (int8) slabs carry symmetric float32 scales per (layer,
    example, kv head, slot) in ``k_scale``/``v_scale`` (L, B, Hkv,
    max_len): half the slab bytes of bf16 per decode step.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @staticmethod
    def slab_shapes(cfg: TextDecoderConfig, batch: int, max_len: int,
                    dtype: torch.dtype, quantized: bool = False) -> list:
        """[(shape, dtype)] of the slab's tensors in constructor order:
        k and v, then for an int8 slab their scales."""
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
                 max_len, cfg.head_dim)
        if quantized:
            return [(shape, torch.int8)] * 2 + [(shape[:-1],
                                                 torch.float32)] * 2
        return [(shape, dtype)] * 2

    @classmethod
    def zeros(cls, cfg: TextDecoderConfig, batch: int, max_len: int,
              dtype: torch.dtype = torch.bfloat16,
              device: str | torch.device = "cpu",
              quantized: bool = False) -> "KVCache":
        return cls(*(torch.zeros(shape, dtype=dt, device=device)
                     for shape, dt in cls.slab_shapes(cfg, batch, max_len,
                                                      dtype, quantized)))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def store(self, l: int, k, v, start=0) -> None:
        """Write fresh K/V (B, Hkv, S, D) of layer ``l`` at slots [start,
        start + S), quantized for an int8 slab (JAX ``_store_kv``).
        ``start``: a host int, or a 0-d integer device tensor, whose
        slots are written by ``index_copy_`` (no host read; a slot past
        the slab fails its bounds check instead of clamping)."""
        pairs = [(self.k, k), (self.v, v)]
        if self.quantized:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            pairs = [(self.k, k), (self.v, v), (self.k_scale, ks),
                     (self.v_scale, vs)]
        n = k.shape[2]
        if isinstance(start, torch.Tensor):
            idx = start.reshape(()).long() + torch.arange(
                n, device=self.k.device)
            for dst, src in pairs:
                dst[l].index_copy_(2, idx, src.to(dst.dtype))
            return
        for dst, src in pairs:
            dst[l, :, :, start:start + n] = src.to(dst.dtype)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def store_token(self, ks, vs, slot) -> None:
        """Write one token's fresh K/V (L, B, Hkv, D) of every layer,
        quantized per (layer, row, head) for an int8 slab (JAX
        ``_write_token_kv``), by one scatter. ``slot``: the shared slot,
        an int or a 0-d integer device tensor (a step captured in a CUDA
        graph writes where the graph's own counter points); or a (B,)
        integer tensor, row b's slot (the serving scheduler's per-row
        positions, which the caller keeps inside the slab)."""
        pairs = [(self.k, ks), (self.v, vs)]
        if self.quantized:
            (ks, k_scale), (vs, v_scale) = quantize_kv(ks), quantize_kv(vs)
            pairs = [(self.k, ks), (self.v, vs), (self.k_scale, k_scale),
                     (self.v_scale, v_scale)]
        b = self.k.shape[1]
        pos = torch.as_tensor(slot, device=self.k.device).long()
        pos = pos.reshape(-1).expand(b)  # a shared slot is every row's
        rows = torch.arange(b, device=self.k.device)
        for dst, src in pairs:  # indexed subspace (B, L, Hkv[, D])
            dst[:, rows, :, pos] = src.to(dst.dtype).transpose(0, 1)

    def grow(self, new_len: int) -> "KVCache":
        """This slab copied into the first slots of a larger zero slab of
        ``new_len`` slots, int8 scales too (the JAX engine's
        ``grow_cache``)."""
        n = self.max_len
        big = []
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is None:
                big.append(None)
                continue
            g = t.new_zeros(t.shape[:3] + (new_len,) + t.shape[4:])
            g[:, :, :, :n].copy_(t)
            big.append(g)
        return KVCache(*big)

    def layer(self, l: int, dtype):
        """Layer ``l``'s slabs (B, Hkv, S, D): dequantized to ``dtype``
        from an int8 slab, as stored otherwise (JAX ``_decode_scan``)."""
        if self.quantized:
            return (dequantize_kv(self.k[l], self.k_scale[l], dtype),
                    dequantize_kv(self.v[l], self.v_scale[l], dtype))
        return self.k[l], self.v[l]


def _per_row(pos) -> bool:
    """Whether a decode position is one per row (a (B,) tensor)."""
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def quantize_kv(t):
    """Symmetric int8 quantization over the last (D) axis, bit-equal to
    JAX's: t (..., D) -> (int8 (..., D), float32 scale (...,)), scale =
    max(absmax, 1e-8) / 127, values rounded half to even, clipped to
    +-127."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    """int8 (..., D) * float32 scale (...,) -> dtype (..., D)."""
    return (q.float() * scale[..., None]).to(dtype)


def check_params(params: Tree) -> None:
    """Raise NotImplementedError for parameter trees of unported branches:
    float merged projections; and for the JAX engine's padded lm_head
    copies (``lm_fold_*``, a TPU layout that ``weights/convert.py``
    drops: the fold reads the lm_head)."""
    layers = params.get("layers", {})
    bad = [n for n in params if n.startswith("lm_fold_")]
    bad += [n for n in ("qkv_w", "gateup_w") if n in layers]
    bad += [n for n, t in layers.items()
            if (n.endswith("_s") and t.ndim not in (2, 3))
            or (n.endswith("_q4") and t.ndim not in (3, 4))]
    if bad:
        raise NotImplementedError(
            f"decoder parameters {bad} (float merged projections or the "
            "JAX engine's lm_fold_* copies) are not ported to the PyTorch "
            "package"
        )


def is_blocked(layers: Tree) -> bool:
    """Whether a stacked layer tree holds blocked int4 (tp) weights."""
    return any(n.endswith("_q4") and t.ndim == 4 for n, t in layers.items())


def _linear(tree: Tree, name: str, x):
    """x @ W for a float weight, an int8 (``{name}_q``, ``{name}_s``) pair
    or a nibble-packed int4 (``{name}_q4``, ``{name}_s``) pair, with
    per-column scales or (int4g) 2-D (G, N) group scales.

    int8 runs K5 (``quant_matmul``; its plain version on the CPU). int4 is
    the JAX package's two half-width products on the sign-extended
    nibbles (``ops/quant.py::int4_matmul_plain``; per block for the
    blocked tp layout), int4g its ``int4_grouped_matmul`` in both of its
    row regimes. Each applies its scales to the float32 products, then
    rounds to x.dtype once.
    """
    if f"{name}_q" in tree:
        forbid_backward("K5 (quant_matmul)", x)
        x2 = x.reshape(-1, x.shape[-1])
        y = quant_matmul(x2.contiguous(), tree[f"{name}_q"], tree[f"{name}_s"])
        return y.reshape(*x.shape[:-1], -1)
    if f"{name}_q4" in tree:
        if tree[f"{name}_q4"].ndim == 3:  # blocked (K, blocks, N / 2 blocks)
            return int4_blocked_matmul(x, tree[f"{name}_q4"],
                                       tree[f"{name}_s"])
        if tree[f"{name}_s"].ndim == 2:
            return int4_grouped_matmul(x, tree[f"{name}_q4"],
                                       tree[f"{name}_s"]).to(x.dtype)
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


def tp_local_config(cfg: TextDecoderConfig, tp: int) -> TextDecoderConfig:
    """The decoder config of one tp shard: heads and MLP width over tp
    (the vocabulary stays whole: the logits are gathered)."""
    for name in ("num_attention_heads", "num_key_value_heads",
                 "intermediate_size", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} does not divide "
                             f"over tp = {tp}")
    return dataclasses.replace(
        cfg, num_attention_heads=cfg.num_attention_heads // tp,
        num_key_value_heads=cfg.num_key_value_heads // tp,
        intermediate_size=cfg.intermediate_size // tp)


class TextDecoder:
    """Stateless decoder; parameters are passed to every call. ``tp``:
    this rank's view of the mesh's 'tp' axis (``parallel/comm.mesh_axis``),
    None without tensor parallelism; ``self.cfg`` is then the shard's
    config (``tp_local_config``)."""

    cache_type = KVCache
    # the port's modes (``models/decoders.py::require``): this decoder
    # runs every one
    modes = frozenset({
        "serving", "streaming", "speculative decoding", "quantized weights",
        "int8 cache", "tensor parallelism", "training", "checkpoint loading",
        "checkpoint export"})

    def __init__(self, cfg: TextDecoderConfig, max_position: int = 8192,
                 device: str | torch.device = "cpu", tp=None):
        self.tp = tp
        self.vocab_size = cfg.vocab_size
        if tp is not None:
            cfg = tp_local_config(cfg, tp.size)
        self.cfg = cfg
        self.rotary = RotaryTable(
            head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta,
            mrope_section=cfg.mrope_section(),
            interleaved=cfg.mrope_interleaved(),
            max_position=max_position,
            device=device,
        )

    def call_counts(self, max_new: int, step, done) -> None:
        """The per-call counters that the engine passes to the prefill and
        to every decode step (``counts=``): this decoder keeps none."""
        return None

    def read_counts(self, counts, steps: int) -> dict:
        """What a call's counters add to ``last_stats``: nothing."""
        return {}

    def embed(self, params: Tree, input_ids):
        """Token embedding lookup (reference src/text_decoder.rs:90-92);
        vocab-parallel when the table is a tp shard."""
        table = params["embed"]
        if table.shape[0] < self.vocab_size:
            return vocab_parallel_embed(table, input_ids, self.tp)
        return table[input_ids]

    def _layer(self, layer: Tree, x, cos, sin, l: int, cache: KVCache,
               kv_start=None):
        """One prefill layer: writes the fresh K/V at slots [0, S) of layer
        ``l`` and attends causally over the fresh (unquantized) keys,
        from slot ``kv_start[b]`` on when given (right-aligned rows)."""
        x, k, v = self._causal_layer(layer, x, cos, sin, kv_start)
        cache.store(l, k.transpose(1, 2), v.transpose(1, 2))
        return x

    def _causal_layer(self, layer: Tree, x, cos, sin, kv_start=None):
        """The layer math of a full sequence, storing nothing: returns
        (output, fresh K, fresh V), K/V (B, S, Hkv, D) after QK-norm and
        rotary."""
        cfg = self.cfg
        residual = x
        h = self._tp_in(rms_norm(x, layer["input_ln_w"], cfg.rms_norm_eps))
        q, k, v = _qkv3(layer, h, cfg.num_attention_heads,
                        cfg.num_key_value_heads, cfg.head_dim)
        # the QK-norm weights are replicated but scale each rank's heads
        # only: their gradient is summed over tp (copy_to_tp's backward)
        q = rms_norm(q, self._tp_in(layer["q_norm_w"]), cfg.rms_norm_eps)
        k = rms_norm(k, self._tp_in(layer["k_norm_w"]), cfg.rms_norm_eps)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

        attn = attention(q, k, v, causal=True, kv_start=kv_start)
        b, s = attn.shape[:2]
        x = residual + self._tp_out(_linear(layer, "o_w",
                                            attn.reshape(b, s, -1)))
        return self._mlp_block(layer, x), k, v

    def _tp_in(self, h):
        """The input of the column-parallel products (``copy_to_tp``)."""
        return copy_to_tp(h, self.tp)

    def _tp_out(self, y):
        """A row-parallel product's output, summed over tp."""
        return reduce_from_tp(y, self.tp)

    def _mlp_block(self, layer: Tree, x):
        """x + MLP(post-norm x), the MLP's down product summed over tp."""
        h = self._tp_in(rms_norm(x, layer["post_ln_w"], self.cfg.rms_norm_eps))
        return x + self._tp_out(_mlp(layer, h))

    def _full_layer(self, layer: Tree, x, cos, sin):
        return self._causal_layer(layer, x, cos, sin)[0]

    def forward_full(self, params: Tree, hidden, position_ids,
                     remat: bool = False):
        """Cache-free full forward of (B, S, H) embeddings at
        ``position_ids`` (S,): float32 logits (B, S, V) at every position
        (JAX ``forward_full``: training and tests). No KV slab, no
        ``inference_mode``: with float parameters that require grad, the
        result carries the autograd graph.

        ``remat=True`` checkpoints each layer when grad is enabled (the
        backward recomputes it from its input; JAX's ``nothing_saveable``
        per scanned layer). Quantized trees run inference: int8 linears
        and lm_head through K5, an int4 lm_head through K4. Those kernels
        and K3 have no backward; reached while a gradient is required they
        raise (``ops/kernels.forbid_backward``). The auto dispatch never
        takes K3 under a gradient (``ops/attention.py``)."""
        check_params(params)
        cos, sin = self.rotary.lookup(position_ids)
        for layer in unstack_layers(params["layers"]):
            if remat and torch.is_grad_enabled():
                hidden = checkpoint(self._full_layer, layer, hidden, cos, sin,
                                    use_reentrant=False)
            else:
                hidden = self._full_layer(layer, hidden, cos, sin)
        return self.logits(params, hidden)

    def logits(self, params: Tree, hidden):
        """Final norm + lm head; float32 logits (B, S, V), never rounded
        to the compute dtype (JAX: ``preferred_element_type=float32``).
        int4 lm_head: K4; int8 lm_head: K5 with a float32 output."""
        h = rms_norm(hidden, params["final_ln_w"], self.cfg.rms_norm_eps)
        b, s, hd = h.shape
        h2 = h.reshape(b * s, hd).contiguous()
        lm = params.get("lm_head")
        if lm is not None and lm.shape[0] < self.vocab_size:
            h2 = self._tp_in(h2)  # the vocab-parallel product's input
        if "lm_head_q4" in params:
            forbid_backward("K4 (quant_matvec_int4)", h2)
            y = quant_matvec_int4(h2, params["lm_head_q4"], params["lm_head_s"])
        elif "lm_head_q" in params:
            forbid_backward("K5 (quant_matmul)", h2)
            y = quant_matmul(h2, params["lm_head_q"], params["lm_head_s"],
                             out_dtype=torch.float32)
        else:
            y = matmul_f32(h2, params["lm_head"].T)
        if y.shape[-1] < self.vocab_size:  # a vocab-parallel shard
            y = gather_from_tp(y, self.tp)
        return y.reshape(b, s, -1)

    @torch.inference_mode()
    def prefill(self, params: Tree, hidden, position_ids, cache: KVCache,
                true_len, counts=None):
        """Full-sequence prefill of (B, P, H) embeddings. Writes
        cache[0:P] in place; returns (logits at true_len - 1 (B, V), cache).
        ``true_len``: an int shared by the rows, or a sequence of one per
        row (the serving scheduler's batched admission). The padded suffix
        [true_len, P) is causal garbage that later decode steps
        overwrite. ``counts`` (``call_counts``'s None) is ignored, as in
        every step below."""
        check_params(params)
        cos, sin = self.rotary.lookup(position_ids)
        hidden = self._run_layers(params, hidden, cos, sin, cache)
        if isinstance(true_len, int):
            last = hidden[:, true_len - 1: true_len]
        else:  # host lengths: row slices, no copy to the device
            last = torch.stack([hidden[i, int(n) - 1]
                                for i, n in enumerate(true_len)])[:, None]
        return self.logits(params, last)[:, 0], cache

    @torch.inference_mode()
    def prefill_chunk(self, params: Tree, hidden, start, cache: KVCache,
                      true_len: int):
        """Incremental (chunked) prefill of (B, P, H) embeddings at
        positions [start, start + P), extending a cache whose slots [0,
        start) hold the earlier chunks (JAX ``prefill_chunk``): each layer
        writes the block at [start, start + P), then chunk query i attends
        to slab slot j iff j <= start + i, over the slab as stored
        (dequantized from an int8 slab). ``start``: an int or a 0-d
        device tensor. Returns (logits at chunk index true_len - 1 (B,
        V), cache)."""
        hidden = self._chunk_layers(params, hidden, start, cache)
        last = hidden[:, true_len - 1: true_len]
        return self.logits(params, last)[:, 0], cache

    @torch.inference_mode()
    def score_chunk(self, params: Tree, token_ids, start, cache: KVCache,
                    return_logits: bool = False):
        """Score a block of already-chosen tokens (B, P) at positions
        [start, start + P) in one call (JAX ``score_chunk``, the verify of
        speculative decoding): the block's K/V land in slab slots [start,
        start + P) through the chunk layers of ``prefill_chunk``, and
        position i's output is the model's greedy successor of the
        history and block[:, :i + 1]. Rejected-draft slots are
        overwritten by the next block before any mask makes them
        attendable. ``start``: an int or a 0-d device tensor. Returns
        (argmax tokens (B, P) int32, cache), or with ``return_logits``
        ((B, P, V) float32 logits, cache): speculative sampling needs the
        target's distribution at every position.

        On an int8 slab every position attends the block's K/V as stored
        (quantized), its own included, as JAX's verify does; a decode
        step attends its own K/V unquantized, so an int8-KV speculative
        run may leave plain greedy decoding where int8 rounding reorders
        the two best logits."""
        hidden = self._chunk_layers(params, self.embed(params, token_ids),
                                    start, cache)
        logits = self.logits(params, hidden)
        if return_logits:
            return logits, cache
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def _chunk_layers(self, params: Tree, hidden, start, cache: KVCache):
        """Every layer of a chunk at positions [start, start + P): the
        rotary rows gathered at ``start + arange(P)`` (on the device when
        ``start`` is a tensor)."""
        check_params(params)
        cos, sin = self.rotary.lookup(
            start + torch.arange(hidden.shape[1], device=hidden.device))
        layers = params["layers"]
        for l in range(cache.k.shape[0]):
            hidden = self._chunk_layer({k: v[l] for k, v in layers.items()},
                                       hidden, cos, sin, l, cache, start)
        return hidden

    def _chunk_layer(self, layer: Tree, x, cos, sin, l: int, cache: KVCache,
                     start):
        """One layer of chunked prefill (JAX ``_chunk_layer``): store the
        fresh block first, then attend over the whole slab as stored with
        the mask j <= start + i, which covers the history and the block
        causally. The JAX package computes this with plain einsums,
        outside any kernel; so does this. The mask's query positions
        ``start + arange(P)`` stay on the device for a tensor ``start``."""
        cfg = self.cfg
        b, p_len, _ = x.shape
        nq, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        residual = x
        h = self._tp_in(rms_norm(x, layer["input_ln_w"], cfg.rms_norm_eps))
        q, k, v = _qkv3(layer, h, nq, nkv, hd)
        q = rms_norm(q, layer["q_norm_w"], cfg.rms_norm_eps)
        k = rms_norm(k, layer["k_norm_w"], cfg.rms_norm_eps)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        cache.store(l, k.transpose(1, 2), v.transpose(1, 2), start)
        k_use, v_use = cache.layer(l, q.dtype)  # (B, Hkv, S, D)
        qg = q.reshape(b, p_len, nkv, nq // nkv, hd)
        sc = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(),
                          k_use.float()) * hd ** -0.5
        slot = torch.arange(k_use.shape[2], device=x.device)
        query = start + torch.arange(p_len, device=x.device)
        sc = torch.where(slot[None, :] <= query[:, None], sc, -1e9)
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        out = torch.einsum("bhgqk,bhkd->bqhgd",
                           p.to(v_use.dtype).float(), v_use.float())
        out = out.reshape(b, p_len, nq * hd).to(x.dtype)
        x = residual + self._tp_out(_linear(layer, "o_w", out))
        return self._mlp_block(layer, x)

    def _run_layers(self, params: Tree, hidden, cos, sin, cache: KVCache,
                    kv_start=None):
        layers = params["layers"]
        for l in range(cache.k.shape[0]):
            hidden = self._layer({k: v[l] for k, v in layers.items()},
                                 hidden, cos, sin, l, cache, kv_start)
        return hidden

    @torch.inference_mode()
    def prefill_aligned(self, params: Tree, hidden, kv_start, cache: KVCache,
                        counts=None):
        """Right-aligned prefill: row b of the (B, P, H) embeddings holds
        its prompt at slots [kv_start[b], P) and garbage before. Positions
        are max(slot - kv_start, 0); attention is causal from kv_start on.
        Writes cache[0:P] in place; returns (logits at slot P - 1 (B, V),
        cache)."""
        check_params(params)
        p = hidden.shape[1]
        slots = torch.arange(p, device=hidden.device)
        positions = torch.clamp(slots[None, :] - kv_start[:, None], min=0)
        cos, sin = self.rotary.lookup_batch(positions)
        hidden = self._run_layers(params, hidden, cos, sin, cache, kv_start)
        return self.logits(params, hidden[:, -1:])[:, 0], cache

    def _use_fused_step(self, params: Tree, device,
                        fold_lm: bool = False, pos=None) -> bool:
        """The decode kernel runs for a shared write slot at any B, no
        attention biases, head_dim 128 on CUDA, for float, int8, int4 and
        merged int4g weights, and bf16/f32 or int8 slabs
        (ASR_DECODE_IMPL=scan|fused overrides 'auto'). As in JAX's
        dispatch, per-row positions (a (B,) ``pos``: serving), unmerged
        int4g weights, blocked int4 and tensor parallelism run the
        per-layer path, and a folded step (``fold_lm``) does not take an
        int4 lm_head."""
        impl = os.environ.get("ASR_DECODE_IMPL", "auto")
        if (impl == "scan" or (fold_lm and "lm_head_q4" in params)
                or _per_row(pos) or self.tp is not None):
            return False
        layers = params["layers"]
        eligible = "q_b" not in layers and not is_blocked(layers) and (
            "qkv_w_q4" in layers or not is_grouped(layers))
        if impl == "fused":
            return eligible
        return eligible and device.type == "cuda" and self.cfg.head_dim == 128

    @torch.inference_mode()
    def decode_step(self, params: Tree, token_ids, pos, cache: KVCache,
                    *, fold: bool = False, counts=None):
        """Single greedy decode step at position ``pos``: shared by every
        row (slab slots [0, pos) are live), an int or a 0-d integer device
        tensor (the engine's captured steps); or a (B,) integer tensor,
        row b at position pos[b] over its slots [0, pos[b]) (JAX's
        per-example positions, the serving scheduler's slots), which runs
        the per-layer path and writes each row's K/V at its own slot.
        Returns (logits (B, V) float32 — with ``fold``, token ids (B,)
        int32 — and the cache updated in place)."""
        b = token_ids.shape[0]
        if _per_row(pos):
            if pos.shape[0] != b:
                raise ValueError(
                    f"decode_step: {pos.shape[0]} positions for {b} rows; "
                    "per-row positions need one per row")
            if fold:
                raise ValueError("decode_step: the folded lm_head takes a "
                                 "shared position, not per-row positions")
            cos, sin = self.rotary.lookup_batch(pos.long())  # (B, D)
            return self._step(params, token_ids, cos, sin, cache, None, pos,
                              False)
        if isinstance(pos, torch.Tensor) and pos.ndim == 0:
            cos, sin = self.rotary.lookup_at(pos)
        elif isinstance(pos, int):
            cos, sin = self.rotary.lookup_pos(pos)  # (1, D)
        else:
            raise TypeError(
                "decode_step: pos must be an int, a 0-d or a (B,) integer "
                "tensor; right-aligned batches use decode_step_aligned")
        return self._step(params, token_ids, cos.expand(b, -1),
                          sin.expand(b, -1), cache, None, pos, fold)

    @torch.inference_mode()
    def decode_step_aligned(self, params: Tree, token_ids, slot, kv_start,
                            cache: KVCache, *, fold: bool = False,
                            counts=None):
        """Right-aligned decode step: every row writes the shared slot
        ``slot`` (== P + step; an int or a 0-d integer device tensor); row
        b attends to slots [kv_start[b], slot) at position slot -
        kv_start[b]. Returns what ``decode_step`` returns."""
        positions = (slot - kv_start)[:, None]  # (B, 1)
        cos, sin = self.rotary.lookup_batch(positions)
        return self._step(params, token_ids, cos[:, 0], sin[:, 0], cache,
                          kv_start, slot, fold)

    def _step(self, params: Tree, token_ids, cos, sin, cache: KVCache,
              start, end, fold: bool):
        """One decode step of every row: cos/sin (B, D), live slab slots
        [start_b, end) (start None: 0; ``end`` an int, a 0-d device
        tensor or per row a (B,) one), the fresh K/V written at ``end``.
        ``fold``: the final RMSNorm, lm_head and argmax run inside the
        decode kernel, which returns token ids in place of the logits."""
        check_params(params)
        hidden = self.embed(params, token_ids)  # (B, H)
        fold_kw = {}
        if fold:
            lm_q = params.get("lm_head_q")
            fold_kw = dict(
                fold_lm=True, final_ln_w=params["final_ln_w"],
                lm_head=params["lm_head"] if lm_q is None else lm_q,
                lm_scales=None if lm_q is None else params["lm_head_s"])
        if fold or self._use_fused_step(params, hidden.device, pos=end):
            out, ks, vs = decode_layers_fused(
                hidden, cos.contiguous(), sin.contiguous(), params["layers"],
                cache.k, cache.v, start, end, eps=self.cfg.rms_norm_eps,
                k_scales=cache.k_scale, v_scales=cache.v_scale, **fold_kw,
            )
        else:
            out, ks, vs = self._decode_scan(params, hidden, cos, sin,
                                            cache, start, end)
        cache.store_token(ks, vs, end)
        if fold:
            return out, cache
        return self.logits(params, out[:, None])[:, 0], cache

    def _fold(self, params: Tree, token_ids) -> bool:
        """Whether a token step folds the lm_head into the decode kernel:
        ``ASR_FOLD_LM=1`` and the kernel eligible with ``fold_lm``."""
        return os.environ.get("ASR_FOLD_LM") == "1" and self._use_fused_step(
            params, token_ids.device, fold_lm=True)

    @torch.inference_mode()
    def decode_step_token(self, params: Tree, token_ids, pos,
                          cache: KVCache, counts=None):
        """Greedy decode step emitting the next token ids (B,); ties break
        on the first index, as jnp.argmax does. Folded (``ASR_FOLD_LM=1``)
        the decode kernel returns them as int32; else ``torch.argmax`` of
        ``decode_step``'s logits gives int64."""
        fold = self._fold(params, token_ids) and not _per_row(pos)
        out, cache = self.decode_step(params, token_ids, pos, cache, fold=fold)
        return (out if fold else torch.argmax(out, dim=-1)), cache

    @torch.inference_mode()
    def decode_step_aligned_token(self, params: Tree, token_ids, slot,
                                  kv_start, cache: KVCache, counts=None):
        """Right-aligned ``decode_step_token`` (see decode_step_aligned)."""
        fold = self._fold(params, token_ids)
        out, cache = self.decode_step_aligned(params, token_ids, slot,
                                              kv_start, cache, fold=fold)
        return (out if fold else torch.argmax(out, dim=-1)), cache

    def _decode_scan(self, params: Tree, hidden, cos, sin, cache: KVCache,
                     start, end):
        """Plain per-layer decode over each row's stale slab [start_b, end).
        Returns (hidden (B, H), ks, vs (L, B, Hkv, D))."""
        impl = os.environ.get("ASR_DECODE_ATTN", "auto")
        if impl == "auto":
            impl = "kernel" if hidden.is_cuda else "dense"
        if impl not in ("kernel", "dense"):
            raise ValueError(f"unknown ASR_DECODE_ATTN {impl!r}")
        layers = params["layers"]
        ks, vs = [], []
        h = hidden[:, None]  # (B, 1, H)
        cos, sin = cos[:, None], sin[:, None]  # (B, 1, D)
        for l in range(cache.k.shape[0]):
            layer = {k: v[l] for k, v in layers.items()}
            h, k_f, v_f = self._decode_layer(layer, l, h, cos, sin, cache,
                                             start, end, impl)
            ks.append(k_f)
            vs.append(v_f)
        return h[:, 0], torch.stack(ks), torch.stack(vs)

    def _decode_layer(self, layer: Tree, l: int, h, cos, sin, cache: KVCache,
                      start, end, impl: str):
        """One decode layer; attention through K2 ('kernel') or the masked
        dense einsums of the JAX scan path ('dense'). The self K/V stay
        unquantized: in the slab dtype, or in h's for an int8 slab."""
        cfg = self.cfg
        b = h.shape[0]
        nq, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        residual = h
        x = self._tp_in(rms_norm(h, layer["input_ln_w"], cfg.rms_norm_eps))
        q, k, v = _qkv3(layer, x, nq, nkv, hd)
        q = rms_norm(q, layer["q_norm_w"], cfg.rms_norm_eps)
        k = rms_norm(k, layer["k_norm_w"], cfg.rms_norm_eps)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        if impl == "kernel":
            self_dtype = h.dtype if cache.quantized else cache.k.dtype
            out = decode_attention_dma(
                q[:, 0].contiguous(), cache.k, cache.v,
                k[:, 0].to(self_dtype).contiguous(),
                v[:, 0].to(self_dtype).contiguous(), l, start, end,
                k_scales=cache.k_scale, v_scales=cache.v_scale,
            )
        else:
            k_lay, v_lay = cache.layer(l, h.dtype)
            out = self._dense_self_attention(q, k, v, k_lay, v_lay, start, end)
        out = out.reshape(b, 1, nq * hd).to(h.dtype)
        h = residual + self._tp_out(_linear(layer, "o_w", out))
        return self._mlp_block(layer, h), k[:, 0], v[:, 0]

    def _dense_self_attention(self, q, k, v, k_lay, v_lay, start, end):
        """Masked dense decode attention (JAX ``_decode_layer_masked``):
        slab slots [start_b, end) (start None: 0) plus the self term;
        probabilities normalized first and rounded to the slab dtype
        before the V products."""
        b, _, nq, hd = q.shape
        nkv = k.shape[2]
        groups = nq // nkv
        scale = hd ** -0.5
        qg = q.reshape(b, 1, nkv, groups, hd).float()
        sc = torch.einsum("bqhgd,bhkd->bhgqk", qg, k_lay.float()) * scale
        slot = torch.arange(k_lay.shape[2], device=q.device)[None, :]
        end = torch.as_tensor(end, device=q.device).reshape(-1, 1)
        live = (slot < end).expand(b, -1)
        if start is not None:
            live = live & (slot >= start[:, None])
        sc = torch.where(live[:, None, None, None, :], sc, -1e9)
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
