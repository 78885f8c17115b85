"""The ``deepseek_v3`` text decoder (Kimi-VL-A3B's language model) under
the Qwen3-ASR audio tower: multi-head latent attention (MLA) and routed
experts with shared ones.

It follows transformers' ``modeling_deepseek_v3.py`` (the router, the MoE
block with its shared experts, interleaved rope, MLA with one rope key
shared by every head and the scale ``qk_head_dim ** -0.5``, the layer
whose MLP is dense below ``first_k_dense_replace``), with the engine's
interface of ``models/text_decoder.py``: ``embed``, ``prefill``,
``prefill_aligned``, the decode steps and ``logits``, the cache type in
``cache_type``. Positions are Qwen3-ASR's (0 at a prompt's first token,
every MRoPE row the same), so the rope is 1-D over ``qk_rope_head_dim``.

Attention, two forms of one function. The prefill runs the expanded
form: ``kv_b_proj`` makes every head's K (its 128 "nope" dims, then the
shared roped 64) and V from the normed latent ``c_kv``, and attention is
causal over the prompt (``scaled_dot_product_attention``; V keeps its
own width). A decode step runs the absorbed form over the latent cache:
the query's nope part goes through ``kv_b_proj``'s K half into the
512-wide latent, the scores are q_lat . c_kv + q_rot . k_rot times
192 ** -0.5, and the attention output over c_kv goes through the V half
and then ``o_proj``; the slab holds per layer and position the normed
``c_kv`` and the roped ``k_rot`` (576 values, ``LatentCache``), 4% of a
step's bytes at Kimi-VL-A3B's widths. A step writes its own latent into
the slab first and attends [start, slot] inclusive. The attention's ops
are plain torch ops, captured in the engine's CUDA graphs; the norms and
the latent's prologue (its RMSNorm and the interleaved rope of the
query's and key's rope parts) are K8's fused passes
(``ops/kernels/fused_elementwise.py``).

The MLP of a layer at or past ``first_k_dense_replace``: the router
(``ops/kernels/moe_experts.py::route``), the routed experts through K7
(``moe_experts``), the shared experts (one SwiGLU of ``n_shared_experts``
x ``moe_intermediate_size``) as plain bf16 products, the routed sum
rounded to the compute dtype before the shared output is added, as
published. The residual stream between the layers is float32 (the
published bf16 model keeps it in bf16): each norm reads it and rounds
once to the compute dtype, each layer's outputs are added to it
unrounded, which keeps the served tokens nearer the float32 reference
where random weights route near-tied experts. A prompt's padding, and in
a decode step the rows that are done, are routed nowhere. The engine's
per-call object (``call_counts``: a ``RouteCounts``, passed as
``counts=`` to the prefill and every decode step) holds the decode
loop's done flags and counts on the device the routes each expert got;
``read_counts`` reads it once after the loop into the engine's
``last_stats`` and the tracer's ``moe.*`` counters. The eager prefill
enters a ``prefill.moe`` span around each MoE block.

Weights (the layout the benchmark draws, ``benchmark/architectures/
deepseek_v3.py``): ``layers/`` the attention and norms of every layer
(``input_ln_w``, ``q_w`` (H, heads x 192), ``kv_a_w`` (H, 576),
``kv_a_ln_w`` (512), ``kv_b_w`` (512, heads x 256: each head's K nope
then V), ``o_w`` (heads x 128, H), ``post_ln_w``), ``dense/`` the dense
layers' ``gate_w``, ``up_w``, ``down_w``, ``moe/`` the others'
``router_w`` (H, E), ``router_bias`` (E), ``experts_gate_up_w`` (E, H,
2 I), ``experts_down_w`` (E, I, H) and ``shared_{gate,up,down}_w``,
each stacked on a leading layer axis; ``embed``, ``final_ln_w``,
``lm_head`` (V, H). Linears are (in, out).

Only the offline path runs this decoder (``modes`` is empty): serving,
streaming, speculative decoding, training, tensor parallelism, quantized
weights, an int8 cache and checkpoint loading and export refuse it
(``models/decoders.py::require``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..config import DeepseekV3TextConfig
from ..errors import ArchitectureNotSupported
from ..ops.attention import MASK_VALUE
from ..ops.kernels.fused_elementwise import latent_rope, rms_norm
from ..ops.kernels.moe_experts import moe_experts, route
from ..ops.quant import matmul_f32
from ..ops.rotary import RotaryTable
from ..utils.tracing import count, span

Tree = Any

# transformers' DeepseekV3RMSNorm default: kv_a_layernorm is built without
# the config's rms_norm_eps
KV_A_NORM_EPS = 1e-6


@dataclasses.dataclass
class RouteCounts:
    """One call's device counters of the routed experts, the engine's
    per-call object (``DeepseekV3Decoder.call_counts``): ``touched[i]``
    the experts that got at least one live route, summed over the MoE
    layers, of decode step i (``step``, the decode loop's own counter,
    indexes it) and, at the last index, of the prefill; ``rows`` the live
    routes over layers and steps, of the decode steps then of the
    prefill; ``max_rows`` the most routes one expert got in one layer and
    step (or prefill). ``done``: the decode loop's done flags, whose rows
    a decode step routes nowhere."""

    touched: torch.Tensor   # (max_new + 1,) int64
    rows: torch.Tensor      # (2,) int64
    max_rows: torch.Tensor  # () int64
    step: torch.Tensor      # () int64
    done: torch.Tensor      # (B,) bool

    @classmethod
    def zeros(cls, n: int, step: torch.Tensor, done: torch.Tensor
              ) -> "RouteCounts":
        i64 = dict(dtype=torch.int64, device=step.device)
        return cls(touched=torch.zeros(n + 1, **i64),
                   rows=torch.zeros(2, **i64),
                   max_rows=torch.zeros((), **i64), step=step, done=done)

    def zero_(self) -> None:
        for t in (self.touched, self.rows, self.max_rows):
            t.zero_()

    def add(self, counts: torch.Tensor, prefill: bool) -> None:
        """Add one decode step's (at ``step``) or the prefill's routes per
        expert of every MoE layer, ``counts`` (layers, E)."""
        touched = (counts > 0).sum().reshape(1)
        if prefill:
            self.touched[-1:].add_(touched)
        else:
            self.touched.index_add_(0, self.step.reshape(1), touched)
        self.rows[int(prefill)].add_(counts.sum())
        self.max_rows.copy_(torch.maximum(self.max_rows, counts.max()))

    def read(self, steps: int) -> dict:
        """Read the counters once; record the tracer's ``moe.*`` counters
        and return ``last_stats``' ``experts_touched`` (one number per
        decode step run)."""
        values = torch.cat([self.touched, self.rows,
                            self.max_rows.reshape(1)]).tolist()
        touched, pf_touched, rows, pf_rows, max_rows = (
            values[:steps], *values[-4:])
        count("moe.decode_experts_touched", sum(touched))
        count("moe.decode_rows", rows)
        count("moe.prefill_experts_touched", pf_touched)
        count("moe.prefill_rows", pf_rows)
        count("moe.max_expert_rows", max_rows, largest=True)
        return {"experts_touched": touched}


@dataclasses.dataclass
class LatentCache:
    """Preallocated latent slab: c (num_layers, batch, max_len, 576), per
    layer and position the normed ``c_kv`` (512) then the roped ``k_rot``
    (64), in the compute dtype. The contract of ``KVCache``: ``zeros``,
    ``slab_shapes`` (the engine's arenas), ``store``, ``store_token``,
    ``grow``, ``max_len``, ``layer``."""

    c: torch.Tensor

    quantized = False

    @staticmethod
    def slab_shapes(cfg: DeepseekV3TextConfig, batch: int, max_len: int,
                    dtype: torch.dtype, quantized: bool = False) -> list:
        """[(shape, dtype)] of the slab's tensors, in constructor order."""
        if quantized:
            raise ArchitectureNotSupported(
                "an int8 cache does not hold the deepseek_v3 latent")
        return [((cfg.num_hidden_layers, batch, max_len, cfg.latent_dim),
                 dtype)]

    @classmethod
    def zeros(cls, cfg: DeepseekV3TextConfig, batch: int, max_len: int,
              dtype: torch.dtype = torch.bfloat16,
              device: str | torch.device = "cpu",
              quantized: bool = False) -> "LatentCache":
        (shape, dt), = cls.slab_shapes(cfg, batch, max_len, dtype, quantized)
        return cls(torch.zeros(shape, dtype=dt, device=device))

    @property
    def max_len(self) -> int:
        return self.c.shape[2]

    def store(self, l: int, lat, start=0) -> None:
        """Write latents (B, S, 576) of layer ``l`` at slots [start, start
        + S); ``start`` a host int or a 0-d device tensor (a captured
        step's slot)."""
        n = lat.shape[1]
        if isinstance(start, torch.Tensor):
            idx = start.reshape(1).long()
            if n > 1:
                idx = idx + torch.arange(n, device=lat.device)
            self.c[l].index_copy_(1, idx, lat.to(self.c.dtype))
            return
        self.c[l, :, start:start + n] = lat.to(self.c.dtype)

    def store_token(self, lats, slot) -> None:
        """Write one token's latents (L, B, 576) of every layer at the
        shared ``slot`` (an int or a 0-d device tensor)."""
        for l in range(lats.shape[0]):
            self.store(l, lats[l][:, None], slot)

    def grow(self, new_len: int) -> "LatentCache":
        """This slab copied into the first slots of a larger zero slab."""
        g = self.c.new_zeros(self.c.shape[:2] + (new_len,) + self.c.shape[3:])
        g[:, :, :self.max_len].copy_(self.c)
        return LatentCache(g)

    def layer(self, l: int, dtype=None):
        """Layer ``l``'s latents (B, S, 576)."""
        return self.c[l]


def _bmm_f32(a, b):
    """a @ b (batched) with float32 accumulation and a float32 result."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _swiglu(x, gate_w, up_w, down_w):
    return (F.silu(x @ gate_w) * (x @ up_w)) @ down_w


class DeepseekV3Decoder:
    """Stateless decoder; parameters are passed to every call."""

    cache_type = LatentCache
    # the offline path alone: no mode of ``models/decoders.py::MODES``
    modes = frozenset()

    def __init__(self, cfg: DeepseekV3TextConfig, max_position: int = 8192,
                 device: str | torch.device = "cpu", tp=None):
        if tp is not None:
            from .decoders import require  # decoders imports this module

            require(cfg, "tensor parallelism")
        self.cfg = cfg.check()
        self.vocab_size = cfg.vocab_size
        d = cfg.qk_rope_head_dim
        self.rotary = RotaryTable(head_dim=d, rope_theta=cfg.rope_theta,
                                  mrope_section=(d // 2,),
                                  max_position=max_position, device=device)
        self.scale = cfg.qk_head_dim ** -0.5

    def call_counts(self, max_new: int, step, done) -> RouteCounts:
        """The per-call counters that the engine passes to the prefill and
        to every decode step (``counts=``), for a loop of up to
        ``max_new`` steps whose step counter and done flags are ``step``
        and ``done``; a prefill zeroes them first."""
        return RouteCounts.zeros(max_new, step, done)

    def read_counts(self, counts: RouteCounts, steps: int) -> dict:
        """What a call's counters add to ``last_stats`` after ``steps``
        decode steps (one device read; the ``moe.*`` counters recorded)."""
        return counts.read(steps)

    def embed(self, params: Tree, input_ids):
        return params["embed"][input_ids]

    def logits(self, params: Tree, hidden):
        """Final norm and lm_head: float32 logits (B, S, V)."""
        h = rms_norm(hidden.contiguous(), params["final_ln_w"],
                     self.cfg.rms_norm_eps, params["embed"].dtype)
        return matmul_f32(h, params["lm_head"].T)

    # ----------------------------------------------------------- layers

    def _latent(self, lp: Tree, l: int, x, cos, sin):
        """The queries' nope parts (B, S, heads, 128) and rope parts turned
        (B, S, heads, 64), and the latent (B, S, 576): normed c_kv, then
        roped k_rot (K8's ``latent_rope``)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ lp["q_w"][l]).view(b, s, cfg.num_attention_heads,
                                    cfg.qk_head_dim)
        nope = cfg.qk_nope_head_dim
        q_rot, lat = latent_rope(q, x @ lp["kv_a_w"][l], cos, sin,
                                 lp["kv_a_ln_w"][l], KV_A_NORM_EPS, nope)
        return q[..., :nope], q_rot, lat

    def _attn_expanded(self, lp: Tree, l: int, x, cos, sin, mask):
        """Prefill attention: (output (B, S, H), latent (B, S, 576))."""
        cfg = self.cfg
        b, s, _ = x.shape
        nh, nope = cfg.num_attention_heads, cfg.qk_nope_head_dim
        q_nope, q_rot, lat = self._latent(lp, l, x, cos, sin)
        q = torch.cat([q_nope, q_rot], -1)
        kv = (lat[..., :cfg.kv_lora_rank] @ lp["kv_b_w"][l]).view(
            b, s, nh, nope + cfg.v_head_dim)
        k = torch.cat([kv[..., :nope], lat[:, :, None, cfg.kv_lora_rank:]
                       .expand(b, s, nh, cfg.qk_rope_head_dim)], -1)
        att = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2),
            kv[..., nope:].transpose(1, 2), attn_mask=mask, scale=self.scale)
        out = att.transpose(1, 2).reshape(b, s, nh * cfg.v_head_dim)
        return out @ lp["o_w"][l], lat

    def _attn_absorbed(self, lp: Tree, l: int, x, cos, sin,
                       cache: LatentCache, slot, masked):
        """A decode step's attention over the latent slab (x (B, 1, H)):
        the step's latent written at ``slot`` first, then every slot but
        the ``masked`` ones ((B, 1, S) or (1, 1, S)) attended. Returns
        (B, 1, H)."""
        cfg = self.cfg
        b = x.shape[0]
        nh, nope, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                       cfg.kv_lora_rank)
        q_nope, q_rot, lat = self._latent(lp, l, x, cos, sin)
        cache.store(l, lat, slot)
        w = lp["kv_b_w"][l].view(r, nh, nope + cfg.v_head_dim)
        q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0], w[..., :nope])
        qc = torch.cat([q_lat, q_rot[:, 0]], -1)              # (B, nh, 576)
        c = cache.layer(l)                                     # (B, S, 576)
        scores = _bmm_f32(qc, c.transpose(1, 2)) * self.scale  # (B, nh, S)
        scores = scores.masked_fill(masked, MASK_VALUE)
        p = torch.softmax(scores, -1).to(c.dtype)
        o_lat = _bmm_f32(p, c[..., :r]).to(x.dtype)           # (B, nh, 512)
        o = torch.einsum("bhc,chv->bhv", o_lat, w[..., nope:])
        return o.reshape(b, 1, nh * cfg.v_head_dim) @ lp["o_w"][l]

    def _mlp(self, params: Tree, l: int, x, live, per_layer: list,
             eager: bool):
        """x + the layer's MLP of post-normed x: dense, or routed experts
        plus shared ones; the routes per expert go to ``per_layer``."""
        cfg = self.cfg
        h = rms_norm(x, params["layers"]["post_ln_w"][l], cfg.rms_norm_eps,
                     params["embed"].dtype)
        if l < cfg.first_k_dense_replace:
            d = params["dense"]
            return x + _swiglu(h, d["gate_w"][l], d["up_w"][l],
                               d["down_w"][l])
        m, j = params["moe"], l - cfg.first_k_dense_replace
        with span("prefill.moe") if eager else contextlib.nullcontext():
            h2 = h.reshape(-1, h.shape[-1])
            routes = route(h2, m["router_w"][j], m["router_bias"][j],
                           cfg.num_experts_per_tok,
                           cfg.routed_scaling_factor, cfg.norm_topk_prob,
                           live)
            y = moe_experts(h2, routes, m["experts_gate_up_w"][j],
                            m["experts_down_w"][j])
        per_layer.append(routes.counts)
        shared = _swiglu(h, m["shared_gate_w"][j], m["shared_up_w"][j],
                         m["shared_down_w"][j])
        return x + (y.view_as(x) + shared)

    def _run(self, params: Tree, hidden, cos, sin, mask, cache, live,
             counts: Optional[RouteCounts]):
        """Every layer of a prefill, each layer's latent stored at [0,
        S); the residual stream in float32. ``counts``, zeroed first, gets
        the prefill's routes."""
        lp, per_layer = params["layers"], []
        if counts is not None:
            counts.zero_()
        hidden = hidden.float()
        for l in range(self.cfg.num_hidden_layers):
            x = rms_norm(hidden, lp["input_ln_w"][l], self.cfg.rms_norm_eps,
                         params["embed"].dtype)
            out, lat = self._attn_expanded(lp, l, x, cos, sin, mask)
            cache.store(l, lat)
            hidden = self._mlp(params, l, hidden + out, live, per_layer,
                               True)
        if counts is not None and per_layer:
            counts.add(torch.stack(per_layer).long(), prefill=True)
        return hidden

    @torch.inference_mode()
    def prefill(self, params: Tree, hidden, position_ids, cache: LatentCache,
                true_len: int, counts: Optional[RouteCounts] = None):
        """Left-aligned prefill of one utterance (B, P, H) with ``true_len``
        real tokens (an int). Returns (logits at true_len - 1 (B, V),
        cache)."""
        if not isinstance(true_len, int):
            raise ArchitectureNotSupported(
                "per-row prompt lengths (serving) do not run the "
                "deepseek_v3 decoder")
        p = hidden.shape[1]
        cos, sin = self.rotary.lookup_batch(position_ids)
        slot = torch.arange(p, device=hidden.device)
        mask = slot[None, :] <= slot[:, None]
        live = (slot < true_len).expand(hidden.shape[0], -1)
        hidden = self._run(params, hidden, cos, sin, mask, cache, live,
                           counts)
        last = hidden[:, true_len - 1: true_len]
        return self.logits(params, last)[:, 0], cache

    @torch.inference_mode()
    def prefill_aligned(self, params: Tree, hidden, kv_start,
                        cache: LatentCache,
                        counts: Optional[RouteCounts] = None):
        """Right-aligned prefill: row b's prompt at slots [kv_start[b], P),
        positions max(slot - kv_start, 0), causal attention from kv_start
        on (a padding slot attends itself alone, so that its row stays
        finite). Returns (logits at slot P - 1 (B, V), cache)."""
        p = hidden.shape[1]
        slot = torch.arange(p, device=hidden.device)
        positions = torch.clamp(slot[None, :] - kv_start[:, None], min=0)
        cos, sin = self.rotary.lookup_batch(positions)
        live = slot[None, :] >= kv_start[:, None]                 # (B, P)
        causal = slot[None, :] <= slot[:, None]                   # (P, P)
        mask = (causal & live[:, None, :]) | torch.eye(
            p, dtype=torch.bool, device=hidden.device)
        hidden = self._run(params, hidden, cos, sin, mask[:, None], cache,
                           live, counts)
        return self.logits(params, hidden[:, -1:])[:, 0], cache

    def _step(self, params: Tree, token_ids, positions, start, slot,
              cache: LatentCache, counts: Optional[RouteCounts]):
        """One decode step of every row at ``positions`` (B,), writing the
        shared ``slot`` and attending slots [start_b, slot] (start None:
        0); the rows ``counts.done`` are routed nowhere, and the routes
        are added to ``counts``. Returns float32 logits (B, V)."""
        cos, sin = self.rotary.lookup_batch(positions.reshape(-1, 1).long())
        h = self.embed(params, token_ids)[:, None].float()
        j = torch.arange(cache.max_len, device=h.device)[None, :]
        end = torch.as_tensor(slot, device=h.device).reshape(-1, 1)
        masked = j > end
        if start is not None:
            masked = masked | (j < start[:, None])
        masked = masked[:, None, :]
        live = None if counts is None else ~counts.done
        lp, per_layer = params["layers"], []
        for l in range(self.cfg.num_hidden_layers):
            x = rms_norm(h, lp["input_ln_w"][l], self.cfg.rms_norm_eps,
                         params["embed"].dtype)
            h = h + self._attn_absorbed(lp, l, x, cos, sin, cache, slot,
                                        masked)
            h = self._mlp(params, l, h, live, per_layer, False)
        if counts is not None and per_layer:
            counts.add(torch.stack(per_layer).long(), prefill=False)
        return self.logits(params, h)[:, 0]

    @torch.inference_mode()
    def decode_step(self, params: Tree, token_ids, pos, cache: LatentCache,
                    *, counts: Optional[RouteCounts] = None):
        """Decode step of a left-aligned batch at the shared position
        ``pos`` (an int or a 0-d device tensor; slots [0, pos] live).
        Returns (logits (B, V) float32, cache)."""
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            raise ArchitectureNotSupported(
                "per-row positions (serving) do not run the deepseek_v3 "
                "decoder")
        b = token_ids.shape[0]
        positions = torch.as_tensor(pos, device=token_ids.device).expand(b)
        return self._step(params, token_ids, positions, None, pos, cache,
                          counts), cache

    @torch.inference_mode()
    def decode_step_aligned(self, params: Tree, token_ids, slot, kv_start,
                            cache: LatentCache, *,
                            counts: Optional[RouteCounts] = None):
        """Right-aligned decode step: every row writes ``slot`` (P +
        step), row b attends [kv_start[b], slot] at position slot -
        kv_start[b]. Returns (logits (B, V) float32, cache)."""
        return self._step(params, token_ids, slot - kv_start, kv_start, slot,
                          cache, counts), cache

    @torch.inference_mode()
    def decode_step_token(self, params: Tree, token_ids, pos,
                          cache: LatentCache, **kw):
        """``decode_step``'s greedy token ids (B,) int64."""
        logits, cache = self.decode_step(params, token_ids, pos, cache, **kw)
        return torch.argmax(logits, dim=-1), cache

    @torch.inference_mode()
    def decode_step_aligned_token(self, params: Tree, token_ids, slot,
                                  kv_start, cache: LatentCache, **kw):
        """``decode_step_aligned``'s greedy token ids (B,) int64."""
        logits, cache = self.decode_step_aligned(params, token_ids, slot,
                                                 kv_start, cache, **kw)
        return torch.argmax(logits, dim=-1), cache

