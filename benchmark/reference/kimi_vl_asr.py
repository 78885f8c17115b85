"""Kimi-VL-A3B's language model under the Qwen3-ASR audio tower, in plain
float32 PyTorch: the reference that decides ``correct`` for the
``deepseek_v3`` configurations.

The audio side is ``reference/qwen3_asr.py``'s, unchanged (log-mel, the
chunked encoder, the chat prompt with the audio injected after the ninth
token); this class replaces its decoder with transformers'
``DeepseekV3`` one (``modeling_deepseek_v3.py``, 4.57): multi-head latent
attention in the expanded form (``kv_b_proj`` makes every head's K and
V, one interleaved-rope key shared by the heads, the scale
``qk_head_dim ** -0.5``, ``kv_a_layernorm`` at its module default eps
1e-6), the dense MLP below ``first_k_dense_replace``, and past it the
router (float32 logits, sigmoid, the bias used only to choose, the
chosen scores normalised and times ``routed_scaling_factor``), a loop
over the experts summing each token's routed outputs, and the shared
experts. It knows nothing of the program: no kernels, no cache, no
batching, no padding, no latent absorption. Every product with a weight
upcasts that weight alone, per product (a float32 copy of the whole
model would be 64 GB), TF32 off.

Departures from the published file: the weights are the benchmark's
layout (``architectures/deepseek_v3.py``: linears (in, out), experts
stacked with gate and up fused); ``n_group`` = ``topk_group`` = 1, so
the group choice, the identity, is left out; positions are Qwen3-ASR's
1-D ones.

    ref = Reference(config, enc, dec, "cuda")           # or matmul="fp8"
    logits = ref.continuation_logits(samples, tokens)   # (n + 1, V)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from harness.spec import load_module

BASE = load_module(Path(__file__).resolve().parent / "qwen3_asr.py")

KV_A_NORM_EPS = 1e-6  # DeepseekV3RMSNorm's default, as kv_a_layernorm has


def _rope_interleave(x, cos, sin):
    """``apply_rotary_pos_emb_interleave`` on x (S, heads, D)."""
    s, h, d = x.shape
    x = x.view(s, h, d // 2, 2).transpose(3, 2).reshape(s, h, d)
    turned = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos[:, None] + turned * sin[:, None]


class Reference(BASE.Reference):
    """The model of one ``deepseek_v3`` configuration over one set of
    weights; ``matmul="fp8"``: every product with a weight from float8
    e4m3 operands (the control), as ``reference/qwen3_asr.py``'s."""

    def __init__(self, config: dict, *args, **kw):
        super().__init__(config, *args, **kw)
        # the published keys stand at the file's top level
        top = {k: v for k, v in config.items() if k != "thinker_config"}
        self.t = {**top, **config["thinker_config"].get("text_config", {})}

    def _rope(self, n: int):
        """cos/sin (n, qk_rope_head_dim) of the default rope at 0..n-1."""
        t = self.t
        d = t["qk_rope_head_dim"]
        inv = 1.0 / t["rope_theta"] ** (np.arange(0, d, 2) / d)
        ang = np.arange(n)[:, None] * inv[None, :]
        ang = np.concatenate([ang, ang], 1)
        return (torch.tensor(np.cos(ang), dtype=torch.float32,
                             device=self.device),
                torch.tensor(np.sin(ang), dtype=torch.float32,
                             device=self.device))

    def _mlp(self, x, gate_w, up_w, down_w):
        return self._mm(F.silu(self._mm(x, gate_w)) * self._mm(x, up_w),
                        down_w)

    def _attention(self, x, l: int, cos, sin):
        t, p = self.t, self.dec["layers"]
        s = x.shape[0]
        nh, nope, rd, vd, r = (t["num_attention_heads"],
                               t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                               t["v_head_dim"], t["kv_lora_rank"])
        q = self._mm(x, p["q_w"][l]).view(s, nh, nope + rd)
        ckv = self._mm(x, p["kv_a_w"][l])
        c = BASE._rms_norm(ckv[:, :r], p["kv_a_ln_w"][l], KV_A_NORM_EPS)
        kv = self._mm(c, p["kv_b_w"][l]).view(s, nh, nope + vd)
        q_rot = _rope_interleave(q[..., nope:], cos, sin)
        k_rot = _rope_interleave(ckv[:, None, r:], cos, sin)
        qs = torch.cat([q[..., :nope], q_rot], -1).transpose(0, 1)
        ks = torch.cat([kv[..., :nope], k_rot.expand(s, nh, rd)],
                       -1).transpose(0, 1)
        sc = qs @ ks.transpose(1, 2) * (nope + rd) ** -0.5
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
        att = torch.softmax(sc, -1) @ kv[..., nope:].transpose(0, 1)
        return self._mm(att.transpose(0, 1).reshape(s, nh * vd), p["o_w"][l])

    def _moe(self, x, j: int):
        t, m = self.t, self.dec["moe"]
        scores = torch.sigmoid(self._mm(x, m["router_w"][j]))
        ids = torch.topk(scores + m["router_bias"][j].float(),
                         t["num_experts_per_tok"], dim=-1).indices
        weights = scores.gather(1, ids)
        if t["norm_topk_prob"]:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        weights = weights * t["routed_scaling_factor"]
        inter = t["moe_intermediate_size"]
        out = torch.zeros_like(x)
        for e in range(t["n_routed_experts"]):
            tok, slot = torch.where(ids == e)
            if tok.numel() == 0:
                continue
            gu = m["experts_gate_up_w"][j, e]
            y = self._mlp(x[tok], gu[:, :inter], gu[:, inter:],
                          m["experts_down_w"][j, e])
            out.index_add_(0, tok, y * weights[tok, slot, None])
        return out + self._mlp(x, m["shared_gate_w"][j], m["shared_up_w"][j],
                               m["shared_down_w"][j])

    def _decoder_layer(self, h, l: int, cos, sin):
        t, p = self.t, self.dec["layers"]
        eps = t["rms_norm_eps"]
        h = h + self._attention(BASE._rms_norm(h, p["input_ln_w"][l], eps),
                                l, cos, sin)
        x = BASE._rms_norm(h, p["post_ln_w"][l], eps)
        k = t["first_k_dense_replace"]
        if l < k:
            d = self.dec["dense"]
            return h + self._mlp(x, d["gate_w"][l], d["up_w"][l],
                                 d["down_w"][l])
        return h + self._moe(x, l - k)
