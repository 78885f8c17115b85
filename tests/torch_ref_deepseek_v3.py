"""The ``deepseek_v3`` text decoder in plain float32 PyTorch: the
reference the port's tests hold ``models/deepseek_v3_decoder.py`` to.

It follows transformers' ``models/deepseek_v3/modeling_deepseek_v3.py``
(4.57): the router (``DeepseekV3TopkRouter``: float32 logits, sigmoid,
the bias used only to choose, the chosen scores normalised and scaled),
the MoE block (``DeepseekV3MoE.moe``: a loop over the experts, each
token's routed outputs summed in float32, the shared experts added),
interleaved rope (``apply_rotary_pos_emb_interleave``), MLA in its
expanded form (``DeepseekV3Attention``: ``kv_b_proj`` makes every head's K
and V, one rope key shared by the heads, the scale ``qk_head_dim **
-0.5``) and the layer (dense below ``first_k_dense_replace``). One
sequence, no cache, no batching, no kernels; every product float32.

Departures from the published file: the weights are the port's layout
(linears (in, out), the experts stacked, gate and up fused, see the
port's module docstring), read as given; ``n_group`` and ``topk_group``
are 1 (the group choice is then the identity and is left out); the rope
is the "default" type with no scaling; the embeddings are given (the
audio tower's output injected), so that the tests can feed what the
engine made. It imports no JAX and nothing of the port.

    logits, routes = forward(text, dec, hidden, positions)

``text``: the text config as a dict; ``dec``: the decoder tree; ``hidden``
(S, H); ``positions`` (S,). Returns float32 logits (S, V) and, per MoE
layer, the chosen expert ids (S, k).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope_tables(t: dict, positions):
    """cos/sin (S, qk_rope_head_dim) of the default rope."""
    d = t["qk_rope_head_dim"]
    inv = 1.0 / t["rope_theta"] ** (torch.arange(0, d, 2,
                                                 dtype=torch.float64) / d)
    ang = positions.double()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], -1)
    return ang.cos().float(), ang.sin().float()


def rope_interleave(x, cos, sin):
    """``apply_rotary_pos_emb_interleave`` on x (S, heads, D)."""
    s, h, d = x.shape
    x = x.view(s, h, d // 2, 2).transpose(3, 2).reshape(s, h, d)
    turned = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos[:, None] + turned * sin[:, None]


def mlp(x, gate_w, up_w, down_w):
    return (F.silu(x @ gate_w.float()) * (x @ up_w.float())) @ down_w.float()


def router(t: dict, x, w, bias):
    """(ids (S, k), weights (S, k)) of ``DeepseekV3TopkRouter``."""
    scores = torch.sigmoid(x @ w.float())
    ids = torch.topk(scores + bias.float(), t["num_experts_per_tok"],
                     dim=-1).indices
    weights = scores.gather(1, ids)
    if t["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return ids, weights * t["routed_scaling_factor"]


def moe(t: dict, m: dict, j: int, x):
    """The MoE block of MoE layer ``j`` on x (S, H): routed experts in a
    loop, then the shared experts. Returns (output, ids)."""
    ids, weights = router(t, x, m["router_w"][j], m["router_bias"][j])
    inter = t["moe_intermediate_size"]
    out = torch.zeros_like(x)
    for e in range(t["n_routed_experts"]):
        tok, slot = torch.where(ids == e)
        if tok.numel() == 0:
            continue
        gu = m["experts_gate_up_w"][j, e].float()
        y = mlp(x[tok], gu[:, :inter], gu[:, inter:],
                m["experts_down_w"][j, e])
        out.index_add_(0, tok, y * weights[tok, slot, None])
    shared = mlp(x, m["shared_gate_w"][j], m["shared_up_w"][j],
                 m["shared_down_w"][j])
    return out + shared, ids


def attention(t: dict, lp: dict, l: int, x, cos, sin):
    """Expanded MLA of layer ``l`` on x (S, H), causal."""
    s = x.shape[0]
    nh, nope, rd, vd, r = (t["num_attention_heads"], t["qk_nope_head_dim"],
                           t["qk_rope_head_dim"], t["v_head_dim"],
                           t["kv_lora_rank"])
    q = (x @ lp["q_w"][l].float()).view(s, nh, nope + rd)
    q_pass, q_rot = q[..., :nope], q[..., nope:]
    ckv = x @ lp["kv_a_w"][l].float()
    c = rms_norm(ckv[:, :r], lp["kv_a_ln_w"][l], 1e-6)  # the module default
    k_rot = ckv[:, None, r:]
    kv = (c @ lp["kv_b_w"][l].float()).view(s, nh, nope + vd)
    k_pass, v = kv[..., :nope], kv[..., nope:]
    q_rot = rope_interleave(q_rot, cos, sin)
    k_rot = rope_interleave(k_rot, cos, sin).expand(s, nh, rd)
    qs = torch.cat([q_pass, q_rot], -1).transpose(0, 1)
    ks = torch.cat([k_pass, k_rot], -1).transpose(0, 1)
    sc = qs @ ks.transpose(1, 2) * (nope + rd) ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    sc = sc.masked_fill(~causal, float("-inf"))
    out = torch.softmax(sc, -1) @ v.transpose(0, 1)
    return out.transpose(0, 1).reshape(s, nh * vd) @ lp["o_w"][l].float()


@torch.no_grad()
def forward(t: dict, dec: dict, hidden, positions):
    """float32 logits (S, V) of the embeddings ``hidden`` (S, H) at
    ``positions``, and each MoE layer's chosen experts (S, k)."""
    eps = t["rms_norm_eps"]
    lp = dec["layers"]
    cos, sin = rope_tables(t, positions)
    h = hidden.float()
    routes = []
    for l in range(t["num_hidden_layers"]):
        x = rms_norm(h, lp["input_ln_w"][l], eps)
        h = h + attention(t, lp, l, x, cos, sin)
        x = rms_norm(h, lp["post_ln_w"][l], eps)
        k = t["first_k_dense_replace"]
        if l < k:
            d = dec["dense"]
            h = h + mlp(x, d["gate_w"][l], d["up_w"][l], d["down_w"][l])
        else:
            y, ids = moe(t, dec["moe"], l - k, x)
            routes.append(ids)
            h = h + y
    h = rms_norm(h, dec["final_ln_w"], eps)
    return h @ dec["lm_head"].float().T, routes
