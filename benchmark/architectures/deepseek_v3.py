"""The ``deepseek_v3`` text decoder (Kimi-VL-A3B's language model): its
weight layout and its work.

Multi-head latent attention (MLA) in every layer; a dense SwiGLU MLP of
``intermediate_size`` below ``first_k_dense_replace``, and past it a
router over ``n_routed_experts`` experts of ``moe_intermediate_size``
(``num_experts_per_tok`` a token) beside ``n_shared_experts`` shared
ones, which together are one SwiGLU of their summed width. The
widths are the published config's keys (transformers'
``DeepseekV3Config``), at the top level of the configuration's file.

The layout is the program's (``qwen3_asr_rs_tpu_torch/models/
deepseek_v3_decoder.py``): linears (in, out); the attention and norms of
every layer under ``layers/``, the dense MLPs under ``dense/``, the MoE
layers' router, experts (stacked, gate and up fused, gate columns
first) and shared experts under ``moe/``, each on a leading layer axis;
an untied ``lm_head`` (V, H). The router's bias is a weight leaf (drawn
like the others), which moves the choice as a trained one does.

Work. A prefill is counted in the expanded form of MLA (``kv_b_proj``
applied to every token's latent, attention over 192-wide keys and
128-wide values); a decode step in the absorbed form that the published
inference runs (the query's nope part taken into the 512-wide latent,
scores against the cached latent and rope key, the output through
``kv_b_proj``'s V half), whatever the program runs. A token's expert
work is its ``num_experts_per_tok`` routed experts; a decode step's
bytes read every weight but the embedding (gathered) and the routed
experts once and, of those, the experts the program's counter says the
step touched
(``stats["experts_touched"][step]``, summed over the MoE layers; none
without the counter), each row's live latent slots of every layer, and
write the fresh ones.
"""

from __future__ import annotations

import math


def text_config(config: dict) -> dict:
    """The decoder's keys: the published ones at the file's top level
    (the catalog's flattened form), with what ``thinker_config.
    text_config`` gives (its ``model_type``) over them, as the
    program's ``AsrConfig.from_dict`` reads them."""
    top = {k: v for k, v in config.items() if k != "thinker_config"}
    return {**top, **config["thinker_config"].get("text_config", {})}



def _dims(t: dict) -> tuple:
    return (t["hidden_size"], t["num_attention_heads"],
            t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"],
            t["kv_lora_rank"])


def decoder_leaves(config: dict) -> dict:
    """{name: (shape, kind)} of the decoder (kind 'w' a weight, 'g' a
    norm gain), per-layer leaves stacked on a leading axis."""
    t = text_config(config)
    h, nh, nope, rd, vd, r = _dims(t)
    v, nl = t["vocab_size"], t["num_hidden_layers"]
    nd = t["first_k_dense_replace"]
    nm = nl - nd
    e, mi = t["n_routed_experts"], t["moe_intermediate_size"]
    si = t["n_shared_experts"] * mi
    di = t["intermediate_size"]
    leaves = {"embed": ((v, h), "w"), "final_ln_w": ((h,), "g"),
              "lm_head": ((v, h), "w")}
    for n, shape, kind in (
            ("input_ln_w", (h,), "g"), ("q_w", (h, nh * (nope + rd)), "w"),
            ("kv_a_w", (h, r + rd), "w"), ("kv_a_ln_w", (r,), "g"),
            ("kv_b_w", (r, nh * (nope + vd)), "w"),
            ("o_w", (nh * vd, h), "w"), ("post_ln_w", (h,), "g")):
        leaves[f"layers/{n}"] = ((nl,) + shape, kind)
    for n, shape in (("gate_w", (h, di)), ("up_w", (h, di)),
                     ("down_w", (di, h))):
        leaves[f"dense/{n}"] = ((nd,) + shape, "w")
    for n, shape in (("router_w", (h, e)), ("router_bias", (e,)),
                     ("experts_gate_up_w", (e, h, 2 * mi)),
                     ("experts_down_w", (e, mi, h)),
                     ("shared_gate_w", (h, si)), ("shared_up_w", (h, si)),
                     ("shared_down_w", (si, h))):
        leaves[f"moe/{n}"] = ((nm,) + shape, "w")
    return leaves


def expert_weights(config: dict) -> int:
    """Weights of one routed expert."""
    t = text_config(config)
    return 3 * t["hidden_size"] * t["moe_intermediate_size"]


def _routed(leaves: dict) -> int:
    return sum(math.prod(s) for k, (s, _) in leaves.items()
               if k.startswith("moe/experts"))


def _per_token(config: dict) -> float:
    """Weights one token multiplies through every layer: the attention's
    projections (kv_b_proj's whole, in either form), its MLP or its
    router, shared experts and ``num_experts_per_tok`` routed experts."""
    t = text_config(config)
    leaves = decoder_leaves(config)
    per_layer = sum(math.prod(s[1:]) for k, (s, kind) in leaves.items()
                    if k.startswith("layers/") and kind == "w")
    nd = t["first_k_dense_replace"]
    dense = sum(math.prod(s[1:]) for k, (s, _) in leaves.items()
                if k.startswith("dense/"))
    unrouted = sum(math.prod(s[1:]) for k, (s, _) in leaves.items()
                   if k.startswith("moe/") and not k.startswith("moe/experts")
                   and k != "moe/router_bias")
    nm = t["num_hidden_layers"] - nd
    return (t["num_hidden_layers"] * per_layer + nd * dense
            + nm * (unrouted + t["num_experts_per_tok"]
                    * expert_weights(config)))


def _attend_ops(t: dict) -> int:
    """Operations per attended position, layer and token of the absorbed
    form: q_lat . c_kv + q_rot . k_rot, then p . c_kv, every head."""
    _, nh, _, rd, _, r = _dims(t)
    return 2 * nh * (2 * r + rd)


def prefill_flops(config: dict, prompt_len: int) -> float:
    """A prompt of ``prompt_len`` real tokens through every layer in the
    expanded form, causal attention over 192-wide keys and 128-wide
    values included, and the lm_head at its last position."""
    t = text_config(config)
    _, nh, nope, rd, vd, _ = _dims(t)
    p = prompt_len
    return (2.0 * p * _per_token(config)
            + t["num_hidden_layers"] * p * (p + 1) * nh * (nope + rd + vd)
            + 2.0 * t["hidden_size"] * t["vocab_size"])


def decode_flops(config: dict, prompt_len: int, n_tokens: int) -> float:
    """The decode steps that made tokens 2..n of a request (the first
    comes from the prefill), in the absorbed form: two operations per
    weight a token multiplies, the lm_head's too, and ``_attend_ops`` per
    attended position and layer."""
    t = text_config(config)
    steps = max(n_tokens - 1, 0)
    per = 2.0 * (_per_token(config) + t["hidden_size"] * t["vocab_size"])
    keys = steps * prompt_len + steps * (steps + 1) / 2
    return steps * per + t["num_hidden_layers"] * _attend_ops(t) * keys


def decode_step_work(config: dict, live: list, weight_bytes: int = 2,
                     kv_bytes: int = 2, stats=None, step: int = 0) -> tuple:
    """(bytes, operations) of one decode step over rows that read
    ``live[b]`` stale latent slots each: every weight but the embedding
    and the routed experts, and the experts the step touched, read once
    (see the module's docstring), each row's live latents of every
    layer, the fresh ones written, the token's embedding in and the
    hidden state out; two
    operations per weight a row multiplies and ``_attend_ops`` per
    attended position (the stale ones and the row's own) and layer."""
    t = text_config(config)
    leaves = decoder_leaves(config)
    touched = (stats or {}).get("experts_touched", [0] * (step + 1))[step]
    # the embedding is gathered (the rows' own, counted below), not read
    weights = (sum(math.prod(s) for k, (s, _) in leaves.items()
                   if k != "embed")
               - _routed(leaves) + touched * expert_weights(config))
    nl, h = t["num_hidden_layers"], t["hidden_size"]
    b = len(live)
    slot = (t["kv_lora_rank"] + t["qk_rope_head_dim"]) * kv_bytes
    nbytes = (weights * weight_bytes + nl * (sum(live) + b) * slot
              + 2 * b * h * weight_bytes)
    ops = (2.0 * b * (_per_token(config) + t["vocab_size"] * h)
           + nl * _attend_ops(t) * (sum(live) + b))
    return nbytes, ops


def expert_work(config: dict, touched: int, rows: int,
                weight_bytes: int = 2) -> tuple:
    """(bytes, operations) of the routed experts alone over ``rows``
    routes that touched ``touched`` (expert, layer) pairs: each touched
    expert's weights read once, each route's input row read, its gated
    activation written and read, its float32 output written; two
    operations per expert weight and route."""
    t = text_config(config)
    h, mi = t["hidden_size"], t["moe_intermediate_size"]
    nbytes = (touched * expert_weights(config) * weight_bytes
              + rows * (h * weight_bytes + 2 * mi * weight_bytes + 4 * h))
    return nbytes, 2.0 * rows * expert_weights(config)
