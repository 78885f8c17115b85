"""A toy decoder architecture, a fixture of the harness's tests only: the
tests copy it into a copy of the benchmark as
``architectures/toy_moe.py`` and show that a configuration naming it
joins as files alone. No configuration of the benchmark names it and no
run executes it; its equations are no model's.

Two kinds of layer, in the order of ``layer_types``: a linear-attention
mixer (an input projection, a short causal conv, an output projection)
and full attention (GQA). Every layer then has a routed expert block
with a shared expert. This chip holds ``num_experts`` of the
``deployment``'s ``num_experts``, one share of an expert-parallel
deployment; the router keeps the published width and routes each token
to ``num_experts_per_tok`` of them, so a token's expected expert work
here is that many times the held share.
"""

from __future__ import annotations

import math

KINDS = ("linear_attention", "full_attention")


def _text(config: dict) -> dict:
    return config["thinker_config"]["text_config"]


def _mixer_leaves(t: dict) -> dict:
    h, d = t["hidden_size"], t["head_dim"]
    nq, nkv, k = (t["num_attention_heads"], t["num_key_value_heads"],
                  t["linear_conv_kernel_dim"])
    return {"linear_attention": {"in_w": (h, 3 * h), "conv_w": (k, 3 * h),
                                 "out_w": (h, h)},
            "full_attention": {"q_w": (h, nq * d), "k_w": (h, nkv * d),
                               "v_w": (h, nkv * d), "o_w": (nq * d, h)}}


def _moe_leaves(config: dict) -> dict:
    t = _text(config)
    h, mi, si = (t["hidden_size"], t["moe_intermediate_size"],
                 t["shared_expert_intermediate_size"])
    held, published = t["num_experts"], config["deployment"]["num_experts"]
    return {"router_w": (h, published), "experts_gate_up_w": (held, h, 2 * mi),
            "experts_down_w": (held, mi, h), "shared_gate_up_w": (h, 2 * si),
            "shared_down_w": (si, h), "shared_gate_w": (h, 1)}


def decoder_leaves(config: dict) -> dict:
    t = _text(config)
    h, v, kinds = t["hidden_size"], t["vocab_size"], t["layer_types"]
    leaves = {"embed": ((v, h), "w"), "final_ln_w": ((h,), "g")}
    mixers = _mixer_leaves(t)
    for kind in KINDS:
        n = kinds.count(kind)
        leaves[f"{kind}/input_ln_w"] = ((n, h), "g")
        for name, shape in mixers[kind].items():
            leaves[f"{kind}/{name}"] = ((n,) + shape, "w")
        leaves[f"{kind}/post_ln_w"] = ((n, h), "g")
    for name, shape in _moe_leaves(config).items():
        leaves[f"moe/{name}"] = ((len(kinds),) + shape, "w")
    return leaves


def expert_weights(config: dict) -> int:
    """Weights of one routed expert."""
    t = _text(config)
    return 3 * t["hidden_size"] * t["moe_intermediate_size"]


def _per_token(config: dict) -> float:
    """Weights that one token multiplies through every layer: its
    mixer, the router, the shared expert and its expected share of the
    held experts."""
    t = _text(config)
    mixers, moe = _mixer_leaves(t), _moe_leaves(config)
    routed = (t["num_experts_per_tok"] * t["num_experts"]
              / config["deployment"]["num_experts"])
    unrouted = sum(math.prod(s) for k, s in moe.items()
                   if not k.startswith("experts"))
    return sum(sum(math.prod(s) for s in mixers[k].values()) + unrouted
               + routed * expert_weights(config) for k in t["layer_types"])


def prefill_flops(config: dict, prompt_len: int) -> float:
    t = _text(config)
    full = t["layer_types"].count("full_attention")
    qd = t["num_attention_heads"] * t["head_dim"]
    p = prompt_len
    return (2.0 * p * _per_token(config) + 2.0 * full * p * (p + 1) * qd
            + 2.0 * t["hidden_size"] * t["vocab_size"])


def decode_flops(config: dict, prompt_len: int, n_tokens: int) -> float:
    t = _text(config)
    full = t["layer_types"].count("full_attention")
    qd = t["num_attention_heads"] * t["head_dim"]
    steps = max(n_tokens - 1, 0)
    keys = steps * prompt_len + steps * (steps + 1) / 2
    return (steps * 2.0 * (_per_token(config)
                           + t["hidden_size"] * t["vocab_size"])
            + 4.0 * full * qd * keys)


def decode_step_work(config: dict, live: list, weight_bytes: int = 2,
                     kv_bytes: int = 2, stats=None, step: int = 0) -> tuple:
    """(bytes, operations) of one decode step: every weight but the
    routed experts, plus the experts that the program's counter says the
    step read (``stats["experts_touched"][step]``, over all layers); with
    no counter none, so that the bound never counts an expert the step
    did not read."""
    t = _text(config)
    h, d, nkv = t["hidden_size"], t["head_dim"], t["num_key_value_heads"]
    full = t["layer_types"].count("full_attention")
    leaves = decoder_leaves(config)
    routed = sum(math.prod(s) for k, (s, _) in leaves.items()
                 if k.startswith("moe/experts"))
    touched = (stats or {}).get("experts_touched", [0] * (step + 1))[step]
    # the (tied) embedding is read whole as the lm_head
    weights = (sum(math.prod(s) for s, _ in leaves.values()) - routed
               + touched * expert_weights(config))
    b = len(live)
    slot = 2 * nkv * d * kv_bytes
    nbytes = (weights * weight_bytes + full * (sum(live) + b) * slot
              + 2 * b * h * weight_bytes)
    ops = 2.0 * b * (_per_token(config) + t["vocab_size"] * h) + 4.0 * full * (
        t["num_attention_heads"] * d) * (sum(live) + b)
    return nbytes, ops
