"""Qwen3-ASR's dense text decoder: its weight layout and its work.

Every layer alike: GQA attention with a per-head QK RMSNorm and MRoPE,
then a SwiGLU MLP of one ``intermediate_size``. A configuration that
names no ``architecture`` is this one.

An architecture module exports what the harness asks of a decoder:

    decoder_leaves(config)             {name: (shape, kind)} of its weights
    prefill_flops(config, prompt_len)  one prompt's prefill
    decode_flops(config, prompt_len, n_tokens)  a request's decode steps
    decode_step_work(config, live, weight_bytes, kv_bytes, stats, step)
                                       (bytes, operations) of one step

``stats`` is the program's ``last_stats`` of the call the step belongs
to, and ``step`` its index in the call, so that an architecture whose
work depends on what the program did (the experts a step touched) can
count it from the program's counters. This one ignores both.
"""

from __future__ import annotations


def _text(config: dict) -> dict:
    return config["thinker_config"]["text_config"]


def decoder_leaves(config: dict) -> dict:
    """{name: (shape, kind)} of the text decoder (kind 'w' a weight,
    'g' a norm gain; per-layer leaves under 'layers/', stacked on a
    leading axis); a tied lm_head is not a leaf of its own."""
    t = _text(config)
    h, d, inter = t["hidden_size"], t["head_dim"], t["intermediate_size"]
    nq, nkv = t["num_attention_heads"], t["num_key_value_heads"]
    v, nl = t["vocab_size"], t["num_hidden_layers"]
    leaves = {"embed": ((v, h), "w"), "final_ln_w": ((h,), "g")}
    if not t.get("tie_word_embeddings", True):
        leaves["lm_head"] = ((v, h), "w")
    for n, shape, kind in (
            ("input_ln_w", (h,), "g"), ("q_w", (h, nq * d), "w"),
            ("k_w", (h, nkv * d), "w"), ("v_w", (h, nkv * d), "w"),
            ("o_w", (nq * d, h), "w"), ("q_norm_w", (d,), "g"),
            ("k_norm_w", (d,), "g"), ("post_ln_w", (h,), "g"),
            ("gate_w", (h, inter), "w"), ("up_w", (h, inter), "w"),
            ("down_w", (inter, h), "w")):
        leaves[f"layers/{n}"] = ((nl,) + shape, kind)
    return leaves


def layer_weights(t: dict) -> int:
    """Weights of one decoder layer's seven products."""
    h, d, inter = t["hidden_size"], t["head_dim"], t["intermediate_size"]
    nq, nkv = t["num_attention_heads"], t["num_key_value_heads"]
    return h * (nq + 2 * nkv) * d + nq * d * h + 3 * h * inter


def layer_norm_weights(t: dict) -> int:
    """Norm gains of one decoder layer: two RMSNorms and the QK norms."""
    return 2 * t["hidden_size"] + 2 * t["head_dim"]


def prefill_flops(config: dict, prompt_len: int) -> float:
    """A prompt of ``prompt_len`` real tokens through every layer, causal
    attention included, and the lm_head at its last position."""
    t = _text(config)
    nl, qd = t["num_hidden_layers"], t["num_attention_heads"] * t["head_dim"]
    p = prompt_len
    return (2.0 * p * nl * layer_weights(t) + 2.0 * nl * p * (p + 1) * qd
            + 2.0 * t["hidden_size"] * t["vocab_size"])


def decode_flops(config: dict, prompt_len: int, n_tokens: int) -> float:
    """The decode steps that made tokens 2..n of a request (the first
    comes from the prefill): two operations per weight, the lm_head's
    too, and four per attended position, query head and dimension."""
    t = _text(config)
    nl, qd = t["num_hidden_layers"], t["num_attention_heads"] * t["head_dim"]
    steps = max(n_tokens - 1, 0)
    per = 2.0 * (nl * layer_weights(t) + t["hidden_size"] * t["vocab_size"])
    # step j (1..steps) attends prompt_len + j positions
    keys = steps * prompt_len + steps * (steps + 1) / 2
    return steps * per + 4.0 * nl * qd * keys


def decode_step_work(config: dict, live: list, weight_bytes: int = 2,
                     kv_bytes: int = 2, stats=None, step: int = 0) -> tuple:
    """(bytes, operations) of one decode step over rows that read
    ``live[b]`` stale slab slots each (rows that are done are left out):
    every decoder weight, norm and the lm_head read once, each row's
    live K/V of every layer, the fresh K/V written, the token's
    embedding in and the hidden state out; two operations per weight and
    row, four per attended position (the stale ones and the row's own),
    query head and dimension. Every step of a dense decoder reads every
    weight, so ``stats`` and ``step`` change nothing."""
    t = _text(config)
    nl, h, d = t["num_hidden_layers"], t["hidden_size"], t["head_dim"]
    nkv, qd = t["num_key_value_heads"], t["num_attention_heads"] * d
    b = len(live)
    lm = t["vocab_size"] * h
    weights = nl * (layer_weights(t) + layer_norm_weights(t)) + h + lm
    slot = 2 * nkv * d * kv_bytes
    nbytes = (weights * weight_bytes + nl * sum(live) * slot
              + nl * b * slot + 2 * b * h * weight_bytes)
    ops = 2.0 * b * (nl * layer_weights(t) + lm) + 4.0 * nl * qd * (
        sum(live) + b)
    return nbytes, ops
