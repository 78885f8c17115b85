"""The yardstick: the chip's peaks, and the operations and bytes that the
real work of a window needs, worked out from the shapes alone.

What is counted does not depend on which kernel does the work, so a
change of kernel cannot leave it stale: the model's operations on real
audio and real prompts (padding, born-done rows and steps past a row's
end are not work), and for a decode step the least bytes it has to move.
The arithmetic of ``bound_s`` and ``decode_step_work`` follows
``chip_smoke.py``'s ``bound_of`` and ``k1_work``, extended to the whole
step (the lm_head included).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the HBM rate and the operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)


def _text(config: dict) -> dict:
    return config["thinker_config"]["text_config"]


def _audio(config: dict) -> dict:
    return config["thinker_config"]["audio_config"]


def layer_weights(t: dict) -> int:
    """Weights of one decoder layer's seven products."""
    h, d, inter = t["hidden_size"], t["head_dim"], t["intermediate_size"]
    nq, nkv = t["num_attention_heads"], t["num_key_value_heads"]
    return h * (nq + 2 * nkv) * d + nq * d * h + 3 * h * inter


def _layer_norm_weights(t: dict) -> int:
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


def _stem_dims(a: dict) -> list:
    """(channels in, channels out, freq out, time out) of the 3 convs."""
    f, t = a["num_mel_bins"], 2 * a["n_window"]
    dh, dims, cin = a["downsample_hidden_size"], [], 1
    for _ in range(3):
        f, t = (f - 1) // 2 + 1, (t - 1) // 2 + 1
        dims.append((cin, dh, f, t))
        cin = dh
    return dims


def encoder_flops(config: dict, n_true_frames: int) -> float:
    """The audio encoder over one clip's real chunks: the conv stem and
    conv_out on each chunk that holds audio, the layers and the head on
    the valid tokens, attention within each window over its valid
    tokens only."""
    a = _audio(config)
    cf, d, ff = 2 * a["n_window"], a["d_model"], a["encoder_ffn_dim"]
    dims = _stem_dims(a)
    tpc = dims[-1][3]
    chunks = -(-n_true_frames // cf)
    stem = sum(2.0 * ci * co * 9 * f * t for ci, co, f, t in dims)
    stem += 2.0 * tpc * (dims[-1][1] * dims[-1][2]) * d
    n_valid = audio_tokens(config, n_true_frames * 160)[1]
    win = (a["n_window_infer"] // cf) * tpc
    windows = [min(win, n_valid - w) for w in range(0, n_valid, win)]
    per_layer = (2.0 * n_valid * (4 * d * d + 2 * d * ff)
                 + 4.0 * d * sum(w * w for w in windows))
    head = 2.0 * n_valid * (d * d + d * a["output_dim"])
    return chunks * stem + a["encoder_layers"] * per_layer + head


def request_flops(config: dict, n_true_frames: int, prompt_len: int,
                  n_tokens: int) -> float:
    """One transcription's real work: encoder, prefill and decode."""
    return (encoder_flops(config, n_true_frames)
            + prefill_flops(config, prompt_len)
            + decode_flops(config, prompt_len, n_tokens))


def decode_step_work(config: dict, live: list, weight_bytes: int = 2,
                     kv_bytes: int = 2) -> tuple:
    """(bytes, operations) of one decode step over rows that read
    ``live[b]`` stale slab slots each (rows that are done are left out):
    every decoder weight, norm and the lm_head read once, each row's
    live K/V of every layer, the fresh K/V written, the token's
    embedding in and the hidden state out; two operations per weight and
    row, four per attended position (the stale ones and the row's own),
    query head and dimension."""
    t = _text(config)
    nl, h, d = t["num_hidden_layers"], t["hidden_size"], t["head_dim"]
    nkv, qd = t["num_key_value_heads"], t["num_attention_heads"] * d
    b = len(live)
    lm = t["vocab_size"] * h
    weights = nl * (layer_weights(t) + _layer_norm_weights(t)) + h + lm
    slot = 2 * nkv * d * kv_bytes
    nbytes = (weights * weight_bytes + nl * sum(live) * slot
              + nl * b * slot + 2 * b * h * weight_bytes)
    ops = 2.0 * b * (nl * layer_weights(t) + lm) + 4.0 * nl * qd * (
        sum(live) + b)
    return nbytes, ops



def audio_tokens(config: dict, n_samples: int) -> tuple:
    """(true mel frames, audio tokens) of a clip of ``n_samples``: one
    frame per hop of 160 samples, tokens_per_chunk per whole chunk and
    the stem's output of a partial one."""
    a = _audio(config)
    cf = 2 * a["n_window"]
    frames = -(-n_samples // 160)
    tpc = _stem_dims(a)[-1][3]
    tail = frames % cf
    for _ in range(3):
        tail = (tail - 1) // 2 + 1 if tail > 0 else 0
    return frames, (frames // cf) * tpc + tail


def prompt_len(config: dict, n_samples: int) -> int:
    """Real tokens of a clip's prompt: header, audio, tail."""
    p = config["prompt"]
    return len(p["header"]) + audio_tokens(config, n_samples)[1] + len(
        p["tail"])
