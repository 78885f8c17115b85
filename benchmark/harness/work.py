"""The yardstick: the chip's peaks, and the operations and bytes that the
real work of a window needs, worked out from the shapes alone.

What is counted does not depend on which kernel does the work, so a
change of kernel cannot leave it stale: the model's operations on real
audio and real prompts (padding, born-done rows and steps past a row's
end are not work), and for a decode step the least bytes it has to move.
The audio tower's work is here, since every configuration runs
Qwen3-ASR's; the decoder's is its architecture's
(``architectures/<architecture>.py``), to which ``prefill_flops``,
``decode_flops``, ``request_flops`` and ``decode_step_work`` dispatch.
The arithmetic of ``bound_s`` and the dense ``decode_step_work`` follows
``chip_smoke.py``'s ``bound_of`` and ``k1_work``, extended to the whole
step (the lm_head included).
"""

from __future__ import annotations

from pathlib import Path

from .spec import BENCH_DIR, architecture

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the HBM rate and the operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)


def _audio(config: dict) -> dict:
    return config["thinker_config"]["audio_config"]


def layer_weights(t: dict) -> int:
    """Weights of one layer of the default architecture's decoder
    (``architectures/qwen3_asr.py``); a text config names no
    architecture."""
    return architecture({}).layer_weights(t)


def prefill_flops(config: dict, prompt_len: int,
                  bench_dir: Path = BENCH_DIR) -> float:
    """A prompt of ``prompt_len`` real tokens through the decoder, by the
    configuration's architecture."""
    return architecture(config, bench_dir).prefill_flops(config, prompt_len)


def decode_flops(config: dict, prompt_len: int, n_tokens: int,
                 bench_dir: Path = BENCH_DIR) -> float:
    """The decode steps that made tokens 2..n of a request, by the
    configuration's architecture."""
    return architecture(config, bench_dir).decode_flops(
        config, prompt_len, n_tokens)


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
                  n_tokens: int, bench_dir: Path = BENCH_DIR) -> float:
    """One transcription's real work: encoder, prefill and decode."""
    arch = architecture(config, bench_dir)
    return (encoder_flops(config, n_true_frames)
            + arch.prefill_flops(config, prompt_len)
            + arch.decode_flops(config, prompt_len, n_tokens))


def decode_step_work(config: dict, live: list, weight_bytes: int = 2,
                     kv_bytes: int = 2, stats=None, step: int = 0,
                     bench_dir: Path = BENCH_DIR) -> tuple:
    """(bytes, operations) of one decode step over rows that read
    ``live[b]`` stale slab slots each, by the configuration's
    architecture; ``stats``: the program's ``last_stats`` of the call,
    ``step``: the step's index in it."""
    return architecture(config, bench_dir).decode_step_work(
        config, live, weight_bytes, kv_bytes, stats, step)


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
