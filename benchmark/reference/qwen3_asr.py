"""Qwen3-ASR in plain float32 PyTorch: the reference that decides
``correct``.

It follows the published model (Whisper-style log-mel, the chunked audio
encoder, the chat prompt with the audio injected after the ninth token,
the Qwen3 decoder with per-head QK RMSNorm, MRoPE and SwiGLU) and knows
nothing of the program: no kernels, no KV cache, no batching, no
buckets, no padding. It reads the configuration file and the weight
tensors that the benchmark made, computes every product in float32 with
TF32 off, and runs long inputs in blocks. Departures from a real
checkpoint: none in the mathematics; the weights are random.

    ref = Reference(config, enc, dec, "cuda")
    logits = ref.continuation_logits(samples, tokens)  # (n + 1, V)

Row i of ``logits`` is the distribution of the token after the prompt and
``tokens[:i]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
AUDIO_OFFSET = 9  # audio pads start after the nine header tokens
QUERY_BLOCK = 512  # decoder queries per attention block


def _use_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1e-30) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f < 1000.0, mel, log)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3.0)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m < 15.0, lin, log)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-normalized triangular mel filters (n_mels, N_FFT // 2 + 1)
    over 0 .. 8 kHz, built in float64 (Whisper's / librosa's)."""
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2),
                                 n_mels + 2))
    freqs = np.arange(N_FFT // 2 + 1) * SAMPLE_RATE / N_FFT
    lo, mid, hi = pts[:-2, None], pts[1:-1, None], pts[2:, None]
    tri = np.maximum(0.0, np.minimum((freqs - lo) / (mid - lo),
                                     (hi - freqs) / (hi - mid)))
    return tri * (2.0 / (pts[2:] - pts[:-2]))[:, None]


def sinusoids(length: int, dim: int) -> np.ndarray:
    """Whisper's position table: sin in the first half, cos in the
    second, timescales from 1 to 10000."""
    half = dim // 2
    inv = np.exp(-np.arange(half) * (np.log(10000.0) / (half - 1)))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], 1)


def _layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps=1e-5)


def _rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rotate(x, cos, sin):
    """Rotate-half RoPE on (S, heads, D) with cos/sin (S, D)."""
    half = x.shape[-1] // 2
    turned = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos[:, None] + turned * sin[:, None]


def _fp8(x, dim: int):
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the largest magnitude to 448), back in float32."""
    scale = x.abs().amax(dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The model of one configuration file over one set of weights.

    ``matmul="fp8"`` computes every product with a weight from float8
    e4m3 operands (activations scaled per row, weights per output
    column, float32 sums): the control's precision, one step below the
    configurations' bf16; the convolutions and attention stay float32."""

    def __init__(self, config: dict, enc: dict, dec: dict, device,
                 matmul: str = "float32"):
        _use_float32()
        if matmul not in ("float32", "fp8"):
            raise ValueError(f"unknown matmul precision {matmul!r}")
        self.fp8 = matmul == "fp8"
        tc = config["thinker_config"]
        self.a, self.t = tc["audio_config"], tc["text_config"]
        self.ids = tc
        self.prompt_ids = config["prompt"]
        self.enc, self.dec = enc, dec
        self.device = torch.device(device)
        self.filters = torch.tensor(mel_filters(self.a["num_mel_bins"]),
                                    dtype=torch.float32, device=self.device)

    def _mm(self, x, w):
        """x @ w for a weight ``w`` (in, out) as stored, in float32."""
        w = w.float()
        if self.fp8:
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    # ------------------------------------------------------------ audio

    def log_mel(self, samples: np.ndarray) -> torch.Tensor:
        """(n_mels, frames) normalized log-mel of 16 kHz samples: the
        signal zero-padded to whole hops, reflected by N_FFT / 2 at both
        ends, one frame per hop; floor at the maximum minus 8, then
        (x + 4) / 4."""
        x = torch.as_tensor(np.asarray(samples, np.float32),
                            device=self.device)
        frames = -(-x.numel() // HOP)
        wave = F.pad(x, (0, frames * HOP - x.numel()))
        wave = F.pad(wave[None, None], (N_FFT // 2, N_FFT // 2),
                     mode="reflect")[0, 0]
        window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64,
                                   device=self.device).float()
        spec = torch.stft(wave, N_FFT, HOP, window=window, center=False,
                          return_complex=True)[:, :frames]
        mel = self.filters @ (spec.real ** 2 + spec.imag ** 2)
        log = torch.log10(torch.clamp(mel, min=1e-10))
        log = torch.maximum(log, log.max() - 8.0)
        return (log + 4.0) / 4.0

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(valid tokens, output_dim) audio embeddings of a log-mel: the
        frames cut into chunks of 2 n_window (the last zero-padded), a
        conv stem per chunk, the chunk's own positions, then windows of
        n_window_infer frames attending within themselves."""
        a, p = self.a, self.enc
        cf = 2 * a["n_window"]
        n = mel.shape[1]
        chunks = -(-n // cf)
        x = F.pad(mel, (0, chunks * cf - n))
        x = x.reshape(mel.shape[0], chunks, cf).permute(1, 0, 2)[:, None]
        for i in (1, 2, 3):
            x = F.gelu(F.conv2d(x, p[f"conv{i}_w"].float(),
                                p[f"conv{i}_b"].float(), stride=2, padding=1))
        c, ch, fr, t = x.shape
        x = x.permute(0, 3, 1, 2).reshape(c, t, ch * fr)
        x = self._mm(x, p["conv_out_w"]) + p["conv_out_b"].float()
        pos = torch.tensor(sinusoids(t, a["d_model"]), dtype=torch.float32,
                           device=self.device)
        x = (x + pos).reshape(c * t, -1)
        tail = n % cf
        for _ in range(3):
            tail = (tail - 1) // 2 + 1 if tail else 0
        x = x[: (n // cf) * t + tail]  # the valid tokens
        win = (a["n_window_infer"] // cf) * t
        out = []
        for w0 in range(0, x.shape[0], win):
            h = x[w0: w0 + win]
            for l in range(a["encoder_layers"]):
                h = self._encoder_layer(h, l)
            out.append(h)
        h = _layer_norm(torch.cat(out), p["ln_post_w"], p["ln_post_b"])
        h = F.gelu(self._mm(h, p["proj1_w"]) + p["proj1_b"].float())
        return self._mm(h, p["proj2_w"]) + p["proj2_b"].float()

    def _encoder_layer(self, x, l: int):
        a, p = self.a, self.enc["layers"]
        heads = a["encoder_attention_heads"]
        hd = a["d_model"] // heads

        def lin(name, y):
            return self._mm(y, p[f"{name}_w"][l]) + p[f"{name}_b"][l].float()

        h = _layer_norm(x, p["attn_ln_w"][l], p["attn_ln_b"][l])
        q, k, v = (lin(n, h).reshape(-1, heads, hd).transpose(0, 1)
                   for n in ("q", "k", "v"))
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), -1) @ v
        x = x + lin("out", att.transpose(0, 1).reshape(x.shape))
        h = _layer_norm(x, p["ffn_ln_w"][l], p["ffn_ln_b"][l])
        return x + lin("fc2", F.gelu(lin("fc1", h)))

    # ----------------------------------------------------------- prompt

    def prompt(self, n_audio: int) -> list:
        """The chat prompt (system, user with the audio, assistant), the
        language left to the model."""
        pr = self.prompt_ids
        return (pr["header"] + [self.ids["audio_token_id"]] * n_audio
                + pr["tail"])

    # ---------------------------------------------------------- decoder

    def _rope(self, n: int):
        """cos/sin (n, head_dim) of MRoPE at positions 0..n-1 on all
        three position rows (text and audio alike), each frequency taking
        its row from the contiguous section map; the rows are equal, so
        an interleaved map would give the same."""
        t = self.t
        d = t["head_dim"]
        sections = t["rope_scaling"]["mrope_section"]
        inv = 1.0 / t["rope_theta"] ** (np.arange(0, d, 2) / d)
        rows = np.repeat(np.arange(3), sections)[: d // 2]
        pos3 = np.stack([np.arange(n)] * 3)  # (3, n)
        ang = pos3[rows].T * inv[None, :]     # (n, d / 2)
        ang = np.concatenate([ang, ang], 1)
        return (torch.tensor(np.cos(ang), dtype=torch.float32,
                             device=self.device),
                torch.tensor(np.sin(ang), dtype=torch.float32,
                             device=self.device))

    def _decoder_layer(self, h, l: int, cos, sin):
        t, p = self.t, self.dec["layers"]
        nq, nkv, d = (t["num_attention_heads"], t["num_key_value_heads"],
                      t["head_dim"])
        eps = t["rms_norm_eps"]
        s = h.shape[0]
        x = _rms_norm(h, p["input_ln_w"][l], eps)
        q = self._mm(x, p["q_w"][l]).reshape(s, nq, d)
        k = self._mm(x, p["k_w"][l]).reshape(s, nkv, d)
        v = self._mm(x, p["v_w"][l]).reshape(s, nkv, d)
        q = _rotate(_rms_norm(q, p["q_norm_w"][l], eps), cos, sin)
        k = _rotate(_rms_norm(k, p["k_norm_w"][l], eps), cos, sin)
        k = k.repeat_interleave(nq // nkv, 1).transpose(0, 1)  # (nq, S, d)
        v = v.repeat_interleave(nq // nkv, 1).transpose(0, 1)
        q = q.transpose(0, 1)
        att = torch.empty_like(q)
        for i0 in range(0, s, QUERY_BLOCK):
            i1 = min(i0 + QUERY_BLOCK, s)
            sc = q[:, i0:i1] @ k[:, :i1].transpose(1, 2) / math.sqrt(d)
            keep = (torch.arange(i1, device=h.device)[None, :]
                    <= torch.arange(i0, i1, device=h.device)[:, None])
            sc = sc.masked_fill(~keep, float("-inf"))
            att[:, i0:i1] = torch.softmax(sc, -1) @ v[:, :i1]
        h = h + self._mm(att.transpose(0, 1).reshape(s, nq * d), p["o_w"][l])
        x = _rms_norm(h, p["post_ln_w"][l], eps)
        up = F.silu(self._mm(x, p["gate_w"][l])) * self._mm(x, p["up_w"][l])
        return h + self._mm(up, p["down_w"][l])

    @torch.no_grad()
    def continuation_logits(self, samples: np.ndarray, tokens) -> torch.Tensor:
        """float32 logits (len(tokens) + 1, V) of the prompt of ``samples``
        followed by ``tokens``: row i after tokens[:i]."""
        audio = self.encode(self.log_mel(samples))
        ids = self.prompt(audio.shape[0]) + [int(x) for x in tokens]
        h = self.dec["embed"][torch.tensor(ids, device=self.device)].float()
        h[AUDIO_OFFSET: AUDIO_OFFSET + audio.shape[0]] = audio
        cos, sin = self._rope(len(ids))
        for l in range(self.t["num_hidden_layers"]):
            h = self._decoder_layer(h, l, cos, sin)
        last = h[len(ids) - len(tokens) - 1:]
        last = _rms_norm(last, self.dec["final_ln_w"], self.t["rms_norm_eps"])
        return self._mm(last, self.dec["lm_head"].T)
