"""Whisper-style log-mel frontend in PyTorch.

Port of ``qwen3_asr_rs_tpu/features/mel.py``: zero-pad to a hop
multiple, reflect-pad ``n_fft // 2`` at the TRUE boundary (host numpy,
``pad_waveform``), frame with hop 160, windowed real DFT as two matmuls
against f64-built constants, ``|X|^2``, Slaney mel projection,
``log10(max(., 1e-10))``, floor at ``max - 8`` over the true frames only,
``(x + 4) / 4``, and padded frames forced to exactly 0.0.
``log_mel_from_padded`` takes one padded waveform or a batch of them.

The host constants (filterbank, Hann window, DFT matrices) and
``pad_waveform`` are numpy copies of the JAX module's.
"""

from __future__ import annotations

import numpy as np
import torch


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above (src/mel.rs:131-137)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f < min_log_hz,
        f / f_sp,
        min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep,
    )


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    """Inverse Slaney mel scale (src/mel.rs:139-145)."""
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m < min_log_mel,
        f_sp * m,
        min_log_hz * np.exp(logstep * (m - min_log_mel)),
    )


def create_mel_filterbank(
    num_mels: int = 128,
    n_fft: int = 400,
    sample_rate: int = 16000,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular Slaney-normalized mel filterbank, (num_mels, n_fft//2+1),
    built in float64 and returned float32 (src/mel.rs:115-187)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1

    mel_min = hz_to_mel_slaney(np.array(fmin))
    mel_max = hz_to_mel_slaney(np.array(fmax))
    mel_pts = mel_min + (mel_max - mel_min) * np.arange(num_mels + 2) / (num_mels + 1)
    filter_freqs = mel_to_hz_slaney(mel_pts)  # (num_mels + 2,)

    all_freqs = np.arange(n_freqs, dtype=np.float64) * sample_rate / n_fft
    f_diff = np.diff(filter_freqs)  # (num_mels + 1,)

    down = (all_freqs[None, :] - filter_freqs[:-2, None]) / f_diff[:-1, None]
    up = (filter_freqs[2:, None] - all_freqs[None, :]) / f_diff[1:, None]
    filters = np.maximum(0.0, np.minimum(down, up))

    enorm = 2.0 / (filter_freqs[2:] - filter_freqs[:-2])
    filters = filters * enorm[:, None]
    return filters.astype(np.float32)


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window default)."""
    return (
        0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft))
    ).astype(np.float32)


def dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real DFT as two matmul constants, cos and -sin, (n_fft, n_fft//2+1);
    built in float64, stored float32."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def num_mel_frames(num_samples: int, hop_length: int = 160) -> int:
    """Mel frame count for a raw sample count: ceil(num_samples / hop)."""
    return -(-num_samples // hop_length)


def pad_waveform(samples: np.ndarray, n_fft: int = 400, hop_length: int = 160,
                 bucket_frames: int | None = None) -> tuple[np.ndarray, int]:
    """Host-side waveform prep: hop-multiple zero pad + reflect pad.

    Returns ``(padded, n_true_frames)`` where ``padded`` has length
    ``bucket_frames * hop + 2 * (n_fft // 2)``. The reflect padding is
    applied at the *true* boundary (before any bucket padding).
    """
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    n_true_frames = num_mel_frames(len(samples), hop_length)
    hop_len = n_true_frames * hop_length
    wave = np.zeros(hop_len, dtype=np.float32)
    wave[: len(samples)] = samples
    pad = n_fft // 2
    wave = np.pad(wave, (pad, pad), mode="reflect")
    if bucket_frames is not None:
        if bucket_frames < n_true_frames:
            raise ValueError(
                f"bucket_frames={bucket_frames} < true frames {n_true_frames}"
            )
        total = bucket_frames * hop_length + 2 * pad
        wave = np.pad(wave, (0, total - len(wave)))
    return wave, n_true_frames


def _windowed_dft(n_fft: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    # the Hann window folds into the host constants, in float32 as in JAX
    cos_m, sin_m = dft_matrices(n_fft)
    window = hann_window(n_fft)[:, None]
    return (torch.from_numpy(cos_m * window).to(device),
            torch.from_numpy(sin_m * window).to(device))


def _raw_log_mel(wave, n_true_frames, mel_filters,
                 n_fft: int, hop_length: int):
    """log10 mel power before normalization; returns (log_mel (..., mels,
    frames), frame_valid (..., frames)).

    ``wave`` ((L,) or (B, L) f32 tensor) already carries the reflect
    padding from ``pad_waveform``; its length sets the frame count.
    ``n_true_frames``: an int, or a (B,) integer tensor for a (B, L) wave.
    """
    pad = n_fft // 2
    num_frames = (wave.shape[-1] - 2 * pad) // hop_length
    frames = wave.float().unfold(-1, n_fft, hop_length)[..., :num_frames, :]
    wcos, wsin = _windowed_dft(n_fft, wave.device)
    re = frames @ wcos
    im = frames @ wsin
    power = re * re + im * im  # (..., num_frames, n_freqs)
    mel = mel_filters @ power.transpose(-1, -2)  # (..., mels, frames)
    if isinstance(n_true_frames, torch.Tensor):
        n_true_frames = n_true_frames[..., None]
    frame_valid = torch.arange(num_frames, device=wave.device) < n_true_frames
    log_mel = torch.log10(torch.clamp(mel, min=1e-10))
    return log_mel, frame_valid


def raw_log_mel_max(wave, n_true_frames: int, mel_filters,
                    n_fft: int = 400, hop_length: int = 160):
    """Max of log10 mel power over the true frames (a 0-d tensor)."""
    log_mel, frame_valid = _raw_log_mel(
        wave, n_true_frames, mel_filters, n_fft, hop_length
    )
    return torch.where(frame_valid[None, :], log_mel, -torch.inf).max()


def log_mel_from_padded(wave, n_true_frames, mel_filters,
                        n_fft: int = 400, hop_length: int = 160,
                        log_max=None):
    """Normalized log-mel (mels, frames) from a ``pad_waveform`` output,
    or (B, mels, frames) from B of them stacked into a (B, L) ``wave``
    with a (B,) integer tensor of true frame counts (JAX's ``vmap`` of
    the 1-D form: each row as the 1-D form gives it).

    With ``log_max`` None the Whisper floor uses the max over each
    waveform's own true frames (src/mel.rs:88-92); a caller may pass a
    running max instead.
    """
    log_mel, frame_valid = _raw_log_mel(
        wave, n_true_frames, mel_filters, n_fft, hop_length
    )
    frame_valid = frame_valid[..., None, :]
    if log_max is None:
        log_max = torch.where(frame_valid, log_mel, -torch.inf).amax(
            (-2, -1), keepdim=True)
    log_mel = torch.maximum(log_mel, log_max - 8.0)
    log_mel = (log_mel + 4.0) / 4.0
    return torch.where(frame_valid, log_mel, 0.0)


class LogMelFrontend:
    """Log-mel extractor over bucketed waveforms (JAX ``LogMelFrontend``):
    the host ``pad_waveform``, then ``log_mel_from_padded`` on ``device``."""

    def __init__(
        self,
        n_fft: int = 400,
        hop_length: int = 160,
        num_mel_bins: int = 128,
        sample_rate: int = 16000,
        device: str | torch.device = "cuda",
    ):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.num_mel_bins = num_mel_bins
        self.sample_rate = sample_rate
        self.device = torch.device(device)
        self.mel_filters = torch.from_numpy(
            create_mel_filterbank(num_mel_bins, n_fft, sample_rate)
        ).to(self.device)

    def __call__(self, samples: np.ndarray, bucket_frames: int | None = None):
        """``(mel, n_true_frames)``: ``mel`` (num_mel_bins, bucket_frames)
        float32 on the frontend's device, frames at index >=
        ``n_true_frames`` exactly 0.0. ``samples``: 1-D float32 PCM at
        ``sample_rate``; ``bucket_frames`` defaults to the exact frame
        count."""
        n_true = num_mel_frames(len(samples), self.hop_length)
        if bucket_frames is None:
            bucket_frames = n_true
        wave, n_true = pad_waveform(samples, self.n_fft, self.hop_length,
                                    bucket_frames)
        mel = log_mel_from_padded(
            torch.from_numpy(wave).to(self.device), n_true, self.mel_filters,
            self.n_fft, self.hop_length,
        )
        return mel, n_true
