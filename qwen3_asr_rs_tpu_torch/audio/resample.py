# A copy of qwen3_asr_rs_tpu/audio/resample.py: the port keeps its own, so that it imports nothing of the JAX package.
"""High-quality polyphase windowed-sinc resampling (host CPU, numpy).

Equivalent in design to the reference's rubato ``SincFixedIn`` fallback
(src/audio.rs:220-245: sinc_len 256, cutoff 0.95, Blackman-Harris window):
a zero-stuffed upsample by L, windowed-sinc anti-aliasing low-pass at
0.95x the narrower Nyquist, then decimation by M, evaluated polyphase so
the zero-stuffed signal is never materialized.

A C++ implementation of the same algorithm lives in native/audioio.cpp;
this numpy version is the always-available fallback and the test oracle
for the native one.
"""

from __future__ import annotations

import math

import numpy as np


def blackman_harris(n: int) -> np.ndarray:
    """4-term Blackman-Harris window."""
    k = np.arange(n, dtype=np.float64)
    x = 2.0 * np.pi * k / (n - 1)
    return (
        0.35875
        - 0.48829 * np.cos(x)
        + 0.14128 * np.cos(2 * x)
        - 0.01168 * np.cos(3 * x)
    )


def design_kernel(up: int, down: int, taps_per_phase: int = 128) -> np.ndarray:
    """Windowed-sinc low-pass at the upsampled rate, gain ``up``."""
    n_taps = taps_per_phase * up
    if n_taps % 2 == 0:
        n_taps += 1
    center = n_taps // 2
    # cutoff in cycles/sample at the upsampled rate; pass the narrower band
    fc = 0.95 * 0.5 / max(up, down)
    n = np.arange(n_taps, dtype=np.float64) - center
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= blackman_harris(n_taps)
    h *= up / np.sum(h)  # normalize DC gain to `up` (unity after decimation)
    return h


def resample_sinc(
    samples: np.ndarray, from_rate: int, to_rate: int,
    taps_per_phase: int = 128,
) -> np.ndarray:
    """Resample mono f32 audio from ``from_rate`` to ``to_rate``."""
    samples = np.asarray(samples, dtype=np.float64).reshape(-1)
    if from_rate == to_rate or samples.size == 0:
        return samples.astype(np.float32)
    g = math.gcd(from_rate, to_rate)
    up, down = to_rate // g, from_rate // g

    h = design_kernel(up, down, taps_per_phase)
    n_taps = len(h)
    center = n_taps // 2

    n_out = int(len(samples) * up / down)
    # Polyphase: y[m] = sum_j h[phase + j*up] * x[base - j]
    # where t = m*down (upsampled index), base = (t + center) // up,
    # phase = (t + center) % up ... derived from y_up[t] = conv(x_up, h).
    pad = taps_per_phase + 2
    x = np.pad(samples, (pad, pad))
    m = np.arange(n_out)
    t = m * down + center
    base = t // up + pad
    phase = t % up

    # per-phase filter bank: bank[p, j] = h[p + j*up], j over taps_per_phase
    n_j = (n_taps - 1) // up + 1
    bank = np.zeros((up, n_j), dtype=np.float64)
    for p in range(up):
        taps = h[p::up]
        bank[p, : len(taps)] = taps

    j = np.arange(n_j)
    # gather x[base - j] -> (n_out, n_j); dot with bank[phase]
    idx = base[:, None] - j[None, :]
    y = np.einsum("mj,mj->m", x[idx], bank[phase])
    return y.astype(np.float32)
