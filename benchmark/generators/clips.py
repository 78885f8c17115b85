"""Speech-clip traffic from a mix file and the seed.

Every seed gets the same set of clip lengths and the same set of gaps
between arrivals, in another order: the lengths are the quantiles
(i + 1/2) / n of the mix's length distribution, split over its
components by their shares, and the gaps the same quantiles of the
exponential distribution of the arrival rate. So a run's work does not
depend on the seed, and its order, its arrivals and its audio do. The
audio is white noise from the seed (the weights are random: what a clip
says does not matter, its length does).

Mix keys:
  arrival    {"kind": "poisson", "rate_per_s": r}: an open loop, n =
             round(r * seconds) requests due in [0, seconds);
             {"kind": "closed", "batch": B, "pool": K}: K batches of B
             clips, each the same B lengths in another order, called
             back to back.
  lengths_s  components {"share", "dist": "lognormal" (median, sigma) or
             "uniform", "min", "max"} in seconds.
  max_new_tokens  {"per_audio_s": a, "plus": b}: a request's cap is
             ceil(a * seconds) + b (open loops).
  amplitude  the noise's standard deviation.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Optional

import numpy as np

SAMPLE_RATE = 16000


@dataclasses.dataclass
class Clip:
    samples: np.ndarray
    seconds: float
    due_s: Optional[float] = None     # open loops: when it is due
    max_new: Optional[int] = None     # open loops: its token cap


@dataclasses.dataclass
class Traffic:
    requests: list   # open loops: Clips by due time
    batches: list    # closed loops: lists of Clips


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(components: list, n: int) -> np.ndarray:
    """n clip lengths: each component's share of n (largest remainders),
    at its quantiles, clipped to [min, max]."""
    shares = np.array([c["share"] for c in components], float)
    raw = shares / shares.sum() * n
    counts = np.floor(raw).astype(int)
    for i in np.argsort(counts - raw)[: n - counts.sum()]:
        counts[i] += 1
    out = []
    for c, k in zip(components, counts):
        q = _quantiles(int(k))
        if c["dist"] == "lognormal":
            z = np.array([NormalDist().inv_cdf(x) for x in q])
            v = c["median"] * np.exp(c["sigma"] * z)
        elif c["dist"] == "uniform":
            v = c["min"] + (c["max"] - c["min"]) * q
        else:
            raise ValueError(f"unknown length distribution {c['dist']!r}")
        out.append(np.clip(v, c["min"], c["max"]))
    return np.concatenate(out)


def _noise(seed: int, key: tuple, seconds: float, amplitude: float):
    rng = np.random.default_rng((seed,) + key)
    n = int(round(seconds * SAMPLE_RATE))
    return (rng.standard_normal(n, dtype=np.float32) * amplitude)


def _due_times(rate: float, n: int, rng) -> np.ndarray:
    gaps = rng.permutation(-np.log1p(-_quantiles(n)) / rate)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def generate(mix: dict, seed: int, seconds: float) -> Traffic:
    seed = int(seed) % 2 ** 63
    rng = np.random.default_rng(seed)
    arrival, amp = mix["arrival"], float(mix["amplitude"])
    if arrival["kind"] == "closed":
        b = int(arrival["batch"])
        base = lengths(mix["lengths_s"], b)
        batches = []
        for k in range(int(arrival["pool"])):
            secs = rng.permutation(base)
            batches.append([Clip(_noise(seed, (k, i), s, amp), float(s))
                            for i, s in enumerate(secs)])
        return Traffic(requests=[], batches=batches)
    if arrival["kind"] != "poisson":
        raise ValueError(f"unknown arrival kind {arrival['kind']!r}")
    rate = float(arrival["rate_per_s"])
    n = int(round(rate * seconds))
    secs = rng.permutation(lengths(mix["lengths_s"], n))
    due = _due_times(rate, n, rng)
    cap = mix["max_new_tokens"]
    reqs = [Clip(_noise(seed, (i,), s, amp), float(s), due_s=float(t),
                 max_new=math.ceil(cap["per_audio_s"] * s) + cap["plus"])
            for i, (s, t) in enumerate(zip(secs, due))]
    return Traffic(requests=reqs, batches=[])
