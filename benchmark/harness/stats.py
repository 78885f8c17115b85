"""Order statistics of a run's samples."""

from __future__ import annotations


def percentile(values, q: float):
    """The q-th percentile, linear between the closest ranks (numpy's
    default); None for no values."""
    v = sorted(values)
    if not v:
        return None
    x = (len(v) - 1) * q / 100.0
    i = int(x)
    j = min(i + 1, len(v) - 1)
    return v[i] + (v[j] - v[i]) * (x - i)
