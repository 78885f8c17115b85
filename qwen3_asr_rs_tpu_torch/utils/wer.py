# A copy of qwen3_asr_rs_tpu/utils/wer.py: the port keeps its own, so that it imports nothing of the JAX package.
"""Word/character error rate (Levenshtein) — quality validation utility.

The north-star target is WER parity with the reference on real weights;
this gives the framework a built-in scorer (the reference has none).
"""

from __future__ import annotations


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance over token lists, O(len(ref) * len(hyp))."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate (whitespace tokenization)."""
    ref = reference.split()
    hyp = hypothesis.split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate (for CJK and character-level scoring)."""
    ref = list(reference.replace(" ", ""))
    hyp = list(hypothesis.replace(" ", ""))
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)
