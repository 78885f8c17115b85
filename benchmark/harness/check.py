"""The comparison that decides ``correct``.

The reference runs once over each sampled request's prompt with the
tokens the program served, and reads, at every served position, by how
much the served token's logit lies below the reference's best there; a
request that stopped before its cap stopped at an end-of-text token,
whose gap is read at the position after its last token (the better of
the two end tokens). Greedy decoding serves the reference's best token
wherever the program computes the logits closely enough, so these gaps
are 0 but for near-ties that the program's rounding flips.

Readings (``readings``): ``max_gap``, the widest gap over every position
of the sample; ``mean_gap``, the mean gap over them; ``mismatch_pct``,
the share of positions whose token is not the reference's best;
``tokens``, the positions read. A cell's ``checks/<cell>.json`` says
which readings are compared, and their limits.
"""

from __future__ import annotations

import sys

import torch


def _summary(gaps: list, prefix: str = "") -> dict:
    g = torch.cat(gaps).double().cpu()
    return {f"{prefix}max_gap": float(g.max()),
            f"{prefix}mean_gap": float(g.mean()),
            f"{prefix}mismatch_pct": 100.0 * float((g > 0).double().mean()),
            f"{prefix}tokens": int(g.numel())}


def readings(ref, items: list, eos: list, control=None) -> dict:
    """``items``: dicts with ``samples`` (the request's audio), ``tokens``
    (the token ids the program served) and ``cap`` (its token limit).
    ``control``: a reference in a lower precision; the same readings of
    the tokens it puts first at the same positions, prefixed
    ``control_`` (a served model's control need not decode)."""
    gaps, cgaps = [], []
    for it in items:
        toks = [int(x) for x in it["tokens"]]
        logits = ref.continuation_logits(it["samples"], toks)
        best = logits.max(-1).values
        n = len(toks)
        if n:
            rows = torch.arange(n, device=logits.device)
            served = logits[rows, torch.tensor(toks, device=logits.device)]
            gaps.append(best[:n] - served)
        if n < it["cap"]:
            gaps.append((best[n] - logits[n, eos].max()).reshape(1))
        if control is not None:
            first = control.continuation_logits(it["samples"], toks).argmax(-1)
            cgaps.append(best - logits.gather(1, first[:, None])[:, 0])
    out = _summary(gaps)
    if control is not None:
        out.update(_summary(cgaps, "control_"))
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for every limited reading; a
    reading that is missing or not a number fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = isinstance(v, (int, float)) and v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def print_checks(checks: dict, info: dict) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error (after the readings that are not compared)."""
    for name, v in info.items():
        print(f"reading {name} {v}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
