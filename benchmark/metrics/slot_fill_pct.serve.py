"""slot_fill_pct.serve (%, program counter): the tokens delivered over
the slot-steps the batcher ran while the window's requests were served
(``ContinuousBatcher.stats["steps"]`` times its slots): each slot-step
emits at most one token."""


def read(rec):
    p = rec.get("program", {})
    if not p.get("steps") or "slots" not in p:
        return None
    return 100.0 * p["tokens"] / (p["steps"] * p["slots"])
