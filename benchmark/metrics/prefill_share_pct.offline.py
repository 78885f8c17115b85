"""prefill_share_pct.offline (%, program span): the engine's prefill
time (log-mel, encoder, prompt injection and the batched prefill: the
program's host-clock ``last_stats["prefill_seconds"]``, synchronized)
summed over the window's calls, over the window's wall time."""


def read(rec):
    p = rec.get("program", {})
    if "prefill_seconds" not in p:
        return None
    return 100.0 * p["prefill_seconds"] / rec["window_s"]
