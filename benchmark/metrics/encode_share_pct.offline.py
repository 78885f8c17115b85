"""encode_share_pct.offline (%, program span): the engine's
``prefill.encode`` span (the per-clip log-mel and encoder loop, token
embedding and audio injection: ``AsrEngine._embed_prompts``) over the
traced slice, the window's second batch whole. The profiler slows the
loop's eager launches, so it reads higher than the untraced share."""

from harness.spans import share_pct


def read(rec):
    return share_pct(rec, lambda name: name == "prefill.encode")
