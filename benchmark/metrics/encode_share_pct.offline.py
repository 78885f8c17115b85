"""encode_share_pct.offline (%, program span): the engine's
``prefill.encode`` span (the host's padding of the call's clips, one
batched log-mel and one batched encoder call over every row, token
embedding and audio injection: ``AsrEngine._embed_prompts``) over the
traced slice, the window's second batch whole. The profiler slows eager
launches, so host-bound work can read a larger share traced than
untraced."""

from harness.spans import share_pct


def read(rec):
    return share_pct(rec, lambda name: name == "prefill.encode")
