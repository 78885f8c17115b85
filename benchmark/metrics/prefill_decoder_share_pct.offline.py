"""prefill_decoder_share_pct.offline (%, program span): the engine's
``prefill.decoder`` span (the text decoder's batched prefill over the
prompts, host clock: what the host spends enqueuing it and any wait
inside it) over the traced slice, the window's second batch whole."""

from harness.spans import share_pct


def read(rec):
    return share_pct(rec, lambda name: name == "prefill.decoder")
