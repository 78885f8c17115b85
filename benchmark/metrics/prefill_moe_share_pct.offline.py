"""prefill_moe_share_pct.offline (%, program span): the engine's
``prefill.moe`` spans (each MoE block of the eager prefill: the router,
the routes grouped by expert and the routed experts' launches, host
clock: what the host spends enqueuing them and any wait inside) over the
traced slice, the window's second batch whole."""

from harness.spans import share_pct


def read(rec):
    return share_pct(rec, lambda name: name == "prefill.moe")
