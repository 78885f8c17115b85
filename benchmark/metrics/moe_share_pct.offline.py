"""moe_share_pct.offline (%, device trace): the routed-expert kernel's
device seconds (every device operation whose name holds
``moe_experts_kernel``: the gate-up and down launches of the program's
K7, summed over the whole profile by ``harness/moe.py``) over the traced
slice's host-clock length, the window's second batch whole. None where
the slice ran no such kernel (a dense decoder, a program without K7)."""

from harness.moe import expert_seconds


def read(rec):
    t = rec.get("trace")
    seconds = expert_seconds(rec)
    if not seconds or not t.get("window_s"):
        return None
    return 100.0 * seconds / t["window_s"]
