"""moe_experts_roofline.offline (%, device trace): the least time of the
traced batch's routed-expert work over the device seconds of the kernel
that did it (``moe_share_pct.offline``'s). The work is the architecture
module's ``expert_work`` (``architectures/<architecture>.py``) applied
to the program's ``moe.*`` counters of the same batch, by the
architecture of the cell being run: the (expert,
layer) pairs its decode steps and its prefill touched and the routes
they ran, each phase's bound the larger of its bytes over 3.35 TB/s and
its operations over 989 TFLOP/s, the two bounds summed. None where the
slice ran no expert kernel or the program kept no counters."""

from harness.moe import expert_bound_s, expert_seconds


def read(rec):
    seconds = expert_seconds(rec)
    bound = expert_bound_s()
    if not seconds or not bound:
        return None
    return 100.0 * bound / seconds
