"""mfu_pct.offline (%, host clock): the model operations of the window's real
work (harness/work.py: the encoder over each clip's real chunks, the
prefill of each real prompt, 2 x weights and the attention per emitted
token; no padding) over the window's wall time at 989 TFLOP/s."""

from harness.work import PEAK_BF16_FLOPS


def read(rec):
    if not rec.get("flops"):
        return None
    return 100.0 * rec["flops"] / (rec["window_s"] * PEAK_BF16_FLOPS)
