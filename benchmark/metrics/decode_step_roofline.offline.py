"""decode_step_roofline.offline (%, program span): the least time the
window's decode steps need (harness/work.py: the larger of each step's
bytes over 3.35 TB/s and operations over 989 TFLOP/s, live rows only),
over the decode loops' GPU time (the program's CUDA events)."""


def read(rec):
    p = rec.get("program", {})
    if not p.get("decode_gpu_seconds") or not p.get("decode_bound_s"):
        return None
    return 100.0 * p["decode_bound_s"] / p["decode_gpu_seconds"]
