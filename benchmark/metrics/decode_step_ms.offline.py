"""decode_step_ms.offline (ms, program span): the decode loop's GPU time
(the program's CUDA events, ``last_stats["decode_gpu_seconds"]``) over
its steps (``decode_steps``), summed over the window's calls."""


def read(rec):
    p = rec.get("program", {})
    if not p.get("decode_steps") or not p.get("decode_gpu_seconds"):
        return None
    return 1e3 * p["decode_gpu_seconds"] / p["decode_steps"]
