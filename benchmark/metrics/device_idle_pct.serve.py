"""device_idle_pct.serve (%, device trace): the share of the traced slice in
which no device operation ran (torch.profiler: 1 - the union of the
device events' intervals over the slice's host-clock length)."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
