"""latency_p50_ms (ms, host clock): the 50th percentile, over every
request due in the window, of the time from its due time to its result;
a failed request counts with the time waited for it."""

from harness.stats import percentile


def read(rec):
    return percentile(rec.get("latencies_ms", []), 50)
