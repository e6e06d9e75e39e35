"""request_p95_ms: the 95th percentile of request latency over every
request of the window (nearest rank), each timed on the host clock from the
call to the host read of its iteration count."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
