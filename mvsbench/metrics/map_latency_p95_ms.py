"""map_latency_p95_ms: the 95th percentile (nearest rank) of every
request's time in the window, from its inputs on the host to its depth
and confidence on the host, by the host clock."""

import math


def read(rec):
    lat = sorted(rec.latencies_s)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
