"""call_p95_ms: the 95th percentile of the latency of every call of the
window (from the call's start, its inputs made, to its tags on the
host), host clock, linear interpolation between order statistics."""

import numpy as np


def read(r):
    lat = [c["latency_s"] for c in r.calls]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
