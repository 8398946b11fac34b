"""latency_p95_ms (ms): the 95th percentile, by nearest rank, over every
call due in the window of (its output's event completed - its due
time).  A call that finished after the window's last due time counts
with the time it really took: the wait is latency."""
import math


def read(w):
    lat = sorted(c.ready - c.due for c in w.calls if c.due is not None)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
