"""``call_p90_ms``: the 90th percentile of the window's call times, nearest
rank, over every call (host clock)."""

import math


def read(run):
    times = sorted(run.call_s)
    return 1000.0 * times[math.ceil(0.9 * len(times)) - 1]
