"""count_file_s.p95: the 95th percentile of the wall time of every call of
the window, in seconds (host clock; the nearest-rank percentile)."""

import math


def read(run):
    walls = sorted(c.wall for c in run.calls)
    if not walls:
        return None
    return walls[max(0, math.ceil(0.95 * len(walls)) - 1)]
