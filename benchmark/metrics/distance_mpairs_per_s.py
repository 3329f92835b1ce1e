"""distance_mpairs_per_s: pairs i < j of all the window's calls over the
window's whole wall time, in Mpairs/s (host clock)."""

from benchmark.readers import total_work


def read(run):
    return total_work(run) / 1e6 / run.window_s if run.calls else None
