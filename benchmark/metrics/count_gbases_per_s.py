"""count_gbases_per_s: input bases of all the window's calls over the
window's whole wall time, in Gbase/s (host clock)."""

from benchmark.readers import total_work


def read(run):
    return total_work(run) / 1e9 / run.window_s if run.calls else None
