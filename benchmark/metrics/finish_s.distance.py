"""finish_s.distance: the host float32 finish (phases["finish"], host
clock), mean a call."""

from benchmark.readers import phase_mean


def read(run):
    return phase_mean(run, "finish")
