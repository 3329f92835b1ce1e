"""d2h_s.distance: the copy of the min-sums and counts to the host
(phases["d2h"]: the host wall left over, so the transfer and the wait for
the device), mean a call."""

from benchmark.readers import phase_mean


def read(run):
    return phase_mean(run, "d2h")
