"""d2h_gbytes_per_s.distance: the bytes of the [S, S] int32 min-sums and
the counts copied to the host (the ``d2h.copy`` span's counter ``bytes``)
over the span's host-clock seconds, in GB/s (program span)."""

from benchmark.spans import copy_gbytes_per_s


def read(run):
    return copy_gbytes_per_s(run)
