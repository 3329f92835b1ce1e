"""d2h_gbytes_per_s.count: the bytes of each batch's window words copied
to the host (the ``d2h.copy`` spans' counter ``bytes``) over the spans'
host-clock seconds, in GB/s (program span)."""

from benchmark.spans import copy_gbytes_per_s


def read(run):
    return copy_gbytes_per_s(run)
