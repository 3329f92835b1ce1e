"""host_sys_s.distance: the process's system CPU seconds over each
distance call (the root span's ``sys_s``), mean a call (program span)."""

from benchmark.spans import sys_s_mean


def read(run):
    return sys_s_mean(run)
