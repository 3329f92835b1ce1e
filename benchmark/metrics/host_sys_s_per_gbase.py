"""host_sys_s_per_gbase: the process's system CPU seconds over each count
call (the root span's ``sys_s``: page faults of fresh host arrays, frees,
file reads) over the calls' input Gbase (program span)."""

from benchmark.spans import sys_s_per_gbase


def read(run):
    return sys_s_per_gbase(run)
