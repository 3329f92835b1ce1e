"""compact_s_per_gbase: the native radix compaction (phases["compact"],
host clock) over the window's input Gbase."""

from benchmark.readers import phase_per_gbase


def read(run):
    return phase_per_gbase(run, "compact")
