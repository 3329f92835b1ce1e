"""parse_s_per_gbase.count: the native parse (phases["parse"], host
clock) over the window's input Gbase."""

from benchmark.readers import phase_per_gbase


def read(run):
    return phase_per_gbase(run, "parse")
