"""entry_s_per_gbase: each call's wall minus the sum of its phases (the
entry layer: engine construction, buffers, everything no phase covers),
summed over the window's calls, over their input Gbase."""

from benchmark.readers import per_gbase


def read(run):
    return per_gbase(run, lambda c: c.wall - sum(c.phases.values()))
