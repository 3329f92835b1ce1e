"""merge_s_per_gbase: the merge of batch tables (phases["merge"], the
MergeLadder; host clock) over the window's input Gbase."""

from benchmark.readers import phase_per_gbase


def read(run):
    return phase_per_gbase(run, "merge")
