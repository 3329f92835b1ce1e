"""merge_passes: the rows the native pair merges wrote (the ``merge.pair``
spans' counter ``rows_out``) over the final tables' rows (the root span's
counter ``rows``): how many times the merge writes each row (program
counter)."""

from benchmark.spans import merge_passes


def read(run):
    return merge_passes(run)
