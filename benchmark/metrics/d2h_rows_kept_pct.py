"""d2h_rows_kept_pct: the rows of the batch tables the compactor returned
(the ``compact`` spans' counter ``rows``) over the window words it was
handed (their counter ``words``), in percent (program counter): the share
of the words copied to the host that survive as table rows, the yardstick
of any de-duplication on the device."""

from benchmark.spans import counter, named, window_calls


def read(run):
    recs = named(window_calls(run), "compact")
    words = counter(recs, "words")
    return 100.0 * counter(recs, "rows") / words if words > 0 else None
