"""table_on_card_pct: the share of the window's count calls whose root span
counted ``table_on_card`` 1, in percent (program counter): the calls whose
table the card built from the call's keys (one sort and run-length) rather
than the host from per-batch tables and their merge. A program whose roots
keep no such counter reads nothing."""

from benchmark.spans import roots, window_calls


def read(run):
    rs = [r for r in roots(window_calls(run)) if "table_on_card" in r["counters"]]
    return 100.0 * sum(r["counters"]["table_on_card"] for r in rs) / len(rs) if rs else None
