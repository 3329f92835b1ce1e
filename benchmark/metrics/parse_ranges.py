"""parse_ranges: the record-aligned ranges the native parse cut the file
into, one a host thread (the ``parse`` spans' counter ``ranges``), mean a
parse span of the window's calls (program counter): 1 where the parse ran
on one range, up to the host's threads where it ran split. A program whose
parse spans keep no such counter reads nothing."""

from benchmark.spans import named, window_calls


def read(run):
    recs = [r for r in named(window_calls(run), "parse") if "ranges" in r["counters"]]
    return sum(r["counters"]["ranges"] for r in recs) / len(recs) if recs else None
