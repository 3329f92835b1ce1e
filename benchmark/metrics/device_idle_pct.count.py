"""device_idle_pct.count: the share of the traced window in which no
kernel, copy or memset ran on the card, in the count cells (device
trace)."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
