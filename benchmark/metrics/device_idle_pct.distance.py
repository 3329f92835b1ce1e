"""device_idle_pct.distance: the share of the traced window in which no
kernel, copy or memset ran on the card, in the distance cell (device
trace)."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
