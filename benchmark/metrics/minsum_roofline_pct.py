"""minsum_roofline_pct: the (min,+) product (K3, csrc/min_sum.cu) against
its roofline: the least time of each call's product (benchmark/roofline.py,
from the input sizes) over the product's time in the device trace, in
percent."""

from benchmark.readers import K3_KERNEL, k3_work, roofline_pct


def read(run):
    return roofline_pct(run, K3_KERNEL, k3_work(run))
