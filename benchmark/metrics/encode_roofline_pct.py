"""encode_roofline_pct: K1 (csrc/encode_packed.cu) against its roofline:
the least time of encoding the windows of every call's parsed stream
(benchmark/roofline.py, from the input sizes, padding not counted) over
the time of every K1 launch in the device trace, in percent."""

from benchmark.readers import K1_KERNEL, k1_work, roofline_pct


def read(run):
    return roofline_pct(run, K1_KERNEL, k1_work(run))
