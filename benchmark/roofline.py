"""The yardstick of the kernels' roofline shares: the card's published peaks
and the bytes and operations each kernel's function needs, counted from the
cell's input sizes alone. Nothing here follows how the program stages its
work (batch sizes, padding, halos): a launch that pads does more than the
function needs, and its share shows it. A later change to a kernel or a
route is judged against the same count of work.

Peaks: one NVIDIA H100 SXM (data sheet, 700 W): 3.35 TB/s of HBM, 67
TFLOP/s outside the tensor cores; the least time of some work is the larger
of its bytes over the first and its operations over the second. Every
input byte is counted read once and every output byte written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def least_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take for this work."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S)


def k1_hi_bytes(k: int) -> int:
    """Bytes of K1's high word per window: none up to k = 15, 2 to k = 23,
    else 4."""
    return 0 if k <= 15 else 2 if k <= 23 else 4


def k1_work(stream_len: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of encoding a parsed stream of ``stream_len``
    bases (records and one separator between records) into its windows'
    codes: the stream read once as two bit planes (0.5 B a base), and a low
    and a high word written for each of its stream_len - k + 1 windows.
    Operations: none counted (the work is bound by its bytes)."""
    windows = max(stream_len - k + 1, 0)
    return stream_len / 2 + windows * (4 + k1_hi_bytes(k)), 0.0


def k3_work(S: int, B: int) -> tuple[float, float]:
    """(bytes, operations) of K3 over an int32 [S, B] counts matrix: the
    counts in, the [S, S] int32 min-sums out, and a minimum and an add for
    every bin of every pair i < j."""
    return 4.0 * S * B + 4.0 * S * S, 2.0 * B * S * (S - 1) / 2
