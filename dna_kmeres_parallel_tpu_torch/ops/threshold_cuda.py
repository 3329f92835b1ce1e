"""The threshold (min,+) route: int8 tensor-core products on the card.

The counterpart of ``dna_kmeres_parallel_tpu/ops/distance.py``'s
``min_sum_matrix_mxu``, which the JAX package runs as XLA ``dot_general``
calls outside any kernel body (no Pallas kernel stands behind it), so a
library int8 GEMM is its port: ``torch._int_mm`` (cuBLASLt on Hopper's
int8 tensor cores, int32 out). It uses

    sum_p min(a_p, b_p) = sum_{t=1..cmax} [a_p >= t] * [b_p >= t]

with the 0/1 planes of all thresholds laid side by side along the inner
dimension, A'[i, t * Bp + p] = [a_ip >= t + 1], so that one product
A' B'^T adds every threshold's term in its int32 accumulators: exact
where every count is at most cmax and every row sums below 2^31.

``threshold_product`` holds the layout (the planes, their padding to
what ``_int_mm`` takes on a card, and the chunks that bound the planes'
memory) and runs on any device, the CPU included, so its layout is
tested there. ``min_sum_matrix_threshold`` picks the route by the
counts' device and nothing else: the card's products on the card, the
plain version (``ops/distance.min_sum_matrix_threshold``) on the CPU.
"""

from __future__ import annotations

import torch

from dna_kmeres_parallel_tpu_torch.ops import distance as dist_ops

#: Products the route ran on the card since the counts were last reset
#: (one a call, as K3 and K4 count one a launch), and the ``_int_mm``
#: calls they made (one a chunk).
THRESHOLD_LAUNCHES = 0
GEMM_LAUNCHES = 0
#: ``_int_mm`` on a card: more than 16 rows; inner and column sizes
#: multiples of 8. Rows are padded to a multiple of 8 as well.
MIN_ROWS = 17
ALIGN = 8
#: a plane's bins are padded to a multiple of this, the int8 MMA's depth:
#: at (d)'s 111,940 bins, 8 mod 16, cuBLASLt took 4.42 ms where padded to
#: 32 it took 3.35 ms on one NVIDIA H100 80GB HBM3 at 700 W
#: (``scripts/threshold_probe.py``, PERF.md section 6)
PLANE_ALIGN = 32
#: the planes' memory budget is the counts' own bytes, but never below this
MIN_PLANE_BYTES = 64 << 20


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_rows(n: int) -> int:
    """Rows of a plane as ``_int_mm`` takes it: a multiple of 8, above 16."""
    return max(_round_up(n, ALIGN), _round_up(MIN_ROWS, ALIGN))


def plane_chunks(rows: int, cols: int | None, bins: int, cmax: int,
                 budget_bytes: int) -> list[tuple[int, int, int, int]]:
    """The chunks (t0, t1, b0, b1) of one product: thresholds t0 + 1..t1
    over bins [b0, b1). A chunk's planes (both sides' padded rows by
    (t1 - t0) planes of its bins, each padded to a multiple of
    PLANE_ALIGN) stay within ``budget_bytes``: whole thresholds over every
    bin where one threshold fits, else one threshold over slices of the
    bins. Every chunk's int32 partial product adds exactly into the
    result."""
    plane_rows = padded_rows(rows) + (0 if cols is None else padded_rows(cols))
    per_t = plane_rows * _round_up(bins, PLANE_ALIGN)
    if per_t <= budget_bytes:
        step = max(1, min(cmax, budget_bytes // per_t))
        return [(t, min(t + step, cmax), 0, bins) for t in range(0, cmax, step)]
    width = max(PLANE_ALIGN, budget_bytes // plane_rows // PLANE_ALIGN * PLANE_ALIGN)
    return [(t, t + 1, b, min(b + width, bins))
            for t in range(cmax) for b in range(0, bins, width)]


def build_planes(counts: torch.Tensor, t0: int, t1: int, b0: int, b1: int) -> torch.Tensor:
    """int8 [padded_rows(S), (t1 - t0) * Bp]: plane t of bins [b0, b1),
    [counts >= t0 + 1 + t], at columns [t * Bp, t * Bp + b1 - b0), Bp the
    bin count padded to a multiple of PLANE_ALIGN; zeros in every padding
    row and column (they add nothing to a product). One comparison pass
    writes the bool planes in place, viewed as int8."""
    S = counts.shape[0]
    T, width = t1 - t0, b1 - b0
    Bp = _round_up(width, PLANE_ALIGN)
    planes = torch.empty(padded_rows(S), T, Bp, dtype=torch.bool, device=counts.device)
    planes[S:] = False
    planes[:S, :, width:] = False
    thresholds = torch.arange(t0 + 1, t1 + 1, dtype=counts.dtype, device=counts.device)
    torch.ge(counts[:, None, b0:b1], thresholds[None, :, None], out=planes[:S, :, :width])
    return planes.view(torch.int8).reshape(planes.shape[0], T * Bp)


def default_budget(counts: torch.Tensor, counts_other: torch.Tensor | None) -> int:
    """The planes' memory budget: the counts' own bytes (both sides), at
    least ``MIN_PLANE_BYTES``."""
    own = counts.numel() * counts.element_size()
    if counts_other is not None:
        own += counts_other.numel() * counts_other.element_size()
    return max(own, MIN_PLANE_BYTES)


def threshold_product(counts: torch.Tensor, cmax: int,
                      counts_other: torch.Tensor | None = None,
                      budget_bytes: int | None = None) -> tuple[torch.Tensor, int]:
    """(int32 [S, S2] min-sums, ``_int_mm`` calls): the route's layout on
    the counts' device. For each chunk of ``plane_chunks`` the planes of
    both sides (one set for a symmetric product) are built and multiplied,
    ``_int_mm(A', B'^T)`` with B' row-major [S2p, K] (its transpose is the
    column-major operand cuBLASLt takes), and the partials are added in
    int32. The caller has checked cmax and the row sums
    (``dist_ops.check_threshold``)."""
    S, B = counts.shape
    S2 = S if counts_other is None else counts_other.shape[0]
    if counts_other is not None and counts_other.shape[1] != B:
        raise ValueError(f"bins differ: {B} and {counts_other.shape[1]}")
    out = torch.zeros(padded_rows(S), padded_rows(S2), dtype=torch.int32, device=counts.device)
    if cmax <= 0 or not (S and S2 and B):
        return out[:S, :S2].contiguous(), 0
    budget = default_budget(counts, counts_other) if budget_bytes is None else budget_bytes
    chunks = plane_chunks(S, None if counts_other is None else S2, B, cmax, budget)
    for t0, t1, b0, b1 in chunks:
        a = build_planes(counts, t0, t1, b0, b1)
        b = a if counts_other is None else build_planes(counts_other, t0, t1, b0, b1)
        out += torch._int_mm(a, b.t())
        del a, b
    return out[:S, :S2].contiguous(), len(chunks)


def min_sum_threshold_cuda(counts: torch.Tensor, cmax: int,
                           counts_other: torch.Tensor | None = None,
                           budget_bytes: int | None = None) -> torch.Tensor:
    """The route on the card: int32 [S, S2] min-sums of integer counts on
    one card, checked (``dist_ops.check_threshold``) and counted."""
    global THRESHOLD_LAUNCHES, GEMM_LAUNCHES
    mats = (counts,) if counts_other is None else (counts, counts_other)
    for m in mats:
        if m.device.type != "cuda" or m.device != counts.device:
            raise ValueError(f"the threshold route needs tensors on one card, got {m.device}")
    dist_ops.check_threshold(cmax, *mats)
    out, gemms = threshold_product(counts, cmax, counts_other, budget_bytes)
    THRESHOLD_LAUNCHES += 1
    GEMM_LAUNCHES += gemms
    return out


def min_sum_matrix_threshold(counts: torch.Tensor, cmax: int,
                             counts_other: torch.Tensor | None = None) -> torch.Tensor:
    """int32 [S, S2] min-sums by ``cmax`` thresholds: the card's int8
    products on the card, the plain version on the CPU."""
    if counts.device.type == "cuda":
        return min_sum_threshold_cuda(counts, cmax, counts_other)
    if counts.device.type != "cpu":
        raise ValueError(f"no threshold route for device {counts.device}")
    return dist_ops.min_sum_matrix_threshold(counts, cmax, counts_other)
