"""Pairwise k-mer distances: the plain (min,+) product and the host finish.

D(i, j) = 1 - sum_p min(c_i[p], c_j[p]) / (min(L_i, L_j) - k + 1), float32
(the reference's formula). The port of
``dna_kmeres_parallel_tpu/ops/distance.py``'s ``min_sum_matrix`` (the plain
version of K3 and K4), ``finish_distances``, ``finish_distances_panel``,
``distance_matrix_packed``, ``distance_matrix_square`` and
``tri_time_per_pair`` (with the card's rates), and of
``min_sum_matrix_mxu``, here ``min_sum_matrix_threshold`` (the plain
version of the threshold route, ``ops/threshold_cuda``) with the time
models its gate compares, and K3/K4's plan of bin slices
(``min_sum_split``). The integer min-sums are exact on any device. The
float32 finish is correctly rounded wherever it runs: on the host in
``finish_upper_plain`` (the plain PyTorch version of the card's finish
kernel, ``csrc/finish.cu``; ``finish_upper`` and ``finish_packed`` are its
NumPy forms), pinned bit for bit to NumPy's ``finish_distances_panel``,
and on the card in the kernel; so the distances are bit-reproducible.
"""

from __future__ import annotations

import numpy as np
import torch

#: elements of one block's [rows, S2, B] broadcast in the plain product
_BLOCK_ELEMS = 1 << 24

#: The per-pair time model of K3 and K4 on the card, which the distance
#: gates of ``models/sparse_engine`` read: t = bins / rate a pair.
#: Measured by ``kmer-gpu calibrate`` (``ops/calibrate``) on one NVIDIA
#: H100 80GB HBM3 at 700.00 W: K3 over a [2,048, 131,072] union matrix in
#: 8 bin slices (1.359e13) (PERF.md, section 6).
TRI_BIN_PAIRS_PER_SEC = 1.36e13


#: K3's rate with every SM busy: [16,384, 64] (8,256 output tiles), as
#: ``ops/calibrate`` measured it on one NVIDIA H100 80GB HBM3 at 700 W
#: (``scripts/threshold_probe.py``, PERF.md section 6): what
#: ``minplus_time``'s rate grows to at bins too few to split. At 64 bins
#: K3 is bound by its stores, so the wide-bin rates are above it.
PEAK_BIN_PAIRS_PER_SEC = 1.07e13
#: K3/K4's output tile (``csrc/min_sum.cu``'s kTile)
MINPLUS_TILE = 128
#: Bins a stage of K3/K4 (``csrc/min_sum.cu``'s kBK), and the fewest bins
#: a bin slice of their split holds: against 1,024 bins, adding a tile
#: into the output is a small share of a block's work.
MINPLUS_STAGE_BINS = 32
MINPLUS_SLICE_MIN_BINS = 1024
#: Blocks of each K3/K4 route resident on one SM (``Tiling::kMinBlocks``),
#: by ``ops/distance_cuda``'s route names.
MINPLUS_RESIDENT_BLOCKS = {"u16x2": 4, "i32": 2}
#: the rows of the shapes ``ops/calibrate`` measures K3's dense and union
#: rates at, [1024, 4^9] and [2048, 131,072]
DENSE_RATE_ROWS = 1024
UNION_RATE_ROWS = 2048
#: the threshold route's cap on cmax's power-of-two bucket (the JAX
#: package's ``MXU_CMAX_DEFAULT``): one plane of B columns a threshold
THRESHOLD_CMAX_DEFAULT = 64
#: int8 multiply-adds a second of the threshold route, its 0/1 planes
#: built and multiplied (``torch._int_mm``): the marginal rate between
#: cmax 8 and cmax 2 over a [2048, 65,536] matrix (``ops/calibrate``'s
#: method), measured on one NVIDIA H100 80GB HBM3 at 700 W
#: (``scripts/threshold_probe.py``, PERF.md section 6)
THRESHOLD_MACS_PER_SEC = 2.96e14


def tri_time_per_pair(bins: int, rate: float = TRI_BIN_PAIRS_PER_SEC) -> float:
    """Predicted seconds a pair of the (min,+) product over ``bins``
    columns takes in K3 or K4."""
    return bins / rate


def minplus_tiles(rows: int, cols: int, symmetric: bool) -> int:
    """The 128 x 128 output tiles K3 (``symmetric``: the upper triangle
    of [rows, rows]) or K4 ([rows, cols]) launches."""
    t = -(-rows // MINPLUS_TILE)
    return t * (t + 1) // 2 if symmetric else t * -(-cols // MINPLUS_TILE)


def _slices_most(bins: int) -> int:
    """The most bin slices of MINPLUS_SLICE_MIN_BINS that ``bins`` hold."""
    return -(-bins // MINPLUS_STAGE_BINS) // (MINPLUS_SLICE_MIN_BINS // MINPLUS_STAGE_BINS)


def min_sum_split(tiles: int, bins: int, route: str, sms: int) -> tuple[int, int]:
    """(P, L): the bin slices K3/K4 cut a product of ``tiles`` output tiles
    over ``bins`` bins into on ``route`` on a card of ``sms`` SMs, and the
    bins of each (the last slice ends at ``bins``). The wrapper passes L to
    the kernels, which launch ceil(bins / L) slices.

    (1, bins) wherever the tiles alone give two waves of the route's
    resident blocks (``sms`` x ``MINPLUS_RESIDENT_BLOCKS[route]``), or the
    bins hold fewer than two slices of MINPLUS_SLICE_MIN_BINS. Otherwise
    the fewest slices that give two waves, at most one a
    MINPLUS_SLICE_MIN_BINS; L whole stages of MINPLUS_STAGE_BINS, as few
    as give that count, so that no slice is empty."""
    if route not in MINPLUS_RESIDENT_BLOCKS:
        raise ValueError(f"route must be one of {tuple(MINPLUS_RESIDENT_BLOCKS)}, got {route!r}")
    target = 2 * sms * MINPLUS_RESIDENT_BLOCKS[route]
    most = _slices_most(bins)
    if tiles <= 0 or tiles >= target or most < 2:
        return 1, bins
    stages = -(-bins // MINPLUS_STAGE_BINS)
    per = -(-stages // min(-(-target // tiles), most))
    return -(-stages // per), per * MINPLUS_STAGE_BINS


def minplus_time(rows: int, cols: int, bins: int, symmetric: bool, *, rate: float,
                 rate_rows: int, peak: float = PEAK_BIN_PAIRS_PER_SEC) -> float:
    """Predicted seconds of K3 (``symmetric``, the pairs of [rows, rows])
    or K4 ([rows, cols]) over ``bins`` columns. ``rate`` was measured by K3
    over ``rate_rows`` rows at wide bins. Wherever the bins hold two
    slices (``min_sum_split``), the kernels split them until the card is
    full, so the rate is flat: pairs * bins / rate, whatever the tiles.
    Fewer bins do not split, and the rate grows with the output tiles in
    flight: rate * t / tiles(rate_rows) at t tiles, at most ``peak``
    (every SM busy)."""
    pairs = rows * (rows - 1) / 2 if symmetric else rows * cols
    if _slices_most(bins) >= 2:
        eff = rate
    else:
        tiles = minplus_tiles(rows, cols, symmetric)
        eff = min(peak, rate * tiles / minplus_tiles(rate_rows, rate_rows, True))
    return pairs * bins / max(eff, 1e-30)


def threshold_time(rows: int, cols: int, bins: int, cmax: int, macs_per_sec: float,
                   sms: int) -> float:
    """Predicted seconds of the threshold route over [rows, bins] x
    [cols, bins] at ``cmax`` thresholds: it computes the whole rectangle
    (the whole square for a symmetric product), one multiply-add a bin,
    pair and threshold, at ``macs_per_sec`` where the output holds a
    128 x 128 tile for each of the card's ``sms`` SMs, and slower by that
    share where it holds fewer (the GEMM gives an SM an output tile;
    PERF.md section 6 has its rate at 4, 64 and 256 such tiles)."""
    slow = max(1.0, sms / max(1, minplus_tiles(rows, cols, False)))
    return rows * cols * bins * cmax / macs_per_sec * slow


def check_threshold(cmax: int, *mats: torch.Tensor) -> None:
    """Raise ValueError unless ``cmax`` is a threshold every integer
    matrix's dtype can hold (an int8 count compared with 128 would wrap:
    the JAX package's guard) and every row of every matrix sums below
    2^31 (an int32 min-sum could not hold such a pair)."""
    for m in mats:
        if m.dim() != 2:
            raise ValueError(f"counts must be 2-D, got {tuple(m.shape)}")
        if not m.dtype.is_floating_point and cmax > torch.iinfo(m.dtype).max:
            raise ValueError(
                f"cmax={cmax} not representable in {m.dtype}; widen the counts "
                "(int32) before the threshold route"
            )
        if m.numel() and int(m.sum(1, dtype=torch.int64).max()) >= 1 << 31:
            raise ValueError(
                "a row of the counts sums to 2^31 or more: its min-sums could "
                "overflow int32"
            )


def min_sum_matrix_threshold(
    counts: torch.Tensor, cmax: int, counts_other: torch.Tensor | None = None
) -> torch.Tensor:
    """int32 [S, S2] min-sums by thresholds, the plain version of the
    threshold route:

        sum_p min(a_p, b_p) = sum_{t=1..cmax} [a_p >= t] * [b_p >= t]

    one int32 product of 0/1 planes a threshold (on the CPU), summed in
    int32. Exact where every count is at most ``cmax`` (larger counts are
    cut to cmax) and every row sums below 2^31; ``check_threshold``
    raises otherwise."""
    other = counts if counts_other is None else counts_other
    check_threshold(cmax, counts, other)
    out = torch.zeros(counts.shape[0], other.shape[0], dtype=torch.int32,
                      device=counts.device)
    for t in range(1, cmax + 1):
        a = (counts >= t).to(torch.int32)
        out += a @ (a if counts_other is None else (other >= t).to(torch.int32)).T
    return out


def min_sum_matrix(
    counts: torch.Tensor, counts_other: torch.Tensor | None = None
) -> torch.Tensor:
    """int32 [S, S2]: sum_p min(counts[i, p], counts_other[j, p]).

    counts_other defaults to counts (the symmetric case). Row-blocked so a
    block's broadcast holds about 2^24 elements; int64 sums, cast back to
    int32 (callers keep every row sum below 2^31)."""
    other = counts if counts_other is None else counts_other
    S, B = counts.shape
    S2 = other.shape[0]
    out = torch.empty(S, S2, dtype=torch.int32, device=counts.device)
    rows = max(1, _BLOCK_ELEMS // max(S2 * B, 1))
    for r in range(0, S, rows):
        blk = counts[r : r + rows]
        out[r : r + rows] = (
            torch.minimum(blk[:, None, :], other[None, :, :])
            .sum(-1, dtype=torch.int64)
            .to(torch.int32)
        )
    return out


def finish_distances(min_sums: np.ndarray, lengths: np.ndarray, k: int) -> np.ndarray:
    """Host float32 finish of a square matrix: D = 1 - s / (min(L_i, L_j)
    - k + 1), with NumPy's correctly rounded float32 division."""
    lengths = np.asarray(lengths, dtype=np.int64)
    return finish_distances_panel(min_sums, lengths, lengths, k)


def finish_distances_panel(
    min_sums: np.ndarray, lengths_rows: np.ndarray, lengths_all: np.ndarray, k: int
) -> np.ndarray:
    """Panel finish: rows against columns. [R, S] float32."""
    min_sums = np.asarray(min_sums)
    lr = np.asarray(lengths_rows, dtype=np.int64)[:, None]
    la = np.asarray(lengths_all, dtype=np.int64)[None, :]
    denom = (np.minimum(lr, la) - k + 1).astype(np.float32)
    return np.float32(1.0) - min_sums.astype(np.float32) / denom


def finish_upper(
    min_sums: np.ndarray, lengths_rows, lengths_cols, k: int, r0: int = 0, base: int = 0
) -> np.ndarray:
    """Packed float32 distances of a panel's strict upper triangle: row i
    of the panel is sequence r0 + i, column j is sequence base + j, and
    only the columns after the row's own sequence are finished. The NumPy
    form of ``finish_upper_plain``, which computes it."""
    return finish_upper_plain(
        torch.from_numpy(np.asarray(min_sums)),
        torch.from_numpy(np.asarray(lengths_rows, dtype=np.int64)),
        torch.from_numpy(np.asarray(lengths_cols, dtype=np.int64)),
        k, r0, base,
    ).numpy()


def finish_packed(min_sums: np.ndarray, lengths: np.ndarray, k: int) -> np.ndarray:
    """Square [S, S] min-sums -> packed float32 distances of the upper
    triangle (``finish_upper`` of the whole square)."""
    return finish_upper(min_sums, lengths, lengths, k)


#: elements of one row block of ``finish_upper_plain``
_FINISH_BLOCK_ELEMS = 1 << 22
#: NumPy's float32 NaN on x86 as int32 bits (0xFFC00000, the sign set),
#: which 0 / 0 gives there: the CSV writer's ``%f`` prints it as "-nan"
NUMPY_NAN_BITS = 0xFFC00000 - (1 << 32)


def _skipped(x: int, C: int) -> int:
    """sum_{u=0}^{x-1} min(u, C), 0 for x <= 0 (``csrc/finish.cu``'s
    ``skipped``)."""
    if x <= 0:
        return 0
    if x <= C + 1:
        return x * (x - 1) // 2
    return C * (C + 1) // 2 + (x - C - 1) * C


def packed_upper_size(R: int, C: int, r0: int = 0, base: int = 0) -> int:
    """Elements of ``finish_upper``'s output for an [R, C] panel: row i
    keeps the columns from clamp(i + r0 + 1 - base, 0, C) on."""
    d = r0 + 1 - base
    return R * C - (_skipped(R + d, C) - _skipped(d, C))


def finish_upper_plain(
    min_sums: torch.Tensor, lengths_rows: torch.Tensor, lengths_cols: torch.Tensor,
    k: int, r0: int = 0, base: int = 0,
) -> torch.Tensor:
    """The host float32 finish in PyTorch, and the plain version of the
    card's finish kernel (``ops/distance_cuda.finish_upper_cuda``): int32
    [R, C] min-sums, int64 lengths [R] and [C] -> float32 packed
    distances in ``finish_upper``'s layout, on their device. Bit for bit
    ``finish_distances_panel`` on x86: an int32 and an int64 to float32
    conversion, one correctly rounded division and subtraction, and every
    NaN written as ``NUMPY_NAN_BITS``. Row blocks of about 2^22
    elements."""
    R, C = min_sums.shape
    d = r0 + 1 - base
    dev = min_sums.device
    out = torch.empty(packed_upper_size(R, C, r0, base), dtype=torch.float32, device=dev)
    nan = torch.tensor(NUMPY_NAN_BITS, dtype=torch.int32, device=dev).view(torch.float32)
    cols = torch.arange(C, device=dev)
    step = max(1, _FINISH_BLOCK_ELEMS // max(C, 1))
    pos = 0
    for a in range(0, R, step):
        b = min(a + step, R)
        keep = cols[None, :] >= torch.arange(a + d, b + d, device=dev)[:, None]
        den = torch.minimum(lengths_rows[a:b, None], lengths_cols[None, :]) - k + 1
        dist = 1.0 - min_sums[a:b].to(torch.float32) / den.to(torch.float32)
        dist = torch.where(torch.isnan(dist), nan, dist)[keep]
        out[pos : pos + dist.numel()] = dist
        pos += dist.numel()
    return out


def distance_matrix_square(counts: torch.Tensor, lengths, k: int) -> torch.Tensor:
    """The float32 [S, S] distance matrix on the counts' device: the
    symmetric (min,+) product (K3 on the card) and D = 1 - s / (min(L_i,
    L_j) - k + 1) there. The JAX package's throughput form: the division
    is the device's, which may be 1 ulp off the host finish, so use
    ``distance_matrix_packed`` where bitwise parity matters."""
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

    sums = distance_cuda.min_sum_matrix_tri(counts)
    lengths = torch.as_tensor(np.asarray(lengths), device=counts.device)
    min_len = torch.minimum(lengths[:, None], lengths[None, :])
    denom = (min_len - k + 1).to(torch.float32)
    return 1.0 - sums.to(torch.float32) / denom


def distance_matrix_packed(counts: torch.Tensor, lengths, k: int) -> np.ndarray:
    """Packed strict-upper-triangle float32 distances (the reference's
    layout), bit-exact: the symmetric (min,+) product and the float32
    finish on the counts' device (K3 and the finish kernel on the card),
    and only the packed triangle copied to the host."""
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

    sums = distance_cuda.min_sum_matrix_tri(counts)
    lens = torch.as_tensor(np.asarray(lengths, dtype=np.int64)).to(counts.device)
    return distance_cuda.finish_upper_packed(sums, lens, lens, k).cpu().numpy()
