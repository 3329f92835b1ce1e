"""Pairwise k-mer distances: the plain (min,+) product and the host finish.

D(i, j) = 1 - sum_p min(c_i[p], c_j[p]) / (min(L_i, L_j) - k + 1), float32
(the reference's formula). The port of
``dna_kmeres_parallel_tpu/ops/distance.py``'s ``min_sum_matrix`` (the plain
version of K3 and K4), ``finish_distances``, ``finish_distances_panel``,
``distance_matrix_packed`` and ``tri_time_per_pair`` (with the card's
rates). The integer min-sums are exact on any
device; the float32 finish runs on the host in NumPy, whose division is
IEEE correctly rounded, so the distances are bit-reproducible.
"""

from __future__ import annotations

import numpy as np
import torch

#: elements of one block's [rows, S2, B] broadcast in the plain product
_BLOCK_ELEMS = 1 << 24

#: The per-pair time model of K3 and K4 on the card, which the distance
#: gates of ``models/sparse_engine`` read: t = bins / rate a pair.
#: Measured by ``chip_smoke.measure_gate_rates`` on one NVIDIA H100 80GB
#: HBM3 at 700 W: K3 over phase (d)'s [2,048, 131,072] union matrix
#: (6.77e12) (PERF.md, section 7).
TRI_BIN_PAIRS_PER_SEC = 6.8e12


def tri_time_per_pair(bins: int, rate: float = TRI_BIN_PAIRS_PER_SEC) -> float:
    """Predicted seconds a pair of the (min,+) product over ``bins``
    columns takes in K3 or K4."""
    return bins / rate


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
    """Packed float32 distances of a panel's strict upper triangle, row by
    row: row i of the panel is sequence r0 + i, column j is sequence
    base + j, and only the columns after the row's own sequence are
    finished (``finish_distances_panel`` on each row's tail)."""
    R, C = min_sums.shape
    lr = np.asarray(lengths_rows, dtype=np.int64)
    lc = np.asarray(lengths_cols, dtype=np.int64)
    first = np.clip(np.arange(R) + r0 + 1 - base, 0, C)
    out = np.empty(int((C - first).sum()), dtype=np.float32)
    pos = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        for i, f in enumerate(first.tolist()):
            out[pos : pos + C - f] = finish_distances_panel(
                min_sums[i : i + 1, f:], lr[i : i + 1], lc[f:], k
            )[0]
            pos += C - f
    return out


def finish_packed(min_sums: np.ndarray, lengths: np.ndarray, k: int) -> np.ndarray:
    """Square [S, S] min-sums -> packed float32 distances, finished row by
    row over the upper triangle only."""
    return finish_upper(min_sums, lengths, lengths, k)


def distance_matrix_packed(counts: torch.Tensor, lengths, k: int) -> np.ndarray:
    """Packed strict-upper-triangle float32 distances (the reference's
    layout), bit-exact: the symmetric (min,+) product on the counts'
    device (K3 on the card) and the host float32 finish."""
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

    sums = distance_cuda.min_sum_matrix_tri(counts).cpu().numpy()
    return finish_packed(sums, np.asarray(lengths), k)
