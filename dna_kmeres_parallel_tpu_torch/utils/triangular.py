"""Packed strict-upper-triangle (row-major) index math.

The pairwise distances of n sequences are stored as the strict upper
triangle of the n x n matrix, row-major, n*(n-1)/2 entries (the
reference's layout). For 0-based i < j the packed index is

    idx(i, j, n) = i*n - i*(i+1)//2 + (j - i - 1)

which equals the reference's 1-based helper
``getIdxTriangularMatrixRowMajor(i+1, j-i, n)`` (``packed_index_reference``).
"""

from __future__ import annotations

import numpy as np


def packed_size(n: int) -> int:
    """Number of strict-upper-triangle entries of an n x n matrix."""
    return n * (n - 1) // 2


def packed_index(i, j, n: int):
    """0-based (i, j) with i < j  ->  packed row-major index. Vectorized."""
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    out = i * n - (i * (i + 1)) // 2 + (j - i - 1)
    return int(out) if out.ndim == 0 else out


def packed_index_reference(i1: int, j_offset: int, n: int) -> int:
    """The reference's 1-based formula: i1 = i + 1, j_offset = j - i."""
    return (n * (i1 - 1) - (((i1 - 2) * (i1 - 1)) // 2)) + (j_offset - i1)


def unpack_indices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """All (i, j) pairs with i < j, in packed order: (rows, cols), int64."""
    rows, cols = np.triu_indices(n, k=1)
    return rows.astype(np.int64), cols.astype(np.int64)


def packed_to_square(packed: np.ndarray, n: int, diag=0.0) -> np.ndarray:
    """A packed strict-upper-triangle vector -> the symmetric n x n matrix,
    ``diag`` on its diagonal."""
    packed = np.asarray(packed)
    out = np.full((n, n), diag, dtype=packed.dtype)
    rows, cols = unpack_indices(n)
    out[rows, cols] = packed
    out[cols, rows] = packed
    return out


def square_to_packed(square: np.ndarray) -> np.ndarray:
    """The strict upper triangle of a square matrix, packed row-major."""
    square = np.asarray(square)
    rows, cols = unpack_indices(square.shape[0])
    return square[rows, cols]
