"""Packed strict-upper-triangle (row-major) index math.

The pairwise distances of n sequences are stored as the strict upper
triangle of the n x n matrix, row-major, n*(n-1)/2 entries (the
reference's layout). For 0-based i < j the packed index is

    idx(i, j, n) = i*n - i*(i+1)//2 + (j - i - 1)
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
