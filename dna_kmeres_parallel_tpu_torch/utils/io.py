"""Result writers in the reference's formats: the distance CSV (one
``%f`` value per line) and the ragged lower-triangle TSV of
``printMinDistances``."""

from __future__ import annotations

import numpy as np

from dna_kmeres_parallel_tpu_torch import native


def write_distances_csv(path, packed: np.ndarray) -> None:
    """One float per line, C ``"%f"``, byte for byte the reference's
    results CSV (formatted by the native library's threaded snprintf)."""
    with open(path, "wb") as f:
        f.write(native.format_f6(np.asarray(packed, dtype=np.float32)))


def write_min_distances_tsv(path, packed: np.ndarray, n: int) -> None:
    """Ragged rows: row i holds the distances (i, i+1..n-1), ``"%.2f\\t"``
    per entry, then a newline."""
    packed = np.asarray(packed, dtype=np.float32)
    with open(path, "w", encoding="ascii") as f:
        pos = 0
        for row_len in range(n - 1, 0, -1):
            f.write("".join("%.2f\t" % v for v in packed[pos : pos + row_len]))
            f.write("\n")
            pos += row_len
