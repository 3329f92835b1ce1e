"""Result writers and readers: the distance CSV (one ``%f`` value per
line) and the ragged lower-triangle TSV of ``printMinDistances`` in the
reference's formats, the k-mer count table as CSV and as ``.npz`` (the
JAX package's format, so a table written by either package loads in the
other), and a JSON run report."""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np

from dna_kmeres_parallel_tpu_torch import native

#: table entries formatted per native call by ``write_count_codes_csv``
_CSV_CHUNK = 1 << 22


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


def write_count_table_csv(path, table: Mapping[str, int]) -> None:
    """k-mer frequency table: a ``kmer,count`` header, then one
    ``kmer,count`` line per k-mer in lexicographic order."""
    with open(path, "w", encoding="ascii") as f:
        f.write("kmer,count\n")
        for kmer in sorted(table):
            f.write(f"{kmer},{table[kmer]}\n")


def write_count_codes_csv(path, k: int, codes: np.ndarray, counts: np.ndarray) -> None:
    """The bytes of ``write_count_table_csv`` for a sorted-unique table
    given as codes and counts (code order is the k-mers' lexicographic
    order), formatted by the native library a chunk at a time: no Python
    object per k-mer."""
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    buf = np.empty(64 * min(codes.shape[0], _CSV_CHUNK), dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b"kmer,count\n")
        for lo in range(0, codes.shape[0], _CSV_CHUNK):
            hi = lo + _CSV_CHUNK
            f.write(native.format_count_lines(codes[lo:hi], counts[lo:hi], k, buf))


def write_count_npz(path, result) -> None:
    """Binary count table: a dense result saves as ``hist``, a sparse one
    as sorted ``codes`` (uint64) and ``counts`` (int64), with ``k`` and
    ``canonical``. Large sparse tables are written uncompressed (codes are
    near-incompressible)."""
    meta = {"k": result.k, "canonical": result.canonical}
    if hasattr(result, "hist"):
        save = np.savez_compressed if result.hist.nbytes < (64 << 20) else np.savez
        save(path, hist=result.hist, **meta)
    else:
        big = result.codes.nbytes + result.counts.nbytes >= (16 << 20)
        save = np.savez if big else np.savez_compressed
        save(path, codes=result.codes, counts=result.counts, **meta)


def read_count_npz(path):
    """Load a count table written by ``write_count_npz`` -> (k, canonical,
    codes_u64, counts_i64); a dense histogram comes back as its nonzero
    entries."""
    with np.load(path) as z:
        k = int(z["k"])
        canonical = bool(z["canonical"])
        if "hist" in z:
            hist = z["hist"]
            codes = np.nonzero(hist)[0].astype(np.uint64)
            counts = hist[codes.astype(np.int64)].astype(np.int64)
        else:
            codes = z["codes"].astype(np.uint64)
            counts = z["counts"].astype(np.int64)
    return k, canonical, codes, counts


def read_distances_csv(path) -> np.ndarray:
    with open(path, "r", encoding="ascii") as f:
        return np.array([float(x) for x in f if x.strip()], dtype=np.float32)


def write_report_json(path, report: Mapping) -> None:
    """A run report as indented JSON with sorted keys."""
    with open(path, "w", encoding="ascii") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
