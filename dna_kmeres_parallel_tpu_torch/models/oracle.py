"""The NumPy golden engine: exact reference semantics, the oracle the
port's ``selftest`` holds its engines against.

The port's copy of the JAX package's ``models/oracle.py``. Its contract
is the reference's CPU engine's:

1. k-mer codes are big-endian 2-bit codes, A=0, C=1, G=2, T=3
   (lexicographic order);
2. a sequence of length L has L - k + 1 windows;
3. a window holding a character outside {A, C, G, T} is neither counted
   nor part of a distance;
4. D(i, j) = 1 - sum_p min(cnt_i[p], cnt_j[p]) / (min(L_i, L_j) - k + 1),
   in float32;
5. distances are packed as the strict upper triangle, row-major.
"""

from __future__ import annotations

import numpy as np

from dna_kmeres_parallel_tpu_torch.utils import codec
from dna_kmeres_parallel_tpu_torch.utils.triangular import packed_index, packed_size


def count_vector(seq: str | np.ndarray, k: int, canonical: bool = False) -> np.ndarray:
    """Exact dense count vector [4^k] (int64) for one sequence.

    Bucket ``c`` counts windows whose canonical big-endian code is ``c``.
    Invalid-character windows are excluded entirely (contract point 3).
    With ``canonical=True``, reverse complements are folded:
    bucket = min(code, revcomp(code)) — a new capability, not in the reference.
    """
    bases = codec.encode_bases(seq) if isinstance(seq, str) else np.asarray(seq)
    codes, valid = codec.kmer_codes(bases, k)
    if canonical:
        codes = codec.canonical_code(codes, k)
    hist = np.zeros(codec.num_bins(k), dtype=np.int64)
    np.add.at(hist, codes[valid], 1)
    return hist


def counts_matrix(seqs: list[str], k: int, canonical: bool = False) -> np.ndarray:
    """[n_seqs, 4^k] int64 count matrix."""
    return np.stack([count_vector(s, k, canonical) for s in seqs], axis=0)


def count_table(seqs: list[str], k: int, canonical: bool = False) -> dict[str, int]:
    """Aggregate counts over all sequences, keyed by k-mer string.

    This is the order-free representation used for cross-engine parity checks
    (robust to any internal bucket-layout choice, including the reference's
    little-endian one)."""
    total = np.zeros(codec.num_bins(k), dtype=np.int64)
    for s in seqs:
        total += count_vector(s, k, canonical)
    return {
        codec.code_to_kmer(c, k): int(total[c]) for c in np.nonzero(total)[0]
    }


def count_table_any_k(
    seqs: list[str], k: int, canonical: bool = False
) -> dict[str, int]:
    """Naive dict-based aggregate counter valid for ANY k (including k > 15
    where dense vectors are impossible) — the oracle for the sparse engine."""
    table: dict[str, int] = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i : i + k]
            if any(ch not in "ACGT" for ch in w):
                continue
            if canonical:
                w = min(w, codec.revcomp_str(w))
            table[w] = table.get(w, 0) + 1
    return table


def distance_pair(cnt_i, cnt_j, len_i: int, len_j: int, k: int) -> np.float32:
    """Reference distance formula in float32 (contract point 4)."""
    s = np.int64(np.minimum(cnt_i, cnt_j).sum())
    denom = min(len_i, len_j) - k + 1
    return np.float32(1.0) - np.float32(s) / np.float32(denom)


def distance_matrix_packed(
    seqs: list[str], k: int, canonical: bool = False
) -> np.ndarray:
    """Packed strict-upper-triangle float32 distance vector (contract 4+5)."""
    n = len(seqs)
    counts = counts_matrix(seqs, k, canonical)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    out = np.zeros(packed_size(n), dtype=np.float32)
    for i in range(n - 1):
        # Vectorized over j for speed; float32 math matches the scalar formula.
        js = np.arange(i + 1, n)
        sums = np.minimum(counts[i][None, :], counts[js]).sum(axis=1)
        denoms = (np.minimum(lengths[i], lengths[js]) - k + 1).astype(np.float32)
        d = np.float32(1.0) - sums.astype(np.float32) / denoms
        out[packed_index(i, js, n)] = d
    return out


def naive_count_vector(seq: str, k: int) -> np.ndarray:
    """Independent O(L*k) dict-based counter used to cross-check count_vector
    (two different implementations of the same contract)."""
    hist = np.zeros(codec.num_bins(k), dtype=np.int64)
    for i in range(len(seq) - k + 1):
        window = seq[i : i + k]
        if any(ch not in "ACGT" for ch in window):
            continue
        hist[codec.kmer_to_code(window)] += 1
    return hist


def distance_matrix_packed_sparse(
    seqs: list[str], k: int, canonical: bool = False
) -> np.ndarray:
    """Packed float32 distance vector for ANY k via per-sequence dict
    tables (the oracle twin of sparse_engine.distance_sparse_packed —
    k > 15 where the dense counts matrix of distance_matrix_packed is
    impossible). Same float32 finish as contract point 4."""
    n = len(seqs)
    tables = [count_table_any_k([s], k, canonical) for s in seqs]
    lengths = [len(s) for s in seqs]
    out = np.zeros(packed_size(n), dtype=np.float32)
    w = 0
    for i in range(n - 1):
        ti = tables[i]
        for j in range(i + 1, n):
            tj = tables[j]
            small, big = (ti, tj) if len(ti) <= len(tj) else (tj, ti)
            s = sum(min(c, big.get(km, 0)) for km, c in small.items())
            denom = min(lengths[i], lengths[j]) - k + 1
            out[w] = np.float32(1.0) - np.float32(s) / np.float32(denom)
            w += 1
    return out
