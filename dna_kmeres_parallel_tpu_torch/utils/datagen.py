"""Synthetic FASTA generation for benchmarks and large-scale tests: the
port's copy of the JAX package's ``utils/datagen.py`` (the same seed
writes the same bytes)."""

from __future__ import annotations

import numpy as np

_ALPHABET = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_fasta(
    path: str,
    n_seqs: int,
    seq_len: int | tuple[int, int],
    seed: int = 0,
    line_width: int = 80,
    invalid_frac: float = 0.0,
) -> int:
    """Write a random FASTA file; returns total bases written.

    seq_len: fixed length or (lo, hi) uniform range.
    """
    rng = np.random.default_rng(seed)
    total = 0
    with open(path, "wb") as f:
        for i in range(n_seqs):
            if isinstance(seq_len, tuple):
                L = int(rng.integers(seq_len[0], seq_len[1] + 1))
            else:
                L = seq_len
            seq = _ALPHABET[rng.integers(0, 4, size=L)]
            if invalid_frac > 0:
                mask = rng.random(L) < invalid_frac
                seq = np.where(mask, np.uint8(ord("N")), seq)
            f.write(b">seq%d synthetic\n" % i)
            for off in range(0, L, line_width):
                f.write(seq[off : off + line_width].tobytes())
                f.write(b"\n")
            f.write(b"\n")
            total += L
    return total


def realistic_fasta(
    path: str,
    genome_len: int = 100_000,
    coverage: float = 30.0,
    read_len: int = 150,
    repeat_unit: int = 311,
    repeat_copies: int = 20,
    n_run_rate: float = 0.002,
    n_run_len: int = 12,
    lowercase_frac: float = 0.05,
    seed: int = 0,
) -> int:
    """Write a sequencing-shaped FASTA: reads sampled at ``coverage``x
    from one synthetic genome. Returns total bases written.

    What uniform random bases lack: coverage duplication (most k-mers
    repeat), ``repeat_copies`` copies of one ``repeat_unit``-base element
    planted in the genome (shared minimizers concentrate their windows on
    few bucket owners), geometric bursts of 'N' inside reads, and
    soft-masked (lowercase, so invalid) spans.
    """
    rng = np.random.default_rng(seed)
    genome = _ALPHABET[rng.integers(0, 4, size=genome_len)]
    unit = _ALPHABET[rng.integers(0, 4, size=repeat_unit)]
    for _ in range(repeat_copies):
        at = int(rng.integers(0, max(genome_len - repeat_unit, 1)))
        genome[at : at + repeat_unit] = unit[: genome_len - at]
    n_reads = max(int(coverage * genome_len / read_len), 1)
    total = 0
    with open(path, "wb") as f:
        for i in range(n_reads):
            start = int(rng.integers(0, max(genome_len - read_len, 1)))
            read = genome[start : start + read_len].copy()
            L = read.shape[0]
            # N bursts (sequencer dropouts), geometric-ish length.
            j = 0
            while j < L:
                if rng.random() < n_run_rate:
                    run = 1 + int(rng.geometric(1.0 / max(n_run_len, 1)))
                    read[j : j + run] = np.uint8(ord("N"))
                    j += run
                j += 1
            # Soft-masked (lowercase) span.
            if rng.random() < lowercase_frac and L > 20:
                a = int(rng.integers(0, L - 10))
                b = min(a + int(rng.integers(5, 30)), L)
                read[a:b] = read[a:b] + 32  # ACGT -> acgt (N -> n)
            f.write(b">read%d pos=%d\n" % (i, start))
            f.write(read.tobytes())
            f.write(b"\n")
            total += L
    return total
