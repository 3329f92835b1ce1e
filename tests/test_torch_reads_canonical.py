"""Canonical counting of a FASTQ read set on the CPU, at a small size of the
benchmark's ``count_k21c.reads30x`` traffic (a 20 kbase genome at 30x,
4,000 reads of 150 bases from ``benchmark/gen/reads.py``): the native
parse reads the generator's stream back, ``count_file`` gives the plain
reference's table row for row, the reference's strand fold is a naive
per-read count's, and the reads carry the strands, substitutions and
depth their parameters state."""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import dna_kmeres_parallel_tpu_torch as port  # noqa: E402
from benchmark.gen import reads  # noqa: E402
from benchmark.reference import kmers  # noqa: E402
from dna_kmeres_parallel_tpu_torch import native  # noqa: E402

PARAMS = dict(files=1, records=[4000, 4000], record_bases=[150, 150], genome_bases=20_000,
              coverage=30, minus_share=0.5, substitution_rate=0.0025, n_fraction=0.0002,
              format="fastq")
SEED = 2**33 + 21
R, L, G = 4000, 150, 20_000


@pytest.fixture(scope="module")
def read_set(tmp_path_factory):
    """The genome, the reads and where they came from, and the written
    file (the same seed's, so the two agree)."""
    genome, (made,), _ = reads.make_reads(PARAMS, SEED)
    (f,) = reads.generate(PARAMS, SEED, str(tmp_path_factory.mktemp("reads")))
    assert np.array_equal(f.records.stream, made.records.stream)
    return genome, made, f


def test_the_native_parse_reads_the_generators_stream(read_set):
    _, _, f = read_set
    parsed = native.parse_fasta_native(f.path)
    r = f.records
    assert parsed.n_seqs == r.lengths.size == R
    assert np.array_equal(parsed.stream, r.stream)
    assert np.array_equal(parsed.offsets[:-1], r.starts)
    assert np.array_equal(parsed.lengths, r.lengths)
    assert parsed.total_bases == r.bases == R * L
    quals = open(f.path, "rb").read().split(b"\n")[3::4]
    assert sum(q[:1] == b"@" for q in quals) > 0 and sum(q[:1] == b"+" for q in quals) > 0


@pytest.mark.parametrize("k, canonical", [(21, True), (31, True), (21, False)])
def test_count_file_is_the_reference_row_for_row(read_set, k, canonical):
    # batches of 128 kbase, so the merge adds the counts of keys that
    # repeat across batch tables, as at the cell's size
    _, _, f = read_set
    got = port.count_file(f.path, k=k, canonical=canonical, device="cpu",
                          batch_bases=1 << 17)
    codes, counts = kmers.reference_table(f.records.stream, k, canonical, "cpu")
    assert got.n_seqs == R and got.total_bases == R * L
    assert np.array_equal(got.codes, codes)
    assert np.array_equal(got.counts, counts)
    assert got.counts.dtype == np.int64 and counts.max() > 1


def naive_canonical(seqs, k: int) -> dict[int, int]:
    """min(code, reverse-complement code) of every window of k valid bases
    of each read, one window at a time."""
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    out = collections.Counter()
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i : i + k]
            if max(w) > 3:
                continue
            code = rc = 0
            for b in w:
                code = code * 4 + b
            for b in reversed(w):
                rc = rc * 4 + comp[b]
            out[min(code, rc)] += 1
    return dict(out)


@pytest.mark.parametrize("k", [21, 4])
def test_the_references_strand_fold_is_the_naive_counts(read_set, k):
    # k=4 holds palindromes (a k-mer its own reverse complement)
    _, made, _ = read_set
    r = made.records
    n = 200
    stream = r.stream[: r.starts[n - 1] + r.lengths[n - 1]]
    seqs = [stream[s : s + ln].tolist() for s, ln in zip(r.starts[:n], r.lengths[:n])]
    codes, counts = kmers.reference_table(stream, k, True, "cpu")
    assert dict(zip(codes.tolist(), counts.tolist())) == naive_canonical(seqs, k)


def bound(n: int, p: float, sd: float = 5.0) -> tuple[float, float]:
    """A binomial count's mean less and plus ``sd`` standard deviations."""
    mean, s = n * p, (n * p * (1 - p)) ** 0.5
    return mean - sd * s, mean + sd * s


@pytest.mark.parametrize("what", ["minus_strand", "substitutions", "depth"])
def test_the_reads_within_their_binomial_bounds(read_set, what):
    genome, made, _ = read_set
    rows = made.records.stream.tolist() + [255]
    rows = np.array(rows, np.uint8).reshape(R, L + 1)[:, :L]
    if what == "minus_strand":
        lo, hi = bound(R, 0.5)
        assert lo < made.minus.sum() < hi and 0 < made.minus.sum() < R
    elif what == "substitutions":
        # each read against its source: the plus strand's bases, or the
        # reverse complement of them
        src = genome[made.pos[:, None] + np.arange(L)]
        src = np.where(made.minus[:, None], 3 - src[:, ::-1], src)
        differ = (rows != src) & (rows < 4)
        n_sub = made.substituted.size
        lo, hi = bound(R * L, PARAMS["substitution_rate"])
        assert lo < n_sub < hi
        off = made.substituted - made.substituted // (L + 1)  # stream offset to base number
        assert np.array_equal(np.flatnonzero(differ), np.sort(off[rows.ravel()[off] < 4]))
        lo, hi = bound(R * L, PARAMS["n_fraction"])
        assert max(lo, 0) <= (rows > 3).sum() < hi
    else:
        depth = np.zeros(G + 1, np.int64)
        np.add.at(depth, made.pos, 1)
        np.add.at(depth, made.pos + L, -1)
        depth = np.cumsum(depth)[:G]
        assert depth.sum() == R * L  # 30x: every read lies inside the genome
        p = L / (G - L + 1)  # the chance that a read covers an inner base
        inner = depth[L : G - L]
        assert abs(inner.mean() / (R * p) - 1) < 0.03
        lo, hi = bound(R, p)
        assert lo < inner.min() and inner.max() < hi
        assert 0.6 < inner.var() / (R * p * (1 - p)) < 1.4
