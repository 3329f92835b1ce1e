"""The port's sparse counting engine (CPU route: the kernel's plain
version) against the JAX engine in Pallas interpret mode and the oracle.

Integer tables: every comparison is exact (tolerance zero)."""

import numpy as np
import pytest

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu import native
from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.models.sparse_engine import (
    SparseKmerEngine as JaxSparseKmerEngine,
)
from dna_kmeres_parallel_tpu.utils import datagen, fasta
from dna_kmeres_parallel_tpu.utils.config import KmerConfig
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
    PHASES,
    MergeLadder,
    SparseKmerEngine,
    batch_plan,
)


def seqs_for(k: int) -> list[str]:
    """Three N-rich sequences, about 4.7 kbase: three 2048-base batches,
    so every batch edge carries a k-1 base halo."""
    rng = np.random.default_rng(100 + k)
    alphabet = np.array(list("ACGTN"))
    out = []
    for n in (1100, 1500, 2100):
        s = alphabet[rng.choice(5, size=n, p=[0.24, 0.24, 0.24, 0.24, 0.04])]
        out.append("".join(s))
    return out


@pytest.mark.parametrize(
    "k,canonical", [(13, False), (21, False), (31, False), (11, True), (21, True)]
)
def test_engine_matches_jax_engine_and_oracle(k, canonical, monkeypatch):
    monkeypatch.setenv("KMER_TPU_PALLAS_INTERPRET", "1")
    seqs = seqs_for(k)
    cfg = KmerConfig(k=k, canonical=canonical, batch_bases=2048)
    got = SparseKmerEngine(cfg, device="cpu").count_sequences(seqs)
    ref = JaxSparseKmerEngine(cfg).count_sequences(seqs)
    total = sum(len(s) for s in seqs) + len(seqs) - 1
    assert -(-total // batch_plan(total, k, cfg.batch_bases)[0]) == 3
    assert got.codes.dtype == np.uint64 and got.counts.dtype == np.int64
    assert np.array_equal(got.codes, ref.codes)
    assert np.array_equal(got.counts, ref.counts)
    assert (got.n_seqs, got.total_bases) == (ref.n_seqs, ref.total_bases)
    assert got.table() == oracle.count_table_any_k(seqs, k, canonical)
    assert set(got.phases) == set(PHASES)


@pytest.mark.parametrize("k,canonical", [(21, False), (17, True)])
def test_count_file_native_parser(tmp_path, k, canonical):
    path = tmp_path / "in.fasta"
    datagen.random_fasta(str(path), 5, (300, 900), seed=k, invalid_frac=0.02)
    res = port.count_file(
        str(path), k=k, canonical=canonical, device="cpu", batch_bases=1024
    )
    seqs = [r.seq for r in fasta.parse_fasta(str(path))]
    assert res.table() == oracle.count_table_any_k(seqs, k, canonical)
    parsed = native.parse_fasta_native(str(path))
    codes, counts = native.count_sparse_host_native(parsed.stream, k, canonical)
    assert np.array_equal(res.codes, codes) and np.array_equal(res.counts, counts)
    assert res.n_seqs == 5 and res.phases["parse"] >= 0.0


def test_count_sequences_short_and_empty_streams():
    for seqs in ([], ["ACGT"], ["ACGTNACGTACGTACGTACGTACGTACGTAC"]):
        res = port.count_sequences(seqs, k=21, device="cpu")
        assert res.table() == oracle.count_table_any_k(seqs, 21)


@pytest.mark.parametrize(
    "kw", [{"device_sort": True}, {"compact": "host"}, {"compact": "device-rle"}]
)
def test_unported_routes_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SparseKmerEngine(KmerConfig(k=21, **kw), device="cpu")


def test_merge_ladder_sums_counts_across_runs():
    rng = np.random.default_rng(5)
    ladder = MergeLadder(buffer_max=2)
    want: dict[int, int] = {}
    for _ in range(7):
        codes = np.unique(rng.integers(0, 500, 120).astype(np.uint64))
        counts = rng.integers(1, 9, codes.shape[0]).astype(np.int64)
        for c, n in zip(codes.tolist(), counts.tolist()):
            want[c] = want.get(c, 0) + n
        ladder.push((codes, counts))
    ladder.push((np.zeros(0, np.uint64), np.zeros(0, np.int64)))
    codes, counts = ladder.result()
    assert codes.tolist() == sorted(want)
    assert counts.tolist() == [want[c] for c in sorted(want)]
