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


@pytest.mark.parametrize("kw", [{"compact": "device-super"}])
def test_unported_routes_raise(tmp_path, kw):
    # The compact modes belong to the streaming counter, which refuses the
    # unported one.
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    cfg = port.KmerConfig(k=21, **kw)
    path = tmp_path / "in.fasta"
    fasta.write_fasta(path, [(">r", "ACGT" * 30)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamingCounter(cfg, device="cpu").run(str(path))


@pytest.mark.parametrize("compact", ["auto", "device", "host", "device-rle", "device-super"])
def test_engine_ignores_compact(tmp_path, compact):
    # compact belongs to the streaming counter: the one-shot engine counts
    # the same table whatever it says, as the JAX engine does.
    path = tmp_path / "in.fasta"
    datagen.random_fasta(str(path), 4, (300, 700), seed=3, invalid_frac=0.02)
    got = port.count_file(str(path), k=21, compact=compact, device="cpu", batch_bases=512)
    ref = JaxSparseKmerEngine(KmerConfig(k=21, compact=compact, batch_bases=512)).count_file(
        str(path)
    )
    assert np.array_equal(got.codes, ref.codes) and np.array_equal(got.counts, ref.counts)


@pytest.fixture
def encoder_calls(monkeypatch):
    """Count the calls of the two encode entries of ``ops/sparse``: the u8
    stream's (K9) and the planes' (K1)."""
    from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

    calls = {"encode_words": 0, "encode_words_planes": 0}
    for name in calls:
        real = getattr(sparse_ops, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(sparse_ops, name, counted)
    return calls


@pytest.mark.parametrize("pack_input", [True, False])
@pytest.mark.parametrize("k,canonical", [(21, False), (13, True), (31, True)])
def test_pack_input_picks_the_encoder(monkeypatch, encoder_calls, k, canonical, pack_input):
    # pack_input=False ships the padded u8 batch and encodes it with K9, as
    # the JAX engine does; pack_input=True ships planes to K1.
    monkeypatch.setenv("KMER_TPU_PALLAS_INTERPRET", "1")
    seqs = seqs_for(k)
    cfg = KmerConfig(k=k, canonical=canonical, batch_bases=2048, pack_input=pack_input)
    got = SparseKmerEngine(cfg, device="cpu").count_sequences(seqs)
    ref = JaxSparseKmerEngine(cfg).count_sequences(seqs)
    assert np.array_equal(got.codes, ref.codes) and np.array_equal(got.counts, ref.counts)
    used = "encode_words_planes" if pack_input else "encode_words"
    assert encoder_calls == {**dict.fromkeys(encoder_calls, 0), used: 3}


@pytest.mark.parametrize("pack_input", [True, False])
def test_dense_k10_via_sparse_picks_the_encoder(encoder_calls, pack_input):
    # k = 9..12 count through the sparse engine: with pack_input=False
    # that is K9 too.
    seqs = seqs_for(10)
    res = port.count_sequences(seqs, k=10, device="cpu", pack_input=pack_input,
                               batch_bases=2048)
    want = sum(oracle.count_vector(s, 10).astype(np.int64) for s in seqs)
    assert np.array_equal(res.hist, want)
    used = "encode_words_planes" if pack_input else "encode_words"
    assert encoder_calls == {**dict.fromkeys(encoder_calls, 0), used: 3}


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
