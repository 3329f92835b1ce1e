"""The port's NumPy oracle, data generator, codec, table I/O and FASTA
helpers against the JAX package's, bit for bit on seeded random inputs;
and the port's ``SparseCountResult.count_of`` and
``KmerEngine.verify_against_oracle``."""

import numpy as np
import pytest

from dna_kmeres_parallel_tpu.models import oracle as jax_oracle
from dna_kmeres_parallel_tpu.models.sparse_engine import SparseCountResult as JaxSparseResult
from dna_kmeres_parallel_tpu.utils import codec as jax_codec
from dna_kmeres_parallel_tpu.utils import datagen as jax_datagen
from dna_kmeres_parallel_tpu.utils import fasta as jax_fasta
from dna_kmeres_parallel_tpu.utils import io as jax_io
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.models import oracle
from dna_kmeres_parallel_tpu_torch.models.engine import CountResult, KmerEngine
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseCountResult, SparseKmerEngine
from dna_kmeres_parallel_tpu_torch.utils import codec, datagen, fasta, io


def random_seqs(seed: int, n: int = 6):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTNacgt", np.uint8)
    out = []
    for _ in range(n):
        L = int(rng.integers(0, 300))
        p = np.array([0.24, 0.24, 0.24, 0.24, 0.02, 0.005, 0.005, 0.005, 0.005])
        out.append(letters[rng.choice(9, L, p=p)].tobytes().decode())
    return out


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_dense_oracle_matches_jax(seed, canonical, k):
    seqs = random_seqs(seed)
    for s in seqs:
        assert same(oracle.count_vector(s, k, canonical), jax_oracle.count_vector(s, k, canonical))
        assert same(oracle.naive_count_vector(s, k), jax_oracle.naive_count_vector(s, k))
    assert same(oracle.counts_matrix(seqs, k, canonical),
                jax_oracle.counts_matrix(seqs, k, canonical))
    assert oracle.count_table(seqs, k, canonical) == jax_oracle.count_table(seqs, k, canonical)
    assert same(oracle.distance_matrix_packed(seqs, k, canonical),
                jax_oracle.distance_matrix_packed(seqs, k, canonical))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [2, 9, 16, 21, 31])
def test_sparse_oracle_matches_jax(seed, canonical, k):
    seqs = random_seqs(100 + seed)
    assert oracle.count_table_any_k(seqs, k, canonical) == (
        jax_oracle.count_table_any_k(seqs, k, canonical))
    assert same(oracle.distance_matrix_packed_sparse(seqs, k, canonical),
                jax_oracle.distance_matrix_packed_sparse(seqs, k, canonical))


def test_distance_pair_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(50):
        a, b = rng.integers(0, 9, (2, 64))
        la, lb = rng.integers(10, 500, 2)
        assert same(oracle.distance_pair(a, b, la, lb, 3),
                    jax_oracle.distance_pair(a, b, la, lb, 3))


@pytest.mark.parametrize("kw", [
    {"n_seqs": 7, "seq_len": 333, "seed": 1},
    {"n_seqs": 5, "seq_len": (0, 500), "seed": 2, "invalid_frac": 0.05, "line_width": 61},
])
def test_random_fasta_bytes_match_jax(tmp_path, kw):
    a, b = tmp_path / "a.fa", tmp_path / "b.fa"
    assert datagen.random_fasta(str(a), **kw) == jax_datagen.random_fasta(str(b), **kw)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("kw", [
    {"genome_len": 5000, "coverage": 3.0, "seed": 4},
    {"genome_len": 3000, "coverage": 2.0, "read_len": 101, "n_run_rate": 0.02,
     "lowercase_frac": 0.5, "repeat_copies": 5, "seed": 9},
])
def test_realistic_fasta_bytes_match_jax(tmp_path, kw):
    a, b = tmp_path / "a.fa", tmp_path / "b.fa"
    assert datagen.realistic_fasta(str(a), **kw) == jax_datagen.realistic_fasta(str(b), **kw)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("k", [1, 4, 11, 16, 21, 31])
def test_codec_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), 200, dtype=np.int64)
    assert codec.num_bins(k) == jax_codec.num_bins(k)
    assert same(codec.revcomp_code(codes, k), jax_codec.revcomp_code(codes, k))
    assert same(codec.canonical_code(codes, k), jax_codec.canonical_code(codes, k))
    for c in codes[:20].tolist():
        kmer = codec.code_to_kmer(c, k)
        assert kmer == jax_codec.code_to_kmer(c, k)
        assert codec.kmer_to_code(kmer) == jax_codec.kmer_to_code(kmer) == c
        assert codec.revcomp_str(kmer) == jax_codec.revcomp_str(kmer)
        assert codec.revcomp_code(c, k) == jax_codec.revcomp_code(c, k)
        assert codec.canonical_code(c, k) == jax_codec.canonical_code(c, k)
    bases = rng.integers(0, 6, 300).astype(np.uint8)
    bases[bases >= 4] = codec.INVALID_BASE
    for got, want in zip(codec.kmer_codes(bases, k), jax_codec.kmer_codes(bases, k)):
        assert same(got, want)
    assert codec.decode_bases(bases) == jax_codec.decode_bases(bases)
    assert codec.INVALID_BASE == jax_codec.INVALID_BASE
    if k <= 4:
        assert codec.all_kmers(k) == jax_codec.all_kmers(k)
    with pytest.raises(ValueError):
        codec.kmer_to_code("ACGN")
    with pytest.raises(ValueError):
        codec.all_kmers(13)


def _results(k, canonical, codes, counts):
    return (SparseCountResult(k=k, canonical=canonical, codes=codes, counts=counts,
                              n_seqs=0, total_bases=0),
            JaxSparseResult(k=k, canonical=canonical, codes=codes, counts=counts,
                            n_seqs=0, total_bases=0))


@pytest.mark.parametrize("size", [10, 1 << 20])
def test_count_npz_loads_in_either_package(tmp_path, size):
    # A small table is compressed, a large one is not: each file written
    # by one package reads back equal in the other.
    rng = np.random.default_rng(size)
    codes = np.unique(rng.integers(0, 1 << 42, size, dtype=np.uint64))
    counts = rng.integers(1, 100, codes.size).astype(np.int64)
    port, jax = _results(21, True, codes, counts)
    io.write_count_npz(tmp_path / "p.npz", port)
    jax_io.write_count_npz(tmp_path / "j.npz", jax)
    for path in ("p.npz", "j.npz"):
        for reader in (io.read_count_npz, jax_io.read_count_npz):
            k, canonical, c, n = reader(tmp_path / path)
            assert (k, canonical) == (21, True) and same(c, codes) and same(n, counts)
    hist = rng.integers(0, 3, 256).astype(np.int64)
    io.write_count_npz(tmp_path / "h.npz", CountResult(k=4, canonical=False, hist=hist,
                                                       n_seqs=0, total_bases=0))
    got, want = io.read_count_npz(tmp_path / "h.npz"), jax_io.read_count_npz(tmp_path / "h.npz")
    assert got[:2] == want[:2] and same(got[2], want[2]) and same(got[3], want[3])


def test_writers_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    packed = rng.random(45).astype(np.float32)
    table = {codec.code_to_kmer(int(c), 6): int(rng.integers(1, 9))
             for c in rng.integers(0, 4096, 50)}
    for name, port_fn, jax_fn, args in (
        ("d.csv", io.write_distances_csv, jax_io.write_distances_csv, (packed,)),
        ("m.tsv", io.write_min_distances_tsv, jax_io.write_min_distances_tsv, (packed, 10)),
        ("t.csv", io.write_count_table_csv, jax_io.write_count_table_csv, (table,)),
        ("r.json", io.write_report_json, jax_io.write_report_json,
         ({"k": 3, "x": [1, 2], "path": tmp_path},)),
    ):
        port_fn(tmp_path / f"p_{name}", *args)
        jax_fn(tmp_path / f"j_{name}", *args)
        assert (tmp_path / f"p_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
    assert same(io.read_distances_csv(tmp_path / "p_d.csv"),
                jax_io.read_distances_csv(tmp_path / "j_d.csv"))


def test_fasta_iter_and_write_match_jax(tmp_path):
    seqs = random_seqs(7, 9)
    records = [(f"r{i} x", s) for i, s in enumerate(seqs)]
    fasta.write_fasta(tmp_path / "p.fa", records, width=37)
    jax_fasta.write_fasta(tmp_path / "j.fa", records, width=37)
    raw = (tmp_path / "p.fa").read_bytes()
    assert raw == (tmp_path / "j.fa").read_bytes()
    for chunk in (1, 7, 64, 1 << 20):
        got = list(fasta.iter_fasta_records(str(tmp_path / "p.fa"), chunk_bytes=chunk))
        want = list(jax_fasta.iter_fasta_records(str(tmp_path / "p.fa"), chunk_bytes=chunk))
        assert [tuple(r) for r in got] == [tuple(r) for r in want]
        assert [tuple(r) for r in got] == [tuple(r) for r in fasta.parse_fasta(raw)]
    import gzip

    (tmp_path / "p.fa.gz").write_bytes(gzip.compress(raw))
    assert [tuple(r) for r in fasta.iter_fasta_records(str(tmp_path / "p.fa.gz"))] == [
        tuple(r) for r in fasta.parse_fasta(raw)]


@pytest.mark.parametrize("canonical", [False, True])
def test_count_of_matches_jax(canonical):
    seqs = random_seqs(11)
    res = SparseKmerEngine(KmerConfig(k=9, canonical=canonical), device="cpu").count_sequences(seqs)
    jax = JaxSparseResult(k=9, canonical=canonical, codes=res.codes, counts=res.counts,
                          n_seqs=0, total_bases=0)
    rng = np.random.default_rng(1)
    queries = [codec.code_to_kmer(int(c), 9) for c in res.codes[:30]]
    queries += [codec.code_to_kmer(int(c), 9) for c in rng.integers(0, 4**9, 30)]
    queries += [codec.revcomp_str(q) for q in queries[:30]]
    for q in queries:
        assert res.count_of(q) == jax.count_of(q), q
    table = oracle.count_table_any_k(seqs, 9, canonical)
    for q in queries[:30]:
        assert res.count_of(q) == table[q]


@pytest.mark.parametrize("k,canonical", [(1, False), (3, False), (5, True), (8, False)])
def test_verify_against_oracle(k, canonical):
    seqs = [s for s in random_seqs(20 + k, 5) if len(s) >= k]
    eng = KmerEngine(KmerConfig(k=k, canonical=canonical), device="cpu")
    verdict = eng.verify_against_oracle(seqs)
    assert verdict == {"counts_equal": True, "distances_equal": True, "n_seqs": len(seqs),
                       "total_kmers": sum(oracle.count_table_any_k(seqs, k, canonical).values())}
