"""The port's multi-host layer (``parallel/multihost``) in one process:
byte ranges, the native range parser, the global stream, the dense and
bucketed resumable counts and the row-sharded distances, on
``LocalMesh(D, "cpu")`` against the JAX package's ``parallel/multihost``
on its virtual CPU mesh of the same D, on the same seeded files.

Histograms, tables, byte ranges and CSV bytes: the tolerance is zero."""

import gzip
import os

import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu import native as jnative
from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.parallel import multihost as jmh
from dna_kmeres_parallel_tpu.parallel import sharded_count as jsc
from dna_kmeres_parallel_tpu.parallel.mesh import make_mesh as jax_mesh
from dna_kmeres_parallel_tpu.utils import checkpoint as jckpt
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig, native
from dna_kmeres_parallel_tpu_torch.models import sparse_engine
from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine
from dna_kmeres_parallel_tpu_torch.parallel import bucketed, multihost, sharded_count
from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh
from dna_kmeres_parallel_tpu_torch.utils import fasta


def dna(rng, n: int, invalid: float = 0.01) -> str:
    out = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    out = np.where(rng.random(n) < invalid, np.uint8(ord("N")), out)
    return out.tobytes().decode()


def seeded_records(seed: int, n: int, lo: int, spread: int) -> list[tuple[str, str]]:
    rng = np.random.default_rng(seed)
    return [(f">r{i} h", dna(rng, lo + (i * 91) % spread)) for i in range(n)]


@pytest.fixture(scope="module")
def big_fasta(tmp_path_factory):
    # tests/test_multihost.py's big_fasta: 40 records of 200-600 bases,
    # width 73, from a seed.
    records = seeded_records(15, 40, 200, 400)
    path = tmp_path_factory.mktemp("mh") / "multi.fasta"
    fasta.write_fasta(path, records, width=73)
    return str(path), [s for _, s in records]


@pytest.fixture(scope="module")
def tiny_fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("mh") / "tiny.fasta"
    fasta.write_fasta(path, [(">a", "ACGTACGTTGCA")])
    return str(path)


@pytest.fixture(scope="module")
def straddle_fasta(tmp_path_factory):
    # Two records on one line each, sized so that the 2-part split's first
    # 1 MiB read ends on the '\n' of "\n>b": the '>' is the next read's
    # first byte, seen only through the 1-byte overlap.
    n2 = 1000
    n1 = (1 << 21) + n2 - 2
    path = tmp_path_factory.mktemp("mh") / "straddle.fasta"
    path.write_text(">a\n" + "A" * n1 + "\n>b\n" + "C" * n2 + "\n")
    size = path.stat().st_size
    assert 3 + n1 == size // 2 - 1 + (1 << 20) - 1  # the '\n' ends the first read
    return str(path)


@pytest.fixture(scope="module")
def mesh8():
    return LocalMesh(8, "cpu")


@pytest.fixture(scope="module")
def jmesh8():
    return jax_mesh(8)


def files(big_fasta, tiny_fasta, straddle_fasta):
    return {"big": big_fasta[0], "tiny": tiny_fasta, "straddle": straddle_fasta}


@pytest.mark.parametrize("name", ["big", "tiny", "straddle"])
@pytest.mark.parametrize("n_parts", [1, 2, 3, 5, 8])
def test_byte_ranges_equal_jax(big_fasta, tiny_fasta, straddle_fasta, name, n_parts):
    path = files(big_fasta, tiny_fasta, straddle_fasta)[name]
    got = multihost.split_fasta_byte_ranges(path, n_parts)
    assert got == jmh.split_fasta_byte_ranges(path, n_parts)
    assert len(got) == n_parts and got[0][0] == 0 and got[-1][1] == os.path.getsize(path)
    assert all(b1 == a2 for (_, b1), (a2, _) in zip(got[:-1], got[1:]))
    if name == "straddle" and n_parts == 2:
        assert got[0][1] == (1 << 21) + 1002  # the '>' of the second record


def same_parse(got, want) -> bool:
    return (got.n_seqs == want.n_seqs and got.ids == want.ids
            and got.total_bases == want.total_bases and got.invalid_bases == want.invalid_bases
            and np.array_equal(got.stream, want.stream)
            and np.array_equal(got.offsets, want.offsets)
            and np.array_equal(got.lengths, want.lengths))


@pytest.mark.parametrize("name", ["big", "tiny", "straddle"])
@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_native_range_parse_equals_jax(big_fasta, tiny_fasta, straddle_fasta, name, n_parts):
    path = files(big_fasta, tiny_fasta, straddle_fasta)[name]
    n_seqs = 0
    for a, b in multihost.split_fasta_byte_ranges(path, n_parts):
        got = native.parse_fasta_native(path, byte_range=(a, b))
        assert same_parse(got, jnative.parse_fasta_native(path, byte_range=(a, b)))
        stream, total, n = multihost.encode_range_stream(path, a, b)
        want = jmh.encode_range_stream(path, a, b)
        assert np.array_equal(stream, want[0]) and (total, n) == want[1:]
        assert [(r.id, r.seq) for r in multihost.read_range_records(path, a, b)] == [
            (r.id, r.seq) for r in jmh.read_range_records(path, a, b)]
        n_seqs += got.n_seqs
    assert n_seqs == native.parse_fasta_native(path).n_seqs


def test_fastq_and_gzip_ranges(tmp_path):
    rng = np.random.default_rng(16)
    reads = [dna(rng, 50 + 7 * i) for i in range(6)]
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@q{i}\n{s}\n+\n{'@' * len(s)}\n" for i, s in enumerate(reads)))
    whole = native.parse_fasta_native(fq, byte_range=(0, -1))
    assert same_parse(whole, native.parse_fasta_native(fq))
    assert same_parse(whole, jnative.parse_fasta_native(str(fq), byte_range=(0, -1)))
    assert whole.n_seqs == 6 and whole.total_bases == sum(map(len, reads))
    gz = tmp_path / "r.fasta.gz"
    with gzip.open(gz, "wt") as f:
        f.write("".join(f">s{i}\n{s}\n" for i, s in enumerate(reads)))
    assert native.parse_fasta_native(gz, byte_range=(0, -1)).n_seqs == 6
    for rng_ in ((0, 40), (10, -1)):
        with pytest.raises(ValueError, match="gzip"):
            native.parse_fasta_native(gz, byte_range=rng_)
        with pytest.raises(IOError, match="code 3"):
            jnative.parse_fasta_native(str(gz), byte_range=rng_)


def test_make_global_stream_on_a_local_mesh(big_fasta):
    flat = multihost.encode_range_stream(big_fasta[0], 0, 1000)[0]
    rows = multihost.make_global_stream(flat, LocalMesh(3, "cpu"))
    assert rows.shape == (3, -(-flat.size // 3)) and rows.dtype == torch.uint8
    assert np.array_equal(rows.numpy().reshape(-1)[: flat.size], flat)
    assert (rows.numpy().reshape(-1)[flat.size :] == 0xFF).all()


def test_init_distributed_one_process_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.init_distributed(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.init_distributed(device="cpu")
    if not torch.cuda.is_available():
        # the default is the card, and the port never carries on without one
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.init_distributed()


def want_hist(seqs, k, canonical, bins=None):
    return sum((oracle.count_vector(s, k, canonical) for s in seqs),
               np.zeros(bins or 4**k, np.int64))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_count_file_multihost_equals_jax(big_fasta, mesh8, jmesh8, k, canonical):
    path, seqs = big_fasta
    got = multihost.count_file_multihost(path, KmerConfig(k=k, canonical=canonical), mesh8)
    want = jmh.count_file_multihost(path, JaxConfig(k=k, canonical=canonical), jmesh8)
    assert got[0].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert np.array_equal(got[0], want_hist(seqs, k, canonical))
    assert got[1:] == (sum(map(len, seqs)), len(seqs))


def test_global_stream_counts_3000_bins_like_jax(big_fasta, mesh8, jmesh8):
    # K8's plain version through count_sharded: a bin count that is not a
    # power of two.
    flat = multihost.encode_range_stream(big_fasta[0], 0, os.path.getsize(big_fasta[0]))[0]
    got = sharded_count.count_sharded(multihost.make_global_stream(flat, mesh8), 6, 3000,
                                      False, mesh8)
    want = jsc.count_sharded(jmh.make_global_stream(flat, jmesh8), 6, 3000, False, jmesh8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


def test_dense_resumable_stop_and_resume(big_fasta, mesh8, jmesh8, tmp_path):
    path, seqs = big_fasta
    cfg, ckpt, batch = KmerConfig(k=4), str(tmp_path / "mh"), 2048
    first = multihost.count_file_multihost_resumable(path, cfg, mesh8, checkpoint_path=ckpt,
                                                     batch_bases=batch, max_steps=2)
    assert first[3] == 2 and first[4] > 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["mh.p0.g0.npz", "mh.p0.g1.npz"]
    hist, total, n_seqs, done, n_steps = multihost.count_file_multihost_resumable(
        path, cfg, mesh8, checkpoint_path=ckpt, batch_bases=batch)
    assert done == n_steps and (total, n_seqs) == (sum(map(len, seqs)), len(seqs))
    want = jmh.count_file_multihost_resumable(path, JaxConfig(k=4), jmesh8, batch_bases=batch)
    assert np.array_equal(hist, want[0]) and np.array_equal(hist, want_hist(seqs, 4, False))
    one_shot = multihost.count_file_multihost_resumable(path, cfg, mesh8, batch_bases=batch)
    assert np.array_equal(one_shot[0], hist) and one_shot[3:] == (n_steps, n_steps)


def test_dense_resumable_ignores_stale_checkpoints(big_fasta, mesh8, tmp_path):
    # tests/test_multihost.py's stale cases: another k, then a batch that
    # does not divide the saved cursor, each a full recount.
    path, seqs = big_fasta
    ckpt = str(tmp_path / "mh2")
    multihost.count_file_multihost_resumable(path, KmerConfig(k=4), mesh8, checkpoint_path=ckpt,
                                             batch_bases=2048, max_steps=2)
    hist, *_ = multihost.count_file_multihost_resumable(path, KmerConfig(k=5), mesh8,
                                                        checkpoint_path=ckpt, batch_bases=2048)
    assert np.array_equal(hist, want_hist(seqs, 5, False))
    hist, *_ = multihost.count_file_multihost_resumable(path, KmerConfig(k=4), mesh8,
                                                        checkpoint_path=ckpt, batch_bases=1500)
    assert np.array_equal(hist, want_hist(seqs, 4, False))


def test_jax_checkpoint_resumes_in_the_port(big_fasta, mesh8, jmesh8, tmp_path):
    path, seqs = big_fasta
    ckpt, batch = str(tmp_path / "jx"), 2048
    jmh.count_file_multihost_resumable(path, JaxConfig(k=4, canonical=True), jmesh8,
                                       checkpoint_path=ckpt, batch_bases=batch, max_steps=2)
    saved = jckpt.load_checkpoint(f"{ckpt}.p0.g0.npz")
    assert saved.cursor == 2 * batch
    hist, _, _, done, n_steps = multihost.count_file_multihost_resumable(
        path, KmerConfig(k=4, canonical=True), mesh8, checkpoint_path=ckpt, batch_bases=batch,
        max_steps=1)
    assert done == 3 < n_steps  # resumed after the JAX run's second step
    hist, *_ = multihost.count_file_multihost_resumable(
        path, KmerConfig(k=4, canonical=True), mesh8, checkpoint_path=ckpt, batch_bases=batch)
    assert np.array_equal(hist, want_hist(seqs, 4, True))


def test_dense_resumable_refuses_sparse_k(big_fasta, mesh8):
    with pytest.raises(ValueError, match="dense-histogram path"):
        multihost.count_file_multihost_resumable(big_fasta[0], KmerConfig(k=13), mesh8)


@pytest.mark.parametrize("k,owner_mode", [(21, "prefix"), (31, "minimizer")])
def test_bucketed_resumable_equals_jax(big_fasta, tmp_path, k, owner_mode):
    path, seqs = big_fasta
    mesh, batch, ckpt = LocalMesh(4, "cpu"), 2048, str(tmp_path / "b")
    first = multihost.count_file_bucketed_multihost_resumable(
        path, KmerConfig(k=k), mesh, checkpoint_path=ckpt, batch_bases=batch, max_steps=2,
        owner_mode=owner_mode)
    assert first[4] == 2 and first[5] > 2
    codes, counts, total, n_seqs, done, n_steps = (
        multihost.count_file_bucketed_multihost_resumable(
            path, KmerConfig(k=k), mesh, checkpoint_path=ckpt, batch_bases=batch,
            owner_mode=owner_mode))
    assert done == n_steps and (total, n_seqs) == (sum(map(len, seqs)), len(seqs))
    want = jmh.count_file_bucketed_multihost_resumable(
        path, JaxConfig(k=k), jax_mesh(4), batch_bases=batch, owner_mode=owner_mode)
    assert np.array_equal(codes, want[0]) and np.array_equal(counts, want[1])
    table = oracle.count_table_any_k(seqs, k)
    assert len(codes) == len(table) and int(counts.sum()) == sum(table.values())


def test_shard_rows_of_a_sharded_operand():
    mesh = LocalMesh(4, "cpu")
    a = np.arange(8).reshape(4, 2)
    assert bucketed._shard_row(a, 2, mesh).tolist() == [4, 5]
    with pytest.raises(ValueError, match="3 rows on a mesh of 4 shards"):
        bucketed._shard_row(a[:3], 2, mesh)


def write_records(path, records):
    fasta.write_fasta(path, records, width=60)
    return [s for _, s in records]


@pytest.mark.parametrize("k", [3, 21])
def test_distances_equal_jax_and_the_single_process_stream(tmp_path, k):
    seqs = write_records(tmp_path / "d.fasta", seeded_records(17, 12, 90, 130))
    path = str(tmp_path / "d.fasta")
    out = tmp_path / "d.csv"
    stopped = multihost.distance_file_multihost_resumable(
        path, KmerConfig(k=k), str(out), str(tmp_path / "ck"), panel_rows=4, max_panels=1,
        device="cpu")
    assert not stopped["completed"] and not stopped["all_complete"] and not out.exists()
    report = multihost.distance_file_multihost_resumable(
        path, KmerConfig(k=k), str(out), str(tmp_path / "ck"), panel_rows=4, device="cpu")
    assert report["all_complete"] and report["rows"] == [0, len(seqs) - 1]
    assert report["regime"] == ("dense" if k == 3 else "sparse")
    want = tmp_path / "jax.csv"
    jmh.distance_file_multihost_resumable(path, JaxConfig(k=k), str(want), panel_rows=4)
    assert out.read_bytes() == want.read_bytes()
    single = tmp_path / "single.csv"
    if k == 3:
        KmerEngine(KmerConfig(k=k), device="cpu").distance_stream_to_csv(seqs, single,
                                                                       panel_rows=4)
    else:
        sparse_engine.distance_sparse_stream_to_csv(seqs, k, single, panel_rows=4,
                                                    device="cpu")
    assert out.read_bytes() == single.read_bytes()
