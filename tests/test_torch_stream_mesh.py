"""The streaming counter's mesh arms and its super-k-mer route, on the
CPU, against the JAX package's ``StreamingCounter`` on its 8 virtual CPU
devices and against the oracle: the dense and sparse arms over
``mesh_shape=(8,)`` (each shard's kernel once a batch), a run stopped on a
mesh and resumed on one device and the reverse, ``compact="device-super"``
at k = 13, 21 and 31.

Integer counts: every comparison is exact (tolerance zero)."""

import numpy as np
import pytest

from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.models.pipeline import StreamingCounter as JaxStreamingCounter
from dna_kmeres_parallel_tpu.utils import fasta
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxKmerConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.models import pipeline
from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops


def counter(cfg: KmerConfig, **kw) -> pipeline.StreamingCounter:
    return pipeline.StreamingCounter(cfg, device="cpu", **kw)


def same_result(a, b) -> bool:
    if hasattr(a, "hist"):
        return a.hist.dtype == np.int64 and np.array_equal(a.hist, b.hist)
    return np.array_equal(a.codes, b.codes) and np.array_equal(a.counts, b.counts)


@pytest.fixture
def mesh_file(tmp_path, make_dna):
    # The JAX test's records: 4 of 300-423 bases, 2% N.
    records = [(f">r{i}", make_dna(300 + 41 * i, invalid_frac=0.02)) for i in range(4)]
    path = tmp_path / "mesh.fasta"
    fasta.write_fasta(path, records)
    return str(path), [s for _, s in records]


@pytest.fixture
def fasta_file(tmp_path, make_dna):
    records = [(f">r{i}", make_dna(400 + 31 * i, invalid_frac=0.02)) for i in range(6)]
    path = tmp_path / "in.fasta"
    fasta.write_fasta(path, records)
    return str(path), [s for _, s in records]


def calls(monkeypatch, module, name: str) -> dict:
    """Count the calls of ``module.name`` (a kernel's entry, its plain
    version here)."""
    seen = {"n": 0}
    real = getattr(module, name)

    def counted(*a, **kw):
        seen["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return seen


@pytest.mark.parametrize("k", [5, 9, 21])
def test_stream_mesh_dp_matches_single(mesh_file, k):
    # As JAX tests/test_pipeline.py::test_stream_mesh_dp_matches_single,
    # and against the JAX counter's own mesh result.
    path, _ = mesh_file
    single = counter(KmerConfig(k=k, batch_bases=512)).run(path)
    dp = counter(KmerConfig(k=k, batch_bases=512, mesh_shape=(8,))).run(path)
    jax_dp = JaxStreamingCounter(JaxKmerConfig(k=k, batch_bases=512, mesh_shape=(8,))).run(path)
    assert same_result(dp, single) and same_result(dp, jax_dp)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_dense_mesh_arm_counts_each_shard_once_a_batch(mesh_file, monkeypatch, k, canonical):
    # u8 shard rows, one histogram launch a shard and batch (K7 or K6 on
    # the card), whatever pack_input says, as the JAX mesh arm stages.
    path, seqs = mesh_file
    seen = calls(monkeypatch, histogram_cuda, "histogram_stream")
    planes = calls(monkeypatch, histogram_cuda, "histogram_planes")
    sc = counter(KmerConfig(k=k, canonical=canonical, batch_bases=256, mesh_shape=(8,)))
    got = sc.run(path)
    want = sum((oracle.count_vector(s, k, canonical) for s in seqs), np.zeros(4**k, np.int64))
    assert np.array_equal(got.hist, want)
    assert seen["n"] == 8 * sc.metrics.counters["batches"] and planes["n"] == 0


@pytest.mark.parametrize("device_sort", [None, True])
@pytest.mark.parametrize("pack_input", [True, False])
@pytest.mark.parametrize("k,canonical", [(13, True), (21, False)])
def test_sparse_mesh_arm_routes(mesh_file, monkeypatch, device_sort, pack_input, k, canonical):
    # The four sharded routes (K1 from planes, K9 from u8; row sorts with
    # device_sort, K11's plain version at k <= 15 with pallas_sort): one
    # encode a shard and batch, one table a shard in the drain.
    path, seqs = mesh_file
    name = "encode_words_planes" if pack_input else "encode_words"
    seen = calls(monkeypatch, sparse_ops, name)
    cfg = KmerConfig(k=k, canonical=canonical, batch_bases=512, mesh_shape=(8,),
                     pack_input=pack_input, device_sort=device_sort, sort_row_len=128)
    sc = counter(cfg, pallas_sort=True)
    got = sc.run(path)
    assert got.table() == oracle.count_table_any_k(seqs, k, canonical)
    ref = JaxStreamingCounter(JaxKmerConfig(k=k, canonical=canonical, batch_bases=512)).run(path)
    assert same_result(got, ref)
    assert seen["n"] == 8 * sc.metrics.counters["batches"]


@pytest.mark.parametrize("k,stop", [(5, 2), (21, 3)])
@pytest.mark.parametrize("first_mesh", [True, False])
def test_stop_on_one_and_resume_on_the_other(fasta_file, tmp_path, k, stop, first_mesh):
    # Checkpoints hold no mesh: a run stopped on a mesh resumes on one
    # device, and the reverse.
    path, seqs = fasta_file
    ck = str(tmp_path / "c.npz")
    mesh_cfg = KmerConfig(k=k, batch_bases=256, mesh_shape=(8,))
    one_cfg = KmerConfig(k=k, batch_bases=256)
    first, then = (mesh_cfg, one_cfg) if first_mesh else (one_cfg, mesh_cfg)
    counter(first, checkpoint_path=ck, max_batches=stop).run(path)
    sc = counter(then, checkpoint_path=ck)
    got = sc.run(path)
    assert sc.metrics.counters["resumed_from_base"] == stop * 256
    assert same_result(got, counter(one_cfg).run(path))
    assert same_result(got, JaxStreamingCounter(JaxKmerConfig(k=k, batch_bases=256)).run(path))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [13, 21, 31])
def test_compact_device_super_matches_jax_and_oracle(fasta_file, k, canonical):
    path, seqs = fasta_file
    kw = dict(k=k, canonical=canonical, batch_bases=256, compact="device-super")
    sc = counter(KmerConfig(**kw))
    got = sc.run(path)
    assert got.table() == oracle.count_table_any_k(seqs, k, canonical)
    assert same_result(got, JaxStreamingCounter(JaxKmerConfig(**kw)).run(path))
    assert sc.metrics.counters["batches"] > 1


def test_compact_device_super_stops_and_resumes(fasta_file, tmp_path):
    path, seqs = fasta_file
    ck = str(tmp_path / "c.npz")
    cfg = KmerConfig(k=21, batch_bases=256, compact="device-super")
    counter(cfg, checkpoint_path=ck, max_batches=3).run(path)
    got = counter(cfg, checkpoint_path=ck).run(path)
    assert got.table() == oracle.count_table_any_k(seqs, 21)
