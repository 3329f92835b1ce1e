"""Dense k-mer counting (k <= 12): the port's plain versions of K5-K8 (the
CPU route of ``histogram_planes`` / ``histogram_stream``), its
``unpack_stream`` and ``dense_from_sparse``, and ``count_file`` /
``count_sequences(device="cpu")`` against the JAX package (its Pallas
kernels in interpret mode, its engine) and the oracle. The CUDA kernels
are held against the plain versions in test_torch_cuda.py.

Integer counts: every comparison is exact (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dna_kmeres_parallel_tpu as jax_pkg
import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.models import sparse_engine as jax_sparse_engine
from dna_kmeres_parallel_tpu.ops import encode as jax_encode
from dna_kmeres_parallel_tpu.ops import histogram_pallas as jax_hp
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
    SparseCountResult,
    SparseKmerEngine,
    dense_from_sparse,
)
from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda
from dna_kmeres_parallel_tpu_torch.utils import codec

CPU = torch.device("cpu")
T = 4096


def nrich(n: int, seed: int) -> np.ndarray:
    """Seeded u8 stream of n bases: 8% isolated N, an N run, an all-T run."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, n).astype(np.uint8)
    b[rng.random(n) < 0.08] = codec.INVALID_BASE
    if n >= 2048:
        b[700:760] = codec.INVALID_BASE
        b[1000:1064] = 3
    return b


def port_planes(bases: np.ndarray):
    return engine.stage_batch_planes(bases, CPU)


def jax_u32(plane: torch.Tensor):
    return jnp.asarray(plane.numpy().view(np.uint32))


N_OWN = {"none": 0, "one": 1, "mid": 300, "full": T}


@pytest.mark.parametrize("n_own", list(N_OWN))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 3, 4, 7, 8])
def test_plain_planes_matches_jax_packed_kernel(k, canonical, n_own):
    bases = nrich(T, k)
    planes = port_planes(bases)
    got = histogram_cuda.histogram_planes(*planes, N_OWN[n_own], k, canonical)
    ref = jax_hp.histogram_bp2_packed_pallas(
        jax_u32(planes[0]), jax_u32(planes[1]), jnp.int32(N_OWN[n_own]), k, 4**k,
        canonical, interpret=True,
    )
    assert got.dtype == torch.int32 and got.shape == (4**k,)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum()) <= N_OWN[n_own]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8])
def test_plain_u8_matches_jax_kernels(k, canonical):
    # k <= 3: the bit-plane kernel (K7's TPU original); k = 4..8: the bp2
    # kernel with compare-built one-hots (K6's), as histogram_pallas routes.
    bases = nrich(T, 20 + k)
    n_own = T - 333
    got = histogram_cuda.histogram_stream(torch.from_numpy(bases), n_own, k, 4**k, canonical)
    args = (jnp.asarray(bases), jnp.int32(n_own), k, 4**k, canonical)
    if k <= 3:
        ref = jax_hp.histogram_bitplane_pallas(*args, interpret=True)
    else:
        ref = jax_hp.histogram_bp2_pallas(*args, interpret=True, mode="cmp")
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("canonical", [False, True])
def test_plain_u8_matches_jax_two_level_body(canonical):
    # 1,000 bins (not a power of two) reach histogram_pallas's own body; k=5
    # codes 1000..1023 are dropped.
    bases = nrich(T, 31)
    got = histogram_cuda.histogram_stream(torch.from_numpy(bases), T - 7, 5, 1000, canonical)
    ref = jax_hp.histogram_pallas(
        jnp.asarray(bases), jnp.int32(T - 7), 5, 1000, canonical, interpret=True
    )
    assert histogram_cuda.u8_route(1000) == "any"
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("canonical", [False, True])
def test_bins_not_a_power_of_two_keep_every_bin(canonical):
    # 3,000 bins at k=6: the port returns all 3,000 entries, equal to the
    # oracle's counts of codes below 3,000. The JAX package's two-level body
    # returns H * W = 23 * 128 = 2,944 entries here (histogram_pallas.py
    # _split_hw and its final reshape), so the windows with codes
    # 2,944..2,999 are lost there; the port agrees with it on the rest.
    bases = nrich(T, 41)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seq = letters[np.minimum(bases, 4)].tobytes().decode()
    got = histogram_cuda.histogram_stream(torch.from_numpy(bases), T, 6, 3000, canonical)
    assert got.shape == (3000,)
    want = oracle.count_vector(seq, 6, canonical)[:3000]
    assert np.array_equal(got.numpy(), want)
    ref = np.asarray(jax_hp.histogram_pallas(
        jnp.asarray(bases), jnp.int32(T), 6, 3000, canonical, interpret=True
    ))
    assert ref.shape[0] < 3000
    assert np.array_equal(got.numpy()[: ref.shape[0]], ref)


@pytest.mark.parametrize("n", [0, 8, 1024, 4104])
def test_unpack_stream_matches_jax(n):
    bases = nrich(n, n)
    data, mask, _ = native.pack_2bit_native(bases)
    got = encode_ops.unpack_stream(torch.from_numpy(data), torch.from_numpy(mask))
    ref = jax_encode.unpack_stream(jnp.asarray(data), jnp.asarray(mask))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy(), bases)


def test_unpack_stream_refuses_mismatched_planes():
    with pytest.raises(ValueError, match="bases"):
        encode_ops.unpack_stream(torch.zeros(4, dtype=torch.uint8), torch.zeros(1, dtype=torch.uint8))


@pytest.mark.parametrize("k", [9, 10])
def test_dense_from_sparse_matches_jax(k):
    seqs = ["".join(np.random.default_rng(k).choice(list("ACGTN"), 3000))]
    sp = SparseKmerEngine(port.KmerConfig(k=k), device="cpu").count_sequences(seqs)
    got = dense_from_sparse(sp, 4**k)
    ref = jax_sparse_engine.dense_from_sparse(sp, 4**k)
    assert got.dtype == np.int64 and np.array_equal(got, ref)
    assert got.sum() == sp.counts.sum()


# ---------------------------------------------------------------------------
# The engine against the JAX package's
# ---------------------------------------------------------------------------

BATCH = 1024


def fasta_records() -> list[str]:
    """Records whose flat stream (one separator between records) puts N
    runs across the batch edges at 1,024 and 2,048, and holds records
    shorter than k (length 0, 2 and 5) and a homopolymer run."""
    rng = np.random.default_rng(7)
    letters = np.array(list("ACGT"))
    lengths = [1500, 5, 0, 2, 1800, 800]
    recs = ["".join(letters[rng.integers(0, 4, n)]) for n in lengths]
    recs = [list(r) for r in recs]
    for pos in (1015, 1020):  # stream offsets 1015..1030 straddle 1024
        recs[0][pos : pos + 10] = "N" * 10
    # Record 4 starts at stream offset 1500 + 1 + 5 + 1 + 0 + 1 + 2 + 1 = 1511;
    # 2048 lies at its offset 537.
    recs[4][530:545] = "N" * 15
    recs[4][1000:1040] = "T" * 40
    return ["".join(r) for r in recs]


@pytest.fixture(scope="module")
def fasta_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dense") / "in.fasta"
    with open(path, "w") as f:
        for i, r in enumerate(fasta_records()):
            f.write(f">r{i}\n")
            for j in range(0, len(r), 60):
                f.write(r[j : j + 60] + "\n")
    return str(path)


@pytest.mark.parametrize("pack_input", [True, False])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 3, 4, 8, 9, 10])
@pytest.mark.parametrize("entry", ["count_file", "count_sequences"])
def test_count_matches_jax_package(fasta_path, entry, k, canonical, pack_input):
    kw = dict(k=k, canonical=canonical, batch_bases=BATCH, pack_input=pack_input)
    arg = fasta_path if entry == "count_file" else fasta_records()
    got = getattr(port, entry)(arg, device="cpu", **kw)
    ref = getattr(jax_pkg, entry)(arg, **kw)
    assert isinstance(got, engine.CountResult) and got.hist.dtype == np.int64
    assert np.array_equal(got.hist, np.asarray(ref.hist, np.int64))
    assert (got.n_seqs, got.total_bases) == (ref.n_seqs, ref.total_bases)
    stream_len = sum(len(r) for r in fasta_records()) + len(fasta_records()) - 1
    assert -(-stream_len // engine.batch_plan(stream_len, k, BATCH)[0]) == 5
    if 4**k <= histogram_cuda.MAX_BINS:
        assert set(got.phases) == set(engine.COUNT_PHASES)
    assert got.phases["parse"] >= 0.0


@pytest.mark.parametrize("pack_input", [True, False])
@pytest.mark.parametrize("canonical", [False, True])
def test_count_k6_matches_jax_engine_in_interpret_mode(fasta_path, monkeypatch, canonical, pack_input):
    # The JAX engine then runs its Pallas kernels in interpret mode: the
    # packed-plane kernel (K5's original) with pack_input, the bp2 kernel
    # (K6's) without.
    monkeypatch.setenv("KMER_TPU_PALLAS_INTERPRET", "1")
    kw = dict(k=6, canonical=canonical, batch_bases=BATCH, pack_input=pack_input)
    got = port.count_file(fasta_path, device="cpu", **kw)
    ref = jax_pkg.count_file(fasta_path, **kw)
    assert np.array_equal(got.hist, np.asarray(ref.hist, np.int64))


@pytest.mark.parametrize("k", [3, 8, 9])
def test_count_empty_file(tmp_path, k):
    path = tmp_path / "empty.fasta"
    path.write_text("")
    got = port.count_file(str(path), k=k, device="cpu")
    ref = jax_pkg.count_file(str(path), k=k)
    assert got.hist.shape == (4**k,) and not got.hist.any()
    assert np.array_equal(got.hist, ref.hist)
    assert (got.n_seqs, got.total_bases, got.total_kmers) == (0, 0, 0)


@pytest.mark.parametrize("k", [4, 9])
def test_count_only_empty_records(k):
    # Twelve empty records: a stream of eleven separators, longer than k.
    got = port.count_sequences([""] * 12, k=k, device="cpu")
    ref = jax_pkg.count_sequences([""] * 12, k=k)
    assert got.hist.shape == (4**k,) and not got.hist.any()
    assert np.array_equal(got.hist, ref.hist) and got.n_seqs == ref.n_seqs == 12


@pytest.mark.parametrize("k", [3, 6])
def test_flush_limit_keeps_the_histogram(monkeypatch, k):
    # A flush every two 1,024-base batches gives the same counts: with a
    # limit of 2,048 windows the accumulator flushes before each batch
    # that could take it past the limit.
    seqs = fasta_records()
    want = port.count_sequences(seqs, k=k, device="cpu", batch_bases=BATCH).hist
    drains = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(t):
        drains.append(t.numel())
        return real_cpu(t)

    monkeypatch.setattr(engine, "FLUSH_WINDOWS", 2 * BATCH)
    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    got = port.count_sequences(seqs, k=k, device="cpu", batch_bases=BATCH).hist
    monkeypatch.undo()
    assert np.array_equal(got, want)
    assert drains.count(4**k) == 3  # before batches 3 and 5, and at the end


@pytest.mark.parametrize("entry", ["count_sequences", "stream"])
def test_batch_past_the_limit_raises(monkeypatch, tmp_path, entry):
    # With the limit set below one batch, both dense entries refuse it.
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    monkeypatch.setattr(engine, "FLUSH_WINDOWS", BATCH - 1)
    seqs = fasta_records()
    with pytest.raises(ValueError, match=f"batch_bases={BATCH}"):
        if entry == "count_sequences":
            port.count_sequences(seqs, k=3, device="cpu", batch_bases=BATCH)
        else:
            path = tmp_path / "in.fasta"
            path.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(seqs)))
            cfg = port.KmerConfig(k=3, batch_bases=BATCH)
            StreamingCounter(cfg, device="cpu").run(str(path))


@pytest.mark.parametrize("k", [3, 6])
def test_streaming_flush_limit_keeps_the_histogram(monkeypatch, tmp_path, k):
    # The streaming counter's dense arm flushes by the same rule.
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    path = tmp_path / "in.fasta"
    path.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(fasta_records())))
    cfg = port.KmerConfig(k=k, batch_bases=BATCH)
    want = StreamingCounter(cfg, device="cpu").run(str(path)).hist
    drains = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(t):
        drains.append(t.numel())
        return real_cpu(t)

    monkeypatch.setattr(engine, "FLUSH_WINDOWS", 2 * BATCH)
    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    got = StreamingCounter(cfg, device="cpu").run(str(path)).hist
    monkeypatch.undo()
    assert np.array_equal(got, want)
    assert drains.count(4**k) == 3  # before batches 3 and 5, and at the end


def test_count_result_table_and_totals():
    seqs = ["ACGTNACGTT", "GGGG"]
    res = port.count_sequences(seqs, k=3, device="cpu")
    assert res.table() == oracle.count_table_any_k(seqs, 3)
    assert res.total_kmers == sum(res.table().values())
    assert res.distinct_kmers == len(res.table())


@pytest.mark.parametrize("k,kind", [(1, "dense"), (8, "dense"), (9, "dense"), (12, "dense"), (13, "sparse")])
def test_count_entries_route_like_the_jax_package(k, kind):
    res = port.count_sequences(["ACGTACGTACGTAC" * 3], k=k, device="cpu")
    assert isinstance(res, engine.CountResult if kind == "dense" else SparseCountResult)
    ref = jax_pkg.count_sequences(["ACGTACGTACGTAC" * 3], k=k)
    assert type(ref).__name__ == type(res).__name__


def test_dense_engine_refuses_k_above_15():
    with pytest.raises(NotImplementedError, match="SparseKmerEngine"):
        engine.KmerEngine(port.KmerConfig(k=16), device="cpu")


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "bins,route", [(1, "small"), (4, "small"), (64, "small"), (256, "u8"), (65536, "u8"),
                   (100, "any"), (3000, "any"), (131072, "any"), (1 << 22, "any")]
)
def test_u8_route_follows_histogram_pallas(bins, route):
    assert histogram_cuda.u8_route(bins) == route


def test_entries_add_into_the_given_accumulator():
    bases = nrich(T, 3)
    b = torch.from_numpy(bases)
    once = histogram_cuda.histogram_stream(b, T, 4, 256)
    acc = torch.full((256,), 5, dtype=torch.int32)
    out = histogram_cuda.histogram_stream(b, T, 4, 256, acc=acc)
    assert out is acc and torch.equal(acc, once + 5)
    planes = port_planes(bases)
    histogram_cuda.histogram_planes(*planes, T, 4, acc=acc)
    assert torch.equal(acc, 2 * once + 5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    b = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="acc"):
        histogram_cuda.histogram_stream(b, 64, 3, 64, acc=torch.zeros(63, dtype=torch.int32))
    with pytest.raises(ValueError, match="acc"):
        histogram_cuda.histogram_stream(b, 64, 3, 64, acc=torch.zeros(64, dtype=torch.int64))
    with pytest.raises(ValueError, match="bins"):
        histogram_cuda.histogram_stream(b, 64, 3, (1 << 24) + 1)
    with pytest.raises(ValueError, match="k must be"):
        histogram_cuda.histogram_planes(*port_planes(nrich(64, 1)), 64, 9)
    # The kernels' wrappers take CUDA tensors only: a CPU tensor is refused,
    # never sent to the plain version.
    for fn in (histogram_cuda.hist_u8_cuda, histogram_cuda.hist_u8_small_cuda,
               histogram_cuda.hist_u8_any_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(b, 64, 3, 64)
    with pytest.raises(ValueError, match="CUDA"):
        histogram_cuda.hist_planes_cuda(*port_planes(nrich(64, 1)), 64, 3)
    with pytest.raises(ValueError, match="power-of-two"):
        histogram_cuda.hist_u8_cuda(b, 64, 3, 100)


@pytest.mark.parametrize(
    "bins,cluster,plan",
    [(1, None, (1, 4)), (4, None, (1, 4)), (64, None, (1, 64)), (1000, None, (1, 1000)),
     (3000, None, (1, 3000)), (1024, None, (1, 1024)), (32768, None, (1, 32768)),
     (40000, None, (histogram_cuda.WIDE_CLUSTER, -(-40000 // histogram_cuda.WIDE_CLUSTER))),
     (65535, 2, (2, 32768)), (65536, 2, (2, 32768)), (65536, 4, (4, 16384)),
     (1024, 4, (4, 256)), (5, 2, (2, 4)), (65535, 4, (4, 16384))],
)
def test_u8_plan(bins, cluster, plan):
    # K6's launch plan: one block's shared memory up to 32,768 bins, a
    # cluster above; slices padded to 4 bins for the 16-byte bulk flush.
    assert histogram_cuda.u8_plan(bins, cluster) == plan
    c, s = plan
    assert s % 4 == 0 and c * s >= bins and s <= histogram_cuda.MAX_SLICE_BINS


@pytest.mark.parametrize("bins,cluster", [(65536, 1), (40000, 1), (0, None), (65537, None),
                                          (1024, 3), (1024, 8)])
def test_u8_plan_refuses(bins, cluster):
    with pytest.raises(ValueError):
        histogram_cuda.u8_plan(bins, cluster)


def test_wide_bins_take_a_cluster_of_two_or_four():
    # The default at 4^8 bins is a cluster of 2 or 4 blocks (the one
    # measured faster on the card), never one block's shared memory.
    assert histogram_cuda.u8_plan(65536)[0] in (2, 4)
