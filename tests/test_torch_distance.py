"""The port's dense distance path (CPU route: the kernels' plain versions)
against the JAX package: K2's counts matrix against ``_counts_matrix_batch``
(Pallas interpret mode and plain jnp), the (min,+) product against the
Pallas K3/K4 kernels in interpret mode, and ``distance_sequences`` against
the JAX engine and the NumPy oracle.

Integers are compared exactly and float32 distances bit for bit: the
tolerance is zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.models.engine import KmerEngine as JaxKmerEngine
from dna_kmeres_parallel_tpu.models.engine import _counts_matrix_batch
from dna_kmeres_parallel_tpu.ops import distance as jax_distance
from dna_kmeres_parallel_tpu.ops import distance_pallas
from dna_kmeres_parallel_tpu.utils import io as jax_io
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxKmerConfig
from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda, histogram_cuda
from dna_kmeres_parallel_tpu_torch.utils import io, triangular


def make_seqs(seed: int = 0) -> list[str]:
    """37 records of 0-400 bases (4% N and one N run each where long
    enough), plus records shorter than k at every k tested."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("ACGTN"))
    out = []
    for n in rng.integers(0, 401, 37):
        s = alphabet[rng.choice(5, size=n, p=[0.24, 0.24, 0.24, 0.24, 0.04])]
        if n > 60:
            s[20:35] = "N"
        out.append("".join(s))
    return out + ["", "A", "ACG", "ACGTACG"]


SEQS = make_seqs()


def grid_of(seqs: list[str]) -> np.ndarray:
    stream, offsets, lengths = engine.seq_stream(seqs)
    grid = np.full((len(seqs), max(lengths)), 0xFF, np.uint8)
    for r, (o, n) in enumerate(zip(offsets, lengths)):
        grid[r, :n] = stream[o : o + n]
    return grid


def bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


# The Pallas kernel serves at most 1,024 bins (k <= 5); past that the JAX
# engine's plain jnp path is the reference.
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize(
    "k,pallas",
    [(1, "interpret"), (3, "interpret"), (5, "interpret"), (1, None), (3, None),
     (5, None), (8, None)],
)
def test_counts_matrix_matches_jax(k, canonical, pallas):
    grid = grid_of(SEQS)
    got = histogram_cuda.counts_matrix_grid(torch.from_numpy(grid), k, 4**k, canonical)
    ref = np.asarray(_counts_matrix_batch(jnp.asarray(grid), k, 4**k, canonical, pallas))
    assert got.dtype == torch.int32 and got.shape == (len(SEQS), 4**k)
    assert np.array_equal(got.numpy(), ref)


def test_engine_counts_matrix_matches_jax_engine():
    got = engine.KmerEngine(port.KmerConfig(k=3), device="cpu").counts_matrix(SEQS)
    ref = JaxKmerEngine(JaxKmerConfig(k=3)).counts_matrix(SEQS)
    assert got.dtype == np.int32 and np.array_equal(got, ref)


def counts_of(bins: int, rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 6, (rows, bins)).astype(np.int32)
    c[rng.random((rows, bins)) < 0.5] = 0
    return c


@pytest.mark.parametrize("bins", [64, 300, 1024])
def test_min_sum_matches_pallas_kernels(bins):
    # 300 bins crosses the TPU kernels' 256-bin slab; 37 rows are not a
    # multiple of any tile.
    a = counts_of(bins, 37, bins)
    b = counts_of(bins, 11, bins + 1)
    tri = distance_cuda.min_sum_matrix_tri(torch.from_numpy(a)).numpy()
    rect = distance_cuda.min_sum_matrix_rect(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref_tri = np.asarray(distance_pallas.min_sum_matrix_pallas_tri(jnp.asarray(a), interpret=True))
    ref_rect = np.asarray(
        distance_pallas.min_sum_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    )
    assert tri.dtype == np.int32 and tri.shape == (37, 37)
    assert np.array_equal(tri, ref_tri)
    assert rect.dtype == np.int32 and rect.shape == (37, 11)
    assert np.array_equal(rect, ref_rect)


def test_min_sum_refuses_rows_summing_to_2_31():
    a = torch.zeros(2, 3, dtype=torch.int32)
    a[0, 0] = a[0, 1] = 1 << 30
    with pytest.raises(ValueError, match="2\\^31"):
        distance_cuda.min_sum_matrix_tri(a)
    with pytest.raises(ValueError, match="2\\^31"):
        distance_cuda.min_sum_matrix_rect(a[1:], a)


@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [3, 5, 8])
def test_distance_sequences_matches_jax_engine_and_oracle(
    k, canonical, interpret, monkeypatch
):
    if interpret:
        monkeypatch.setenv("KMER_TPU_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("KMER_TPU_PALLAS_INTERPRET", raising=False)
    got = port.distance_sequences(SEQS, k=k, canonical=canonical, device="cpu")
    ref = JaxKmerEngine(JaxKmerConfig(k=k, canonical=canonical)).distance_sequences(SEQS)
    want = oracle.distance_matrix_packed(SEQS, k, canonical)
    n = len(SEQS)
    assert got.n == n and got.packed.dtype == np.float32
    assert got.packed.shape == (triangular.packed_size(n),)
    assert np.array_equal(bits(got.packed), bits(ref.packed))
    assert np.array_equal(bits(got.packed), bits(want))
    assert np.array_equal(got.counts, ref.counts)
    assert set(got.phases) == set(engine.DIST_PHASES)


def test_distance_file_matches_jax_engine(tmp_path):
    path = tmp_path / "in.fasta"
    path.write_text("".join(f">r{i} x\n{s}\n\n" for i, s in enumerate(SEQS)))
    got = port.distance_file(str(path), k=3, device="cpu")
    ref = JaxKmerEngine(JaxKmerConfig(k=3)).distance_file(str(path))
    assert got.ids == ref.ids == [f">r{i} x" for i in range(len(SEQS))]
    assert np.array_equal(bits(got.packed), bits(ref.packed))
    capped = port.distance_file(str(path), k=3, device="cpu", max_seqs=5)
    assert capped.n == 5
    assert np.array_equal(bits(capped.packed), bits(oracle.distance_matrix_packed(SEQS[:5], 3)))


def test_csv_is_byte_identical_to_jax_writer(tmp_path):
    packed = port.distance_sequences(SEQS, k=3, device="cpu").packed
    io.write_distances_csv(tmp_path / "port.csv", packed)
    jax_io.write_distances_csv(tmp_path / "jax.csv", packed)
    data = (tmp_path / "port.csv").read_bytes()
    assert data == (tmp_path / "jax.csv").read_bytes()
    assert data == "".join("%f\n" % v for v in packed).encode()
    io.write_min_distances_tsv(tmp_path / "port.tsv", packed, len(SEQS))
    jax_io.write_min_distances_tsv(tmp_path / "jax.tsv", packed, len(SEQS))
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


def test_finish_upper_matches_square_layout():
    rng = np.random.default_rng(3)
    n = 9
    sums = rng.integers(0, 50, (n, n)).astype(np.int32)
    sums = np.minimum(sums, sums.T)
    lengths = rng.integers(60, 90, n)
    lengths[2] = 2  # shorter than k: 0/0 and x/negative finish as in NumPy
    with np.errstate(divide="ignore", invalid="ignore"):
        square = distance.finish_distances(sums, lengths, 3)
    rows, cols = np.triu_indices(n, k=1)
    assert np.array_equal(bits(distance.finish_packed(sums, lengths, 3)), bits(square[rows, cols]))
    # A panel of rows 3..5 against columns 2..8 keeps, per row, the columns
    # after its own sequence.
    panel = distance.finish_upper(sums[3:6, 2:], lengths[3:6], lengths[2:], 3, r0=3, base=2)
    keep = (rows >= 3) & (rows < 6)
    assert np.array_equal(bits(panel), bits(square[rows[keep], cols[keep]]))
    assert triangular.packed_index(2, 5, n) == int(np.flatnonzero((rows == 2) & (cols == 5))[0])


@pytest.mark.parametrize("k", [3, 5])
def test_distance_matrix_packed_matches_jax(k):
    counts = engine.KmerEngine(port.KmerConfig(k=k), device="cpu").counts_matrix(SEQS)
    lengths = np.array([len(s) for s in SEQS])
    got = distance.distance_matrix_packed(torch.from_numpy(counts), lengths, k)
    ref = jax_distance.distance_matrix_packed(jnp.asarray(counts), jnp.asarray(lengths), k)
    assert np.array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("entry", ["distance_file", "distance_sequences"])
def test_large_k_distances_are_not_ported(tmp_path, entry):
    # The dense entries serve k <= 15 where the counts matrix fits the
    # memory gate; past it (k = 12) and above k = 15 they raise, and the
    # sparse entries (models/sparse_engine) serve those k.
    path = tmp_path / "in.fasta"
    path.write_text(">a\nACGTACGTACGT\n")
    arg = str(path) if entry == "distance_file" else ["ACGTACGTACGT"]
    with pytest.raises(ValueError, match="distance_sparse_packed"):
        getattr(port, entry)(arg, k=12, device="cpu")
    with pytest.raises(NotImplementedError, match="k <= 15"):
        getattr(port, entry)(arg, k=16, device="cpu")
    assert getattr(port, entry)(arg, k=9, device="cpu").n == 1


def test_row_chunks_bound_the_grid():
    lengths = np.array([5, 0, 7, 3, 100, 1, 2])
    chunks = engine.row_chunks(lengths, max_bytes=20)
    assert [c[:2] for c in chunks] == [(0, 2), (2, 4), (4, 5), (5, 7)]
    assert all((hi - lo) * L <= 20 or hi - lo == 1 for lo, hi, L in chunks)
    assert [c[2] for c in chunks] == [5, 7, 100, 2]
    assert engine.row_chunks(np.zeros(0, np.int64)) == []
