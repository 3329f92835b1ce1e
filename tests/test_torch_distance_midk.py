"""Dense distances at mid k (9..15) in the port against the JAX package,
on the CPU: the counts matrix above 65,536 bins (K2's plain version), the
(min,+) product at any width (K3/K4's plain version), the engine's
distances and streamed CSVs, and the memory gate.

The JAX engine is held directly at k = 9 and 10. At k = 11 its CPU run
pads the counts grid to 128 rows of 4^11 bins and peaks near 11 GB, so
there the port is held to the JAX package's oracle and its CSV writer,
which the JAX package's own tests hold its engine to.

Integer counts are compared exactly, float32 distances bit for bit, CSVs
byte for byte (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.models.engine import KmerEngine as JaxEngine
from dna_kmeres_parallel_tpu.ops import distance as jax_distance
from dna_kmeres_parallel_tpu.ops import encode as jax_encode
from dna_kmeres_parallel_tpu.ops import histogram as jax_hist
from dna_kmeres_parallel_tpu.utils import io as jax_io
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.ops import distance, histogram_cuda
from dna_kmeres_parallel_tpu_torch.utils import codec


def bits(a) -> list:
    return np.asarray(a, np.float32).view(np.uint32).tolist()


def records(seed: int, n: int = 5) -> list[str]:
    """Seeded records of 150-400 bases with N runs, plus one shorter than
    k and one that shares a stretch with the first."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    out = []
    for i in range(n):
        b = rng.integers(0, 4, 150 + 50 * i)
        b[rng.random(b.size) < 0.01] = 4
        b[20:30] = 4
        out.append(letters[b].tobytes().decode())
    return out + ["ACGTACGT", out[0][:100] + out[1][50:150]]


def port_engine(k: int, canonical: bool = False):
    return engine.KmerEngine(KmerConfig(k=k, canonical=canonical), device="cpu")


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [9, 10])
def test_counts_matrix_matches_jax_scatter(k, canonical):
    seqs = records(k)
    grid = np.full((len(seqs), 400), 0xFF, np.uint8)
    for r, s in enumerate(seqs):
        grid[r, : len(s)] = codec.encode_bases(s)
    got = histogram_cuda.counts_matrix_grid(torch.from_numpy(grid), k, 4**k, canonical)
    codes, valid = jax_encode.rolling_codes(jnp.asarray(grid), k)
    if canonical:
        codes = jax_encode.canonicalize(codes, k)
    want = np.asarray(jax_hist.counts_matrix_scatter(codes, valid, 4**k))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [9, 10, 11])
def test_engine_counts_matrix_matches_oracle(k):
    seqs = records(20 + k)
    got = port_engine(k, canonical=True).counts_matrix(seqs)
    for s, row in zip(seqs, got, strict=True):
        assert np.array_equal(row, oracle.count_vector(s, k, True))


@pytest.mark.parametrize("k", [9, 10])
def test_distance_sequences_matches_jax_engine(k):
    seqs = records(30 + k)
    got = port_engine(k).distance_sequences(seqs)
    want = JaxEngine(JaxConfig(k=k)).distance_sequences(seqs)
    assert bits(got.packed) == bits(want.packed)
    assert np.array_equal(got.counts, want.counts)


def test_distance_sequences_k11_matches_jax_oracle():
    seqs = records(41)
    got = port_engine(11).distance_sequences(seqs)
    assert bits(got.packed) == bits(oracle.distance_matrix_packed(seqs, 11))


@pytest.mark.parametrize("panel_rows", [1, 3, 2048])
def test_stream_to_csv_matches_jax_engine_k9(tmp_path, panel_rows):
    seqs = records(50)
    want = tmp_path / "jax.csv"
    JaxEngine(JaxConfig(k=9)).distance_stream_to_csv(seqs, want, panel_rows=panel_rows)
    got = tmp_path / "port.csv"
    out = port_engine(9).distance_stream_to_csv(seqs, got, panel_rows=panel_rows)
    assert got.read_bytes() == want.read_bytes()
    assert out["completed"]


@pytest.mark.parametrize("k", [10, 11])
def test_stream_stopped_and_resumed_matches_jax_writer(tmp_path, k):
    seqs = records(60 + k)
    want = tmp_path / "jax.csv"
    jax_io.write_distances_csv(want, oracle.distance_matrix_packed(seqs, k))
    got, ckpt = tmp_path / "port.csv", tmp_path / "ckpt.json"
    eng = port_engine(k)
    first = eng.distance_stream_to_csv(seqs, got, panel_rows=2, checkpoint_path=ckpt, max_panels=1)
    assert not first["completed"]
    second = eng.distance_stream_to_csv(seqs, got, panel_rows=2, checkpoint_path=ckpt)
    assert second["resumed"] and second["completed"]
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("B", [65537, 1 << 18])
def test_min_sum_at_wide_bins_matches_jax(B):
    rng = np.random.default_rng(B)
    a = rng.integers(0, 3, (5, B)).astype(np.int32)
    a[rng.random(a.shape) < 0.9] = 0
    got = distance.min_sum_matrix(torch.from_numpy(a))
    want = np.asarray(jax_distance.min_sum_matrix(jnp.asarray(a)))
    assert np.array_equal(got.numpy(), want)
    rect = distance.min_sum_matrix(torch.from_numpy(a[:2]), torch.from_numpy(a[1:]))
    assert np.array_equal(rect.numpy(), want[:2, 1:])


def test_engine_refuses_what_the_memory_gate_refuses():
    # k = 12 never fits (128 padded rows of 4^12 int32 bins are 8 GiB);
    # k = 11 fits up to 128 rows, not 129.
    with pytest.raises(ValueError, match="distance_sparse_packed"):
        port_engine(12).distance_sequences(records(1, 2))
    eng = port_engine(11)
    with pytest.raises(ValueError, match="distance_sparse_packed"):
        eng.distance_sequences(["ACGT" * 5] * 129)
    with pytest.raises(ValueError, match="distance_sparse_packed"):
        eng.distance_stream_to_csv(["ACGT" * 5] * 129, "unused.csv")
    assert eng.distance_sequences(["ACGTACGTACGTACGT"] * 3).n == 3
