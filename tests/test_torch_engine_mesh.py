"""``KmerEngine``'s distances over a mesh on the CPU (``mesh_shape``: a
``LocalMesh`` of that many shards, K4's plain version per shard, partner
rows padded to a multiple of D), against the JAX engine on its virtual CPU
mesh and against the port's single-device engine: packed distances bit
for bit, streamed CSVs byte for byte (tolerance zero)."""

import numpy as np
import pytest

from dna_kmeres_parallel_tpu.models.engine import KmerEngine as JaxKmerEngine
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxKmerConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine
from dna_kmeres_parallel_tpu_torch.ops import distance_cuda


def engine(k: int, mesh: int | None = None, **kw) -> KmerEngine:
    shape = (mesh,) if mesh else ()
    return KmerEngine(KmerConfig(k=k, mesh_shape=shape, **kw), device="cpu")


def jax_engine(k: int, mesh: int | None = None) -> JaxKmerEngine:
    return JaxKmerEngine(JaxKmerConfig(k=k, mesh_shape=(mesh,) if mesh else ()))


@pytest.fixture
def rect_calls(monkeypatch):
    """Count K4's calls (its plain version here) and K3's."""
    seen = {"rect": 0, "tri": 0}
    rect, tri = distance_cuda.min_sum_matrix_rect, distance_cuda.min_sum_matrix_tri

    def counted_rect(*a):
        seen["rect"] += 1
        return rect(*a)

    def counted_tri(*a):
        seen["tri"] += 1
        return tri(*a)

    monkeypatch.setattr(distance_cuda, "min_sum_matrix_rect", counted_rect)
    monkeypatch.setattr(distance_cuda, "min_sum_matrix_tri", counted_tri)
    return seen


@pytest.mark.parametrize("D", [3, 8])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [3, 4])
def test_distance_sequences_mesh_matches_jax(make_dna, rect_calls, k, canonical, D):
    # The whole square as one partner-sharded panel: D launches of K4 and
    # none of K3; 13 records (not a multiple of 3 or 8).
    seqs = [make_dna(70 + 9 * i, invalid_frac=0.02) for i in range(13)]
    got = engine(k, D, canonical=canonical).distance_sequences(seqs).packed
    assert rect_calls == {"rect": D, "tri": 0}
    single = engine(k, canonical=canonical).distance_sequences(seqs).packed
    want = JaxKmerEngine(JaxKmerConfig(k=k, canonical=canonical, mesh_shape=(8,))
                         ).distance_sequences(seqs).packed
    for ref in (single, want):
        assert np.array_equal(got.view(np.uint32), np.asarray(ref).view(np.uint32))


@pytest.mark.parametrize("panel_rows", [1, 5, 2048])
@pytest.mark.parametrize("D", [3, 8])
@pytest.mark.parametrize("k", [3, 4])
def test_distance_stream_to_csv_mesh_byte_identical_to_jax(tmp_path, make_dna, rect_calls, k,
                                                           D, panel_rows):
    seqs = [make_dna(80 + 7 * i, invalid_frac=0.02) for i in range(23)]
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    jax_engine(k, 8).distance_stream_to_csv(seqs, want, panel_rows=panel_rows)
    out = engine(k, D).distance_stream_to_csv(seqs, got, panel_rows=panel_rows)
    assert got.read_bytes() == want.read_bytes() and out["completed"]
    assert rect_calls["rect"] == D * -(-22 // panel_rows)  # the last row has no pair


def test_distance_stream_mesh_s2048_stopped_and_resumed(tmp_path, make_dna):
    # The JAX package's scale bar: 2,048 records at D = 8, byte-identical
    # to the single-device CSV; the run stopped after one panel on the
    # mesh and finished on one device.
    seqs = [make_dna(48 + (i % 7)) for i in range(2048)]
    a, b, ck = tmp_path / "a.csv", tmp_path / "b.csv", tmp_path / "ck.json"
    engine(3).distance_stream_to_csv(seqs, a, panel_rows=512)
    first = engine(3, 8).distance_stream_to_csv(seqs, b, panel_rows=512, checkpoint_path=ck,
                                                max_panels=1)
    second = engine(3).distance_stream_to_csv(seqs, b, panel_rows=512, checkpoint_path=ck)
    assert not first["completed"] and second["resumed"] and second["completed"]
    assert a.read_bytes() == b.read_bytes()


def test_counting_ignores_the_mesh(make_dna):
    # As the JAX engine: counting through KmerEngine runs on one device.
    seqs = [make_dna(200, invalid_frac=0.02) for _ in range(3)]
    got = engine(5, 4).count_sequences(seqs).hist
    assert np.array_equal(got, engine(5).count_sequences(seqs).hist)
