"""The port's streamed distance CSV (CPU route: the kernels' plain
versions) against the JAX engine's stream and a one-shot run, and its
resume: every comparison is byte for byte."""

import numpy as np
import pytest

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu.models import distance_stream as jax_stream
from dna_kmeres_parallel_tpu.models.engine import KmerEngine as JaxKmerEngine
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxKmerConfig
from dna_kmeres_parallel_tpu_torch.models import distance_stream, engine
from dna_kmeres_parallel_tpu_torch.utils import io


def make_seqs(seed: int) -> list[str]:
    """37 seeded records of 0-400 bases, 4% N."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("ACGTN"))
    return [
        "".join(alphabet[rng.choice(5, size=n, p=[0.24, 0.24, 0.24, 0.24, 0.04])])
        for n in rng.integers(0, 401, 37)
    ]


SEQS = make_seqs(1)


def port_engine(k: int, canonical: bool = False) -> engine.KmerEngine:
    return engine.KmerEngine(port.KmerConfig(k=k, canonical=canonical), device="cpu")


@pytest.mark.parametrize("k,canonical", [(3, False), (5, True)])
def test_stream_matches_jax_stream_and_one_shot(tmp_path, k, canonical):
    res = port_engine(k, canonical).distance_stream_to_csv(
        SEQS, tmp_path / "port.csv", panel_rows=8
    )
    JaxKmerEngine(JaxKmerConfig(k=k, canonical=canonical)).distance_stream_to_csv(
        SEQS, tmp_path / "jax.csv", panel_rows=8
    )
    one_shot = port.distance_sequences(SEQS, k=k, canonical=canonical, device="cpu")
    io.write_distances_csv(tmp_path / "one.csv", one_shot.packed)
    data = (tmp_path / "port.csv").read_bytes()
    assert data == (tmp_path / "jax.csv").read_bytes()
    assert data == (tmp_path / "one.csv").read_bytes()
    assert res["n_pairs"] == len(SEQS) * (len(SEQS) - 1) // 2 and res["completed"]
    assert set(res["phases"]) == set(engine.DIST_PHASES)


def test_stream_stopped_and_resumed_is_byte_identical(tmp_path):
    eng = port_engine(3)
    eng.distance_stream_to_csv(SEQS, tmp_path / "full.csv", panel_rows=8)
    out, ck = tmp_path / "part.csv", tmp_path / "part.ckpt"
    first = eng.distance_stream_to_csv(
        SEQS, out, panel_rows=8, checkpoint_path=ck, max_panels=2
    )
    assert not first["completed"] and ck.exists()
    with open(out, "ab") as f:  # a panel cut mid-write by a kill
        f.write(b"0.123")
    second = eng.distance_stream_to_csv(SEQS, out, panel_rows=8, checkpoint_path=ck)
    assert second["resumed"] and second["completed"]
    assert out.read_bytes() == (tmp_path / "full.csv").read_bytes()
    assert second["n_pairs"] == len(SEQS) * (len(SEQS) - 1) // 2


def test_resume_refuses_another_input(tmp_path):
    out, ck = tmp_path / "part.csv", tmp_path / "part.ckpt"
    port_engine(3).distance_stream_to_csv(
        SEQS, out, panel_rows=8, checkpoint_path=ck, max_panels=1
    )
    edited = ["T" + SEQS[0][1:]] + SEQS[1:]
    with pytest.raises(ValueError, match="input_sha"):
        port_engine(3).distance_stream_to_csv(edited, out, panel_rows=8, checkpoint_path=ck)


def test_row_blocks_concatenate_to_the_single_stream(tmp_path):
    eng = port_engine(3)
    eng.distance_stream_to_csv(SEQS, tmp_path / "full.csv", panel_rows=8)
    parts = []
    for i, (lo, hi) in enumerate(distance_stream.balanced_row_splits(len(SEQS), 3)):
        p = tmp_path / f"shard{i}.csv"
        eng.distance_stream_to_csv(SEQS, p, panel_rows=8, row_lo=lo, row_hi=hi)
        parts.append(p.read_bytes())
    assert b"".join(parts) == (tmp_path / "full.csv").read_bytes()


@pytest.mark.parametrize("S,n", [(37, 3), (2, 4), (1000, 7)])
def test_balanced_row_splits_match_jax(S, n):
    assert distance_stream.balanced_row_splits(S, n) == jax_stream.balanced_row_splits(S, n)
    assert distance_stream.input_fingerprint(SEQS) == jax_stream.input_fingerprint(SEQS)


def test_panel_fn_rows_equal_the_one_shot_packing():
    eng = port_engine(5)
    counts = eng._counts_on_device(*engine.seq_stream(SEQS))
    lengths = np.array([len(s) for s in SEQS])
    panel_fn = eng.make_dense_panel_fn(counts, lengths)
    flat = np.concatenate([panel_fn(r, min(r + 5, len(SEQS) - 1)) for r in range(0, 36, 5)])
    want = port.distance_sequences(SEQS, k=5, device="cpu").packed
    assert np.array_equal(flat.view(np.uint32), want.view(np.uint32))
