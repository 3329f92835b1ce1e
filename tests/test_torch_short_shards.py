"""Shards shorter than k - 1 bases, whose windows can reach past the next
shard: the dense multi-host counts (``parallel/multihost.count_file_multihost`` and its
resumable form) on ``LocalMesh(D, "cpu")`` against a naive per-record
counter, which shares no code with either package. The JAX package keeps
the fault (it returns short counts or raises), so it is not the reference
here.

Integer histograms: the tolerance is zero."""

import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.parallel import multihost, sharded_count
from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

LUT = {"A": 0, "C": 1, "G": 2, "T": 3}


def naive_hist(records: list[str], k: int) -> np.ndarray:
    """Every window of every record whose k characters are all ACGT."""
    hist = np.zeros(4**k, dtype=np.int64)
    for seq in records:
        for i in range(len(seq) - k + 1):
            w = seq[i : i + k]
            if all(ch in LUT for ch in w):
                code = 0
                for ch in w:
                    code = code * 4 + LUT[ch]
                hist[code] += 1
    return hist


def write(tmp_path, records: list[str], name: str = "in.fasta") -> str:
    path = tmp_path / name
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(records)))
    return str(path)


def record_22(seed: int = 22) -> str:
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), 22))


def test_five_bases_on_eight_shards(tmp_path):
    path = write(tmp_path, ["CCAAA"])
    for D in (1, 8):
        hist = multihost.count_file_multihost(path, KmerConfig(k=3), LocalMesh(D, "cpu"))[0]
        assert int(hist.sum()) == 3 and np.array_equal(hist, naive_hist(["CCAAA"], 3)), D


def test_a_22_base_record_at_k5_on_eight_shards(tmp_path):
    seq = record_22()
    path = write(tmp_path, [seq])
    hist = multihost.count_file_multihost(path, KmerConfig(k=5), LocalMesh(8, "cpu"))[0]
    assert int(hist.sum()) == 18 and np.array_equal(hist, naive_hist([seq], 5))


def test_resumable_steps_of_four_bases(tmp_path):
    seq = record_22()
    path = write(tmp_path, [seq])
    hist, *_, done, steps = multihost.count_file_multihost_resumable(
        path, KmerConfig(k=3), LocalMesh(8, "cpu"), batch_bases=4)
    assert done == steps and int(hist.sum()) == 20
    assert np.array_equal(hist, naive_hist([seq], 3))
    # stopped after 2 steps and resumed on another mesh
    ck = str(tmp_path / "ck")
    multihost.count_file_multihost_resumable(path, KmerConfig(k=3), LocalMesh(8, "cpu"), ck,
                                             batch_bases=4, max_steps=2)
    again = multihost.count_file_multihost_resumable(path, KmerConfig(k=3), LocalMesh(3, "cpu"),
                                                     ck, batch_bases=4)[0]
    assert np.array_equal(again, hist)


def random_records(rng, D: int, k: int) -> list[str]:
    """1-3 records, N-rich or not, together shorter than D * (k - 1)."""
    total = max(int(rng.integers(1, D * max(k - 1, 1) + 1)), 1)
    out = []
    while total > 0 and len(out) < 3:
        n = int(rng.integers(1, total + 1))
        s = np.array(list("ACGT"))[rng.integers(0, 4, n)]
        s[rng.random(n) < rng.choice([0.0, 0.1])] = "N"
        out.append("".join(s))
        total -= n
    return out


@pytest.mark.parametrize("seed", range(8))
def test_random_short_streams_against_a_naive_counter(tmp_path, seed):
    # D = 1-8 shards, k = 1-9, records shorter than D (k - 1) in all: both
    # entries, the resumable one in steps of 1-8 bases.
    rng = np.random.default_rng(seed)
    for case in range(6):
        D, k = int(rng.integers(1, 9)), int(rng.integers(1, 10))
        records = random_records(rng, D, k)
        path = write(tmp_path, records, f"r{case}.fasta")
        want = naive_hist(records, k)
        mesh = LocalMesh(D, "cpu")
        got = multihost.count_file_multihost(path, KmerConfig(k=k), mesh)[0]
        assert np.array_equal(got, want), (D, k, records)
        batch = int(rng.integers(1, 9))
        got = multihost.count_file_multihost_resumable(path, KmerConfig(k=k), mesh,
                                                       batch_bases=batch)[0]
        assert np.array_equal(got, want), (D, k, batch, records)


@pytest.mark.parametrize("k", [2, 4, 9])
def test_stream_halo_reads_the_stream_past_the_next_shard(k):
    # Each shard followed by the next k - 1 bases of the flat stream,
    # INVALID past its end; where a shard holds k - 1 bases or more, the
    # halo is halo_exchange's.
    mesh = LocalMesh(8, "cpu")
    flat = torch.arange(8 * 3, dtype=torch.uint8)  # shards of 3 bases
    rows = flat.reshape(8, 3)
    got = sharded_count.stream_halo(rows, k, mesh)
    padded = torch.cat([flat, torch.full((k,), 0xFF, dtype=torch.uint8)])
    want = torch.stack([padded[3 * s : 3 * s + 3 + k - 1] for s in range(8)])
    assert torch.equal(got, want)
    if k - 1 <= 3:
        assert torch.equal(got, sharded_count.halo_exchange(rows, k, mesh))
