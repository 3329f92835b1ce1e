"""The frozen plain references against naive loops at small sizes, and
their controls against the references: each control must read as not
correct under the configurations' limits."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.entries import count_file, distance_file
from benchmark.gen import fasta
from benchmark.reference import kmers

BENCH = Path(__file__).resolve().parents[1]
CODE = {c: i for i, c in enumerate("ACGT")}


def records(n: int, lo: int, hi: int, n_fraction: float, seed: int) -> fasta.Records:
    rng = np.random.default_rng(seed)
    return fasta.make_records(rng.integers(lo, hi + 1, n), n_fraction, rng)


def strings(r: fasta.Records) -> list[str]:
    letters = np.frombuffer(b"ACGTN", np.uint8)
    return [letters[np.minimum(r.stream[s : s + n], 4)].tobytes().decode()
            for s, n in zip(r.starts, r.lengths)]


def naive_table(seqs: list[str], k: int, canonical: bool = False) -> Counter:
    """Every window of k valid bases, record by record, as its code."""
    comp = str.maketrans("ACGT", "TGCA")
    out = Counter()
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i : i + k]
            if "N" in w:
                continue
            if canonical:
                w = min(w, w.translate(comp)[::-1])
            code = 0
            for ch in w:
                code = code * 4 + CODE[ch]
            out[code] += 1
    return out


@pytest.mark.parametrize("k,canonical", [(1, False), (5, False), (21, False), (21, True), (31, False)])
def test_reference_table_matches_naive_counter(k, canonical):
    r = records(6, 20, 400, 0.02, 11 + k)
    codes, counts = kmers.reference_table(r.stream, k, canonical, "cpu")
    want = naive_table(strings(r), k, canonical)
    assert codes.dtype == np.uint64 and counts.dtype == np.int64
    assert list(codes) == sorted(want)
    assert dict(zip(codes.tolist(), counts.tolist())) == dict(want)


def test_reference_table_chunks_agree(monkeypatch):
    r = records(3, 300, 500, 0.01, 3)
    whole = kmers.reference_table(r.stream, 21, False, "cpu")
    monkeypatch.setattr(kmers, "REF_CHUNK", 37)
    parts = kmers.reference_table(r.stream, 21, False, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(whole, parts))


def naive_distances(seqs: list[str], k: int) -> tuple[np.ndarray, np.ndarray]:
    """Counts [S, 4^k] and the packed float32 distances, pair by pair."""
    S = len(seqs)
    counts = np.zeros((S, 4**k), np.int32)
    for i, s in enumerate(seqs):
        for code, n in naive_table([s], k).items():
            counts[i, code] = n
    out = []
    for i in range(S):
        for j in range(i + 1, S):
            m = int(np.minimum(counts[i], counts[j]).sum())
            denom = min(len(seqs[i]), len(seqs[j])) - k + 1
            out.append(np.float32(1.0) - np.float32(m) / np.float32(denom))
    return counts, np.array(out, np.float32)


@pytest.mark.parametrize("n_fraction", [0.0, 0.02])
def test_reference_distances_match_naive_loop(n_fraction):
    r = records(9, 30, 120, n_fraction, 5)
    want_counts, want = naive_distances(strings(r), 3)
    counts = kmers.reference_counts(r.stream, r.starts, r.lengths, 3, False, "cpu")
    assert np.array_equal(counts.numpy(), want_counts)
    sums = kmers.reference_min_sums(counts, counts).numpy()
    got = kmers.reference_packed(sums, r.lengths, 3)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_min_sums_blocked_rows_agree():
    a = torch.randint(0, 9, (70, 64), dtype=torch.int32)
    want = np.minimum(a.numpy()[:, None, :], a.numpy()[None]).sum(-1)
    assert np.array_equal(kmers.reference_min_sums(a, a).numpy(), want)


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def fails(limits: dict, got: dict) -> list[str]:
    return [n for n, v in got.items() if v > limits[n]]


def test_count_control_is_not_correct():
    """N read as A, at a small size of the count cells' traffic."""
    cfg = config("count_k21")
    r = records(4, 20000, 60000, 0.001, 9)
    inp = fasta.InputFile(0, "", r)
    ref = count_file.reference(cfg, inp, "cpu")
    got = count_file.compare(cfg, inp, count_file.control(cfg, inp, "cpu"), ref)
    assert fails(cfg["limits"], got) == ["table_rows_differing"]
    assert count_file.compare(cfg, inp, ref, ref) == {n: 0 for n in cfg["limits"]}


def test_distance_control_is_not_correct():
    """The finish in bfloat16, at a small size of the distance cell."""
    cfg = config("distance_k3")
    r = records(64, 1000, 2000, 0.0, 4)
    inp = fasta.InputFile(0, "", r)
    ref = distance_file.reference(cfg, inp, "cpu")
    got = distance_file.compare(cfg, inp, distance_file.control(cfg, inp, "cpu"), ref)
    assert fails(cfg["limits"], got) == ["distance_max_abs_err"]
    assert got["distance_max_abs_err"] > 1e-4
    assert distance_file.compare(cfg, inp, ref, ref) == {n: 0 for n in cfg["limits"]}
