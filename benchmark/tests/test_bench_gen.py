"""The traffic generator: deterministic per seed, and its bases, lengths
and record format follow the workload files."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.gen import fasta

BENCH = Path(__file__).resolve().parents[1]


def parse(path: str) -> list[tuple[str, str]]:
    """A naive FASTA reader: (header, sequence) a record."""
    out = []
    for block in open(path).read().split(">")[1:]:
        head, _, body = block.partition("\n")
        out.append((head, body.replace("\n", "")))
    return out


@pytest.fixture(scope="module")
def cells():
    return {p.stem: json.loads(p.read_text()) for p in (BENCH / "workloads").glob("*.json")}


def test_same_seed_same_bytes(tmp_path):
    params = dict(files=2, records=[3, 7], file_bases=[5000, 9000], min_record_bases=100,
                  n_fraction=0.01, line_width=60)
    runs = []
    for name, seed in (("a", 2**40 + 3), ("b", 2**40 + 3), ("c", 2**40 + 4)):
        (tmp_path / name).mkdir()
        runs.append(fasta.generate(params, seed, str(tmp_path / name)))
    for fa, fb, fc in zip(*runs):
        assert open(fa.path, "rb").read() == open(fb.path, "rb").read()
        assert open(fa.path, "rb").read() != open(fc.path, "rb").read()


def test_spread_gives_every_seed_the_same_sizes(tmp_path):
    params = dict(files=5, records=[1, 20], file_bases=[20000, 60000],
                  min_record_bases=500, n_fraction=0.0)
    sizes = []
    for seed in (1, 2**33 + 1):
        d = tmp_path / str(seed)
        d.mkdir()
        files = fasta.generate(params, seed, str(d))
        sizes.append([f.records.bases for f in files])
    assert sorted(sizes[0]) == sorted(sizes[1])
    assert sizes[0] != sizes[1]  # the seed changes the order
    assert min(sizes[0]) >= 20000 and max(sizes[0]) <= 60000


@pytest.mark.parametrize("cell", ["count_k21.genome", "count_k21.bacteria",
                                  "distance_k3.all_pairs"])
def test_records_follow_the_workload_file(cell, cells, tmp_path):
    """At a smaller scale of each cell's own parameters: the file parses to
    the generator's records, lengths in range, N at the stated share."""
    p = dict(cells[cell]["params"])
    p["files"] = min(p["files"], 3)
    if "record_bases" in p:
        lo, hi = p["record_bases"]
        p["record_bases"] = [lo // 100, hi // 100]
        p["records"] = [min(p["records"][0], 50), min(p["records"][1], 50)]
    else:
        lo, hi = p["file_bases"]
        p["file_bases"] = [lo // 100, hi // 100]
        p["min_record_bases"] = 10
    files = fasta.generate(p, 7, str(tmp_path))
    assert len(files) == p["files"]
    n_total = valid = 0
    for f in files:
        recs = parse(f.path)
        r = f.records
        assert len(recs) == r.lengths.size
        assert p["records"][0] <= len(recs) <= p["records"][1] or "file_bases" in p
        letters = np.frombuffer(b"ACGT", np.uint8)
        for i, (head, seq) in enumerate(recs):
            assert head == f"seq{i} synthetic"
            codes = r.stream[r.starts[i] : r.starts[i] + r.lengths[i]]
            want = np.where(codes < 4, letters[np.minimum(codes, 3)], ord("N")).tobytes()
            assert seq.encode() == want
            if "record_bases" in p:
                assert p["record_bases"][0] <= len(seq) <= p["record_bases"][1]
            n_total += len(seq)
            valid += int((codes < 4).sum())
        lines = open(f.path).read().split("\n")
        assert max(len(x) for x in lines if not x.startswith(">")) <= p["line_width"]
        if "file_bases" in p:
            assert p["file_bases"][0] <= r.bases <= p["file_bases"][1]
        # one INVALID separator between records, none elsewhere but N
        assert np.all(r.stream[r.starts[1:] - 1] == fasta.INVALID)
    share = 1 - valid / n_total
    if p["n_fraction"] == 0:
        assert share == 0
    else:
        assert 0.5 * p["n_fraction"] < share < 1.5 * p["n_fraction"]


def test_bases_are_uniform(tmp_path):
    rec = fasta.make_records(np.array([400_000]), 0.0, np.random.default_rng(5))
    counts = np.bincount(rec.stream, minlength=4)[:4] / rec.stream.size
    assert np.all(np.abs(counts - 0.25) < 0.005)
