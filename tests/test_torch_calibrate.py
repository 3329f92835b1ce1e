"""Calibration of the distance gates (``ops/calibrate``), modelled on the
JAX package's ``tests/test_calibrate.py``: ``kmer-gpu calibrate`` persists
a file per fingerprint, the file loads back as ``DistanceRates``, a fake
file flips both gates both ways, and no file means the defaults."""

import json

import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu_torch import cli
from dna_kmeres_parallel_tpu_torch.models import sparse_engine
from dna_kmeres_parallel_tpu_torch.ops import calibrate
from dna_kmeres_parallel_tpu_torch.utils import fasta

#: the gates read the card's type only: a plan is made, no kernel runs
CARD = torch.device("cuda")


@pytest.fixture(autouse=True)
def _own_calibration(monkeypatch, tmp_path):
    monkeypatch.setenv("KMER_GPU_CAL_DIR", str(tmp_path / "cal"))
    for name in ("KMER_GPU_CALIBRATION_FILE", "KMER_GPU_DIST_UNION",
                 "KMER_GPU_DENSE_DIST_BUDGET", "KMER_GPU_UNION_DIST_BUDGET"):
        monkeypatch.delenv(name, raising=False)


def run_cli(argv, capsys):
    rc = cli.main([str(a) for a in argv])
    out, err = capsys.readouterr()
    return rc, (json.loads(out.strip().splitlines()[-1]) if out.strip() else None), err


def test_calibrate_link_only_persists_and_round_trips(tmp_path, capsys):
    rc, report, _ = run_cli(["calibrate", "--link-only", "--device", "cpu"], capsys)
    assert rc == 0
    path = tmp_path / "cal" / f"calibration_{calibrate.fingerprint('cpu')}.json"
    assert report["calibration_file"] == str(path) and path.exists()
    saved = json.loads(path.read_text())
    assert saved["fingerprint"] == calibrate.fingerprint("cpu")
    for key in ("h2d_bytes_per_sec", "d2h_bytes_per_sec", "roundtrip_s"):
        assert saved[key] > 0 and report[key] == saved[key]
    rates = calibrate.load_rates(device="cpu", cal_dir=tmp_path / "cal")
    default = sparse_engine.DistanceRates()
    assert rates.h2d_bytes_per_sec == saved["h2d_bytes_per_sec"]
    assert rates.d2h_bytes_per_sec == saved["d2h_bytes_per_sec"]
    assert rates.roundtrip_s == saved["roundtrip_s"]
    # --link-only measures no compute rate: those stay the defaults
    assert rates.bin_pairs_per_sec == default.bin_pairs_per_sec
    assert rates.dense_bin_pairs_per_sec == default.dense_bin_pairs_per_sec
    # A second run keeps what the first measured and it does not.
    saved["bin_pairs_per_sec"] = 123.0
    path.write_text(json.dumps(saved))
    assert run_cli(["calibrate", "--link-only", "--device", "cpu"], capsys)[0] == 0
    assert json.loads(path.read_text())["bin_pairs_per_sec"] == 123.0


def test_calibration_file_env_names_the_file(tmp_path, monkeypatch, capsys):
    path = tmp_path / "explicit.json"
    monkeypatch.setenv("KMER_GPU_CALIBRATION_FILE", str(path))
    rc, report, _ = run_cli(["calibrate", "--link-only", "--device", "cpu"], capsys)
    assert rc == 0 and report["calibration_file"] == str(path) and path.exists()
    assert not (tmp_path / "cal").exists()


def test_measure_compute_on_the_cpu():
    cal = calibrate.measure_compute("cpu", threads=2)
    for key in ("bin_pairs_per_sec", "dense_bin_pairs_per_sec",
                "sparse_entry_pairs_per_sec_per_thread"):
        assert cal[key] > 0, key
    assert cal["threads"] == 2
    assert cal["dense_shape"] == [calibrate.CPU_DENSE_SHAPE[0], 4 ** calibrate.CPU_DENSE_SHAPE[1]]
    rates = calibrate.rates_from(cal)
    assert rates.dense_bin_pairs_per_sec == cal["dense_bin_pairs_per_sec"]
    assert rates.host_threads() == 2


def test_no_file_means_the_defaults(tmp_path):
    assert calibrate.load_calibration(tmp_path / "absent.json") == {}
    assert calibrate.load_rates(tmp_path / "absent.json") == sparse_engine.DistanceRates()
    assert calibrate.load_rates(device="cpu", cal_dir=tmp_path) == sparse_engine.DistanceRates()
    assert calibrate.rates_from({"fingerprint": "x", "union_shape": [1, 2]}) == (
        sparse_engine.DistanceRates())


def test_fingerprint_and_save_are_stable(tmp_path):
    fp = calibrate.fingerprint("cpu")
    assert fp == calibrate.fingerprint(torch.device("cpu")) and "/" not in fp
    path = calibrate.save_calibration({"threads": 3}, tmp_path / "d" / "c.json")
    assert calibrate.load_calibration(path) == {"threads": 3}
    assert not list((tmp_path / "d").glob("*.tmp"))


def _write(tmp_path, monkeypatch, cal: dict):
    path = tmp_path / "fake_cal.json"
    path.write_text(json.dumps(cal))
    monkeypatch.setenv("KMER_GPU_CALIBRATION_FILE", str(path))
    return calibrate.load_rates(path)


def test_fake_file_flips_dense_distance_preferred(tmp_path, monkeypatch):
    lengths = [1000] * 64
    fast_dense = _write(tmp_path, monkeypatch, {"dense_bin_pairs_per_sec": 1e16})
    assert sparse_engine.dense_distance_preferred(64, 9, lengths, rates=fast_dense)
    slow_dense = _write(tmp_path, monkeypatch, {"dense_bin_pairs_per_sec": 1e6})
    assert not sparse_engine.dense_distance_preferred(64, 9, lengths, rates=slow_dense)
    # the union shape's rate is not the dense gate's
    union_only = _write(tmp_path, monkeypatch, {"bin_pairs_per_sec": 1e6,
                                                "dense_bin_pairs_per_sec": 1e16})
    assert sparse_engine.dense_distance_preferred(64, 9, lengths, rates=union_only)


def _reads(n=24, L=100, seed=3):
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 1200)].tobytes().decode()
    starts = rng.integers(0, len(genome) - L + 1, size=n)
    return [genome[s : s + L] for s in starts]


def test_fake_file_flips_union_dense_plan(tmp_path, monkeypatch):
    codes, cnts, offs = sparse_engine.build_pair_tables(_reads(), 21, device="cpu")
    slow_link = _write(tmp_path, monkeypatch, {
        "h2d_bytes_per_sec": 1e4, "d2h_bytes_per_sec": 1e4, "roundtrip_s": 10.0})
    assert sparse_engine.union_dense_plan(codes, cnts, offs, device=CARD, threshold="off",
                                          rates=slow_link) is None
    fast_card = _write(tmp_path, monkeypatch, {
        "h2d_bytes_per_sec": 1e13, "d2h_bytes_per_sec": 1e13, "roundtrip_s": 0.0,
        "bin_pairs_per_sec": 1e16, "sparse_entry_pairs_per_sec_per_thread": 1e3,
        "threads": 1})
    assert sparse_engine.union_dense_plan(codes, cnts, offs, device=CARD, threshold="off",
                                          rates=fast_card) is not None
    # the dense shape's rate is not the union gate's
    dense_only = _write(tmp_path, monkeypatch, {
        "h2d_bytes_per_sec": 1e13, "d2h_bytes_per_sec": 1e13, "roundtrip_s": 0.0,
        "bin_pairs_per_sec": 1.0, "dense_bin_pairs_per_sec": 1e16,
        "sparse_entry_pairs_per_sec_per_thread": 1e3, "threads": 1})
    assert sparse_engine.union_dense_plan(codes, cnts, offs, device=CARD, threshold="off",
                                          rates=dense_only) is None


@pytest.mark.parametrize("rate,route", [(1e16, "gpu"), (1e3, "host/sparse")])
def test_distance_command_routes_by_the_file(tmp_path, monkeypatch, capsys, rate, route):
    # kmer-gpu distance at k=9 reads the file through the dense router.
    path = tmp_path / "in.fasta"
    fasta.write_fasta(path, [(f"r{i}", s) for i, s in enumerate(_reads(8, 300))])
    _write(tmp_path, monkeypatch, {"dense_bin_pairs_per_sec": rate})
    rc, report, _ = run_cli(["distance", "--device", "cpu", "--k", 9, path], capsys)
    assert rc == 0 and report["engine"] == route


def test_union_switch_and_budget_env(tmp_path, monkeypatch, capsys):
    path = tmp_path / "in.fasta"
    fasta.write_fasta(path, [(f"r{i}", s) for i, s in enumerate(_reads())])
    monkeypatch.setenv("KMER_GPU_DIST_UNION", "1")
    rc, report, _ = run_cli(["distance", "--device", "cpu", "--k", 21, path], capsys)
    assert rc == 0 and report["engine"] == "union/plain"
    monkeypatch.setenv("KMER_GPU_UNION_DIST_BUDGET", "1000")
    rc, report, _ = run_cli(["distance", "--device", "cpu", "--k", 21, path], capsys)
    assert rc == 0 and report["engine"] == "host/sparse"
    monkeypatch.delenv("KMER_GPU_UNION_DIST_BUDGET")
    monkeypatch.delenv("KMER_GPU_DIST_UNION")
    seqs = _reads(8, 300)
    fasta.write_fasta(path, [(f"r{i}", s) for i, s in enumerate(seqs)])
    _write(tmp_path, monkeypatch, {"dense_bin_pairs_per_sec": 1e16})
    assert run_cli(["distance", "--device", "cpu", "--k", 9, path], capsys)[1]["engine"] == "gpu"
    monkeypatch.setenv("KMER_GPU_DENSE_DIST_BUDGET", "1000")  # the [8, 4^9] matrix is over it
    assert run_cli(["distance", "--device", "cpu", "--k", 9, path], capsys)[1]["engine"] == (
        "host/sparse")
    monkeypatch.setenv("KMER_GPU_DIST_UNION", "sometimes")
    assert run_cli(["distance", "--device", "cpu", "--k", 21, path], capsys)[0] == 2
