"""The port's microbenchmarks (``models/benchmarks``) and ``kmer-gpu
bench`` on the CPU at a tiny size: every report has the JAX package's
keys, counts its windows exactly, and its timing is valid."""

import json

import pytest

from dna_kmeres_parallel_tpu_torch import cli
from dna_kmeres_parallel_tpu_torch.models import benchmarks

#: the keys of the JAX package's reports (its two-size count report and
#: its sparse and distance reports)
COUNT_KEYS = {"bench", "k", "canonical", "bins", "total_bases", "requested_total_bases",
              "batch_bases", "elapsed_s", "gbases_per_sec", "bases_per_sec", "timing_valid",
              "windows_counted", "windows_expected", "device"}
SPARSE_KEYS = {"bench", "k", "canonical", "device_sort", "row_len", "total_bases",
               "batch_bases", "elapsed_s", "gbases_per_sec", "timing_valid",
               "windows_counted", "windows_expected", "device"}
DISTANCE_KEYS = {"bench", "k", "impl", "cmax", "n_seqs", "seq_len", "n_pairs", "elapsed_s",
                 "pairs_per_sec", "device"}


def exact(report) -> bool:
    return report["timing_valid"] and report["windows_counted"] == report["windows_expected"]


@pytest.mark.parametrize("k,canonical,pack_input", [
    (1, False, True), (3, True, True), (2, False, False), (4, False, True), (6, True, False),
    (8, False, True),
])
def test_count_bench(k, canonical, pack_input):
    r = benchmarks.run_count_bench(k=k, canonical=canonical, total_bases=3 << 12,
                                   batch_bases=1 << 12, device="cpu", pack_input=pack_input)
    assert COUNT_KEYS <= set(r) and exact(r)
    assert r["n_batches"] == 3 and r["windows_expected"] == 3 * ((1 << 12) - k + 1)
    assert r["bench"] == "count" and r["bins"] == 4**k and r["device"] == "cpu"


def test_count_bench_refuses_sparse_k():
    with pytest.raises(ValueError, match="k <= 8"):
        benchmarks.run_count_bench(k=9, total_bases=4096, device="cpu")


@pytest.mark.parametrize("k,canonical,kw", [
    (21, False, {}), (11, True, {}), (31, False, {"pack_input": False}),
    (13, False, {"device_sort": True, "row_len": 128}),
    (21, True, {"device_sort": True, "row_len": 0}),
    (15, False, {"device_sort": True, "row_len": 128, "pallas_sort": True}),
])
def test_sparse_bench(k, canonical, kw):
    r = benchmarks.run_sparse_bench(k=k, canonical=canonical, total_bases=2 << 12,
                                    batch_bases=1 << 12, device="cpu", **kw)
    assert SPARSE_KEYS <= set(r) and exact(r)
    assert r["windows_expected"] == 2 * ((1 << 12) - k + 1)


@pytest.mark.parametrize("k,impl", [(3, "auto"), (5, "plain"), (9, "auto")])
def test_distance_bench(k, impl):
    r = benchmarks.run_distance_bench(n_seqs=12, seq_len=150, k=k, impl=impl, reps=2,
                                      device="cpu")
    assert DISTANCE_KEYS <= set(r) and exact(r)
    assert r["n_pairs"] == 66 and r["impl"] == "plain" and r["cmax"] >= 1
    with pytest.raises(ValueError):
        benchmarks.run_distance_bench(n_seqs=4, seq_len=20, impl="mxu", device="cpu")


def test_impl_matrix_bench():
    reports = benchmarks.run_impl_matrix_bench(ks=(2, 4, 8), total_bases=1 << 12, reps=2,
                                               device="cpu")
    assert [(r["k"], r["impl"]) for r in reports] == [
        (2, "packed"), (2, "u8"), (4, "planes"), (4, "u8"), (8, "planes"), (8, "u8")]
    assert [r["kernel"] for r in reports] == [
        "hist_packed_small", "hist_u8_small", "hist_planes", "hist_u8", "hist_planes", "hist_u8"]
    assert all(r["exact"] and r["timing_valid"] for r in reports)


@pytest.mark.parametrize("k,bench", [(8, "count"), (21, "sparse_count")])
def test_bench_command(capsys, k, bench):
    rc = cli.main(["bench", "--device", "cpu", "--k", str(k), "--bases", "8K", "--batch", "4K"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["bench"] == bench and exact(report)
    assert report["total_bases"] == 8192
