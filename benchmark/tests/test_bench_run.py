"""The harness end to end on the CPU (the kernels' plain versions), past its
look for a card: a cell added as data files alone, the timed path broken
underneath (``correct`` must come out false), the check for JAX modules,
and the exit without a card. One test drives a cell on the card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.gen import fasta

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

TINY = {
    "tiny.count": ("count_k21", {"files": 3, "records": [1, 5], "file_bases": [30000, 90000],
                                 "min_record_bases": 1000,
                                 "n_fraction": 0.001, "line_width": 80}),
    "tiny.distance": ("distance_k3", {"files": 1, "records": [40, 40],
                                      "record_bases": [100, 300],
                                      "n_fraction": 0.0, "line_width": 80}),
}


def add_cell(bench_dir: Path, manifest: dict, name: str, like: str) -> None:
    """A throwaway cell: one new workload file, and the manifest's entries
    that list the cell ``like`` listing it too."""
    config, params = TINY[name]
    (bench_dir / "workloads" / f"{name}.json").write_text(json.dumps({
        "name": name, "config": config, "traffic": name.split(".")[1], "chips": 1,
        "why": "a throwaway cell", "generator": "fasta", "keep_per_input": 1,
        "params": params}))
    manifest["workloads"].append({"name": name, "config": config,
                                  "traffic": name.split(".")[1], "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark's files in a temporary folder, and of the
    manifest, with the two throwaway cells added by new files alone and
    the per-file tail reported by the count cell."""
    d = tmp_path / "bench"
    shutil.copytree(BENCH, d, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    add_cell(d, manifest, "tiny.count", "count_k21.genome")
    add_cell(d, manifest, "tiny.distance", "distance_k3.all_pairs")
    # a metric whose reader is there but that no cell of BENCHMARK.json
    # lists: one manifest entry makes the cell report it
    manifest["end_to_end"].append({"name": "count_file_s.p95", "unit": "s", "better": "lower",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["tiny.count"]})
    return d, manifest


def run_tiny(bench_copy, name: str, traced: bool = False, seed: int = 2**35 + 17) -> dict:
    d, manifest = bench_copy
    return run.run_cell(run.Cell.load(name, d), seed, 0.5, traced, "cpu", manifest)


@pytest.mark.parametrize("name", list(TINY))
@pytest.mark.parametrize("traced", [False, True])
def test_throwaway_cell_runs_from_data_files(bench_copy, name, traced):
    out = run_tiny(bench_copy, name, traced)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 for c in out["checks"].values())
    got = set(out["metrics"])
    if traced:  # no device on the CPU: the trace's readers read nothing
        want = {"d2h_s.distance", "finish_s.distance"} if "distance" in name else {
            "entry_s_per_gbase", "parse_s_per_gbase.count", "compact_s_per_gbase",
            "merge_s_per_gbase"}
        assert got == want and out["device"]["busy_s"] == 0
        assert "breakdown" in out
    else:
        want = {"distance_mpairs_per_s"} if "distance" in name else {
            "count_gbases_per_s", "count_file_s.p95"}
        assert got == want | {"setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_a_new_metric_is_a_new_file(bench_copy):
    d, manifest = bench_copy
    (d / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    manifest["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                                  "better": "higher", "source": "host_clock", "layer": "entry",
                                  "moves": "count_gbases_per_s", "workloads": ["tiny.count"]})
    out = run_tiny(bench_copy, "tiny.count", traced=True)
    assert out["metrics"]["calls_in_window"]["value"] == out["attempted"]


def _faults():
    """Faults planted in the timed path: name -> (owner, attribute, the
    replacement)."""
    from dna_kmeres_parallel_tpu_torch.models import engine, sparse_engine
    from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda

    def half(words, k):  # half of each batch's windows left out
        return orig_compact(tuple(w[: w.shape[0] // 2] for w in words), k)

    def altered(words, k):  # one count altered where it is produced
        codes, counts = orig_compact(words, k)
        counts = counts.copy()
        counts[len(counts) // 2] += 1
        return codes, counts

    def zero_product(counts):  # the product's output never written
        S = counts.shape[0]
        return torch.zeros(S, S, dtype=torch.int32, device=counts.device)

    def half_rows(self, stream, offsets, lengths):  # half of the records left out
        out = orig_counts(self, stream, offsets, lengths)
        out[out.shape[0] // 2:] = 0
        return out

    def wrong_finish(sums, lengths, k):  # one distance altered
        out = orig_finish(sums, lengths, k).copy()
        out[0] += np.float32(0.25)
        return out

    orig_compact = sparse_engine.compact_unsorted
    orig_counts = engine.KmerEngine._counts_on_device
    orig_finish = distance.finish_packed
    return {
        "count.state_unchanged": (sparse_engine.MergeLadder, "push", lambda self, t: None),
        "count.half_batch": (sparse_engine, "compact_unsorted", half),
        "count.answer_altered": (sparse_engine, "compact_unsorted", altered),
        "distance.state_unchanged": (distance_cuda, "min_sum_matrix_tri", zero_product),
        "distance.half_batch": (engine.KmerEngine, "_counts_on_device", half_rows),
        "distance.answer_altered": (distance, "finish_packed", wrong_finish),
    }


FAULTS = ["count.state_unchanged", "count.half_batch", "count.answer_altered",
          "distance.state_unchanged", "distance.half_batch", "distance.answer_altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_timed_path_is_not_correct(bench_copy, monkeypatch, fault):
    target, attr, fn = _faults()[fault]
    monkeypatch.setattr(target, attr, fn)
    name = "tiny.count" if fault.startswith("count") else "tiny.distance"
    out = run_tiny(bench_copy, name)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_forbidden_modules_by_whole_top_level_name():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "jaxtyping",
            "dna_kmeres_parallel_tpu", "dna_kmeres_parallel_tpu.ops.encode",
            "dna_kmeres_parallel_tpu_torch", "dna_kmeres_parallel_tpu_torch.ops", "numpy"]
    assert run.forbidden_loaded(mods) == [
        "dna_kmeres_parallel_tpu", "dna_kmeres_parallel_tpu.ops.encode", "flax.linen",
        "jax", "jax.numpy", "jaxlib.xla_client"]


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole run in a fresh process (the throwaway count cell on the
    CPU), then the check the harness makes after the window."""
    code = f"""
import json, shutil, sys
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
from benchmark import run
from benchmark.tests import test_bench_run as t
d = Path({str(tmp_path)!r}) / "b"
shutil.copytree(t.BENCH, d, ignore=shutil.ignore_patterns("tests", "__pycache__"))
m = json.loads(json.dumps(t.MANIFEST))
t.add_cell(d, m, "tiny.count", "count_k21.genome")
out = run.run_cell(run.Cell.load("tiny.count", d), 5, 0.3, False, "cpu", m)
print(json.dumps([out["correct"], run.forbidden_loaded()]))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, []]


def test_exit_without_a_card_prints_no_result(tmp_path):
    """Without CUDA (or the cards the cell asks for) the run exits nonzero
    and prints nothing on standard output; in a folder holding only
    BENCHMARK.json and the benchmark it does the same."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the look for one passes")
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", lone)
    shutil.copytree(BENCH, lone / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, lone):
        res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                              "count_k21.genome", "--seed", str(2**33), "--seconds", "1",
                              "--trace", "0"], capture_output=True, text=True, timeout=120,
                             cwd=cwd)
        assert res.returncode != 0 and res.stdout == ""


def test_native_parse_reads_the_generators_stream(tmp_path):
    """The program parses the written file into the generator's own stream,
    so the reference and the program read the same records."""
    from dna_kmeres_parallel_tpu_torch import native

    params = dict(TINY["tiny.count"][1], n_fraction=0.01)
    for f in fasta.generate(params, 99, str(tmp_path)):
        parsed = native.parse_fasta_native(f.path)
        assert np.array_equal(parsed.stream, f.records.stream)
        assert parsed.total_bases == f.records.bases


@pytest.mark.cuda
def test_distance_cell_on_the_card():
    """A short run of the distance cell on the card, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = run.run_cell(run.Cell.load("distance_k3.all_pairs"), 2**31 + 5, 1.0, False,
                       "cuda", MANIFEST)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
