"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and sizes, that every configuration and cell has its data files, and that
each per-layer metric is listed only for cells that report the end-to-end
metric it moves."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from benchmark.gen import fasta

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per")


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(text_ok(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch") and (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w == p or w.startswith(p + "/") for p in paths), w
            assert (ROOT / w).exists()


def test_configs():
    cfgs = MANIFEST["configs"]
    assert 1 <= len(cfgs) <= 24
    names = [c["name"] for c in cfgs]
    assert len(set(names)) == len(names)
    files = set()
    for c in cfgs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"]) and text_ok(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)
            assert key in data and key in data["published"]
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_workloads_have_their_files():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    configs = {c["name"] for c in MANIFEST["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert text_ok(w["why"]) and w["config"] in configs
        data = json.loads((ROOT / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        for key in ("name", "config", "traffic", "chips", "why"):
            assert data[key] == w[key], key
        assert (ROOT / "benchmark" / "gen" / f"{data['generator']}.py").exists()
        cfg = json.loads((ROOT / "benchmark" / "configs" / f"{w['config']}.json").read_text())
        assert (ROOT / "benchmark" / "entries" / f"{cfg['entry']}.py").exists()


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_config_scale_is_what_its_cells_generate(cell):
    """A configuration's stated scale (``fasta_bases``: bases a run;
    ``records``: records a file) is what each of its cells' traffic makes,
    on any seed."""
    w = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{w['config']}.json").read_text())
    assert "fasta_bases" in cfg or "records" in cfg
    for seed in (0, 2**31 + 7):
        lengths = fasta.record_lengths(w["params"], np.random.default_rng(seed))
        if "fasta_bases" in cfg:
            assert sum(int(x.sum()) for x in lengths) == cfg["fasta_bases"]
        if "records" in cfg:
            assert all(x.size == cfg["records"] for x in lengths)


def metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_metric_names_units_sources():
    names = [m["name"] for m in metrics()]
    assert len(set(names)) == len(names)
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert text_ok(m["layer"]) and m["source"] in SOURCES
    for m in metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell) for m in MANIFEST["per_layer"])


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in MANIFEST["workloads"]]):
            assert reports(moved, cell), (m["name"], cell)


def test_one_layer_name_per_layer():
    """Metrics of one layer give its name letter for letter, as PERF.md's
    list of layers has it."""
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in MANIFEST["per_layer"]}:
        assert f"`{layer}`" in perf, layer
