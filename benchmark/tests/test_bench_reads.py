"""The read-set generator (``gen/reads.py``), the canonical count cell's
scale, the two readers of the parse and compact counters on synthetic span
logs, and a small copy of the cell run end to end on the CPU, where the
controls must fail its check."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from benchmark import run, spans, trace
from benchmark.gen import fasta, reads
from benchmark.reference import kmers

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CELL = "count_k21c.reads30x"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the cell's parameters at a small size: a 5 kbase genome at 30x
SMALL = dict(files=1, records=[1000, 1000], record_bases=[150, 150], genome_bases=5000,
             coverage=30, minus_share=0.5, substitution_rate=0.0025, n_fraction=0.0002,
             format="fastq")


def generate(tmp_path, seed, params=SMALL, name="a"):
    d = tmp_path / name
    d.mkdir()
    return reads.generate(params, seed, str(d))


def test_same_seed_same_bytes(tmp_path):
    runs = [generate(tmp_path, s, name=n)
            for n, s in (("a", 2**40 + 3), ("b", 2**40 + 3), ("c", 2**40 + 4))]
    a, b, c = (open(r[0].path, "rb").read() for r in runs)
    assert a == b and a != c
    assert np.array_equal(runs[0][0].records.stream, runs[1][0].records.stream)


def test_every_seed_the_same_sizes(tmp_path):
    got = []
    for seed in (1, 2**33 + 1, 2**31 + 7):
        f = generate(tmp_path, seed, name=str(seed))[0]
        r = f.records
        got.append((Path(f.path).stat().st_size, r.stream.size, r.bases,
                    r.lengths.tolist(), r.starts.tolist()))
    assert got[0] == got[1] == got[2]
    assert got[0][2] == 150_000


def test_the_cells_params_give_the_configs_bases():
    w = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    assert w["generator"] == "reads" and cfg["args"] == {"k": 21, "canonical": True}
    for seed in (0, 2**31 + 7):
        lengths = fasta.record_lengths(w["params"], np.random.default_rng(seed))
        assert [x.size for x in lengths] == [1_700_000]
        assert sum(int(x.sum()) for x in lengths) == cfg["fasta_bases"] == 255_000_000
    p = w["params"]
    assert p["records"][0] * p["record_bases"][0] == p["coverage"] * p["genome_bases"]


def test_fastq_layout(tmp_path):
    f = generate(tmp_path, 9)[0]
    lines = open(f.path, "rb").read().split(b"\n")
    assert lines[-1] == b"" and len(lines) == 4 * 1000 + 1
    r = f.records
    letters = np.frombuffer(b"ACGTN", np.uint8)
    for i in range(1000):
        head, seq, plus, qual = lines[4 * i : 4 * i + 4]
        assert head == b"@r%d" % i and plus == b"+" and len(qual) == len(seq) == 150
        codes = r.stream[r.starts[i] : r.starts[i] + 150]
        assert seq == letters[np.minimum(codes, 4)].tobytes()
        q = np.frombuffer(qual, np.uint8)
        assert q.min() >= ord("#") and q.max() <= ord("J")
    assert any(q[:1] in (b"@", b"+") for q in lines[3::4])


@pytest.mark.parametrize("bad, match", [
    (dict(record_bases=[100, 150], coverage=25), "one length"),
    (dict(coverage=20), "not 20x"),
    (dict(format="fasta"), "FASTQ"),
])
def test_params_that_do_not_hold_are_refused(tmp_path, bad, match):
    with pytest.raises(ValueError, match=match):
        generate(tmp_path, 1, {**SMALL, **bad})


# ---- the readers of the parse and compact counters


class FakeCell:
    config = {"args": {"k": 21, "canonical": True}}


def call_records(call, t0, parse, compacts):
    """One count call's records: the root at [t0, t0 + 9], its parse span
    ((bytes, seconds), or None for a parse that counts nothing) and its
    compact spans ((words, rows) each)."""
    recs, t = [], t0 + 0.1
    if parse is not None:
        nbytes, s = parse
        recs.append({"call": call, "name": "parse", "parent": "count_file", "t0": t,
                     "t1": t + s, "sys_s": 0.0,
                     "counters": {} if nbytes is None else {"records": 7, "bytes": nbytes}})
        t += s
    for words, rows in compacts:
        recs.append({"call": call, "name": "compact", "parent": "count_file", "t0": t,
                     "t1": t + 0.2, "sys_s": 0.0,
                     "counters": {} if words is None else {"words": words, "rows": rows}})
        t += 0.2
    recs.append({"call": call, "name": "count_file", "parent": None, "t0": t0, "t1": t0 + 9,
                 "sys_s": 1.0, "counters": {"rows": 5}})
    return recs


def window(traced=True, n_calls=2):
    inp = fasta.InputFile(0, "x", fasta.Records(np.zeros(8, np.uint8), np.array([0]),
                                                np.array([8])))
    calls = [run.Call(inp, 100.0 + 10 * i, 109.95 + 10 * i, 2.5e8, {}) for i in range(n_calls)]
    dev = trace.Trace(device=[dict(ph="X", cat="kernel", name="k", ts=0, dur=1)])
    return run.Run(FakeCell(), calls, 20.0, 5.0, dev if traced else None)


def synthetic_log():
    """A warm-up call before the window and one after it (both left out),
    and two window calls."""
    return (call_records(1, 80.0, (10**12, 0.001), [(10, 10)])
            + call_records(2, 100.0, (3e9, 2.0), [(1000, 400), (1000, 500)])
            + call_records(3, 110.0, (1e9, 2.0), [(2000, 100)])
            + call_records(4, 130.0, (10**12, 0.001), [(10, 10)]))


def read(name, r, monkeypatch, records):
    monkeypatch.setattr(spans, "log", lambda: list(records))
    return run.load_module(BENCH / "metrics" / f"{name}.py").read(r)


@pytest.mark.parametrize("name, want", [
    # (3 + 1) GB over (2 + 2) s
    ("parse_gbytes_per_s", 1.0),
    # (400 + 500 + 100) rows over (1000 + 1000 + 2000) words
    ("d2h_rows_kept_pct", 25.0),
])
def test_readers_on_a_synthetic_log(monkeypatch, name, want):
    assert read(name, window(), monkeypatch, synthetic_log()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["parse_gbytes_per_s", "d2h_rows_kept_pct"])
@pytest.mark.parametrize("case", ["no_records", "outside_only", "untraced", "no_device",
                                  "no_calls", "no_counters"])
def test_nothing_to_read(monkeypatch, name, case):
    r = window(traced=case != "untraced", n_calls=0 if case == "no_calls" else 2)
    records = synthetic_log()
    if case == "no_records":
        records = []
    elif case == "outside_only":
        records = [x for x in records if x["call"] in (1, 4)]
    elif case == "no_device":
        r.trace = trace.Trace()
    elif case == "no_counters":  # a program whose spans count neither
        records = (call_records(2, 100.0, (None, 2.0), [(None, None)])
                   + call_records(3, 110.0, (None, 2.0), [(None, None)]))
    assert read(name, r, monkeypatch, records) is None


# ---- the cell at a small size on the CPU


@pytest.fixture
def bench_copy(tmp_path):
    """The benchmark's files with a small copy of the cell, listed where
    the cell is."""
    d = tmp_path / "bench"
    shutil.copytree(BENCH, d, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    w = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    w.update(name="small.reads", traffic="small", params=SMALL)
    (d / "workloads" / "small.reads.json").write_text(json.dumps(w))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "small.reads", "config": w["config"],
                                  "traffic": "small", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("small.reads")
    return d, manifest


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_and_is_correct(bench_copy, traced):
    d, manifest = bench_copy
    out = run.run_cell(run.Cell.load("small.reads", d), 2**35 + 17, 0.5, traced, "cpu",
                       manifest)
    assert out["correct"] is True and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    want = ({"entry_s_per_gbase", "parse_s_per_gbase.count", "compact_s_per_gbase",
             "merge_s_per_gbase"} if traced else {"count_gbases_per_s", "setup_s"})
    assert set(out["metrics"]) == want  # no device on the CPU: no span reader reads


@pytest.mark.parametrize("control", ["n_as_a", "no_strand_fold"])
def test_the_controls_fail_the_check(bench_copy, control):
    d, _ = bench_copy
    cell = run.Cell.load("small.reads", d)
    inp = cell.generator().generate(cell.workload["params"], 2**31 + 5, str(d))[0]
    ref = cell.entry.reference(cell.config, inp, "cpu")
    if control == "n_as_a":
        got = cell.entry.control(cell.config, inp, "cpu")
    else:
        codes, counts = kmers.reference_table(inp.records.stream, 21, False, "cpu")
        got = {**ref, "codes": codes, "counts": counts}
    checks = cell.entry.compare(cell.config, inp, got, ref)
    assert checks["table_rows_differing"] > 0
    assert checks["bases_differing"] == checks["records_differing"] == 0
