"""The port's spans (``utils/profiling``) on the CPU: a span adds to
``phases`` what the engines' laps added; with the profiler off it logs
nothing and opens no range; under ``torch.profiler`` its records nest
under one call id and its ranges reach the exported trace; the log is
bounded; the engines keep their ``phases`` keys; and the counters the
benchmark reads count what they say (``merge.pair`` rows, ``d2h.copy``
bytes, the root's rows, the parse's records and file bytes, each
compaction's words and rows)."""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import engine, sparse_engine
from dna_kmeres_parallel_tpu_torch.utils import profiling
from dna_kmeres_parallel_tpu_torch.utils.metrics import Metrics


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear()
    yield
    profiling.clear()


def recorded():
    return profile(activities=[ProfilerActivity.CPU])


def seqs(n=12, seed=5):
    rng = np.random.default_rng(seed)
    return ["".join("ACGT"[b] for b in rng.integers(0, 4, 150 + 9 * i)) for i in range(n)]


@pytest.fixture
def fasta(tmp_path):
    path = tmp_path / "in.fasta"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs())))
    return path


class FakeClock:
    def __init__(self, start, step):
        self.t, self.step = start, step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.mark.parametrize("before", [None, 0.0, 2.5])
@pytest.mark.parametrize("step", [0.125, 3.0])
def test_span_adds_its_seconds_as_a_lap(monkeypatch, before, step):
    # a lap added now - t to phases[name]: the span adds its exit minus
    # its entry, to a missing key, a zero and a running sum alike
    monkeypatch.setattr(profiling.time, "perf_counter", FakeClock(10.0, step))
    phases = {} if before is None else {"merge": before}
    with profiling.span("merge", phases):
        pass
    with profiling.span("merge", phases):
        pass
    assert phases == {"merge": (before or 0.0) + 2 * step}


def test_metrics_phase_is_a_span(monkeypatch):
    monkeypatch.setattr(profiling.time, "perf_counter", FakeClock(0.0, 0.5))
    m = Metrics()
    with m.phase("compact"):
        with m.phase("fetch"):
            pass
    assert dict(m.phase_seconds) == {"compact": 1.5, "fetch": 0.5}
    assert set(m.report()) == {"counters", "phase_seconds", "wall_seconds"}


def no_range(name):
    raise AssertionError(f"a range was opened with the profiler off: {name}")


@pytest.mark.parametrize("entry", ["span", "metrics", "count_file", "distance_file"])
def test_profiler_off_logs_nothing(monkeypatch, fasta, entry):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    if entry == "span":
        with profiling.span("a", {}) as s:
            s.count("rows", 3)
    elif entry == "metrics":
        with Metrics().phase("parse"):
            pass
    elif entry == "count_file":
        port.count_file(fasta, k=21, device="cpu", batch_bases=512)
    else:
        port.distance_file(fasta, k=3, device="cpu")
    assert profiling.records() == []


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_records_nest_under_one_call(tmp_path, depth):
    with recorded() as prof:
        for _ in range(2):
            stack = [profiling.span(f"s{i}") for i in range(depth)]
            for s in stack:
                s.__enter__()
            stack[-1].count("rows", 7)
            for s in reversed(stack):
                s.__exit__(None, None, None)
    recs = profiling.records()
    assert len(recs) == 2 * depth
    calls = collections.defaultdict(list)
    for r in recs:
        calls[r["call"]].append(r)
        assert r["t0"] <= r["t1"] and r["sys_s"] >= 0.0
    assert len(calls) == 2
    for group in calls.values():
        by_name = {r["name"]: r for r in group}
        assert by_name["s0"]["parent"] is None
        for i in range(1, depth):
            child, parent = by_name[f"s{i}"], by_name[f"s{i - 1}"]
            assert child["parent"] == f"s{i - 1}"
            assert parent["t0"] <= child["t0"] <= child["t1"] <= parent["t1"]
        assert by_name[f"s{depth - 1}"]["counters"] == {"rows": 7}
    assert [r["seq"] for r in recs] == sorted(r["seq"] for r in recs)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    names = collections.Counter(e.get("name") for e in json.loads(path.read_text())["traceEvents"])
    for i in range(depth):
        assert names[f"kmer.s{i}"] == 2


@pytest.mark.parametrize("spans", [3, 40])
def test_log_is_bounded(monkeypatch, spans):
    monkeypatch.setattr(profiling, "_log", collections.deque(maxlen=8))
    with recorded():
        for i in range(spans):
            with profiling.span(f"s{i}"):
                pass
    recs = profiling.records()
    assert len(recs) == min(spans, 8)
    assert recs[-1]["name"] == f"s{spans - 1}"


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("entry, keys", [
    ("count_file21", sparse_engine.PHASES),
    ("count_sequences21", sparse_engine.PHASES),
    ("count_file5", engine.COUNT_PHASES),
    ("distance_file", engine.DIST_PHASES),
    ("distance_sequences", engine.DIST_PHASES),
])
def test_entries_keep_their_phase_keys(fasta, traced, entry, keys):
    def call():
        if entry == "count_file21":
            return port.count_file(fasta, k=21, device="cpu", batch_bases=512)
        if entry == "count_sequences21":
            return port.count_sequences(seqs(), k=21, device="cpu", batch_bases=512)
        if entry == "count_file5":
            return port.count_file(fasta, k=5, device="cpu", batch_bases=512)
        if entry == "distance_file":
            return port.distance_file(fasta, k=3, device="cpu")
        return port.distance_sequences(seqs(), k=3, device="cpu")

    if traced:
        with recorded():
            res = call()
    else:
        res = call()
    assert set(res.phases) == set(keys)
    assert all(v >= 0.0 for v in res.phases.values())
    roots = [r for r in profiling.records() if r["parent"] is None]
    if not traced:
        assert roots == []
        return
    assert [r["name"] for r in roots] == [entry.rstrip("0123456789")]
    rows = res.packed.shape[0] if "distance" in entry else (
        res.hist.shape[0] if entry == "count_file5" else res.codes.shape[0])
    # a sparse call's root also says where its table was built: on the
    # host, on the CPU
    want = {"rows": rows, "table_on_card": 0} if entry.endswith("21") else {"rows": rows}
    assert roots[0]["counters"] == want
    assert {r["call"] for r in profiling.records()} == {roots[0]["call"]}


@pytest.mark.parametrize("n", [2, 4, 16])
def test_merge_pairs_write_each_row_log2_n_times(n):
    # n disjoint tables: a binary tree of pair merges writes every row once
    # a level, log2(n) levels
    rng = np.random.default_rng(n)
    codes = np.sort(rng.choice(1 << 40, size=300 * n, replace=False).astype(np.uint64))
    tables = [(codes[i::n].copy(), rng.integers(1, 9, 300).astype(np.int64)) for i in range(n)]
    with recorded():
        got = native.merge_tables_native(tables)
    assert np.array_equal(got[0], codes)
    pairs = [r for r in profiling.records() if r["name"] == "merge.pair"]
    assert len(pairs) == n - 1
    assert sum(r["counters"]["rows_out"] for r in pairs) == int(np.log2(n)) * codes.size


def test_sparse_count_spans(fasta):
    with recorded():
        res = port.count_file(fasta, k=21, device="cpu", batch_bases=512)
    recs = profiling.records()
    names = collections.Counter((r["name"], r["parent"]) for r in recs)
    batches = names[("compact", "count_file")]
    assert batches > 1
    for name in ("staging", "d2h"):
        assert names[(name, "count_file")] == batches
    assert names[("d2h.wait", "d2h")] == names[("d2h.copy", "d2h")] == batches
    assert names[("parse", "count_file")] == 1
    assert names[("merge.pair", "merge")] == batches - 1
    # k=21's words, one slot of each batch's padded length T: a u32 low
    # plane and a u16 high plane (42 bits)
    total = sum(len(s) + 1 for s in seqs()) - 1
    _, T = engine.batch_plan(total, 21, 512)
    copies = [r["counters"]["bytes"] for r in recs if r["name"] == "d2h.copy"]
    assert copies == [T * (4 + 2)] * batches
    assert next(r for r in recs if r["parent"] is None)["counters"] == {
        "rows": res.codes.size, "table_on_card": 0}


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_sparse_parse_counts_records_and_file_bytes(tmp_path, fmt):
    path = tmp_path / f"in.{fmt}"
    if fmt == "fasta":
        path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs())))
    else:  # quality lines that begin with '@' and '+'
        path.write_text("".join(f"@r{i}\n{s}\n+\n{'@+' + 'I' * (len(s) - 2)}\n"
                                for i, s in enumerate(seqs())))
    with recorded():
        port.count_file(path, k=21, device="cpu")
    (parse,) = [r for r in profiling.records() if r["name"] == "parse"]
    # a file under the library's thread grain is parsed as one range
    assert parse["counters"] == {"records": 12, "bytes": path.stat().st_size, "ranges": 1}


@pytest.mark.parametrize("k, repeats", [(21, 1), (21, 3), (10, 1)])
def test_sparse_compact_counts_words_and_rows(tmp_path, k, repeats):
    # every window of these reads is distinct, so a batch table holds one
    # row a valid window, unless the reads repeat inside the batch; k=10
    # counts on the sparse counter and densifies
    reads = [s for s in seqs() for _ in range(repeats)]
    path = tmp_path / "in.fasta"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    with recorded():
        res = port.count_file(path, k=k, device="cpu", batch_bases=2048)
    compacts = [r["counters"] for r in profiling.records() if r["name"] == "compact"]
    total = sum(len(s) + 1 for s in reads) - 1
    _, T = engine.batch_plan(total, k, 2048)
    assert len(compacts) == -(-total // 2048) > 1
    assert [c["words"] for c in compacts] == [T] * len(compacts)
    windows = sum(len(s) - k + 1 for s in reads)
    rows = sum(c["rows"] for c in compacts)
    if k == 10:
        assert 0 < rows <= windows
    elif repeats == 1:
        assert rows == windows == res.counts.sum() == res.codes.size
    else:  # repeats fold inside a batch table; the merge folds the rest
        assert res.distinct_kmers <= rows < windows


@pytest.mark.parametrize("k", [2, 3])
def test_distance_copy_counts_the_results_bytes(fasta, k):
    with recorded():
        res = port.distance_file(fasta, k=k, device="cpu")
    copies = [r for r in profiling.records() if r["name"] == "d2h.copy"]
    assert len(copies) == 1
    S = res.n
    assert res.counts.nbytes == S * 4**k * 4
    # the packed float32 triangle, finished on the counts' device, and the
    # counts: the [S, S] min-sums stay where the product left them
    assert res.packed.nbytes == S * (S - 1) // 2 * 4
    assert copies[0]["counters"] == {"bytes": res.packed.nbytes + res.counts.nbytes}
    names = [r["name"] for r in profiling.records()]
    assert names == ["parse", "finish", "d2h.wait", "d2h.copy", "d2h", "distance_file"]
    finish = next(r for r in profiling.records() if r["name"] == "finish")
    assert finish["parent"] == "d2h" and finish["counters"] == {"device_pairs": 0}


def test_trace_writes_the_blocks_spans(tmp_path):
    with recorded():
        with profiling.span("before"):
            pass
    out = tmp_path / "trace"
    with profiling.trace(str(out)):
        with profiling.span("root") as root:
            root.count("rows", 2)
            with Metrics().phase("parse"):
                pass
    assert (out / "trace.json").stat().st_size > 0
    lines = [json.loads(x) for x in (out / "spans.jsonl").read_text().splitlines()]
    assert [r["name"] for r in lines] == ["parse", "root"]
    assert lines[0]["parent"] == "root" and lines[1]["counters"] == {"rows": 2}
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    assert {"kmer.root", "kmer.parse"} <= {e.get("name") for e in events}


def test_trace_without_a_dir_is_a_no_op(tmp_path):
    with profiling.trace(None):
        with profiling.span("x"):
            pass
    assert profiling.records() == [] and list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("k", [5, 21])
def test_streaming_trace_dir_writes_the_metrics_phases(fasta, tmp_path, k):
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    out = tmp_path / "trace"
    sc = StreamingCounter(port.KmerConfig(k=k, batch_bases=1024), device="cpu",
                          trace_dir=str(out))
    sc.run(str(fasta))
    lines = [json.loads(x) for x in (out / "spans.jsonl").read_text().splitlines()]
    # every phase the report times inside the trace (the parse comes
    # before it) is a span of the trace, by its name
    timed = set(sc.metrics.phase_seconds) - {"parse"}
    assert "device" in timed and timed <= {r["name"] for r in lines}
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    assert {"kmer." + name for name in timed} <= {e.get("name") for e in events}
