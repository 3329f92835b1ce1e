"""The span readers (``benchmark/spans.py`` and the five metric files that
read it) on synthetic span logs: what each reads, that records of calls
outside the window's calls are left out, and that a run with no records,
no trace or no device activity reads nothing."""

from pathlib import Path

import numpy as np
import pytest

from benchmark import run, spans, trace
from benchmark.gen import fasta

BENCH = Path(__file__).resolve().parents[1]
READERS = ["d2h_gbytes_per_s.distance", "d2h_gbytes_per_s.count", "merge_passes",
           "host_sys_s_per_gbase", "host_sys_s.distance"]


class FakeCell:
    config = {"args": {"k": 21}}


def card_trace() -> trace.Trace:
    return trace.Trace(device=[dict(ph="X", cat="kernel", name="k", ts=0, dur=1)])


def call_records(call: int, t0: float, bases_rows: int, sys_s: float, copies, pairs):
    """One public call's records: the root at [t0, t0 + 9], its d2h.copy
    spans ((bytes, seconds) each) and merge.pair spans (rows_out each)."""
    recs, t = [], t0 + 0.5
    for nbytes, s in copies:
        recs.append({"call": call, "name": "d2h.copy", "parent": "d2h", "t0": t, "t1": t + s,
                     "sys_s": 0.0, "counters": {"bytes": nbytes}})
        t += s
    for rows_out in pairs:
        recs.append({"call": call, "name": "merge.pair", "parent": "merge", "t0": t,
                     "t1": t + 0.1, "sys_s": 0.0, "counters": {"rows_out": rows_out}})
        t += 0.1
    recs.append({"call": call, "name": "count_file", "parent": None, "t0": t0, "t1": t0 + 9,
                 "sys_s": sys_s, "counters": {"rows": bases_rows}})
    return recs


def window(n_calls=2, work=2.5e8, traced=True) -> run.Run:
    inp = fasta.InputFile(0, "x", fasta.Records(np.zeros(8, np.uint8), np.array([0]),
                                                np.array([8])))
    calls = [run.Call(inp, 100.0 + 10 * i, 109.95 + 10 * i, work, {}) for i in range(n_calls)]
    return run.Run(FakeCell(), calls, 20.0, 5.0, card_trace() if traced else None)


def synthetic_log():
    """A warm-up call before the window (left out), two window calls, and
    a call after the window (left out)."""
    return (call_records(7, 80.0, 1000, 50.0, [(10**9, 0.01)], [999] * 3)
            + call_records(8, 100.0, 1000, 3.0, [(3e9, 1.0), (1e9, 1.0)], [1000] * 4)
            + call_records(9, 110.0, 3000, 5.0, [(6e9, 2.0)], [3000, 3000, 6000])
            + call_records(10, 130.0, 10, 99.0, [(1, 1.0)], [1]))


def read(name, r, monkeypatch, records):
    monkeypatch.setattr(spans, "log", lambda: list(records))
    return run.load_module(BENCH / "metrics" / f"{name}.py").read(r)


def test_window_calls_keep_the_calls_inside_the_window():
    pairs = spans.window_calls(window(), synthetic_log())
    assert [g[0]["call"] for _, g in pairs] == [8, 9]
    assert [c.start for c, _ in pairs] == [100.0, 110.0]


@pytest.mark.parametrize("name, want", [
    # (3 + 1 + 6) GB over (1 + 1 + 2) s
    ("d2h_gbytes_per_s.distance", 10e9 / 4.0 / 1e9),
    ("d2h_gbytes_per_s.count", 10e9 / 4.0 / 1e9),
    # (4 * 1000 + 12000) rows written over 1000 + 3000 rows
    ("merge_passes", 16000 / 4000),
    # 8 s of system time over 2 x 0.25 Gbase
    ("host_sys_s_per_gbase", 8.0 / 0.5),
    ("host_sys_s.distance", 4.0),
])
def test_readers_on_a_synthetic_log(monkeypatch, name, want):
    assert read(name, window(), monkeypatch, synthetic_log()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no_records", "outside_only", "untraced", "no_device",
                                  "no_calls"])
def test_nothing_to_read(monkeypatch, name, case):
    r = window(traced=case != "untraced", n_calls=0 if case == "no_calls" else 2)
    records = synthetic_log()
    if case == "no_records":
        records = []
    elif case == "outside_only":
        records = [x for x in records if x["call"] in (7, 10)]
    elif case == "no_device":
        r.trace = trace.Trace()
    assert read(name, r, monkeypatch, records) is None


def test_a_program_without_a_span_log_reads_nothing(monkeypatch):
    from dna_kmeres_parallel_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    assert spans.log() == []
    assert spans.merge_passes(window()) is None


def test_the_log_is_the_programs(monkeypatch):
    from dna_kmeres_parallel_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "records", synthetic_log)
    assert spans.merge_passes(window()) == pytest.approx(4.0)
