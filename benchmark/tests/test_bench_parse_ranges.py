"""The reader of ``parse_ranges`` (``metrics/parse_ranges.py``): the mean
``ranges`` of the window's ``parse`` spans, read from synthetic span logs
and from the spans of a real count; nothing where no parse span counts
``ranges``, as a program from before the counter."""

from pathlib import Path

import numpy as np
import pytest

from benchmark import run, spans, trace
from benchmark.gen import fasta

BENCH = Path(__file__).resolve().parents[1]


class FakeCell:
    config = {"args": {"k": 21}}


def window(traced=True, n_calls=2):
    inp = fasta.InputFile(0, "x", fasta.Records(np.zeros(8, np.uint8), np.array([0]),
                                                np.array([8])))
    calls = [run.Call(inp, 100.0 + 10 * i, 109.95 + 10 * i, 2.5e8, {}) for i in range(n_calls)]
    dev = trace.Trace(device=[dict(ph="X", cat="kernel", name="k", ts=0, dur=1)])
    return run.Run(FakeCell(), calls, 20.0, 5.0, dev if traced else None)


def call_records(call, t0, ranges):
    """One count call's records: the root at [t0, t0 + 9] and its parse
    span, which counts ``ranges`` unless that is None."""
    counters = {"records": 7, "bytes": 100}
    if ranges is not None:
        counters["ranges"] = ranges
    return [{"call": call, "name": "parse", "parent": "count_file", "t0": t0 + 0.1,
             "t1": t0 + 1.0, "sys_s": 0.0, "counters": counters},
            {"call": call, "name": "count_file", "parent": None, "t0": t0, "t1": t0 + 9,
             "sys_s": 0.0, "counters": {"rows": 5}}]


def read(r, monkeypatch, records):
    monkeypatch.setattr(spans, "log", lambda: list(records))
    return run.load_module(BENCH / "metrics" / "parse_ranges.py").read(r)


def test_mean_ranges_of_the_windows_parse_spans(monkeypatch):
    # a warm-up call before the window (1 range) and one after it are left out
    records = (call_records(1, 80.0, 1) + call_records(2, 100.0, 8)
               + call_records(3, 110.0, 6) + call_records(4, 130.0, 1))
    assert read(window(), monkeypatch, records) == pytest.approx(7.0)


@pytest.mark.parametrize("case", ["no_counter", "no_records", "untraced", "no_calls"])
def test_nothing_to_read(monkeypatch, case):
    r = window(traced=case != "untraced", n_calls=0 if case == "no_calls" else 2)
    records = [] if case == "no_records" else (
        call_records(2, 100.0, None if case == "no_counter" else 8)
        + call_records(3, 110.0, None if case == "no_counter" else 8))
    assert read(r, monkeypatch, records) is None


def test_reads_a_real_counts_parse_span(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    import dna_kmeres_parallel_tpu_torch as port
    from dna_kmeres_parallel_tpu_torch.utils import profiling

    rec = fasta.make_records(np.array([600_000] * 4), 0.001, np.random.default_rng(5))
    path = tmp_path / "in.fasta"
    fasta.write_fasta(str(path), rec)
    monkeypatch.setenv("KMER_NATIVE_THREADS", "4")
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            port.count_file(path, k=5, device="cpu")
        records = profiling.records()
    finally:
        profiling.clear()
    (parse,) = [x for x in records if x["name"] == "parse"]
    assert parse["counters"]["ranges"] == 4
    r = window(n_calls=1)
    r.calls[0].start, r.calls[0].end = -1e9, 1e9
    assert read(r, monkeypatch, records) == 4.0
