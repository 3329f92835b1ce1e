"""The metric readers on recorded phases and a synthetic trace: the
merging of busy intervals, the idle share, the roofline counts from shapes,
and every reader BENCHMARK.json names."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import roofline, run, trace
from benchmark.gen import fasta

BENCH = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())

#: phases as count_file(k=21) returned them on one H100 (256 Mbase)
COUNT_PHASES = {"parse": 0.908, "staging": 0.31, "h2d": 0.05, "kernel": 0.002,
                "d2h": 0.684, "compact": 3.808, "merge": 3.988, "sort": 0.0}
DIST_PHASES = {"parse": 0.1, "counts": 0.001, "min_sum": 0.0008, "d2h": 0.497,
               "finish": 0.966}


def ev(cat, name, ts, dur, **kw):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)


def synthetic() -> trace.Trace:
    """Two calls, 0-100 and 100-200 us; kernels and copies that overlap,
    one outside the calls."""
    return trace.Trace.from_events([
        ev("user_annotation", "bench.call.0", 0, 100),
        ev("user_annotation", "bench.call.0", 100, 100),
        ev("cpu_op", "aten::copy_", 40, 60),
        ev("python_function", "dna_kmeres_parallel_tpu_torch/models/sparse_engine.py(106): "
           "compact_unsorted", 135, 60),
        ev("python_function", "<built-in method view of numpy.ndarray>", 160, 10),
        ev("kernel", "void encode_packed_kernel<2, false, false>(unsigned int const*)", 10, 10),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 15, 15),
        ev("kernel", "void encode_packed_kernel<2, false, false>(unsigned int const*)", 120, 20),
        ev("gpu_memset", "Memset (Device)", 190, 20),
        ev("kernel", "void other_kernel()", 300, 50),
        ev("gpu_user_annotation", "bench.call.0", 0, 200),
        {"ph": "i", "name": "marker", "ts": 5},
    ])


def test_short_names():
    assert trace.short_name("void (anonymous namespace)::encode_packed_kernel<2, false, "
                            "false>(unsigned int const*, long)") == "encode_packed_kernel"
    assert trace.short_name("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<"
                            "long>>(at::native::ReduceOp<long>)") == "at::native::reduce_kernel"
    assert trace.short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"


def test_merge_and_clip():
    assert trace.merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert trace.clip([(0, 3), (5, 8)], 2, 6) == [(2, 3), (5, 6)]


def test_busy_idle_window_and_breakdown():
    t = synthetic()
    assert t.span() == (0, 200)
    assert t.window_s() == pytest.approx(200e-6)
    # [10, 30) + [120, 140) + [190, 200): 50 us; the kernel at 300 is out
    assert t.busy_intervals() == [(10, 30), (120, 140), (190, 200)]
    assert t.busy_s() == pytest.approx(50e-6)
    launches = t.kernel_launches("encode_packed_kernel")
    assert [e["ts"] for e in launches] == [10, 120]
    ops = dict((n, s) for n, s in t.top_device_ops())
    assert ops["encode_packed_kernel"] == pytest.approx(30e-6)
    gaps = t.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([90e-6, 50e-6, 10e-6])
    assert gaps[0][0] == "host: aten::copy_; after: Memcpy DtoH"
    assert gaps[1][0] == "host: sparse_engine.py:compact_unsorted; after: encode_packed_kernel"


class FakeCell:
    def __init__(self, config):
        self.config = config


def count_run(n_calls=2, traced=None, stream_len=257_519_864) -> run.Run:
    inp = fasta.InputFile(0, "x", fasta.Records(np.zeros(stream_len, np.uint8),
                                                np.array([0]), np.array([stream_len])))
    calls = [run.Call(inp, 10.0 * i, 10.0 * i + 9.9, float(stream_len), dict(COUNT_PHASES))
             for i in range(n_calls)]
    return run.Run(FakeCell({"args": {"k": 21}}), calls, 20.0, 15.0, traced)


def read(name, r):
    return run.load_module(BENCH / "metrics" / f"{name}.py").read(r)


def test_phase_readers():
    r = count_run()
    gbase = 2 * 257_519_864 / 1e9
    assert read("count_gbases_per_s", r) == pytest.approx(gbase / 20.0)
    assert read("compact_s_per_gbase", r) == pytest.approx(2 * 3.808 / gbase)
    assert read("merge_s_per_gbase", r) == pytest.approx(2 * 3.988 / gbase)
    assert read("parse_s_per_gbase.count", r) == pytest.approx(2 * 0.908 / gbase)
    entry = 9.9 - sum(COUNT_PHASES.values())
    assert read("entry_s_per_gbase", r) == pytest.approx(2 * entry / gbase)
    assert read("setup_s", r) == 15.0
    # nothing to read without a trace
    assert read("encode_roofline_pct", r) is None
    assert read("device_idle_pct.count", r) is None


def test_distance_readers_and_p95():
    inp = fasta.InputFile(0, "x", fasta.Records(np.zeros(10, np.uint8), np.arange(4),
                                                np.array([2, 2, 2, 2])))
    calls = [run.Call(inp, float(i), float(i) + w, 6.0, dict(DIST_PHASES, finish=w))
             for i, w in enumerate(np.linspace(0.1, 2.0, 40))]
    r = run.Run(FakeCell({"args": {"k": 3}}), calls, 50.0, 1.0)
    assert read("distance_mpairs_per_s", r) == pytest.approx(40 * 6 / 1e6 / 50)
    assert read("finish_s.distance", r) == pytest.approx(np.mean(np.linspace(0.1, 2.0, 40)))
    assert read("d2h_s.distance", r) == pytest.approx(0.497)
    # nearest rank: the 38th of 40 walls
    assert read("count_file_s.p95", r) == pytest.approx(np.linspace(0.1, 2.0, 40)[37])


def test_roofline_counts_from_shapes():
    # a 16 Mbase stream at k=21: planes 0.5 B a base in, 6 B a window out;
    # PERF.md's bound for K1 on one such batch: 0.0326 ms
    n = 16 << 20
    b, o = roofline.k1_work(n, 21)
    assert b == n / 2 + 6 * (n - 20) and o == 0
    assert roofline.least_s(b, o) * 1e3 == pytest.approx(0.0326, abs=5e-5)
    # the work follows the stream, never a padded batch: a 4.6 Mbase file
    # that the program stages as an 8 Mbase bucket counts 4.6 Mbase
    assert roofline.k1_work(4_641_700, 21)[0] == 4_641_700 / 2 + 6 * (4_641_700 - 20)
    assert roofline.k1_work(20, 21) == (10.0, 0.0)
    assert roofline.k1_hi_bytes(15) == 0 and roofline.k1_hi_bytes(23) == 2
    assert roofline.k1_hi_bytes(24) == 4
    # K3 at [16384, 64]: PERF.md's bound 0.3218 ms, by its bytes
    b, o = roofline.k3_work(16384, 64)
    assert o == 2 * 64 * 16384 * 16383 / 2
    assert roofline.least_s(b, o) * 1e3 == pytest.approx(0.3218, abs=5e-5)


def test_roofline_reader_on_a_trace():
    t = synthetic()
    # the two K1 launches (30 us in all) against the windows of the calls,
    # however many launches each call made
    for n_calls in (1, 2):
        r = count_run(n_calls=n_calls, traced=t, stream_len=3_000_000)
        want = 100 * n_calls * roofline.least_s(*roofline.k1_work(3_000_000, 21)) / 30e-6
        assert read("encode_roofline_pct", r) == pytest.approx(want)
    assert read("device_idle_pct.count", r) == pytest.approx(75.0)
    # no K3 launch in the trace: the distance reader reads nothing
    r.cell.config["args"]["k"] = 3
    assert read("minsum_roofline_pct", r) is None


def test_count_warm_up_shapes():
    """The warm-up's batch shapes follow the sparse counter's staging: 16
    Mbase batches, a power-of-two bucket below one batch, the k - 1 halo,
    a multiple of the 128-base lane."""
    entry = run.load_module(BENCH / "entries" / "count_file.py")
    assert entry.batch_shapes(16 << 20, 21) == [(16 << 20) + 128]
    assert len(entry.batch_shapes(257_519_864, 21)) == 16
    assert entry.batch_shapes(4_641_700, 21) == [(8 << 20) + 128]
    assert entry.batch_shapes(20, 21) == []


def test_every_named_metric_has_a_reader():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        mod = run.load_module(BENCH / "metrics" / f"{m['name']}.py")
        assert callable(mod.read)
