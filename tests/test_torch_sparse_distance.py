"""The port's sparse-table distances (k = 1..31) against the JAX package's,
on the CPU: the per-sequence tables, the native two-pointer and its NumPy
twins, the one-shot and streamed distances on the host route and on the
union-indexed route (the plain (min,+) product standing in for K3/K4),
the gates with injected rates, and the refusal to fall back to the host
when the card's kernel fails.

Integer tables and min-sums are compared exactly, float32 distances bit
for bit, CSVs byte for byte (tolerance zero)."""

import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu import native as jax_native
from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.models import sparse_engine as jax_sparse
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import sparse_engine
from dna_kmeres_parallel_tpu_torch.ops import distance_cuda, threshold_cuda

CPU = torch.device("cpu")
#: k of the sparse regime the tests cover (mid k, k > 15, the widest)
KS = (9, 13, 16, 21, 31)


def bits(a) -> list:
    return np.asarray(a, np.float32).view(np.uint32).tolist()


def reads(seed: int, n: int = 14) -> list[str]:
    """Seeded high-sharing records: reads of 120-200 bases from one 1,500
    base genome with N runs, one record shorter than every k above 8, one
    all-N record and one empty record."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    genome = letters[rng.integers(0, 4, 1500)]
    genome[rng.random(1500) < 0.01] = ord("N")
    genome[400:420] = ord("N")
    genome = genome.tobytes().decode()
    out = []
    for i in range(n):
        s = int(rng.integers(0, 1300))
        out.append(genome[s : s + 120 + (i * 7) % 80])
    return out + ["ACGTACG", "NNNNNNNNNNNNNNNNNNNNNNNNNNNNNN", ""]


def tables(seqs, k, canonical=False):
    return sparse_engine.build_pair_tables(seqs, k, canonical, CPU)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_build_pair_tables_match_jax(k, canonical):
    seqs = reads(k)
    got = tables(seqs, k, canonical)
    want = jax_sparse.build_pair_tables(seqs, k, canonical)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("k", [9, 21])
def test_long_records_are_counted_by_the_sparse_engine(monkeypatch, k):
    # Records at the threshold take SparseKmerEngine (K1 on the card);
    # the threshold is lowered so the test stays small.
    monkeypatch.setattr(sparse_engine, "_TPU_TABLE_MIN_BASES", 100)
    counted = []
    count = sparse_engine.SparseKmerEngine.count_sequences

    def spy(self, seqs):
        counted.extend(len(s) for s in seqs)
        return count(self, seqs)

    monkeypatch.setattr(sparse_engine.SparseKmerEngine, "count_sequences", spy)
    seqs = reads(5)
    got = tables(seqs, k)
    want = jax_sparse.build_pair_tables(seqs, k)
    assert counted == [len(s) for s in seqs if len(s) >= 100]
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("k", [9, 21, 31])
def test_min_sum_pairs_match_jax_and_the_python_twins(k):
    codes, cnts, offs = tables(reads(k), k)
    got = native.min_sum_pairs_native(codes, cnts, offs)
    assert got.dtype == np.int64 and got.size == (offs.size - 1) * (offs.size - 2) // 2
    assert np.array_equal(got, jax_native.min_sum_pairs_native(codes, cnts, offs))
    assert np.array_equal(got, sparse_engine.min_sum_pairs_python(codes, cnts, offs))
    assert np.array_equal(got, jax_sparse.min_sum_pairs_python(codes, cnts, offs))


@pytest.mark.parametrize("r0,r1", [(0, 1), (0, 16), (3, 9), (15, 16), (-4, 99), (9, 3), (16, 17)])
def test_min_sum_panel_matches_jax_and_the_python_twins(r0, r1):
    codes, cnts, offs = tables(reads(2), 21)
    got = native.min_sum_panel_native(codes, cnts, offs, r0, r1)
    assert np.array_equal(got, jax_native.min_sum_panel_native(codes, cnts, offs, r0, r1))
    assert np.array_equal(got, sparse_engine.min_sum_panel_python(codes, cnts, offs, r0, r1))
    assert np.array_equal(got, jax_sparse.min_sum_panel_python(codes, cnts, offs, r0, r1))
    lo, hi = max(r0, 0), min(r1, offs.size - 2)
    full = native.min_sum_pairs_native(codes, cnts, offs)
    S = offs.size - 1
    start = lambda i: i * (S - 1) - i * (i - 1) // 2  # noqa: E731
    assert np.array_equal(got, full[start(lo) : start(hi)] if lo < hi else full[:0])


def test_public_entries_default_to_the_card():
    # Every entry of the module that takes a device defaults to "cuda",
    # which raises without CUDA, or takes no default: none runs on the
    # CPU unless the caller asks for it.
    import inspect

    defaults = {}
    for name, obj in vars(sparse_engine).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != sparse_engine.__name__:
            continue
        params = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj).parameters
        if "device" in params:
            defaults[name] = params["device"].default
    assert {n for n, d in defaults.items() if d == "cuda"} == {
        "SparseKmerEngine", "build_pair_tables", "distance_sparse_packed",
        "make_sparse_panel_fn", "distance_sparse_stream_to_csv"}
    assert all(d in ("cuda", inspect.Parameter.empty) for d in defaults.values()), defaults
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sparse_engine.build_pair_tables(["ACGT" * 10], 21)


def test_native_tables_are_checked():
    codes, cnts, offs = tables(reads(1), 21)
    with pytest.raises(ValueError, match="fences"):
        native.min_sum_pairs_native(codes, cnts[:-1], offs)
    with pytest.raises(ValueError, match="offs"):
        native.min_sum_pairs_native(codes, cnts, offs[1:])


@pytest.mark.parametrize("union", ["off", "on"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_distance_sparse_packed_matches_jax(k, canonical, union):
    seqs = reads(100 + k)
    info = {}
    got = sparse_engine.distance_sparse_packed(
        seqs, k, canonical, device="cpu", union=union, info=info
    )
    want = jax_sparse.distance_sparse_packed(seqs, k, canonical)
    assert got.dtype == np.float32 and bits(got) == bits(want)
    assert info["route"] == ("union/plain" if union == "on" else "host/sparse")
    assert set(info["phases"]) == {"tables", "plan", "min_sum", "finish"}


@pytest.mark.parametrize("union", ["off", "on", "auto"])
@pytest.mark.parametrize("seqs", [[], ["ACGTACGTACGTACGTACGTACGT"], ["ACGTAC" * 9, "ACGTNACGTA" * 5]])
def test_distance_sparse_packed_on_few_records(seqs, union):
    got = sparse_engine.distance_sparse_packed(seqs, 13, device="cpu", union=union)
    want = jax_sparse.distance_sparse_packed(seqs, 13)
    assert bits(got) == bits(want) and got.size == len(seqs) * (len(seqs) - 1) // 2


def test_union_route_matches_jax_union_route(monkeypatch):
    # The JAX package's own union route (forced by its environment switch)
    # gives the same bits as the port's.
    monkeypatch.setenv("KMER_TPU_DIST_UNION", "1")
    seqs = reads(7)
    jax_info = {}
    want = jax_sparse.distance_sparse_packed(seqs, 21, info=jax_info)
    assert jax_info["route"].startswith("union/")
    got = sparse_engine.distance_sparse_packed(seqs, 21, device="cpu", union="on")
    assert bits(got) == bits(want)
    assert bits(got) == bits(oracle.distance_matrix_packed_sparse(seqs, 21))


@pytest.mark.parametrize("union", ["off", "on"])
@pytest.mark.parametrize("panel_rows", [1, 7, 2048])
def test_stream_to_csv_is_byte_identical_to_jax(tmp_path, panel_rows, union):
    seqs = reads(panel_rows)
    want = tmp_path / "jax.csv"
    jax_sparse.distance_sparse_stream_to_csv(seqs, 21, want, panel_rows=panel_rows)
    got = tmp_path / "port.csv"
    out = sparse_engine.distance_sparse_stream_to_csv(
        seqs, 21, got, panel_rows=panel_rows, device="cpu", union=union
    )
    assert got.read_bytes() == want.read_bytes()
    assert out["completed"] and out["n_pairs"] == len(seqs) * (len(seqs) - 1) // 2
    assert out["route"] == ("union/plain" if union == "on" else "host/sparse")
    assert set(out["phases"]) == {"tables", "write"}


@pytest.mark.parametrize("union", ["off", "on"])
@pytest.mark.parametrize("canonical", [False, True])
def test_stream_stopped_and_resumed_is_byte_identical(tmp_path, canonical, union):
    seqs = reads(3)
    want = tmp_path / "jax.csv"
    jax_sparse.distance_sparse_stream_to_csv(seqs, 17, want, canonical, panel_rows=4)
    got, ckpt = tmp_path / "port.csv", tmp_path / "ckpt.json"
    kw = dict(panel_rows=4, checkpoint_path=ckpt, device="cpu", union=union)
    first = sparse_engine.distance_sparse_stream_to_csv(seqs, 17, got, canonical, max_panels=2, **kw)
    assert not first["completed"] and first["n_pairs"] > 0
    with open(got, "ab") as f:
        f.write(b"0.123")  # a kill left part of a panel behind
    second = sparse_engine.distance_sparse_stream_to_csv(seqs, 17, got, canonical, **kw)
    assert second["resumed"] and second["completed"]
    assert got.read_bytes() == want.read_bytes()


def test_stream_resume_refuses_another_input(tmp_path):
    seqs = reads(4)
    path, ckpt = tmp_path / "d.csv", tmp_path / "c.json"
    kw = dict(panel_rows=3, checkpoint_path=ckpt, device="cpu")
    sparse_engine.distance_sparse_stream_to_csv(seqs, 21, path, max_panels=1, **kw)
    seqs[0] += "A"
    with pytest.raises(ValueError, match="input_sha"):
        sparse_engine.distance_sparse_stream_to_csv(seqs, 21, path, **kw)


@pytest.mark.parametrize("panel_rows", [None, 4])
@pytest.mark.parametrize("k,boost", [(21, 1), (13, 1), (21, 200)])
def test_union_plan_and_matrix_match_jax(monkeypatch, k, boost, panel_rows):
    monkeypatch.setenv("KMER_TPU_DIST_UNION", "1")
    codes, cnts, offs = tables(reads(k + boost), k)
    cnts = cnts * boost  # boost 200 ships int32 (cmax bucket above 127)
    got = sparse_engine.union_dense_plan(
        codes, cnts, offs, device=CPU, union="on", panel_rows=panel_rows
    )
    want = jax_sparse.union_dense_plan(codes, cnts, offs, panel_rows=panel_rows)
    for key in ("D", "Sp", "Dp", "cmax", "cmax_true"):
        assert got[key] == want[key], key
    assert np.array_equal(got["union"], want["union"])
    # The port builds the matrix on the device from the shipped entries;
    # the JAX package ships the matrix itself, in the plan's dtype.
    mat = sparse_engine.union_on_device(codes, cnts, offs, got, CPU)
    ref = jax_sparse.union_matrix(codes, cnts, offs, want)
    assert got["dtype"] == ref.dtype == (np.int8 if boost == 1 else np.int32)
    assert mat.dtype == torch.int32 and np.array_equal(mat.numpy(), ref.astype(np.int32))
    sums = sparse_engine.union_dense_min_sums(codes, cnts, offs, got, CPU)
    assert np.array_equal(sums, native.min_sum_pairs_native(codes, cnts, offs))


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
def test_sorted_unique_is_np_unique(n):
    codes = np.random.default_rng(n).integers(0, 50, n).astype(np.uint64)
    got = sparse_engine.sorted_unique(codes)
    assert got.dtype == np.uint64 and np.array_equal(got, np.unique(codes))


@pytest.mark.parametrize("budget", [None, 1 << 20, 1 << 28, 1 << 34])
@pytest.mark.parametrize("k", [3, 8, 9, 10, 11, 12, 13, 15])
@pytest.mark.parametrize("S", [0, 1, 2, 30, 127, 128, 129, 2000, 4000, 54_018])
def test_dense_distance_feasible_matches_jax(S, k, budget):
    kw = {} if budget is None else {"budget_bytes": budget}
    assert sparse_engine.dense_distance_feasible(S, k, **kw) == (
        jax_sparse.dense_distance_feasible(S, k, **kw)
    )


#: rates of a made-up card and host, injected into the gates
RATES = sparse_engine.DistanceRates(
    bin_pairs_per_sec=1e12, dense_bin_pairs_per_sec=1e12,
    sparse_entry_pairs_per_sec_per_thread=1e8,
    h2d_bytes_per_sec=1e10, d2h_bytes_per_sec=1e10, roundtrip_s=0.0, threads=4,
)


def test_dense_distance_preferred_pins_its_boundary():
    # k=9 (262,144 bins): dense costs 2.62e-7 s a pair at 1e12 bin-pairs/s;
    # sparse costs table / (1e8 * 4), so the two tie at a table of 104.86
    # entries: lengths 113 (105 entries at k=9) and 112 (104).
    assert sparse_engine.dense_distance_preferred(16, 9, [113] * 16, rates=RATES)
    assert not sparse_engine.dense_distance_preferred(16, 9, [112] * 16, rates=RATES)
    # Twice the threads halve the sparse cost: 209.7 entries now tie.
    eight = sparse_engine.DistanceRates(**{**RATES.__dict__, "threads": 8})
    assert sparse_engine.dense_distance_preferred(16, 9, [218] * 16, rates=eight)
    assert not sparse_engine.dense_distance_preferred(16, 9, [217] * 16, rates=eight)
    # k <= 8, or no lengths: dense wherever feasible; infeasible: never.
    assert sparse_engine.dense_distance_preferred(16, 8, [20] * 16, rates=RATES)
    assert sparse_engine.dense_distance_preferred(16, 9, None, rates=RATES)
    assert not sparse_engine.dense_distance_preferred(16, 12, None, rates=RATES)
    assert not sparse_engine.dense_distance_preferred(16, 9, [10_000] * 16, budget_bytes=1 << 20)


def test_dense_distance_preferred_matches_jax_at_its_rates(monkeypatch):
    # The JAX package's frozen rates and thread count, injected, give its
    # decisions.
    import os

    threads = max(os.cpu_count() or 1, 1)
    jax_rates = sparse_engine.DistanceRates(
        dense_bin_pairs_per_sec=jax_sparse._DENSE_BIN_PAIRS_PER_SEC,
        sparse_entry_pairs_per_sec_per_thread=jax_sparse._SPARSE_ENTRY_PAIRS_PER_SEC_PER_THREAD,
        threads=threads,
    )
    for S, k, L in ((256, 11, 1000), (16, 9, 90), (16, 9, 20), (64, 4, 30), (8, 10, 400)):
        assert sparse_engine.dense_distance_preferred(S, k, [L] * S, rates=jax_rates) == (
            jax_sparse.dense_distance_preferred(S, k, [L] * S)
        ), (S, k, L)


def plan_tables(S: int, entries: int):
    """S tables of ``entries`` shared codes each (count 1): D = entries."""
    codes = np.tile(np.arange(entries, dtype=np.uint64), S)
    cnts = np.ones(S * entries, np.int64)
    offs = np.arange(S + 1, dtype=np.int64) * entries
    return codes, cnts, offs


def test_union_plan_auto_pins_its_boundary():
    # S=128 tables of 200 shared codes: Sp=128, Dp=256. Device: 8,128
    # padded pairs x 256 / 1e12 s = 2.080768e-6 s, plus the H2D of the
    # entries (25,600 codes of 8 bytes and int8 counts, 200 union codes
    # and 128 fences of 8: 233,024 bytes) and the D2H of 65,536 bytes at
    # 1e10 B/s (2.98560e-5 s): 3.19368e-5 s. Host: 8,128 pairs x 200 /
    # (1e8 x threads).
    codes, cnts, offs = plan_tables(128, 200)
    card = torch.device("cuda")
    t_dev = 8128 * 256 / 1e12 + (25_600 * 9 + 200 * 8 + 128 * 8 + 128 * 128 * 4) / 1e10
    t_host_1 = 8128 * 200 / 1e8
    # Threads such that the host just wins, and just loses.
    tie = t_host_1 / t_dev
    for threads, planned in ((int(tie) + 1, False), (int(tie), True)):
        rates = sparse_engine.DistanceRates(**{**RATES.__dict__, "threads": threads})
        info = {}
        plan = sparse_engine.union_dense_plan(codes, cnts, offs, device=card, rates=rates,
                                              threshold="off", info=info)
        assert (plan is not None) == planned, threads
        assert info["t_dev_total"] == pytest.approx(t_dev)
        assert info["t_host_total"] == pytest.approx(t_host_1 / threads)
        if planned:
            assert plan["impl"] == "cuda" and plan["Sp"] == 128 and plan["Dp"] == 256
    # The round trip alone can tip it: add what separates the two.
    rates = sparse_engine.DistanceRates(**{**RATES.__dict__, "threads": int(tie)})
    slow = sparse_engine.DistanceRates(
        **{**rates.__dict__, "roundtrip_s": t_host_1 / int(tie) - t_dev + 1e-9})
    assert sparse_engine.union_dense_plan(codes, cnts, offs, device=card, rates=rates,
                                          threshold="off")
    assert sparse_engine.union_dense_plan(codes, cnts, offs, device=card, rates=slow,
                                          threshold="off") is None


def test_union_plan_gates_and_switch():
    codes, cnts, offs = plan_tables(128, 200)
    card = torch.device("cuda")
    fast = sparse_engine.DistanceRates(**{**RATES.__dict__, "threads": 1})
    # auto: only on the card; on: anywhere; off: never.
    assert sparse_engine.union_dense_plan(codes, cnts, offs, device=card, rates=fast)
    assert sparse_engine.union_dense_plan(codes, cnts, offs, device=CPU, rates=fast) is None
    plan = sparse_engine.union_dense_plan(codes, cnts, offs, device=CPU, union="on")
    assert plan["impl"] == "plain"
    assert sparse_engine.union_dense_plan(codes, cnts, offs, device=card, union="off") is None
    with pytest.raises(ValueError, match="union"):
        sparse_engine.union_dense_plan(codes, cnts, offs, device=card, union="1")
    # The budget: the int32 matrix on the device, 40 bytes an entry while
    # it is built, and the output: 128 x 256 x 4 + 25,600 x 40 + 128 x 128
    # x 8 = 1,286,144 bytes; a panel of 4 rows: 1,159,168 bytes.
    for budget, panel_rows, planned in ((1_286_144, None, True), (1_286_143, None, False),
                                        (1_159_168, 4, True), (1_159_167, 4, False)):
        plan = sparse_engine.union_dense_plan(
            codes, cnts, offs, device=card, union="on", budget_bytes=budget,
            panel_rows=panel_rows)
        assert (plan is not None) == planned, (budget, panel_rows)
    # int8 ships only while the bucketed cmax is at most 127 (counts <= 64;
    # 65 buckets to 128): int32 counts ship 3 more bytes an entry.
    for top, dtype, itemsize in ((64, np.int8, 1), (65, np.int32, 4)):
        c = cnts.copy()
        c[0] = top
        info = {}
        plan = sparse_engine.union_dense_plan(codes, c, offs, device=card, union="on",
                                              threshold="off", info=info)
        assert plan["dtype"] == dtype and info["union_bytes"] == 1_286_144
        assert info["t_dev_total"] == pytest.approx(
            8128 * 256 / sparse_engine.DistanceRates().bin_pairs_per_sec
            + sparse_engine.DistanceRates().roundtrip_s
            + (25_600 * (8 + itemsize) + 328 * 8) / sparse_engine.DistanceRates().h2d_bytes_per_sec
            + 128 * 128 * 4 / sparse_engine.DistanceRates().d2h_bytes_per_sec)
    # A window total of 2^31 refuses (int32 min-sums); fewer than 2 tables
    # or no entries plan nothing.
    c = cnts.copy()
    c[:2] = 1 << 30
    assert sparse_engine.union_dense_plan(codes, c, offs, device=card, union="on") is None
    assert sparse_engine.union_dense_plan(codes[:200], cnts[:200], offs[:2], device=card,
                                          union="on") is None
    empty = np.zeros(0, np.uint64), np.zeros(0, np.int64), np.zeros(5, np.int64)
    assert sparse_engine.union_dense_plan(*empty, device=card, union="on") is None


def test_default_rates_use_the_native_thread_count():
    import os

    assert sparse_engine.DistanceRates().host_threads() == min(os.cpu_count() or 1, 16)
    assert sparse_engine.DistanceRates(threads=3).host_threads() == 3


@pytest.fixture
def fake_card(monkeypatch):
    """A union-planned run on a device that claims to be the card: the
    union matrix stays on the CPU, K3 and K4 raise as a failed launch
    does, and the host two-pointer may not run."""
    card = torch.device("cuda")
    build = sparse_engine.union_on_device
    monkeypatch.setattr(sparse_engine.runtime, "resolve_device", lambda device: card)
    monkeypatch.setattr(sparse_engine, "union_on_device",
                        lambda codes, cnts, offs, plan, device: build(codes, cnts, offs, plan, CPU))

    def failed_launch(*a, **kw):
        raise RuntimeError("kp_min_sum launch failed: cudaError_t 98")

    def host_route(*a, **kw):
        raise AssertionError("the host two-pointer ran after the kernel failed")

    monkeypatch.setattr(distance_cuda, "min_sum_matrix_tri", failed_launch)
    monkeypatch.setattr(distance_cuda, "min_sum_matrix_rect", failed_launch)
    monkeypatch.setattr(threshold_cuda, "min_sum_matrix_threshold", failed_launch)
    for name in ("min_sum_pairs_native", "min_sum_panel_native"):
        monkeypatch.setattr(native, name, host_route)
    return card


def test_a_failing_kernel_raises_instead_of_falling_back(fake_card, tmp_path):
    seqs = reads(9)
    for union in ("on", "auto"):
        # "auto" plans the union route here because the host is made slow.
        rates = sparse_engine.DistanceRates(sparse_entry_pairs_per_sec_per_thread=1.0)
        with pytest.raises(RuntimeError, match="launch failed"):
            sparse_engine.distance_sparse_packed(seqs, 21, device="cuda", union=union, rates=rates)
        with pytest.raises(RuntimeError, match="launch failed"):
            sparse_engine.distance_sparse_stream_to_csv(
                seqs, 21, tmp_path / "d.csv", panel_rows=4, device="cuda", union=union,
                rates=rates)


@pytest.mark.parametrize("union", ["off", "on"])
@pytest.mark.parametrize("D", [3, 8])
def test_mesh_serves_sparse_distances(tmp_path, D, union):
    # A mesh on the CPU: the union route's panels partner-sharded (K4's
    # plain version per shard, partners padded to a multiple of D), the
    # host route's two-pointer unsharded; the CSV byte-identical to the
    # JAX package's on its mesh of D virtual devices.
    from dna_kmeres_parallel_tpu.parallel.mesh import make_mesh as jax_mesh
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

    seqs = reads(D)
    want = tmp_path / "jax.csv"
    jax_sparse.distance_sparse_stream_to_csv(seqs, 21, want, panel_rows=5, mesh=jax_mesh(D))
    got = tmp_path / "port.csv"
    out = sparse_engine.distance_sparse_stream_to_csv(
        seqs, 21, got, panel_rows=5, device="cpu", union=union, mesh=LocalMesh(D, "cpu"))
    assert got.read_bytes() == want.read_bytes()
    assert out["route"] == ("union/plain" if union == "on" else "host/sparse")
