"""The threshold (min,+) route (``ops/threshold_cuda``, the counterpart of
the JAX package's MXU route) on the CPU: its plain version
(``ops/distance.min_sum_matrix_threshold``) against the JAX package's
``min_sum_matrix_mxu`` bit for bit; the card route's own layout (planes,
padding, chunks) through ``torch._int_mm`` on CPU tensors; the gate
(``sparse_engine.threshold_plan``) with injected rates; and the route
forced on in the dense engine, the union route (one shot and streamed)
and a mesh, against the JAX package with its MXU route forced on.

Integer min-sums and float32 distance bits: the tolerance is zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.models import sparse_engine as jax_sparse
from dna_kmeres_parallel_tpu.models.engine import KmerEngine as JaxEngine
from dna_kmeres_parallel_tpu.ops import distance as jax_distance
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.models import sparse_engine
from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine
from dna_kmeres_parallel_tpu_torch.ops import distance, threshold_cuda
from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh
from dna_kmeres_parallel_tpu_torch.utils import fasta

CPU = torch.device("cpu")
#: a device that claims to be the card, for the gate (which reads only its type)
CARD = torch.device("cuda")


def random_counts(seed: int, rows: int, bins: int, top: int, zeros: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(0, top + 1, (rows, bins))
    c[rng.random((rows, bins)) < zeros] = 0
    if rows and bins:
        c[0, 0] = top  # the largest count is there
    return c


# (rows, partner rows or None for the symmetric product, bins)
SHAPES = [(5, None, 13), (16, 9, 40), (17, 24, 64), (3, 7, 1), (30, None, 100)]


#: (shape, largest count, cmax): buckets 1, 2 and 4 at every shape, 64
#: (64 unrolled JAX matmuls) at the shapes of at most 17 rows
PLAIN_CASES = [(shape, top, cmax) for shape in SHAPES
               for top, cmax in ((1, 1), (2, 2), (3, 4), (5, 4))] + [
    (shape, 64, 64) for shape in SHAPES if shape[0] <= 17]


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
@pytest.mark.parametrize("shape,top,cmax", PLAIN_CASES)
def test_plain_matches_jax_mxu(shape, top, cmax, dtype):
    # Shapes under 17 rows and not multiples of 8; top 5 > cmax 4 cuts the
    # counts, as the JAX route does.
    S, S2, B = shape
    a = random_counts(S + top, S, B, top).astype(dtype)
    b = None if S2 is None else random_counts(S2 + top + 1, S2, B, top).astype(dtype)
    want = np.asarray(jax_distance.min_sum_matrix_mxu(
        jnp.asarray(a), cmax, None if b is None else jnp.asarray(b)))
    got = distance.min_sum_matrix_threshold(
        torch.from_numpy(a), cmax, None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if top <= cmax:
        plain = distance.min_sum_matrix(torch.from_numpy(a).int(),
                                        None if b is None else torch.from_numpy(b).int())
        assert torch.equal(got, plain)


def test_a_cmax_the_dtype_cannot_hold_raises():
    a = random_counts(1, 4, 8, 100).astype(np.int8)
    with pytest.raises(ValueError, match="not representable"):
        jax_distance.min_sum_matrix_mxu(jnp.asarray(a), 128)
    with pytest.raises(ValueError, match="not representable"):
        distance.min_sum_matrix_threshold(torch.from_numpy(a), 128)
    with pytest.raises(ValueError, match="not representable"):
        distance.check_threshold(300, torch.zeros(2, 2, dtype=torch.int32),
                                 torch.zeros(2, 2, dtype=torch.uint8))
    # 127 is the largest an int8 holds: accepted
    assert distance.min_sum_matrix_threshold(torch.from_numpy(a), 127).shape == (4, 4)


def test_row_sums_at_2_31_are_refused():
    big = torch.full((2, 1 << 20), 2048, dtype=torch.int32)  # each row sums to 2^31
    with pytest.raises(ValueError, match="2\\^31"):
        distance.min_sum_matrix_threshold(big, 4)
    with pytest.raises(ValueError, match="2\\^31"):
        distance.check_threshold(4, torch.ones(2, 3, dtype=torch.int32), big)
    ok = big.clone()
    ok[:, 0] = 2047  # 2^31 - 1
    distance.check_threshold(4096, ok)


@pytest.mark.parametrize("budget", [None, 1, 300, 5000, 1 << 20])
@pytest.mark.parametrize("shape", SHAPES + [(40, 33, 257)])
@pytest.mark.parametrize("cmax", [1, 3, 8])
def test_layout_through_int_mm_on_cpu(shape, cmax, budget):
    # The card route's own layout on CPU tensors: the planes, their
    # padding and the chunks (whole thresholds, or bin slices when one
    # threshold is over the budget) through torch._int_mm.
    S, S2, B = shape
    a = torch.from_numpy(random_counts(S, S, B, cmax).astype(np.int32))
    b = None if S2 is None else torch.from_numpy(random_counts(S2, S2, B, cmax).astype(np.int32))
    got, gemms = threshold_cuda.threshold_product(a, cmax, b, budget)
    assert torch.equal(got, distance.min_sum_matrix(a, b))
    bud = threshold_cuda.default_budget(a, b) if budget is None else budget
    chunks = threshold_cuda.plane_chunks(S, None if S2 is None else S2, B, cmax, bud)
    assert gemms == len(chunks)
    # every (threshold, bin) exactly once
    cover = np.zeros((cmax, B), int)
    for t0, t1, b0, b1 in chunks:
        cover[t0:t1, b0:b1] += 1
        planes = threshold_cuda.build_planes(a, t0, t1, b0, b1)
        # what _int_mm takes on a card: int8, rows a multiple of 8 above
        # 16, the inner size a multiple of 8 (32 here)
        assert planes.dtype == torch.int8 and planes.is_contiguous()
        assert planes.shape[0] % 8 == 0 and planes.shape[0] > 16
        assert planes.shape[1] % threshold_cuda.PLANE_ALIGN == 0
        assert planes.shape[0] >= S and int(planes[S:].abs().sum()) == 0
    assert (cover == 1).all()


def test_planes_hold_each_threshold():
    a = torch.tensor([[0, 1, 2, 3], [3, 0, 0, 1]], dtype=torch.int8)
    planes = threshold_cuda.build_planes(a, 1, 3, 1, 4)  # thresholds 2, 3 over bins 1..3
    Bp = threshold_cuda.PLANE_ALIGN
    assert planes.shape == (24, 2 * Bp)
    assert planes[:2, :3].tolist() == [[0, 1, 1], [0, 0, 0]]
    assert planes[:2, Bp : Bp + 3].tolist() == [[0, 0, 1], [0, 0, 0]]
    assert int(planes.sum()) == 3


def test_the_wrapper_routes_by_device():
    a = torch.from_numpy(random_counts(3, 6, 10, 3).astype(np.int32))
    assert torch.equal(threshold_cuda.min_sum_matrix_threshold(a, 4), distance.min_sum_matrix(a))
    before = threshold_cuda.THRESHOLD_LAUNCHES
    threshold_cuda.min_sum_matrix_threshold(a, 4, a[:2])
    assert threshold_cuda.THRESHOLD_LAUNCHES == before  # the plain version counts no launch
    with pytest.raises(ValueError, match="on one card"):
        threshold_cuda.min_sum_threshold_cuda(a, 4)
    with pytest.raises(ValueError, match="no threshold route"):
        threshold_cuda.min_sum_matrix_threshold(a.to("meta"), 4)


RATES = sparse_engine.DistanceRates(threshold_macs_per_sec=1e12)


def plan(cmax, row_max=100, rows=64, cols=64, bins=256, alt_s=1.0, **kw):
    kw = {"device": CARD, "rates": RATES, **kw}
    return sparse_engine.threshold_plan(cmax, row_max, rows, cols, bins, alt_s=alt_s, **kw)


def test_gate_buckets_caps_and_modes():
    # cmax rounds up to its power-of-two bucket
    assert [plan(c) for c in (1, 2, 3, 5, 8, 33, 64)] == [1, 2, 4, 8, 8, 64, 64]
    # past the default cap of 64 (65 buckets to 128): K3/K4
    assert plan(65) is None
    # an explicit cap admits more, and skips the cost comparison
    assert plan(100, cap=128, alt_s=0.0) == 128 and plan(100, cap=64) is None
    # modes: off never; auto only on the card; on anywhere
    assert plan(2, mode="off") is None
    assert plan(2, device=CPU) is None and plan(2, device=CPU, mode="on") == 2
    with pytest.raises(ValueError, match="threshold"):
        plan(2, mode="1")
    # no counts, no rows
    assert plan(0) is None and plan(3, rows=0) is None


def test_gate_refuses_row_sums_at_2_31():
    assert plan(4, row_max=(1 << 31) - 1) == 4
    assert plan(4, row_max=1 << 31) is None
    assert plan(4, row_max=1 << 31, mode="on") is None
    assert plan(4, row_max=1 << 31, cap=8) is None


def test_gate_compares_costs():
    # the route over the whole rectangle, 64 x 64 x 256 x bucket MACs at
    # 1e12 MAC/s, slowed by its one output tile of the card's SMs
    # (RATES.sms), against the K3/K4 time it would displace
    info = {}
    t4 = 64 * 64 * 256 * 4 / 1e12 * RATES.sms
    assert plan(3, alt_s=t4 * 1.01, info=info) == 4
    assert info == {"threshold_cmax": 4, "t_threshold": pytest.approx(t4),
                    "t_minplus": pytest.approx(t4 * 1.01)}
    assert plan(3, alt_s=t4) is None  # a tie keeps K3/K4
    assert plan(3, alt_s=t4, mode="on") == 4  # "on" takes it wherever it is exact


def test_minplus_model_grows_with_tiles():
    # K3 at the rate's own probe rows runs at that rate; with more tiles
    # faster, up to the peak; K4 by its rectangle's tiles.
    rate, rows = 1e12, distance.DENSE_RATE_ROWS
    t = distance.minplus_time(rows, rows, 100, True, rate=rate, rate_rows=rows, peak=1e15)
    assert t == pytest.approx(rows * (rows - 1) / 2 * 100 / rate)
    assert distance.minplus_tiles(1024, 1024, True) == 36
    assert distance.minplus_tiles(256, 1000, False) == 2 * 8
    t2 = distance.minplus_time(2 * rows, 2 * rows, 100, True, rate=rate, rate_rows=rows,
                               peak=1e15)
    assert t2 == pytest.approx(4 * t * 36 / 136, rel=1e-3)
    t3 = distance.minplus_time(16384, 16384, 64, True, rate=rate, rate_rows=rows, peak=2e12)
    assert t3 == pytest.approx(16384 * 16383 / 2 * 64 / 2e12)


@pytest.mark.parametrize("name,rows,cols,bins,cmax,symmetric,threshold", [
    # The H100's measured defaults decide as the card's times did
    # (PERF.md, section 6): K3 at (a), the threshold route at (b), (d)
    # and (g) k=9, K4 at (g) k=10's panel (its 4 output tiles split into
    # bin slices, where the route's GEMM fills 4 SMs).
    ("(a)", 16384, 16384, 64, 58, True, False),
    ("(b)", 2048, 2048, 4**8, 4, True, True),
    ("(g) k=9", 1024, 1024, 4**9, 3, True, True),
    ("(g) k=10 panel", 256, 256, 4**10, 2, False, False),
])
def test_default_gate_at_the_path_shapes(name, rows, cols, bins, cmax, symmetric, threshold):
    r = sparse_engine.DistanceRates()
    alt = distance.minplus_time(rows, cols, bins, symmetric, rate=r.dense_bin_pairs_per_sec,
                                rate_rows=distance.DENSE_RATE_ROWS, peak=r.peak_bin_pairs_per_sec)
    got = sparse_engine.threshold_plan(cmax, 10**6, rows, cols, bins, alt_s=alt, device=CARD)
    assert (got is not None) == threshold, name


def test_default_union_gate_takes_the_route_at_d():
    # (d)'s shape: 2,048 tables of 1,500 codes 1-2 of a union of about
    # 112,000 codes; the plan's matrix, planes and output fit 2 GiB
    rng = np.random.default_rng(0)
    S, n = 2048, 1500
    codes = np.concatenate([np.sort(rng.choice(112_000, n, replace=False)) for _ in range(S)])
    cnts = rng.integers(1, 2, codes.size)
    offs = np.arange(S + 1, dtype=np.int64) * n
    info = {}
    p = sparse_engine.union_dense_plan(codes.astype(np.uint64), cnts, offs, device=CARD,
                                       info=info)
    assert p is not None and p["impl"] == "threshold" and p["cmax"] == 1
    off = sparse_engine.union_dense_plan(codes.astype(np.uint64), cnts, offs, device=CARD,
                                         threshold="off")
    assert off["impl"] == "cuda"
    assert p["t_dev_total"] < off["t_dev_total"]


def make_dna(rng, n: int, invalid: float = 0.02) -> str:
    s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    s[rng.random(n) < invalid] = ord("N")
    return s.tobytes().decode()


@pytest.fixture
def mxu_on(monkeypatch):
    """The JAX package's MXU route forced on, its union route and the
    route's sub-selection too."""
    monkeypatch.setenv("KMER_TPU_DIST_MXU", "1")
    monkeypatch.setenv("KMER_TPU_DIST_UNION", "1")
    monkeypatch.setenv("KMER_TPU_UNION_IMPL", "mxu")


def dense_records(seed: int = 5, n: int = 13) -> list[str]:
    rng = np.random.default_rng(seed)
    return [make_dna(rng, 70 + 9 * i) for i in range(n)]


def shared_reads(seed: int = 7, n: int = 12) -> list[str]:
    rng = np.random.default_rng(seed)
    genome = make_dna(rng, 1500, 0.01)
    starts = rng.integers(0, 1500 - 120, n)
    return [genome[s : s + 120 + (i * 5) % 30] for i, s in enumerate(starts)]


def test_dense_route_forced_on_matches_jax(tmp_path, mxu_on):
    seqs = dense_records()
    path = tmp_path / "in.fasta"
    fasta.write_fasta(path, [(f">r{i}", s) for i, s in enumerate(seqs)])
    jeng = JaxEngine(JaxConfig(k=4))
    assert jeng._mxu_dist_cmax(jeng.counts_matrix(seqs)) is not None
    want = jeng.distance_file(str(path)).packed
    eng = KmerEngine(KmerConfig(k=4), device="cpu", threshold="on")
    res = eng.distance_file(str(path))
    assert res.route == "threshold" and np.array_equal(res.packed, want)
    off = KmerEngine(KmerConfig(k=4), device="cpu", threshold="off").distance_file(str(path))
    assert off.route == "minplus" and np.array_equal(off.packed, want)
    a, b = tmp_path / "jax.csv", tmp_path / "port.csv"
    jeng.distance_stream_to_csv(seqs, a, panel_rows=5)
    out = eng.distance_stream_to_csv(seqs, b, panel_rows=5)
    assert out["route"] == "threshold" and a.read_bytes() == b.read_bytes()


def test_dense_route_cap_and_mesh_match_jax(tmp_path, mxu_on, monkeypatch):
    # An explicit cap (KMER_TPU_MXU_CMAX's counterpart), and a panel over
    # LocalMesh(4): the threshold route a shard, as the JAX engine's mesh
    # panels route the MXU matmuls.
    monkeypatch.setenv("KMER_TPU_MXU_CMAX", "64")
    seqs = dense_records(6, 11)
    a, b = tmp_path / "jax.csv", tmp_path / "port.csv"
    JaxEngine(JaxConfig(k=4, mesh_shape=(4,))).distance_stream_to_csv(seqs, a, panel_rows=4)
    eng = KmerEngine(KmerConfig(k=4, mesh_shape=(4,)), device="cpu", threshold="on",
                     threshold_cap=64)
    out = eng.distance_stream_to_csv(seqs, b, panel_rows=4)
    assert out["route"] == "threshold" and a.read_bytes() == b.read_bytes()
    got = eng.distance_sequences(seqs)
    assert got.route == "threshold"
    assert np.array_equal(got.packed, JaxEngine(JaxConfig(k=4)).distance_sequences(seqs).packed)


def test_union_routes_forced_on_match_jax(tmp_path, mxu_on):
    seqs = shared_reads()
    jinfo, info = {}, {}
    want = jax_sparse.distance_sparse_packed(seqs, 21, info=jinfo)
    got = sparse_engine.distance_sparse_packed(seqs, 21, device="cpu", union="on",
                                               threshold="on", info=info)
    assert jinfo["route"] == "union/mxu" and info["route"] == "union/threshold"
    assert np.array_equal(got, want)
    # streamed in panels, alone and over LocalMesh(4)
    a = tmp_path / "jax.csv"
    jax_sparse.distance_sparse_stream_to_csv(seqs, 21, a, panel_rows=5, info=jinfo)
    assert jinfo["route"] == "union/mxu"
    for mesh in (None, LocalMesh(4, "cpu")):
        b = tmp_path / "port.csv"
        out = sparse_engine.distance_sparse_stream_to_csv(
            seqs, 21, b, panel_rows=5, device="cpu", union="on", threshold="on", mesh=mesh)
        assert out["route"] == "union/threshold" and a.read_bytes() == b.read_bytes()
        b.unlink()
