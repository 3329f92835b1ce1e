"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: K1 (encode) and its minimizer plane K1m, K2 (counts matrix), K3
and K4 ((min,+) products), the float32 distance finish, K5-K8 (dense
histograms), K9 (u8 encode), K10 (owner segments), P1 (row roll) and K11
(row sort); and the paths that run them.
Every test here needs an NVIDIA card and skips without one.

The file imports no JAX, so it also runs where JAX is not installed (as on
the machine with the card), without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Integer codes: every comparison is exact (tolerance zero)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.ops import (
    distance,
    distance_cuda,
    encode_cuda,
    histogram_cuda,
)
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops
from dna_kmeres_parallel_tpu_torch.utils import codec

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_finish import LAYOUTS, SIZES, assert_same_bits, finish_case  # noqa: E402

KS = [1, 11, 13, 15, 16, 21, 23, 24, 31]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def stream(n: int, seed: int) -> np.ndarray:
    """Seeded u8 stream of n bases (a multiple of 16): 3% N, one N run and
    an all-T stretch where the length allows."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, n).astype(np.uint8)
    b[rng.random(n) < 0.03] = codec.INVALID_BASE
    if n >= 2048:
        b[300:340] = codec.INVALID_BASE
        b[1000:1064] = 3
    return b


def kernel_and_plain(bases, n_own, k, canonical, dev):
    planes = engine.stage_batch_planes(bases, dev)
    launches = encode_cuda.LAUNCHES
    got = sparse_ops.encode_words_planes(*planes, n_own, k, canonical)
    assert encode_cuda.LAUNCHES == launches + 1
    ref = sparse_ops.narrow_words(
        *encode_cuda.encode_packed_reference(*planes, n_own, k, canonical), k
    )
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_kernel_matches_plain_on_card(cuda_device, k, canonical):
    bases = stream(4096, k)
    got, ref = kernel_and_plain(bases, 4096 - 200, k, canonical, cuda_device)
    for g, r in zip(got, ref, strict=True):
        assert g.device.type == "cuda" and g.dtype == r.dtype
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,n_own,k",
    [(16, 16, 1), (16, 16, 16), (16, 16, 31), (32, 5, 21), (48, 48, 31),
     (48, 0, 13), (4096, 10**9, 24)],
)
def test_kernel_edges_on_card(cuda_device, n, n_own, k):
    # One- to three-word planes (windows past the plane are invalid),
    # nothing owned, and n_own past the end.
    got, ref = kernel_and_plain(stream(n, n + k), n_own, k, True, cuda_device)
    for g, r in zip(got, ref, strict=True):
        assert torch.equal(g, r)
    valid = int((got[0] != -1).sum())
    assert valid <= max(0, min(n_own, n - k + 1))


def base_grid(S: int, L: int, seed: int) -> np.ndarray:
    """Seeded u8 grid [S, L]: 3% N, an N run, rows of every length from 0
    up (0xFF past a row's end), so some rows are shorter than k."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, (S, L)).astype(np.uint8)
    g[rng.random((S, L)) < 0.03] = codec.INVALID_BASE
    if L > 40:
        g[0, 10:30] = codec.INVALID_BASE
    for r, n in enumerate(rng.integers(0, L + 1, S)):
        g[r, n:] = codec.INVALID_BASE
    if S > 2:
        g[S // 2] = codec.INVALID_BASE  # one row all padding
    return g


#: K2's row lengths at the edges of its 16-byte chunks (k - 1 holds no window)
COUNTS_LS = (0, 1, "k-1", 15, 16, 17, 31, 33, 2000, 2001)


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize(
    "S,L,k,bins,offset",
    [(1, 1, 3, 64, 0), (5, 2, 3, 64, 0), (37, 300, 3, 64, 0), (64, 513, 5, 1024, 0),
     (64, 513, 6, 4096, 3), (40, 700, 7, 4097, 5),
     (9, 2000, 8, 65536, 0), (3, 40, 1, 4, 0), (16, 200, 10, 65536, 0), (2, 0, 3, 64, 0)]
    + [(37, L, k, min(4**k, 65536), offset) for k in (1, 3, 8, 10) for L in COUNTS_LS
       for offset in (0, 5)]
    # rows split into parts: few long rows (both routes, and the warp
    # route's widest histogram), a row past the block route's 4,095 chunks,
    # and one or all of the reference's records
    + [(1, 4_000_000, 3, 64, 0), (2, 1_000_000, 2, 16, 3), (3, 300_000, 8, 65536, 7),
       (2, 300_000, 6, 4096, 0), (2, 70_001, 7, 16384, 0), (1, 2000, 3, 64, 0),
       (54018, 2000, 3, 64, 0)],
)
def test_counts_matrix_kernel_matches_plain(cuda_device, S, L, k, bins, offset, canonical):
    # k=10 keeps only the codes below 65,536 (the rest are dropped, as in
    # the plain version); L=0, L=2 and L=k-1 hold no window. `offset` puts
    # the grid that many bytes past an aligned address.
    L = k - 1 if L == "k-1" else L
    g = base_grid(S, L, S * 7 + L)
    buf = torch.empty(S * L + offset, dtype=torch.uint8, device=cuda_device)
    grid = buf[offset:].view(S, L)
    grid.copy_(torch.from_numpy(g))
    launches = histogram_cuda.COUNTS_LAUNCHES
    got = histogram_cuda.counts_matrix_grid(grid, k, bins, canonical)
    assert histogram_cuda.COUNTS_LAUNCHES == launches + 1
    ref = histogram_cuda.counts_matrix_reference(grid, k, bins, canonical)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (S, bins)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize(
    "S,L,k,bins,offset",
    [(37, L, k, 4**k, offset) for k in (9, 10) for L in COUNTS_LS for offset in (0, 5)]
    # bins below 4^k drop the codes past them; k = 12, 13 and 15 at 4^k
    + [(16, 200, 11, 70_000, 3), (40, 2000, 11, 4**11, 0), (5, 3000, 12, 4**12, 1),
       (3, 20_000, 13, 4**13, 7), (1, 5000, 15, 4**15, 3)]
    # rows split into parts: few long rows, one row, and phase (g)'s shape
    + [(1, 4_000_000, 9, 4**9, 0), (2, 1_000_000, 10, 4**10, 3), (8, 300_000, 9, 4**9, 0),
       (1, 2000, 9, 4**9, 0), (1024, 2000, 9, 4**9, 0), (256, 2000, 10, 4**10, 0)],
)
def test_counts_matrix_global_route_matches_plain(cuda_device, S, L, k, bins, offset, canonical):
    # Above 65,536 bins K2 adds every window to its count in device memory
    # with an atomic (its global route): rows shorter than k and N runs
    # (base_grid), grids off the 16-byte grid, rows split into parts.
    L = k - 1 if L == "k-1" else L
    g = base_grid(S, L, S * 5 + L + k)
    buf = torch.empty(S * L + offset, dtype=torch.uint8, device=cuda_device)
    grid = buf[offset:].view(S, L)
    grid.copy_(torch.from_numpy(g))
    launches, wide = histogram_cuda.COUNTS_LAUNCHES, histogram_cuda.COUNTS_GLOBAL_LAUNCHES
    got = histogram_cuda.counts_matrix_grid(grid, k, bins, canonical)
    assert histogram_cuda.COUNTS_LAUNCHES == launches + 1
    assert histogram_cuda.COUNTS_GLOBAL_LAUNCHES == wide + (S > 0)
    ref = histogram_cuda.counts_matrix_reference(grid, k, bins, canonical)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (S, bins)
    assert torch.equal(got, ref)


#: the widths of the union route's matrices and of mid-k counts
WIDE_BINS = (131_072, 262_144)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,route", [("small", "u16x2"), ("wide", "i32")])
@pytest.mark.parametrize("B", WIDE_BINS)
@pytest.mark.parametrize("S", [1, 129, 256])
def test_min_sum_tri_at_wide_bins_matches_plain(cuda_device, S, B, kind, route):
    a = torch.from_numpy(chip_smoke.wide_counts(S, B, kind, S + B)).to(cuda_device)
    got, taken = routed(distance_cuda.min_sum_matrix_tri, a)
    assert taken == route
    torch.cuda.synchronize()
    assert torch.equal(got, distance.min_sum_matrix(a))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,route", [("small", "u16x2"), ("wide", "i32")])
@pytest.mark.parametrize("B", WIDE_BINS)
@pytest.mark.parametrize("S,S2", [(1, 300), (129, 1), (256, 200)])
def test_min_sum_rect_at_wide_bins_matches_plain(cuda_device, S, S2, B, kind, route):
    a = torch.from_numpy(chip_smoke.wide_counts(S, B, kind, S + B)).to(cuda_device)
    b = torch.from_numpy(chip_smoke.wide_counts(S2, B, kind, S2 + B + 1)).to(cuda_device)
    got, taken = routed(distance_cuda.min_sum_matrix_rect, a, b)
    assert taken == route
    torch.cuda.synchronize()
    assert torch.equal(got, distance.min_sum_matrix(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 4096, 1 << 16])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("S,S2,B,cmax", [(1, None, 1, 1), (5, 3, 13, 2), (17, None, 64, 64),
                                         (129, 200, 1000, 4), (300, None, 4099, 3)])
def test_threshold_route_matches_plain_on_card(cuda_device, S, S2, B, cmax, dtype, budget):
    # torch._int_mm on the card: rows under 17 and not multiples of 8,
    # inner sizes not multiples of 8, int8 and int32 counts, the planes
    # chunked by thresholds and by bins.
    from dna_kmeres_parallel_tpu_torch.ops import threshold_cuda

    rng = np.random.default_rng(S + B)
    a = torch.from_numpy(rng.integers(0, cmax + 1, (S, B))).to(dtype).to(cuda_device)
    b = None if S2 is None else torch.from_numpy(
        rng.integers(0, cmax + 1, (S2, B))).to(dtype).to(cuda_device)
    launches = threshold_cuda.THRESHOLD_LAUNCHES
    got = threshold_cuda.min_sum_threshold_cuda(a, cmax, b, budget)
    assert threshold_cuda.THRESHOLD_LAUNCHES == launches + 1
    want = distance.min_sum_matrix(a.int(), None if b is None else b.int())
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got.cpu(), threshold_cuda.threshold_product(
        a.cpu(), cmax, None if b is None else b.cpu(), budget)[0])


@pytest.mark.cuda
def test_threshold_route_refuses_what_it_cannot_hold(cuda_device):
    from dna_kmeres_parallel_tpu_torch.ops import threshold_cuda

    a = torch.ones(4, 8, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="not representable"):
        threshold_cuda.min_sum_matrix_threshold(a, 128)
    big = torch.full((2, 1 << 20), 2048, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="2\\^31"):
        threshold_cuda.min_sum_matrix_threshold(big, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("k,mesh", [(4, ()), (8, ()), (4, (3,))])
def test_engine_threshold_route_equals_its_cpu_route(cuda_device, tmp_path, k, mesh):
    # The dense engine with the route forced on, on the card, against the
    # CPU's (the plain version) and the card's K3/K4 route.
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.ops import threshold_cuda

    rng = np.random.default_rng(k)
    seqs = ["".join(rng.choice(list("ACGTN"), 300 + 7 * i)) for i in range(23)]
    cfg = KmerConfig(k=k, mesh_shape=mesh)
    launches = threshold_cuda.THRESHOLD_LAUNCHES
    got = engine.KmerEngine(cfg, device=cuda_device, threshold="on").distance_sequences(seqs)
    assert got.route == "threshold"
    assert threshold_cuda.THRESHOLD_LAUNCHES == launches + (mesh[0] if mesh else 1)
    off = engine.KmerEngine(cfg, device=cuda_device, threshold="off").distance_sequences(seqs)
    cpu = engine.KmerEngine(cfg, device="cpu", threshold="on").distance_sequences(seqs)
    assert off.route == "minplus" and cpu.route == "threshold"
    assert np.array_equal(got.packed, off.packed) and np.array_equal(got.packed, cpu.packed)


def counts(S: int, B: int, seed: int, dev, cmax: int = 9) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cmax + 1, (S, B)).astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,B", [(1, 1), (1, 64), (2, 3), (63, 64), (64, 64), (65, 300), (130, 1024), (200, 33)]
)
def test_min_sum_tri_kernel_matches_plain(cuda_device, S, B):
    a = counts(S, B, S + B, cuda_device)
    launches = distance_cuda.TRI_LAUNCHES
    got = distance_cuda.min_sum_matrix_tri(a)
    assert distance_cuda.TRI_LAUNCHES == launches + 1
    ref = distance.min_sum_matrix(a)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (S, S)
    assert torch.equal(got, ref)
    assert torch.equal(got, got.T)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,S2,B", [(1, 1, 1), (1, 200, 64), (70, 1, 64), (129, 65, 300), (64, 128, 1024), (5, 77, 65536)]
)
def test_min_sum_rect_kernel_matches_plain(cuda_device, S, S2, B):
    a = counts(S, B, S, cuda_device)
    b = counts(S2, B, S2 + 1, cuda_device, cmax=3)
    launches = distance_cuda.RECT_LAUNCHES
    got = distance_cuda.min_sum_matrix_rect(a, b)
    assert distance_cuda.RECT_LAUNCHES == launches + 1
    ref = distance.min_sum_matrix(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (S, S2)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_min_sum_refuses_rows_summing_to_2_31(cuda_device):
    # One row sums to exactly 2^31: its min-sum with itself would not fit
    # int32. Both kernels refuse before launching; one below passes.
    a = torch.zeros(3, 4, dtype=torch.int32, device=cuda_device)
    a[1, 0] = a[1, 1] = 1 << 30
    tri, rect = distance_cuda.TRI_LAUNCHES, distance_cuda.RECT_LAUNCHES
    with pytest.raises(ValueError, match="2\\^31"):
        distance_cuda.min_sum_matrix_tri(a)
    with pytest.raises(ValueError, match="2\\^31"):
        distance_cuda.min_sum_matrix_rect(a[:1], a)
    assert (distance_cuda.TRI_LAUNCHES, distance_cuda.RECT_LAUNCHES) == (tri, rect)
    a[1, 1] -= 1
    got = distance_cuda.min_sum_matrix_tri(a)
    assert int(got[1, 1]) == (1 << 31) - 1


ROUTE_ROWS = (1, 127, 128, 129)
ROUTE_BINS = (1, 64, 65, 65536)


def route_counts(rows: int, B: int, kind: str, seed: int, dev) -> torch.Tensor:
    """``chip_smoke.route_counts`` on the card: "small" rows sum to at most
    65,535 (row 0 to exactly 65,535), "wide" row 0 to 65,536, "big" rows
    hold a count of 2^16 or more."""
    return torch.from_numpy(chip_smoke.route_counts(rows, B, kind, seed)).to(dev)


def routed(fn, *mats):
    """fn(*mats) and the one route its launch took."""
    before = dict(distance_cuda.ROUTE_LAUNCHES)
    got = fn(*mats)
    taken = [r for r, n in distance_cuda.ROUTE_LAUNCHES.items() if n != before[r]]
    assert len(taken) == 1
    return got, taken[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,route", [("small", "u16x2"), ("wide", "i32")])
@pytest.mark.parametrize("B", ROUTE_BINS)
@pytest.mark.parametrize("S", ROUTE_ROWS)
def test_min_sum_tri_routes_match_plain(cuda_device, S, B, kind, route):
    a = route_counts(S, B, kind, S * 7 + B, cuda_device)
    launches = distance_cuda.TRI_LAUNCHES
    got, taken = routed(distance_cuda.min_sum_matrix_tri, a)
    assert taken == route
    assert distance_cuda.TRI_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(got, distance.min_sum_matrix(a))
    assert int(got[0, 0]) == (65535 if kind == "small" else 65536)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kinds,route",
    [(("small", "small"), "u16x2"), (("small", "big"), "u16x2"),
     (("big", "small"), "u16x2"), (("wide", "wide"), "i32")],
)
@pytest.mark.parametrize("B", ROUTE_BINS)
@pytest.mark.parametrize("S2", ROUTE_ROWS)
@pytest.mark.parametrize("S", ROUTE_ROWS)
def test_min_sum_rect_routes_match_plain(cuda_device, S, S2, B, kinds, route):
    a = route_counts(S, B, kinds[0], S * 7 + B, cuda_device)
    b = route_counts(S2, B, kinds[1], S2 * 11 + B + 1, cuda_device)
    launches = distance_cuda.RECT_LAUNCHES
    got, taken = routed(distance_cuda.min_sum_matrix_rect, a, b)
    assert taken == route
    assert distance_cuda.RECT_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(got, distance.min_sum_matrix(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["u16x2", "i32"])
def test_min_sum_unaligned_operands_and_output(cuda_device, route):
    # Rows of 63 bins (4-byte aligned only) and outputs 4 bytes past a
    # 16-byte boundary: scalar loads, and every head length of the stores.
    base = counts(300, 63, 5, cuda_device)
    a, b = base[1:200], base[3:]
    ref = distance.min_sum_matrix(a, b)
    buf = torch.full((a.shape[0] * b.shape[0] + 1,), -1, dtype=torch.int32, device=cuda_device)
    out = buf[1:].view(a.shape[0], b.shape[0])
    distance_cuda.launch_min_sum_rect(a, b, out, route)
    buf2 = torch.full((a.shape[0] ** 2 + 3,), -1, dtype=torch.int32, device=cuda_device)
    tri = buf2[3:].view(a.shape[0], a.shape[0])
    distance_cuda.launch_min_sum_tri(a, tri, route)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert int(buf[0]) == -1
    assert torch.equal(tri, distance.min_sum_matrix(a))
    assert (buf2[:3] == -1).all()


#: bins at a slice edge of K3/K4's bin split and either side of it (at
#: ROUTE_ROWS: 64 slices of 1,024; 63 and one of 1,023; 62 of 1,056 and
#: one of 65)
SPLIT_BINS = (65535, 65536, 65537)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,route", [("small", "u16x2"), ("wide", "i32")])
@pytest.mark.parametrize("B", SPLIT_BINS)
@pytest.mark.parametrize("S", ROUTE_ROWS)
def test_min_sum_split_tri_matches_plain(cuda_device, S, B, kind, route):
    # K3 over bin slices: 129 rows add K3's mirror tile into the output
    a = route_counts(S, B, kind, S * 13 + B, cuda_device)
    assert distance_cuda.product_split(S, S, B, route, a.device, True)[0] > 1
    launches, routes = distance_cuda.TRI_LAUNCHES, dict(distance_cuda.ROUTE_LAUNCHES)
    got, taken = routed(distance_cuda.min_sum_matrix_tri, a)
    assert taken == route
    assert distance_cuda.TRI_LAUNCHES == launches + 1
    assert distance_cuda.ROUTE_LAUNCHES[route] == routes[route] + 1
    torch.cuda.synchronize()
    assert torch.equal(got, distance.min_sum_matrix(a))
    assert int(got[0, 0]) == (65535 if kind == "small" else 65536)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kinds,route",
    [(("small", "small"), "u16x2"), (("big", "small"), "u16x2"), (("wide", "wide"), "i32")],
)
@pytest.mark.parametrize("B", SPLIT_BINS)
@pytest.mark.parametrize("S,S2", [(1, 1), (127, 129), (128, 1), (129, 128)])
def test_min_sum_split_rect_matches_plain(cuda_device, S, S2, B, kinds, route):
    a = route_counts(S, B, kinds[0], S * 13 + B, cuda_device)
    b = route_counts(S2, B, kinds[1], S2 * 17 + B + 1, cuda_device)
    assert distance_cuda.product_split(S, S2, B, route, a.device, False)[0] > 1
    launches, routes = distance_cuda.RECT_LAUNCHES, dict(distance_cuda.ROUTE_LAUNCHES)
    got, taken = routed(distance_cuda.min_sum_matrix_rect, a, b)
    assert taken == route
    assert distance_cuda.RECT_LAUNCHES == launches + 1
    assert distance_cuda.ROUTE_LAUNCHES[route] == routes[route] + 1
    torch.cuda.synchronize()
    assert torch.equal(got, distance.min_sum_matrix(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["u16x2", "i32"])
def test_min_sum_split_unaligned_operands_and_output(cuda_device, route):
    # Rows of 65,535 bins (4-byte aligned only) and outputs 4 and 12 bytes
    # past a 16-byte boundary: the zeroing and the adds stay in the output.
    base = counts(300, 65535, 9, cuda_device, cmax=1)  # row sums below 2^16
    a, b = base[1:200], base[3:]
    assert distance_cuda.product_split(199, 297, 65535, route, a.device, False)[0] > 1
    buf = torch.full((a.shape[0] * b.shape[0] + 2,), -1, dtype=torch.int32, device=cuda_device)
    out = buf[1:-1].view(a.shape[0], b.shape[0])
    distance_cuda.launch_min_sum_rect(a, b, out, route)
    buf2 = torch.full((a.shape[0] ** 2 + 4,), -1, dtype=torch.int32, device=cuda_device)
    tri = buf2[3:-1].view(a.shape[0], a.shape[0])
    distance_cuda.launch_min_sum_tri(a, tri, route)
    torch.cuda.synchronize()
    assert torch.equal(out, distance.min_sum_matrix(a, b))
    assert int(buf[0]) == -1 and int(buf[-1]) == -1
    assert torch.equal(tri, distance.min_sum_matrix(a))
    assert (buf2[:3] == -1).all() and int(buf2[-1]) == -1


@pytest.mark.cuda
def test_min_sum_split_reads_the_card(cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for route in ("u16x2", "i32"):
        assert distance_cuda.product_split(16384, 16384, 64, route, cuda_device, True) == (1, 64)
        assert distance_cuda.product_split(2048, 54018, 64, route, cuda_device, False) == (1, 64)
        assert distance_cuda.product_split(256, 256, 4**10, route, cuda_device, False) == (
            distance.min_sum_split(4, 4**10, route, sms))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["kp_min_sum_tri", "kp_min_sum_tri_u16x2"])
def test_min_sum_split_refuses_a_slice_off_the_stages(cuda_device, entry):
    # a slice length below B must be a positive multiple of the 32-bin
    # stage: anything else is cudaErrorInvalidValue, launched nowhere
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    a = counts(2, 4096, 3, cuda_device, cmax=1)
    out = torch.full((2, 2), -1, dtype=torch.int32, device=cuda_device)
    fn = getattr(kernels.load(), entry)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for bad in (0, -32, 1000, 1025):
        assert fn(a.data_ptr(), 2, 4096, bad, out.data_ptr(), stream) == 1
    torch.cuda.synchronize()
    assert (out == -1).all()
    assert fn(a.data_ptr(), 2, 4096, 1024, out.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, distance.min_sum_matrix(a))


@pytest.mark.cuda
def test_min_sum_cuda_tensors_never_reach_the_plain_version(cuda_device, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    a = counts(70, 64, 1, cuda_device)
    want_tri, want_rect = distance.min_sum_matrix(a), distance.min_sum_matrix(a[:9], a)
    monkeypatch.setattr(distance_cuda.dist_ops, "min_sum_matrix", refuse)
    tri, rect = distance_cuda.TRI_LAUNCHES, distance_cuda.RECT_LAUNCHES
    routes = dict(distance_cuda.ROUTE_LAUNCHES)
    for step in range(1, 3):
        got_tri = distance_cuda.min_sum_matrix_tri(a)
        got_rect = distance_cuda.min_sum_matrix_rect(a[:9], a)
        assert (distance_cuda.TRI_LAUNCHES, distance_cuda.RECT_LAUNCHES) == (tri + step, rect + step)
    assert distance_cuda.ROUTE_LAUNCHES["u16x2"] == routes["u16x2"] + 4
    assert distance_cuda.ROUTE_LAUNCHES["i32"] == routes["i32"]
    torch.cuda.synchronize()
    assert torch.equal(got_tri, want_tri) and torch.equal(got_rect, want_rect)


# ---------------------------------------------------------------------------
# K5-K8: dense histograms, added into an accumulator
# ---------------------------------------------------------------------------

DENSE_KS = [1, 2, 3, 4, 6, 7, 8]


def own_cases(n: int) -> list[int]:
    return [0, 1, n // 2 + 3, n, 10**12]


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", DENSE_KS)
def test_hist_planes_kernel_matches_plain(cuda_device, k, canonical):
    # K5 from the planes of an N-rich stream with a homopolymer run, for
    # several n_own, added into one accumulator that starts at 7.
    bases = stream(8192, 100 + k)
    planes = engine.stage_batch_planes(bases, cuda_device)
    acc = torch.full((4**k,), 7, dtype=torch.int32, device=cuda_device)
    ref = acc.clone()
    for n_own in own_cases(8192):
        launches = histogram_cuda.PLANES_LAUNCHES
        out = histogram_cuda.histogram_planes(*planes, n_own, k, canonical, acc)
        assert out is acc and histogram_cuda.PLANES_LAUNCHES == launches + 1
        histogram_cuda.hist_planes_reference(*planes, n_own, k, canonical, ref)
        torch.cuda.synchronize()
        assert torch.equal(acc, ref), n_own


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", DENSE_KS)
def test_hist_u8_kernels_match_plain(cuda_device, k, canonical):
    # K7 at k <= 3 and K6 at every k (4^k bins is a power of two), from an
    # N-rich stream with a homopolymer run.
    b = torch.from_numpy(stream(8192, 200 + k)).to(cuda_device)
    kernels = [("U8_LAUNCHES", histogram_cuda.hist_u8_cuda)]
    if k <= 3:
        kernels.append(("SMALL_LAUNCHES", histogram_cuda.hist_u8_small_cuda))
    for counter, fn in kernels:
        for n_own in own_cases(8192):
            launches = getattr(histogram_cuda, counter)
            got = fn(b, n_own, k, 4**k, canonical)
            assert getattr(histogram_cuda, counter) == launches + 1
            ref = histogram_cuda.hist_u8_reference(b, n_own, k, 4**k, canonical)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, ref), (fn.__name__, n_own)


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,bins", [(5, 1000), (6, 3000), (8, 40000), (11, 4**11), (12, 4**12), (3, 5)])
def test_hist_u8_any_kernel_matches_plain(cuda_device, k, bins, canonical):
    # K8 at bins that are not powers of two (one and three shared slices)
    # and above 65,536 (atomics into device memory); codes >= bins dropped.
    b = torch.from_numpy(stream(20000, k + bins % 97)).to(cuda_device)
    launches = histogram_cuda.ANY_LAUNCHES
    got = histogram_cuda.hist_u8_any_cuda(b, 19000, k, bins, canonical)
    assert histogram_cuda.ANY_LAUNCHES == launches + 1
    ref = histogram_cuda.hist_u8_reference(b, 19000, k, bins, canonical)
    torch.cuda.synchronize()
    assert got.shape == (bins,) and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 16, 300])
def test_hist_kernels_short_streams(cuda_device, n):
    # Streams shorter than, equal to and just past k = 8; every kernel
    # launches (and counts) even when no window is counted.
    bases = stream(max(16, -(-n // 16) * 16), n)
    planes = engine.stage_batch_planes(bases, cuda_device)
    got = histogram_cuda.hist_planes_cuda(*planes, n, 8)
    ref = histogram_cuda.hist_planes_reference(*planes, n, 8)
    assert torch.equal(got, ref)
    b = torch.from_numpy(bases[:n].copy()).to(cuda_device)
    for fn, k, bins in ((histogram_cuda.hist_u8_cuda, 8, 4**8),
                        (histogram_cuda.hist_u8_small_cuda, 3, 64),
                        (histogram_cuda.hist_u8_any_cuda, 10, 4**10)):
        got = fn(b, n, k, bins)
        ref = histogram_cuda.hist_u8_reference(b, n, k, bins)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
def test_hist_kernels_homopolymer(cuda_device, k):
    # All 32 lanes of every warp on one bin: all-T, then all-A.
    b = torch.full((1 << 20,), 3, dtype=torch.uint8, device=cuda_device)
    b[1 << 19 :] = 0
    n = (1 << 20) - k + 1
    got = histogram_cuda.histogram_stream(b, n, k, 4**k)
    assert int(got[4**k - 1]) == (1 << 19) - k + 1 and int(got[0]) == (1 << 19) - k + 1
    assert int(got.sum()) == n
    planes = engine.stage_batch_planes(b.cpu().numpy(), cuda_device)
    assert torch.equal(histogram_cuda.hist_planes_cuda(*planes, n, k), got)


def slice_edge_stream(k: int, bins: int, pad: int) -> np.ndarray:
    """u8 stream of the k-mers whose codes sit at every cluster-slice edge
    of ``bins`` (S - 1 and S for each plan's S, and the last bin), each
    followed by an N, then ``pad`` random bases."""
    codes = {0, bins - 1}
    for cluster in histogram_cuda.CLUSTER_SIZES:
        s = -(-bins // cluster) + 3 & ~3
        for r in range(1, cluster):
            codes |= {r * s - 1, r * s}
    out = []
    for c in sorted(x for x in codes if 0 <= x < min(bins, 4**k)):
        out += [(c >> (2 * (k - 1 - j))) & 3 for j in range(k)] + [codec.INVALID_BASE]
    rng = np.random.default_rng(k + bins)
    return np.concatenate([np.array(out, np.uint8), rng.integers(0, 4, pad).astype(np.uint8)])


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 2, 4])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8])
def test_hist_u8_cluster_slices_match_plain(cuda_device, k, canonical, cluster):
    # K6 in clusters of 1, 2 and 4 blocks and its default plan, on the
    # codes at every slice edge, an N-rich stream, and views that start
    # 1..15 bytes past a 16-byte boundary; one accumulator that starts at 7.
    bins = 4**k
    if cluster == 1 and bins > histogram_cuda.MAX_SLICE_BINS:
        with pytest.raises(ValueError, match="bins a block"):
            histogram_cuda.u8_plan(bins, cluster)
        return
    base = np.concatenate([slice_edge_stream(k, bins, 3000), stream(8192, 300 + k)])
    b = torch.from_numpy(base).to(cuda_device)
    acc = torch.full((bins,), 7, dtype=torch.int32, device=cuda_device)
    ref = acc.clone()
    for off in (0, 1, 5, 15):
        view = b[off:]
        for n_own in own_cases(view.numel()):
            launches = histogram_cuda.U8_LAUNCHES
            histogram_cuda.hist_u8_cuda(view, n_own, k, bins, canonical, acc, cluster=cluster)
            assert histogram_cuda.U8_LAUNCHES == launches + 1
            histogram_cuda.hist_u8_reference(view, n_own, k, bins, canonical, ref)
            torch.cuda.synchronize()
            assert torch.equal(acc, ref), (off, n_own)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 2, 4])
@pytest.mark.parametrize("base", [0, 2, 3])
def test_hist_u8_one_repeated_base(cuda_device, base, cluster):
    # Every window has one code: one bin takes 2^22 - 7 counts at k=8,
    # from every lane of every warp.
    n = 1 << 22
    b = torch.full((n,), base, dtype=torch.uint8, device=cuda_device)
    got = histogram_cuda.hist_u8_cuda(b, n, 8, 4**8, cluster=cluster)
    code = sum(base << (2 * j) for j in range(8))
    assert int(got[code]) == n - 7 and int(got.sum()) == n - 7
    canon = histogram_cuda.hist_u8_cuda(b, n, 8, 4**8, True, cluster=cluster)
    assert torch.equal(canon, histogram_cuda.hist_u8_reference(b, n, 8, 4**8, True))


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,bins", [(5, 1000), (6, 3000), (8, 65535), (8, 40000), (7, 3)])
def test_hist_u8_any_sliced_route_matches_plain(cuda_device, k, bins, canonical):
    # K8's sliced route runs K6's kernel at bins that are not powers of
    # two; 65,535 bins leave a last slice of 3 bins past the bulk flush.
    base = np.concatenate([slice_edge_stream(k, bins, 5000), stream(20000, k + bins % 89)])
    b = torch.from_numpy(base).to(cuda_device)
    for n_own in own_cases(b.numel()):
        launches = histogram_cuda.ANY_LAUNCHES
        got = histogram_cuda.hist_u8_any_cuda(b, n_own, k, bins, canonical)
        assert histogram_cuda.ANY_LAUNCHES == launches + 1
        ref = histogram_cuda.hist_u8_reference(b, n_own, k, bins, canonical)
        torch.cuda.synchronize()
        assert got.shape == (bins,) and torch.equal(got, ref), n_own


@pytest.mark.cuda
def test_hist_u8_refuses_an_unaligned_accumulator(cuda_device):
    b = torch.zeros(64, dtype=torch.uint8, device=cuda_device)
    acc = torch.zeros(1024 + 1, dtype=torch.int32, device=cuda_device)[1:]
    launches = histogram_cuda.U8_LAUNCHES
    with pytest.raises(ValueError, match="aligned"):
        histogram_cuda.hist_u8_cuda(b, 64, 5, 1024, acc=acc)
    assert histogram_cuda.U8_LAUNCHES == launches


@pytest.mark.cuda
def test_dense_count_on_card_equals_cpu(cuda_device):
    # The engine end to end on the card against its CPU route: each route
    # (K5 planes, K7 packed, K6 and K7 from u8, K1 + densify) over several
    # batches.
    import dna_kmeres_parallel_tpu_torch as port

    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list("ACGTN"), size=n, p=[0.24] * 4 + [0.04]))
            for n in (5000, 3, 12000, 700)]
    for k, canonical, pack in ((8, False, True), (6, True, True), (3, False, True),
                               (5, True, False), (2, False, False), (9, False, True)):
        kw = dict(k=k, canonical=canonical, pack_input=pack, batch_bases=4096)
        got = port.count_sequences(seqs, device="cuda", **kw)
        want = port.count_sequences(seqs, device="cpu", **kw)
        assert np.array_equal(got.hist, want.hist), (k, canonical, pack)


def packed_on(bases: np.ndarray, dev) -> tuple[torch.Tensor, torch.Tensor]:
    from dna_kmeres_parallel_tpu_torch import native

    data, mask, _ = native.pack_2bit_native(bases)
    return torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,bins", [(1, 4), (2, 16), (3, 64), (3, 37), (5, 64), (15, 7)])
@pytest.mark.parametrize("kind", ["nrich", "runs"])
def test_hist_small_kernels_match_plain(cuda_device, kind, k, bins, canonical):
    # Both K7 entries (u8 and packed) on an N-rich stream and on one whose
    # windows half lie in one-base runs, at every k the engine sends them
    # and at k > 3 with bins <= 64 (histogram_stream routes by bins), for
    # n_own at the edges, added into one accumulator that starts at 7. The
    # u8 entry also on views 1..15 bytes past a 16-byte boundary; the packed
    # one on data views of 2..14 bytes with mask views of 1..7 (8 bases a
    # step), and one of 16 and 8 (aligned again).
    n = 8192 + 40
    if kind == "nrich":
        bases = stream(n, 500 + k)
    else:
        bases = chip_smoke.runs_stream(np.random.default_rng(k), n)
    b = torch.from_numpy(bases).to(cuda_device)
    data, mask = packed_on(bases, cuda_device)
    for off in range(16):
        view = b[off:]
        acc = torch.full((bins,), 7, dtype=torch.int32, device=cuda_device)
        ref = acc.clone()
        for n_own in (0, 1, view.numel() // 2 + 3, view.numel() - k, view.numel(), 10**12):
            launches = histogram_cuda.SMALL_LAUNCHES
            histogram_cuda.hist_u8_small_cuda(view, n_own, k, bins, canonical, acc)
            assert histogram_cuda.SMALL_LAUNCHES == launches + 1
            histogram_cuda.hist_u8_reference(view, n_own, k, bins, canonical, ref)
            torch.cuda.synchronize()
            assert torch.equal(acc, ref), ("u8", off, n_own)
    for d_off, m_off in [(2 * j, j) for j in range(8)] + [(16, 8)]:
        d, m = data[d_off:], mask[m_off:]
        view = b[4 * d_off:]
        acc = torch.full((bins,), 7, dtype=torch.int32, device=cuda_device)
        ref = acc.clone()
        for n_own in (0, 1, view.numel() // 2 + 3, view.numel() - k, view.numel()):
            launches = histogram_cuda.PACKED_LAUNCHES
            out = histogram_cuda.histogram_packed(d, m, n_own, k, bins, canonical, acc)
            assert out is acc and histogram_cuda.PACKED_LAUNCHES == launches + 1
            histogram_cuda.hist_u8_reference(view, n_own, k, bins, canonical, ref)
            torch.cuda.synchronize()
            assert torch.equal(acc, ref), ("packed", d_off, n_own)
            assert torch.equal(
                histogram_cuda.hist_packed_small_reference(d, m, n_own, k, bins, canonical),
                histogram_cuda.hist_u8_reference(view, n_own, k, bins, canonical))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 7, 8])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("kind", ["nrich", "runs"])
def test_hist_planes_views_match_plain(cuda_device, kind, canonical, k):
    # K5 at k=8 (16-bit halves) and below (one block's cluster histogram),
    # on an N-rich stream and a run-rich one, on plane views 0..3 words in,
    # for n_own at the edges.
    n = 65536 + 128
    if kind == "nrich":
        bases = stream(n, 700)
    else:
        bases = chip_smoke.runs_stream(np.random.default_rng(7), n)
    planes = engine.stage_batch_planes(bases, cuda_device)
    b = torch.from_numpy(bases).to(cuda_device)
    for off in range(4):
        view = (planes[0][off:], planes[1][off:])
        m = n - 16 * off
        acc = torch.full((4**k,), 7, dtype=torch.int32, device=cuda_device)
        ref = acc.clone()
        for n_own in (0, 1, m // 2 + 3, m - k, m):
            launches = histogram_cuda.PLANES_LAUNCHES
            histogram_cuda.hist_planes_cuda(*view, n_own, k, canonical, acc)
            assert histogram_cuda.PLANES_LAUNCHES == launches + 1
            histogram_cuda.hist_u8_reference(b[16 * off:], n_own, k, 4**k, canonical, ref)
            torch.cuda.synchronize()
            assert torch.equal(acc, ref), (k, off, n_own)


@pytest.mark.cuda
@pytest.mark.parametrize("code", [0, 2, 3])
def test_hist_kernels_one_code_batch(cuda_device, code):
    # A whole 16 Mbase batch of one base: one bin takes every count (K7's
    # per-thread counters and block sums; K5's 16-bit halves pass 2^15 many
    # times in each block and spill), canonical and not.
    batch, T = engine.batch_plan(1 << 40, 8, 1 << 24)
    bases = np.full(T, code, np.uint8)
    b = torch.from_numpy(bases).to(cuda_device)
    data, mask = packed_on(bases, cuda_device)
    planes = engine.stage_batch_planes(bases, cuda_device)
    for canonical in (False, True):
        for k in (1, 3):
            want = histogram_cuda.hist_u8_reference(b, batch, k, 4**k, canonical)
            assert int(want.max()) == batch
            got = histogram_cuda.hist_u8_small_cuda(b, batch, k, 4**k, canonical)
            assert torch.equal(got, want), ("u8", k)
            got = histogram_cuda.hist_packed_small_cuda(data, mask, batch, k, 4**k, canonical)
            assert torch.equal(got, want), ("packed", k)
        for k in (6, 8):
            want = histogram_cuda.hist_u8_reference(b, T, k, 4**k, canonical)
            assert int(want.max()) == T - k + 1
            got = histogram_cuda.hist_planes_cuda(*planes, T, k, canonical)
            torch.cuda.synchronize()
            assert torch.equal(got, want), k


@pytest.mark.cuda
def test_packed_small_route_runs_no_unpack_on_card(cuda_device, monkeypatch):
    # The engine's packed k <= 3 route launches K7's packed entry once a
    # batch and never unpacks on the card; its counts equal the CPU route's.
    import dna_kmeres_parallel_tpu_torch as port
    from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops

    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGTN"), size=n, p=[0.24] * 4 + [0.04]))
            for n in (5000, 3, 12000, 700)]
    want = {k: port.count_sequences(seqs, k=k, device="cpu", batch_bases=4096).hist
            for k in (1, 2, 3)}
    real_unpack = encode_ops.unpack_stream

    def unpack_on_cpu_only(data, mask):
        assert data.device.type == "cpu", "unpack_stream ran on the card"
        return real_unpack(data, mask)

    monkeypatch.setattr(encode_ops, "unpack_stream", unpack_on_cpu_only)
    for k in (1, 2, 3):
        launches = histogram_cuda.PACKED_LAUNCHES
        small = histogram_cuda.SMALL_LAUNCHES
        got = port.count_sequences(seqs, k=k, device="cuda", batch_bases=4096)
        n_batches = -(-(sum(map(len, seqs)) + len(seqs) - 1) // 4096)
        assert histogram_cuda.PACKED_LAUNCHES == launches + n_batches
        assert histogram_cuda.SMALL_LAUNCHES == small
        assert np.array_equal(got.hist, want[k]), k


# ---------------------------------------------------------------------------
# K9: the u8-stream encoder, and the streaming counter on the card
# ---------------------------------------------------------------------------


def stream_kernel_and_plain(b: torch.Tensor, n_own: int, k: int, canonical: bool):
    launches = encode_cuda.STREAM_LAUNCHES
    got = sparse_ops.encode_words(b, n_own, k, canonical)
    assert encode_cuda.STREAM_LAUNCHES == launches + 1
    ref = sparse_ops.narrow_words(
        *encode_cuda.encode_stream_reference(b, n_own, k, canonical), k
    )
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_stream_kernel_matches_plain_on_card(cuda_device, k, canonical):
    # 3% N, an N run and a 64-base all-T run; T not a multiple of the
    # kernel's tile; several n_own.
    b = torch.from_numpy(stream(8192, 300 + k)[:7001]).to(cuda_device)
    for n_own in (0, 1, 7001 // 2, 7001 - k + 1, 10**12):
        got, ref = stream_kernel_and_plain(b, n_own, k, canonical)
        assert len(got) == sparse_ops.key_words(k)
        for g, r in zip(got, ref, strict=True):
            assert g.device.type == "cuda" and g.dtype == r.dtype and g.shape == (7001,)
            assert torch.equal(g, r), n_own


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,k", [(1, 1), (5, 21), (20, 21), (21, 21), (2048, 16), (2049, 31), (4097, 13)]
)
def test_stream_kernel_edges_on_card(cuda_device, n, k):
    # Streams shorter than k, exactly k, and one past a tile; an unaligned
    # view of a longer stream takes the byte loads.
    full = torch.from_numpy(stream(max(16, -(-(n + 3) // 16) * 16), n + k)).to(cuda_device)
    for b in (full[:n], full[3 : n + 3]):
        got, ref = stream_kernel_and_plain(b, n, k, True)
        for g, r in zip(got, ref, strict=True):
            assert torch.equal(g, r)
        assert int((got[-1] != -1).sum()) <= max(0, n - k + 1)


@pytest.mark.cuda
def test_stream_kernel_all_t_16mer(cuda_device):
    # k=16: the all-T window has lo == 0xFFFFFFFF and is valid (hi == 0);
    # canonical folds it onto all-A.
    b = torch.full((100,), 3, dtype=torch.uint8, device=cuda_device)
    hi, lo = sparse_ops.encode_words(b, 100, 16, False)
    assert int((lo[:85] == -1).sum()) == 85 and int((hi[:85] == 0).sum()) == 85
    assert int((hi[85:] == -1).sum()) == 15
    hi, lo = sparse_ops.encode_words(b, 100, 16, True)
    assert int((lo[:85] == 0).sum()) == 85


@pytest.mark.cuda
def test_stream_kernel_refuses_bad_input(cuda_device):
    b = torch.zeros(64, dtype=torch.uint8, device=cuda_device)
    launches = encode_cuda.STREAM_LAUNCHES
    for bad in (b.to(torch.int32), b[::2], b[:0], b.reshape(8, 8)):
        with pytest.raises(ValueError):
            encode_cuda.encode_stream(bad, 64, 21)
    assert encode_cuda.STREAM_LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,canonical,pack,compact",
    [(21, False, False, "device"), (21, True, True, "device"), (21, False, False, "auto"),
     (11, True, False, "device"), (9, False, True, "auto"), (8, False, True, "auto"),
     (5, True, False, "auto"), (3, False, True, "auto")],
)
def test_streaming_counter_on_card_equals_cpu(cuda_device, tmp_path, k, canonical, pack, compact):
    # The streaming counter end to end on the card against its CPU route,
    # over several batches, with a checkpoint every two batches.
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    rng = np.random.default_rng(k)
    path = tmp_path / "s.fasta"
    with open(path, "w") as f:
        for i, n in enumerate((5000, 3, 12000, 700, 9000)):
            s = "".join(rng.choice(list("ACGTN"), size=n, p=[0.24] * 4 + [0.04]))
            f.write(f">r{i}\n{s}\n")
    cfg = KmerConfig(k=k, canonical=canonical, pack_input=pack, compact=compact,
                     batch_bases=2048)
    out = {}
    for dev in ("cuda", "cpu"):
        sc = StreamingCounter(cfg, device=dev, checkpoint_path=str(tmp_path / f"{dev}.npz"),
                              checkpoint_every_bases=4096)
        out[dev] = sc.run(str(path))
        assert sc.metrics.counters["checkpoints"] >= 5
    if hasattr(out["cpu"], "hist"):
        assert np.array_equal(out["cuda"].hist, out["cpu"].hist)
    else:
        assert np.array_equal(out["cuda"].codes, out["cpu"].codes)
        assert np.array_equal(out["cuda"].counts, out["cpu"].counts)


@pytest.mark.cuda
def test_streaming_counter_trace_shows_the_kernel(cuda_device, tmp_path):
    # trace_dir: the torch.profiler trace holds K9's launches on the card.
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    path = tmp_path / "t.fasta"
    path.write_text(">r\n" + "ACGTTGCAAC" * 3000 + "\n")
    cfg = KmerConfig(k=21, pack_input=False, compact="device", batch_bases=4096)
    sc = StreamingCounter(cfg, device="cuda", trace_dir=str(tmp_path / "trace"))
    res = sc.run(str(path))
    assert res.total_kmers == 30000 - 20
    assert "encode_stream_kernel" in (tmp_path / "trace" / "trace.json").read_text()


# ---------------------------------------------------------------------------
# The bucketed exchange: K1m (K1's minimizer plane), K10, P1, and the path


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,m", [(13, 7), (17, 7), (17, 11), (17, 15), (21, 7), (21, 11),
                                 (21, 15), (24, 9), (31, 7), (31, 11), (31, 15)])
def test_minimizer_kernel_matches_plain_on_card(cuda_device, k, m, canonical):
    planes = engine.stage_batch_planes(stream(4096, 500 + k), cuda_device)
    for n_own in (0, 1, 2048, 4096 - 200, 10**9):
        launches = (encode_cuda.LAUNCHES, encode_cuda.MIN_LAUNCHES)
        got = encode_cuda.encode_packed(*planes, n_own, k, canonical, minimizer_m=m)
        assert (encode_cuda.LAUNCHES, encode_cuda.MIN_LAUNCHES) == (launches[0], launches[1] + 1)
        ref = encode_cuda.encode_packed_reference(*planes, n_own, k, canonical, minimizer_m=m)
        plain = encode_cuda.encode_packed(*planes, n_own, k, canonical)
        torch.cuda.synchronize()
        assert len(got) == 3
        for g, r in zip(got, ref, strict=True):
            if r is None:
                assert g is None
                continue
            assert g.device.type == "cuda" and g.dtype == r.dtype and torch.equal(g, r), n_own
        for g, p in zip(got[:2], plain, strict=True):
            assert (g is None and p is None) or torch.equal(g, p)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(16, 16, 7), (32, 21, 11), (48, 31, 15), (16, 13, 1)])
def test_minimizer_kernel_edges_on_card(cuda_device, n, k, m):
    planes = engine.stage_batch_planes(stream(n, n + k), cuda_device)
    got = encode_cuda.encode_packed(*planes, n, k, True, minimizer_m=m)
    ref = encode_cuda.encode_packed_reference(*planes, n, k, True, minimizer_m=m)
    torch.cuda.synchronize()
    assert torch.equal(got[2], ref[2]) and torch.equal(got[1], ref[1])


def packed_planes_equal(planes, n_own, k, canonical, m):
    """K1 (m None) or K1m against its plain version, plane by plane; with
    m, the words also against K1's without the plane, bit for bit."""
    got = encode_cuda.encode_packed(*planes, n_own, k, canonical, minimizer_m=m)
    ref = encode_cuda.encode_packed_reference(*planes, n_own, k, canonical, minimizer_m=m)
    plain = encode_cuda.encode_packed(*planes, n_own, k, canonical) if m else got[:2]
    torch.cuda.synchronize()
    for g, r in zip(got, ref, strict=True):
        assert (g is None and r is None) or (
            g.device.type == "cuda" and g.dtype == r.dtype and torch.equal(g, r)
        ), (k, m, canonical, n_own)
    for g, w in zip(got[:2], plain, strict=True):
        assert (g is None and w is None) or torch.equal(g, w), (k, m, canonical, n_own)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(2, 32))
def test_minimizer_kernel_every_m_on_card(cuda_device, k):
    # Every (k, m) with 1 <= m < min(k, 16), 345 pairs over k = 2..31, so
    # every window length L = k - m + 1 from 2 to 31: every ladder depth
    # and combine offset, canonical and not, on one 4,096-base stream.
    planes = engine.stage_batch_planes(stream(4096, 900 + k), cuda_device)
    for m in range(1, min(k, 16)):
        for canonical in (False, True):
            packed_planes_equal(planes, 4096 - 200, k, canonical, m)


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(1, None), (11, None), (21, None), (31, None), (16, 15),
                                 (21, 7), (31, 7), (31, 1), (13, 12)])
def test_encode_kernel_n_own_edges_on_card(cuda_device, k, m):
    # n_own at 0, 1, each side of a word edge and of a warp's 512 windows,
    # and past the end.
    planes = engine.stage_batch_planes(stream(4096, 40 + k), cuda_device)
    for n_own in (0, 1, 15, 16, 17, 511, 512, 513, 2047, 2048, 2049, 4095, 4096, 10**9):
        for canonical in (False, True):
            packed_planes_equal(planes, n_own, k, canonical, m)


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [1, 2, 3])
@pytest.mark.parametrize("k,m", [(1, None), (15, None), (16, 15), (23, 2), (24, 9), (31, 7),
                                 (31, 1), (31, 15)])
def test_encode_kernel_short_planes_on_card(cuda_device, n_words, k, m):
    # Planes of one to three words: every window past the planes invalid,
    # nothing read past them.
    planes = engine.stage_batch_planes(stream(16 * n_words, n_words + k), cuda_device)
    for canonical in (False, True):
        packed_planes_equal(planes, 10**9, k, canonical, m)


@pytest.mark.cuda
@pytest.mark.parametrize("start", [1, 2, 3])
@pytest.mark.parametrize("k,m", [(11, None), (21, None), (31, None), (21, 7), (31, 7)])
def test_encode_kernel_plane_views_on_card(cuda_device, start, k, m):
    # Plane views that start 1-3 words into their tensors (4-12 bytes past
    # the allocation's alignment), as a caller's slices give them.
    full = engine.stage_batch_planes(stream(4096 + 64, 70 + k), cuda_device)
    planes = tuple(p[start : start + 256 - start] for p in full)
    assert planes[0].data_ptr() % 16 == 4 * start
    for canonical in (False, True):
        packed_planes_equal(planes, 10**9, k, canonical, m)


@pytest.mark.cuda
@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_minimizer_kernel_one_base_stream_on_card(cuda_device, base):
    # One base throughout: every m-mer of a window ties.
    planes = engine.stage_batch_planes(np.full(4096, base, np.uint8), cuda_device)
    for k, m in ((2, 1), (16, 15), (21, 7), (31, 7), (31, 1), (31, 15)):
        for canonical in (False, True):
            packed_planes_equal(planes, 4096 - 3, k, canonical, m)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 32))
def test_encode_kernel_every_k_on_card(cuda_device, k):
    # K1 at every k, canonical and not, on a stream longer than one block's
    # 4,096 windows and not a multiple of them.
    planes = engine.stage_batch_planes(stream(3 * 4096 + 48, 60 + k), cuda_device)
    for canonical in (False, True):
        packed_planes_equal(planes, 3 * 4096 + 7, k, canonical, None)


def sorted_rows_on(dev, n_rows, row_w, D, seed):
    """Row-sorted int32 planes [n_rows, row_w] (2) grouped by owner and
    their starts [n_rows, D+1]: row 0 one owner, row 1 all sentinels."""
    g = torch.Generator().manual_seed(seed)
    owner = torch.randint(0, D, (n_rows, row_w), generator=g)
    owner[0] = D - 1
    owner[1] = D
    owner[2:, ::7] = D
    words = torch.randint(-(2**31), 2**31 - 1, (2, n_rows, row_w), generator=g,
                          dtype=torch.int64).to(torch.int32)
    key, order = torch.sort(owner, dim=1)
    planes = tuple(w.gather(1, order).contiguous().to(dev) for w in words)
    starts = torch.stack([(key < d).sum(1) for d in range(D + 1)], 1).to(torch.int32)
    return planes, starts.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_planes", [1, 2])
@pytest.mark.parametrize("D,row_w,row_cap", [(1, 2048, 2048), (4, 2048, 1024), (4, 2048, 2048),
                                             (5, 2048, 896), (8, 2048, 512), (8, 300, 128)])
def test_owner_segments_kernel_matches_plain_on_card(cuda_device, D, row_w, row_cap, n_planes):
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    planes, starts = sorted_rows_on(cuda_device, 333, row_w, D, D * row_cap)
    planes = planes[:n_planes]
    launches = sort_cuda.OWNER_LAUNCHES
    got = sort_cuda.extract_owner_segments(planes, starts, row_cap, D)
    assert sort_cuda.OWNER_LAUNCHES == launches + 1
    ref = sort_cuda.owner_segments_reference(planes, starts, row_cap, D)
    torch.cuda.synchronize()
    assert len(got) == n_planes
    for g, r in zip(got, ref, strict=True):
        assert g.shape == (333, D * row_cap) and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize(
    "R,W",
    [(8, 256), (333, 1000), (4096, 2048), (1, 1), (64, 2), (64, 3), (64, 5), (333, 255),
     (100, 2049), (32768, 2048)],
)
def test_row_roll_kernel_matches_plain_on_card(cuda_device, R, W, offset):
    # offset 1 puts x one word past a 16-byte boundary, so no row starts
    # aligned. Shifts include both int32 extremes.
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    g = torch.Generator().manual_seed(R + W)
    x = torch.randint(-(2**31), 2**31 - 1, (R, W), generator=g, dtype=torch.int64)
    buf = torch.empty(R * W + offset, dtype=torch.int32, device=cuda_device)
    x = buf[offset:].view(R, W).copy_(x.to(torch.int32))
    s = torch.randint(-3 * W, 3 * W, (R,), generator=g).to(torch.int32)
    s[0] = -(2**31)
    s[-1] = 2**31 - 1
    s = s.to(cuda_device)
    launches = sort_cuda.ROLL_LAUNCHES
    got = sort_cuda.row_roll(x, s)
    assert sort_cuda.ROLL_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(got, sort_cuda.row_roll_reference(x, s))


def bucket_stream(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, n).astype(np.uint8)
    b[rng.random(n) < 0.01] = codec.INVALID_BASE
    b[n // 3 : n // 3 + 50] = codec.INVALID_BASE
    return b


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,canonical,owner_mode,exchange,D",
    [(31, False, "minimizer", "auto", 4), (31, True, "minimizer", "auto", 4),
     (31, False, "prefix", "raw", 4), (21, False, "prefix", "auto", 5),
     (16, True, "prefix", "raw", 8), (23, False, "minimizer", "raw", 3),
     (13, False, "prefix", "raw", 4), (21, True, "minimizer", "agg", 4),
     (31, False, "minimizer", "super", 4)],
)
def test_bucketed_on_card_equals_cpu(cuda_device, k, canonical, owner_mode, exchange, D):
    from dna_kmeres_parallel_tpu_torch import native
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda
    from dna_kmeres_parallel_tpu_torch.parallel import bucketed
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

    flat = bucket_stream(300_000, k * D)
    want = native.count_sparse_host_native(flat, k, canonical)
    out = {}
    for dev in ("cuda", "cpu"):
        launches = (sort_cuda.OWNER_LAUNCHES, encode_cuda.MIN_LAUNCHES)
        out[dev] = bucketed.count_bucket_auto(flat, k, canonical, LocalMesh(D, dev),
                                              owner_mode=owner_mode, exchange=exchange)
        if dev == "cuda" and exchange in ("auto", "raw"):
            # No fallback: one K10 launch per shard where the row route
            # runs, and one K1m per shard in minimizer mode.
            row = owner_mode == "minimizer" or k <= 15 or bucketed._owner_bits(k, D)[2]
            assert sort_cuda.OWNER_LAUNCHES == launches[0] + (D if row else 0)
            mins = D if owner_mode == "minimizer" else 0
            assert encode_cuda.MIN_LAUNCHES == launches[1] + mins
    for got in out.values():
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.cuda
def test_bucketed_skew_falls_back_on_card(cuda_device):
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda
    from dna_kmeres_parallel_tpu_torch.parallel import bucketed
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

    flat = np.zeros(40_000, np.uint8)
    mesh = LocalMesh(4, cuda_device)
    with pytest.raises(OverflowError):
        bucketed.count_bucket_sharded_raw(flat, 21, False, mesh)
    launches = (encode_cuda.LAUNCHES, sort_cuda.OWNER_LAUNCHES)
    codes, counts = bucketed.count_bucket_auto(flat, 21, False, mesh)
    # Row route, global route, then the aggregated exchange.
    assert (encode_cuda.LAUNCHES - launches[0], sort_cuda.OWNER_LAUNCHES - launches[1]) == (12, 4)
    assert codes.tolist() == [0] and counts.tolist() == [40_000 - 20]


@pytest.mark.cuda
def test_bucketed_nccl_one_rank_equals_local_mesh(cuda_device, tmp_path):
    import torch.distributed as dist

    from dna_kmeres_parallel_tpu_torch.parallel import bucketed
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh, ProcessGroupMesh

    flat = bucket_stream(200_000, 7)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        got = bucketed.count_bucket_auto(flat, 31, False, ProcessGroupMesh("cuda"),
                                         owner_mode="minimizer")
    finally:
        dist.destroy_process_group()
    want = bucketed.count_bucket_auto(flat, 31, False, LocalMesh(1, "cuda"),
                                      owner_mode="minimizer")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The device-sort route: K11 (the row sort) and the path


def row_sort_input(R: int, m: int, seed: int) -> torch.Tensor:
    """int32 [R, m] of random u32 bits, the bias-order extremes in row 0,
    a sentinel tail in every third row and one row all sentinels."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-(2**31), 2**31, (R, m), generator=g, dtype=torch.int64).to(torch.int32)
    x[0, :4] = torch.tensor([0, -1, 2**31 - 1, -(2**31)], dtype=torch.int32)
    x[::3, m // 2 :] = -1
    x[R // 2] = -1
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768])
@pytest.mark.parametrize("R", [1, 9, 37])
def test_row_sort_kernel_matches_plain_on_card(cuda_device, R, m):
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    x = row_sort_input(R, m, R * m).to(cuda_device)
    launches = sort_cuda.ROW_SORT_LAUNCHES
    got = sort_cuda.row_sort_u32(x)
    assert sort_cuda.ROW_SORT_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    want = sort_cuda.row_sort_u32_reference(x)
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), sort_cuda.row_sort_u32(x.cpu()))
    assert int(got[0, -1]) == -1  # the all-ones sentinel sorts last


def row_cases(R: int, m: int, seed: int) -> dict:
    """Rows of one kind each, [R, m] int32 of u32 bits."""
    g = torch.Generator().manual_seed(seed)

    def rand(lo, hi):
        return torch.randint(lo, hi, (R, m), generator=g, dtype=torch.int64)

    top = rand(0, 1 << 32) | (1 << 31)
    cases = {
        "sentinels only": torch.full((R, m), -1, dtype=torch.int64),
        "no sentinel": rand(0, (1 << 32) - 1),
        "all equal": torch.full((R, m), 0x12345678, dtype=torch.int64),
        "all equal, sentinel tails": torch.full((R, m), 7, dtype=torch.int64),
        "top bit set": top,
        "top bit set, all-ones kin": torch.where(rand(0, 2) == 1, top, 0xFFFFFFFE),
        "k=11 words": rand(0, 1 << 22),
    }
    cases["all equal, sentinel tails"][:, m // 3 :] = -1
    for byte in range(4):
        # keys that differ only in one byte; sentinels in every other row
        x = 0x5A5A5A5A & ~(0xFF << (8 * byte)) | (rand(0, 256) << (8 * byte))
        x[1::2, : m // 5] = -1
        cases[f"byte {byte} only"] = x
    return {name: (x & 0xFFFFFFFF).to(torch.uint32).view(torch.int32) for name, x in cases.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768])
@pytest.mark.parametrize("R", [3, 11])
def test_row_sort_kernel_on_row_kinds(cuda_device, R, m):
    # Rows of only sentinels, none, all keys equal, the top bit set, keys
    # that differ in one byte only (a stability fault shows after the
    # second pass), K1's k=11 words; R not a multiple of the rows a block.
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    for name, x in row_cases(R, m, m + R).items():
        x = x.to(cuda_device)
        got = sort_cuda.row_sort_u32_cuda(x)
        torch.cuda.synchronize()
        assert torch.equal(got, sort_cuda.row_sort_u32_reference(x)), name


@pytest.mark.cuda
def test_row_sort_kernel_refuses_bad_input(cuda_device):
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    for shape in ((4, 100), (4, 192), (4, 65536), (0, 128), (128,)):
        with pytest.raises(ValueError):
            sort_cuda.row_sort_u32(torch.zeros(shape, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        sort_cuda.row_sort_u32(torch.zeros((4, 128), dtype=torch.int64, device=cuda_device))
    flat = torch.zeros(4 * 128 + 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        sort_cuda.row_sort_u32_cuda(flat[1:].view(4, 128))
    with pytest.raises(ValueError, match="CUDA"):
        sort_cuda.row_sort_u32_cuda(torch.zeros((4, 128), dtype=torch.int32))


def sort_fasta(path, seed: int) -> None:
    """Five records of about 27 kbase (4% N) with a duplicated stretch."""
    rng = np.random.default_rng(seed)
    core = "".join(rng.choice(list("ACGT"), size=3000))
    with open(path, "w") as f:
        for i, n in enumerate((5000, 3, 12000, 700, 9000)):
            s = "".join(rng.choice(list("ACGTN"), size=n, p=[0.24] * 4 + [0.04]))
            f.write(f">r{i}\n{s}{core}\n")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,canonical,pack,row_len,pallas_sort",
    [(11, True, True, 2048, True), (13, False, False, 128, True), (15, False, True, 512, True),
     (13, False, True, 2048, False), (16, False, True, 2048, True), (21, False, False, 2048, True),
     (24, True, True, 128, False), (31, False, False, 0, False), (11, False, True, 0, True)],
)
def test_device_sort_on_card_equals_cpu(cuda_device, tmp_path, k, canonical, pack, row_len,
                                        pallas_sort):
    # The device-sort route on the card against its CPU route, through both
    # entries: K11 runs once per batch where its gate holds (single-word
    # keys, a row length it takes), and never otherwise.
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    path = tmp_path / "s.fasta"
    sort_fasta(path, k)
    cfg = KmerConfig(k=k, canonical=canonical, pack_input=pack, device_sort=True,
                     sort_row_len=row_len, batch_bases=8192, compact="device",
                     dense_bins_limit=1)
    gate = pallas_sort and k <= 15 and row_len >= 128
    out = {}
    for dev in ("cuda", "cpu"):
        launches = sort_cuda.ROW_SORT_LAUNCHES
        one = SparseKmerEngine(cfg, device=dev, pallas_sort=pallas_sort).count_file(str(path))
        sc = StreamingCounter(cfg, device=dev, pallas_sort=pallas_sort)
        out[dev] = (one, sc.run(str(path)))
        if dev == "cuda":
            batches = sc.metrics.counters["batches"]
            assert batches >= 5
            assert sort_cuda.ROW_SORT_LAUNCHES - launches == (2 * batches if gate else 0)
    for a, b in zip(*out.values()):
        assert np.array_equal(a.codes, b.codes) and np.array_equal(a.counts, b.counts)
    assert np.array_equal(out["cpu"][0].codes, out["cpu"][1].codes)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,canonical,pack",
    [(11, True, True), (13, False, False), (16, False, True), (21, False, True),
     (21, True, False), (24, True, True), (31, False, True)],
)
def test_table_on_card_equals_the_host_route(cuda_device, tmp_path, k, canonical, pack):
    # The card's table build (the default) against the host route on the
    # card (device_sort=False) and the CPU, over a file of several batches
    # with N runs, a three-base record and a stretch every record repeats.
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine

    path = tmp_path / "s.fasta"
    sort_fasta(path, k)
    cfg = KmerConfig(k=k, canonical=canonical, pack_input=pack, batch_bases=8192,
                     dense_bins_limit=1)
    card = SparseKmerEngine(cfg, device="cuda").count_file(str(path))
    host = SparseKmerEngine(cfg.replace(device_sort=False), device="cuda").count_file(str(path))
    cpu = SparseKmerEngine(cfg, device="cpu").count_file(str(path))
    assert card.table_on_card and not host.table_on_card and not cpu.table_on_card
    for other in (host, cpu):
        assert np.array_equal(card.codes, other.codes)
        assert np.array_equal(card.counts, other.counts)
    assert card.counts.max() > 1 and card.phases["merge"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("k,pack", [(11, True), (21, False), (31, True)])
def test_device_rle_on_card_equals_cpu(cuda_device, tmp_path, k, pack):
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    path = tmp_path / "s.fasta"
    sort_fasta(path, k)
    cfg = KmerConfig(k=k, pack_input=pack, compact="device-rle", batch_bases=8192,
                     dense_bins_limit=1)
    got = StreamingCounter(cfg, device="cuda").run(str(path))
    want = StreamingCounter(cfg.replace(compact="host"), device="cpu").run(str(path))
    assert np.array_equal(got.codes, want.codes) and np.array_equal(got.counts, want.counts)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,bins,scale", [(1, 64, 3), (130, 64, 3), (129, 4096, 70_000)])
def test_tri_launcher_equals_min_sum_tri(cuda_device, rows, bins, scale):
    # The benches' and calibration's launcher: one output, the route
    # decided once (u16x2, and i32 where a row sums to 2^16 or more).
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    counts = torch.randint(0, scale, (rows, bins), generator=g, device=cuda_device,
                           dtype=torch.int32)
    run, route = distance_cuda.tri_launcher(counts)
    assert route == distance_cuda.product_route(*distance_cuda.check_counts(counts))
    assert torch.equal(run(), distance_cuda.min_sum_tri_cuda(counts))
    assert torch.equal(run(), distance.min_sum_matrix(counts))


@pytest.mark.cuda
def test_benches_and_calibration_on_card(cuda_device):
    from dna_kmeres_parallel_tpu_torch.models import benchmarks
    from dna_kmeres_parallel_tpu_torch.ops import calibrate

    for r in (benchmarks.run_count_bench(k=8, total_bases=4 << 20, batch_bases=1 << 20),
              benchmarks.run_count_bench(k=3, total_bases=4 << 20, batch_bases=1 << 20,
                                         pack_input=False),
              benchmarks.run_sparse_bench(k=21, total_bases=4 << 20, batch_bases=1 << 20),
              benchmarks.run_sparse_bench(k=13, total_bases=2 << 20, batch_bases=1 << 20,
                                          device_sort=True, row_len=2048, pallas_sort=True),
              benchmarks.run_distance_bench(n_seqs=300, seq_len=500, k=5)):
        assert r["timing_valid"] and r["windows_counted"] == r["windows_expected"], r
    assert all(r["exact"] for r in benchmarks.run_impl_matrix_bench(ks=(3, 6),
                                                                    total_bases=1 << 20))
    cal = calibrate.calibrate(cuda_device, link_only=True)
    assert cal["fingerprint"] == calibrate.fingerprint(cuda_device)
    assert "sm_" in cal["fingerprint"] and cal["h2d_bytes_per_sec"] > 1e9


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [
    ["count", "--k", "21"], ["count", "--k", "4", "--canonical"], ["distance", "--k", "3"],
    ["distance", "--k", "21"], ["histo", "--k", "13"],
])
def test_cli_on_card_equals_cpu(cuda_device, tmp_path, capsys, argv):
    import json

    from dna_kmeres_parallel_tpu_torch import cli
    from dna_kmeres_parallel_tpu_torch.utils import datagen

    path = tmp_path / "in.fasta"
    datagen.random_fasta(str(path), 40, (500, 1500), seed=5, invalid_frac=0.01)
    outs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.out"
        assert cli.main(argv + ["--device", dev, str(path), "-o", str(out)]) == 0
        report = json.loads(capsys.readouterr().out)
        outs[dev] = (out.read_bytes(), {k: v for k, v in report.items()
                                        if k not in ("elapsed_s", "bases_per_sec", "output",
                                                     "engine")})
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# The data-parallel layer on a LocalMesh of the card: the kernels per shard


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 4])
@pytest.mark.parametrize("k,bins", [(3, 64), (8, 4**8), (6, 3000)])
def test_count_sharded_on_card_matches_cpu_mesh(cuda_device, D, k, bins):
    # K7, K6 or K8 once a shard, unaligned shard rows (the halo columns),
    # equal to the CPU mesh's plain versions and to one stream's count.
    from dna_kmeres_parallel_tpu_torch.parallel import sharded_count
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

    flat = stream(3 * 4096 + 5, k)
    route = {"small": "SMALL_LAUNCHES", "u8": "U8_LAUNCHES", "any": "ANY_LAUNCHES"}[
        histogram_cuda.u8_route(bins)]
    before = getattr(histogram_cuda, route)
    got = sharded_count.count_sharded(sharded_count.shard_stream(flat, LocalMesh(D, cuda_device)),
                                      k, bins, True, LocalMesh(D, cuda_device), n_own=9000)
    assert getattr(histogram_cuda, route) == before + D
    cpu = LocalMesh(D, "cpu")
    want = sharded_count.count_sharded(sharded_count.shard_stream(flat, cpu), k, bins, True, cpu,
                                       n_own=9000)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 4])
def test_min_sum_panel_mesh_on_card_both_routes(cuda_device, D):
    # Partners padded to a multiple of D; one shard holds a row summing
    # past 2^16 (i32), the others and the padding take u16x2.
    from dna_kmeres_parallel_tpu_torch.models.engine import min_sum_panel_mesh
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

    rng = np.random.default_rng(D)
    other = rng.integers(0, 9, (301, 64)).astype(np.int32)
    other[-1, 0] = 70_000
    panel = torch.from_numpy(np.concatenate([other[-5:], other[:123]]))
    before = dict(distance_cuda.ROUTE_LAUNCHES)
    got = min_sum_panel_mesh(panel.to(cuda_device), torch.from_numpy(other).to(cuda_device),
                             LocalMesh(D, cuda_device))
    taken = {r: distance_cuda.ROUTE_LAUNCHES[r] - before[r] for r in before}
    assert taken[distance_cuda.WIDE] >= 1 and taken[distance_cuda.PACKED] >= 1
    assert sum(taken.values()) == D
    want = distance.min_sum_matrix(panel, torch.from_numpy(other))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("device_sort", [False, True])
@pytest.mark.parametrize("pack_input", [False, True])
def test_count_sparse_sharded_on_card_matches_cpu(cuda_device, device_sort, pack_input):
    from dna_kmeres_parallel_tpu_torch.parallel import sharded_sparse
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

    flat = stream(4 * 8192, 7)
    for k in (11, 21):
        kw = dict(row_len=1024, device_sort=device_sort, pack_input=pack_input,
                  pallas_sort=True)
        got = sharded_sparse.count_sparse_sharded(flat, k, True, LocalMesh(4, cuda_device), **kw)
        want = sharded_sparse.count_sparse_sharded(flat, k, True, LocalMesh(4, "cpu"), **kw)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_stream_mesh_and_super_on_card(cuda_device, tmp_path):
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    flat = stream(3 * 65536, 9)
    records = [(0, 70000), (70001, 60000), (130002, 3 * 65536 - 130002)]
    path = tmp_path / "in.fasta"
    path.write_text("".join(
        f">r{i}\n" + np.frombuffer(b"ACGTN", np.uint8)[np.minimum(flat[s : s + n], 4)]
        .tobytes().decode() + "\n" for i, (s, n) in enumerate(records)))
    for k, kw in ((3, {"mesh_shape": (4,)}), (8, {"mesh_shape": (3,)}),
                  (21, {"mesh_shape": (4,)}), (21, {"compact": "device-super"}),
                  (31, {"compact": "device-super", "canonical": True})):
        cfg = KmerConfig(k=k, batch_bases=1 << 16, **kw)
        got = StreamingCounter(cfg, device=cuda_device).run(str(path))
        want = StreamingCounter(cfg, device="cpu").run(str(path))
        if hasattr(got, "hist"):
            assert np.array_equal(got.hist, want.hist)
        else:
            assert np.array_equal(got.codes, want.codes)
            assert np.array_equal(got.counts, want.counts)


def finish_on_card(sums, lr, lc, k, r0, base, dev):
    """The finish entry on the card over NumPy inputs, and the launches it
    made."""
    launches = distance_cuda.FINISH_LAUNCHES
    got = distance_cuda.finish_upper_packed(
        torch.as_tensor(sums).to(dev), torch.from_numpy(lr).to(dev),
        torch.from_numpy(lc).to(dev), k, r0, base)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.float32
    return got.cpu().numpy(), distance_cuda.FINISH_LAUNCHES - launches


def plain_finish(sums, lr, lc, k, r0, base) -> np.ndarray:
    return distance.finish_upper_plain(torch.as_tensor(sums), torch.from_numpy(lr),
                                       torch.from_numpy(lc), k, r0, base).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 21])
@pytest.mark.parametrize("lengths", ["short", "huge"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("S", [*SIZES, 3000])
def test_finish_kernel_matches_plain(cuda_device, S, layout, lengths, k):
    sums, lr, lc, r0, base = finish_case(S, layout, lengths, k)
    want = plain_finish(sums, lr, lc, k, r0, base)
    got, launches = finish_on_card(sums, lr, lc, k, r0, base, cuda_device)
    assert launches == (1 if want.size else 0)
    assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,pad", [(1, 0), (2, 3), (3, 1), (0, 5), (0, 4)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_finish_kernel_unaligned_row_stride(cuda_device, layout, offset, pad):
    """Rows that lie apart (the mesh's sliced square) at every alignment
    of the input against the output."""
    sums, lr, lc, r0, base = finish_case(300, layout, "short", 3)
    R, C = sums.shape
    flat = torch.full((offset + R * (C + pad) + 8,), -1, dtype=torch.int32, device=cuda_device)
    view = flat[offset : offset + R * (C + pad)].view(R, C + pad)[:, :C]
    view.copy_(torch.from_numpy(sums))
    got, launches = finish_on_card(view, lr, lc, 3, r0, base, cuda_device)
    assert launches == 1
    assert_same_bits(got, plain_finish(sums, lr, lc, 3, r0, base))


@pytest.mark.cuda
@pytest.mark.parametrize("base", [0, 30000, 54019])
def test_finish_kernel_at_the_cells_rows(cuda_device, base):
    """Random sums [54,018, 64]: the cell's record count as rows; at base
    54,019 every row keeps all 64 columns."""
    rng = np.random.default_rng(54018)
    sums = rng.integers(0, 3000, (54018, 64)).astype(np.int32)
    lr = rng.integers(1000, 2001, 54018)
    lc = rng.integers(1000, 2001, 64)
    lc[:2] = [2, 1 << 30]
    got, launches = finish_on_card(sums, lr, lc, 3, 0, base, cuda_device)
    assert launches == 1
    assert_same_bits(got, plain_finish(sums, lr, lc, 3, 0, base))


def short_records(n: int = 41, seed: int = 21) -> list[str]:
    """Seeded records of 0-600 bases, 2% N, with records of k - 1 = 2
    bases (no 3-mer: NaN against each other and longer ones) and fewer."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("ACGTN"))
    seqs = ["".join(alphabet[rng.choice(5, size=m, p=[0.245] * 4 + [0.02])])
            for m in rng.integers(0, 601, n)]
    return seqs + ["AC", "GT", "A", ""]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["minplus", "threshold", "mesh"])
def test_distance_file_on_card_finishes_there(cuda_device, tmp_path, route):
    """``distance_file`` on the card equals its CPU route bit for bit, on
    each product route (the mesh's square is a strided slice); the finish
    is the kernel's device span, one launch a call."""
    from dna_kmeres_parallel_tpu_torch import KmerConfig

    seqs = short_records()
    path = tmp_path / "in.fasta"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    cfg = KmerConfig(k=3, mesh_shape=(3,) if route == "mesh" else ())
    kw = {"threshold": "on" if route == "threshold" else "off"}
    want = engine.KmerEngine(cfg, device="cpu", **kw).distance_file(str(path))
    eng = engine.KmerEngine(cfg, device=cuda_device, **kw)
    for _ in range(2):
        launches = distance_cuda.FINISH_LAUNCHES
        got = eng.distance_file(str(path))
        assert distance_cuda.FINISH_LAUNCHES == launches + 1
        assert got.phases["finish"] > 0
        assert got.route == ("threshold" if route == "threshold" else "minplus")
        assert np.array_equal(got.counts, want.counts)
        assert_same_bits(got.packed, want.packed)
    assert np.isnan(want.packed).any()


@pytest.mark.cuda
def test_dense_csv_stream_on_card_is_the_references_csv(cuda_device, tmp_path):
    """The dense CSV stream's panels, finished by the kernel, are byte for
    byte the CSV of the port's NumPy oracle, with records shorter than k."""
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models import oracle
    from dna_kmeres_parallel_tpu_torch.utils import io

    seqs = short_records()
    launches = distance_cuda.FINISH_LAUNCHES
    eng = engine.KmerEngine(KmerConfig(k=3), device=cuda_device)
    res = eng.distance_stream_to_csv(seqs, tmp_path / "card.csv", panel_rows=8)
    panels = -(-(len(seqs) - 1) // 8)
    assert distance_cuda.FINISH_LAUNCHES == launches + panels
    assert res["completed"] and res["phases"]["finish"] > 0
    io.write_distances_csv(tmp_path / "ref.csv", oracle.distance_matrix_packed(seqs, 3))
    data = (tmp_path / "card.csv").read_bytes()
    assert b"-nan" in data
    assert data == (tmp_path / "ref.csv").read_bytes()
