"""K3 and K4's bin split on the CPU: the plan and the split arithmetic.

Where a product has too few 128 x 128 output tiles to fill the card, the
kernels (``csrc/min_sum.cu``) cut the bins into P slices of whole 32-bin
stages: each block computes one tile over one slice, and adds its int32
tile (K3: and the mirror tile) into the zeroed output. The plan,
``ops/distance.min_sum_split``, gives P and the slice length L that the
wrapper passes to the kernels, which cut the bins at multiples of L.

Here: the plan at the distance path's shapes and its invariants (whole
stages, no empty slice, P = 1 where the tiles fill two waves or the bins
are few); a NumPy model of the split arithmetic on both routes (per-slice
partials on packed u16 pairs with the clamp, or on int32, unpacked and
summed into the output in int32), symmetric and rectangular, held exactly
to the plain version (``ops/distance.min_sum_matrix``) and to the JAX
package's Pallas kernels in interpret mode; and the gates' time models,
flat at bins that split. The tolerance is zero: integers are compared
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dna_kmeres_parallel_tpu.ops import distance_pallas
from dna_kmeres_parallel_tpu_torch.models import sparse_engine
from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda

PACKED, WIDE = distance_cuda.PACKED, distance_cuda.WIDE
LANE = 0xFFFF
H100_SMS = 132
STAGE = distance.MINPLUS_STAGE_BINS
RESIDENT = distance.MINPLUS_RESIDENT_BLOCKS


def slices(bins: int, L: int) -> list[tuple[int, int]]:
    """The bin slices the kernels cut ``bins`` into at slice length L
    (``bin_slices`` of min_sum.cu): [s L, min((s + 1) L, bins)); one
    slice where L is ``bins`` or more."""
    if L >= bins:
        return [(0, bins)]
    return [(b, min(b + L, bins)) for b in range(0, bins, L)]


def split(rows: int, cols: int, bins: int, route: str, symmetric: bool) -> tuple[int, int]:
    tiles = distance.minplus_tiles(rows, cols, symmetric)
    return distance.min_sum_split(tiles, bins, route, H100_SMS)


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("route", [PACKED, WIDE])
@pytest.mark.parametrize("name,rows,cols,bins,symmetric", [
    ("(a)", 16384, 16384, 64, True),
    ("(c) first panel", 2048, 54018, 64, False),
    ("(c) last panel", 1154, 1154, 64, False),
])
def test_plan_keeps_one_slice_at_the_reference_workload(name, rows, cols, bins, symmetric,
                                                         route):
    assert split(rows, cols, bins, route, symmetric) == (1, bins), name


@pytest.mark.parametrize("name,rows,cols,bins,symmetric,route", [
    ("K3 i32 [256, 131,072]", 256, 256, 131_072, True, WIDE),
    ("K3 i32 [256, 262,144]", 256, 256, 262_144, True, WIDE),
    ("K4 i32 [256, 131,072] x [256, ...]", 256, 256, 131_072, False, WIDE),
    ("K4 i32 [256, 262,144] x [256, ...]", 256, 256, 262_144, False, WIDE),
    ("K4 (g) k=10 panel", 256, 256, 4**10, False, PACKED),
    ("K4 (d) first panel", 256, 2048, 131_072, False, PACKED),
    ("K4 [256, 262,144] x [1024, ...]", 256, 1024, 262_144, False, PACKED),
    ("K3 (g) k=9", 1024, 1024, 4**9, True, PACKED),
    ("K3 (d)", 2048, 2048, 131_072, True, PACKED),
])
def test_plan_splits_every_wide_bin_shape(name, rows, cols, bins, symmetric, route):
    P, L = split(rows, cols, bins, route, symmetric)
    assert P > 1 and len(slices(bins, L)) == P, name
    tiles = distance.minplus_tiles(rows, cols, symmetric)
    waves2 = 2 * H100_SMS * RESIDENT[route]
    # about two waves, unless a slice would drop below 1,024 bins
    if bins // distance.MINPLUS_SLICE_MIN_BINS >= -(-waves2 // tiles):
        assert tiles * P >= 0.9 * waves2, name
    else:
        assert L >= distance.MINPLUS_SLICE_MIN_BINS, name


def test_plan_at_few_bins_and_full_cards():
    for route in (PACKED, WIDE):
        assert distance.min_sum_split(1, 100, route, H100_SMS) == (1, 100)
        assert distance.min_sum_split(1, 2016, route, H100_SMS) == (1, 2016)  # < 2 slices
        assert distance.min_sum_split(1, 2017, route, H100_SMS) == (2, 1024)  # 1,024 + 993
        waves2 = 2 * H100_SMS * RESIDENT[route]
        assert distance.min_sum_split(waves2, 1 << 20, route, H100_SMS) == (1, 1 << 20)
        assert distance.min_sum_split(waves2 - 1, 1 << 20, route, H100_SMS) == (2, 1 << 19)
        assert distance.min_sum_split(0, 1 << 20, route, H100_SMS) == (1, 1 << 20)
    # the resident blocks follow the route and the card
    assert split(256, 256, 4**10, PACKED, False) == (263, 125 * STAGE)  # 1,056 blocks wanted
    assert split(256, 256, 4**10, WIDE, False) == (132, 249 * STAGE)  # 528 wanted
    assert distance.min_sum_split(4, 4**10, PACKED, 66)[0] == 132
    with pytest.raises(ValueError, match="route"):
        distance.min_sum_split(4, 4**10, "u8", H100_SMS)


@settings(max_examples=300, deadline=None)
@given(tiles=st.integers(1, 3000), bins=st.integers(1, 1 << 22),
       route=st.sampled_from([PACKED, WIDE]), sms=st.integers(1, 200))
def test_plan_slices_are_whole_stages_and_never_empty(tiles, bins, route, sms):
    P, L = distance.min_sum_split(tiles, bins, route, sms)
    stages = -(-bins // STAGE)
    assert 1 <= P <= max(1, stages)
    cut = slices(bins, L)
    assert len(cut) == P  # the kernel launches exactly P slices, none empty
    assert cut[0][0] == 0 and cut[-1][1] == bins
    assert all(b1 > b0 for b0, b1 in cut)
    assert all(a[1] == b[0] for a, b in zip(cut, cut[1:]))
    if P > 1:
        # every slice but the last is L bins of whole stages, L at least 1,024
        assert L % STAGE == 0 and L >= distance.MINPLUS_SLICE_MIN_BINS
        assert all(b1 - b0 == L for b0, b1 in cut[:-1])
        assert tiles < 2 * sms * RESIDENT[route]
    else:
        assert L == bins


# ------------------------------------------------ the split arithmetic


def packed_partial(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """One slice's tile on the u16x2 route: A's values clamped and doubled
    into both lanes, C's columns clamped and paired, one min.u16x2 and one
    32-bit add a bin, the lanes split to int32 at the end."""
    a = np.minimum(a.astype(np.int32).view(np.uint32), np.uint32(LANE))
    c = np.minimum(c.astype(np.int32).view(np.uint32), np.uint32(LANE))
    S2 = c.shape[0]
    if S2 % 2:
        c = np.vstack([c, np.zeros((1, c.shape[1]), np.uint32)])
    words = c[0::2] | (c[1::2] << np.uint32(16))
    rows = a * np.uint32(0x10001)
    acc = np.zeros((a.shape[0], words.shape[0]), np.uint32)
    for b in range(a.shape[1]):
        x, y = rows[:, b : b + 1], words[None, :, b]
        lo = np.minimum(x & np.uint32(LANE), y & np.uint32(LANE))
        hi = np.minimum(x >> np.uint32(16), y >> np.uint32(16))
        acc = acc + ((hi << np.uint32(16)) | lo)
    out = np.empty((a.shape[0], 2 * words.shape[0]), np.uint32)
    out[:, 0::2] = acc & np.uint32(LANE)
    out[:, 1::2] = acc >> np.uint32(16)
    return out[:, :S2]


def wide_partial(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """One slice's tile on the i32 route: signed minima, 32-bit adds."""
    acc = np.zeros((a.shape[0], c.shape[0]), np.uint32)
    for b in range(a.shape[1]):
        m = np.minimum(a[:, b : b + 1], c[None, :, b]).astype(np.int32)
        acc = acc + m.view(np.uint32)
    return acc


def split_model(a, c, route, L, tile=None):
    """The kernels' output over bin slices of L bins: each slice's partial tile,
    unpacked to int32, added into a zeroed int32 output (mod 2^32, as
    red.global.add.s32 does). ``c`` None: K3, over the upper-triangle
    tiles of ``tile`` rows, each also added transposed into its mirror."""
    partial = packed_partial if route == PACKED else wide_partial
    sym = c is None
    c = a if sym else c
    out = np.zeros((a.shape[0], c.shape[0]), np.uint32)
    cut = slices(a.shape[1], L)
    if not sym:
        for b0, b1 in cut:
            out += partial(a[:, b0:b1], c[:, b0:b1])
        return out.view(np.int32)
    tile = tile or a.shape[0]
    starts = range(0, a.shape[0], tile)
    for i in starts:
        for j in (j for j in starts if j >= i):
            for b0, b1 in cut:
                t = partial(a[i : i + tile, b0:b1], a[j : j + tile, b0:b1])
                out[i : i + tile, j : j + tile] += t
                if j != i:
                    out[j : j + tile, i : i + tile] += t.T
    return out.view(np.int32)


def plain(a, c=None):
    return distance.min_sum_matrix(
        torch.from_numpy(a), None if c is None else torch.from_numpy(c)).numpy()


def route_of(*mats):
    return distance_cuda.product_route(
        *distance_cuda.check_counts(*(torch.from_numpy(m) for m in mats)))


@st.composite
def small_rows(draw, rows: int, B: int):
    """[rows, B] counts whose rows sum to at most 65,535 (65,535 itself
    half the time), each sum cut into B parts."""
    out = np.zeros((rows, B), np.int64)
    for r in range(rows):
        total = draw(st.one_of(st.just(LANE), st.integers(0, LANE)))
        cuts = sorted(draw(st.lists(st.integers(0, total), min_size=B - 1, max_size=B - 1)))
        out[r] = np.diff(np.array([0, *cuts, total]))
    return out.astype(np.int32)


@st.composite
def big_rows(draw, rows: int, B: int):
    """[rows, B] counts up to 2^20, row 0 all of 2^16 or more."""
    vals = draw(st.lists(st.integers(0, 1 << 20), min_size=rows * B, max_size=rows * B))
    out = np.array(vals, np.int64).reshape(rows, B)
    out[0] = np.maximum(out[0], 1 << 16)
    return out.astype(np.int32)


@st.composite
def split_case(draw):
    """Rows, partner rows, bins and a slice length L from 1 to the bins:
    slices of a few bins, so that the bins of a row's largest counts
    straddle slice edges."""
    S, S2, B = draw(st.integers(1, 7)), draw(st.integers(1, 7)), draw(st.integers(1, 12))
    return S, S2, B, draw(st.integers(1, B))


@settings(max_examples=80, deadline=None)
@given(data=st.data(), case=split_case(), tile=st.integers(1, 4))
def test_split_model_equals_plain_packed_symmetric(data, case, tile):
    S, _, B, L = case
    a = data.draw(small_rows(S, B))
    assert route_of(a) == PACKED
    got = split_model(a, None, PACKED, L, tile)
    assert np.array_equal(got, plain(a))
    for r in np.flatnonzero(a.sum(1) == LANE):
        assert got[r, r] == LANE  # a row of 65,535 over every slice's lanes


@settings(max_examples=80, deadline=None)
@given(data=st.data(), case=split_case(), swap=st.booleans())
def test_split_model_equals_plain_packed_clamped(data, case, swap):
    # one side small, the other with values of 2^16 and more (clamped)
    S, S2, B, L = case
    a, c = data.draw(small_rows(S, B)), data.draw(big_rows(S2, B))
    if swap:
        a, c = c, a
    assert route_of(a, c) == PACKED
    assert np.array_equal(split_model(a, c, PACKED, L), plain(a, c))


@settings(max_examples=80, deadline=None)
@given(data=st.data(), case=split_case(), tile=st.integers(1, 4))
def test_split_model_equals_plain_wide(data, case, tile):
    # the i32 route: signed counts, row sums up to 2^31 - 1
    S, S2, B, L = case
    vals = st.integers(-(1 << 20), (1 << 31) // 16)
    a = np.array(data.draw(st.lists(vals, min_size=S * B, max_size=S * B)),
                 np.int32).reshape(S, B)
    c = np.array(data.draw(st.lists(vals, min_size=S2 * B, max_size=S2 * B)),
                 np.int32).reshape(S2, B)
    assert np.array_equal(split_model(a, c, WIDE, L), plain(a, c))
    assert np.array_equal(split_model(a, None, WIDE, L, tile), plain(a))


def test_split_model_at_the_kernels_stage():
    # 32-bin stages, 100 bins: slices of 100, 64 and 32 bins cut 100 as
    # 100; 64 + 36; 32 x 3 + 4
    rng = np.random.default_rng(0)
    a = rng.integers(0, 700, (9, 100)).astype(np.int32)
    a[0] = 0
    a[0, :95] = 689
    a[0, 95] = LANE - 95 * 689  # row 0 sums to 65,535
    c = rng.integers(0, 1 << 17, (6, 100)).astype(np.int32)
    assert route_of(a) == PACKED and route_of(a, c) == PACKED
    assert [len(slices(100, L)) for L in (100, 64, 32)] == [1, 2, 4]
    for L in (100, 64, 32):
        assert np.array_equal(split_model(a, None, PACKED, L, tile=4), plain(a))
        assert np.array_equal(split_model(a, c, PACKED, L), plain(a, c))
        assert np.array_equal(split_model(a, c, WIDE, L), plain(a, c))


@settings(max_examples=6, deadline=None)
@given(data=st.data(), L=st.integers(1, 4))
def test_split_model_equals_pallas_kernels(data, L):
    # fixed shapes so that each JAX kernel traces once: 37 rows (tiles of
    # 16: K3's mirrors) and 11 partners, 5 bins in slices of 1-4
    a = data.draw(small_rows(37, 5))
    c = data.draw(big_rows(11, 5))
    assert route_of(a) == PACKED and route_of(a, c) == PACKED
    tri = np.asarray(distance_pallas.min_sum_matrix_pallas_tri(jnp.asarray(a), interpret=True))
    rect = np.asarray(
        distance_pallas.min_sum_matrix_pallas(jnp.asarray(a), jnp.asarray(c), interpret=True))
    assert np.array_equal(split_model(a, None, PACKED, L, 16), tri)
    assert np.array_equal(split_model(a, c, PACKED, L), rect)
    assert np.array_equal(split_model(c, a, PACKED, L), rect.T)
    wide = a.copy()
    wide[0, 0] += (1 << 16) - wide[0].sum()  # row 0 sums to 2^16: the i32 route
    assert route_of(wide) == WIDE
    tri_wide = np.asarray(
        distance_pallas.min_sum_matrix_pallas_tri(jnp.asarray(wide), interpret=True))
    assert np.array_equal(split_model(wide, None, WIDE, L, 16), tri_wide)


# --------------------------------------------------- the gates' models


def test_minplus_model_is_flat_where_the_bins_split():
    # (g) k=10's K4 panel has 4 output tiles and splits into 263 slices:
    # its predicted rate is the calibrated one, not 4 / 36 of it as by
    # tiles; so is K3's at (a)'s rows over wide bins, past the peak
    rate, rows = 1e12, distance.DENSE_RATE_ROWS
    bins = 4**10
    t = distance.minplus_time(256, 256, bins, False, rate=rate, rate_rows=rows, peak=1e11)
    assert t == pytest.approx(256 * 256 * bins / rate)
    t = distance.minplus_time(16384, 16384, bins, True, rate=rate, rate_rows=rows, peak=1e11)
    assert t == pytest.approx(16384 * 16383 / 2 * bins / rate)
    # 2,016 bins hold fewer than two slices of 1,024: the rate scales by
    # the tiles, as at 100 bins, up to the peak
    t = distance.minplus_time(256, 256, 2016, False, rate=rate, rate_rows=rows, peak=1e15)
    assert t == pytest.approx(256 * 256 * 2016 / (rate * 4 / 36))
    t = distance.minplus_time(256, 256, 2017, False, rate=rate, rate_rows=rows, peak=1e15)
    assert t == pytest.approx(256 * 256 * 2017 / rate)
    t = distance.minplus_time(16384, 16384, 64, True, rate=rate, rate_rows=rows, peak=2e12)
    assert t == pytest.approx(16384 * 16383 / 2 * 64 / 2e12)


def test_threshold_model_fills_an_sm_a_tile():
    full = distance.threshold_time(2048, 2048, 1000, 4, 1e12, H100_SMS)
    assert full == pytest.approx(2048 * 2048 * 1000 * 4 / 1e12)
    # (g) k=10's panel: 4 output tiles of the 132 SMs
    small = distance.threshold_time(256, 256, 1000, 4, 1e12, H100_SMS)
    assert small == pytest.approx(256 * 256 * 1000 * 4 / 1e12 * 132 / 4)
    assert distance.threshold_time(256, 256, 1000, 4, 1e12, 4) == pytest.approx(
        256 * 256 * 1000 * 4 / 1e12)
    # the gates pass the SMs of the rates' card (``DistanceRates.sms``)
    assert sparse_engine.DistanceRates().sms == H100_SMS
