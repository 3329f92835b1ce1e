"""The routes of K3 and K4, the (min,+) products, on the CPU.

On the card each product runs on one of two routes: ``u16x2`` packs two
outputs into one 32-bit word (C's columns as pairs c[j] | c[j+1] << 16,
A's rows as a * 0x10001, each value clamped to 0xFFFF, one ``min.u16x2``
and one 32-bit add a step, the lanes split at the store), and ``i32`` runs
on 32-bit lanes. The wrapper picks ``u16x2`` only where that is exact: no
count is negative and the smaller side's largest row sum is below 2^16.

Here: the route gate as a pure function of the row sums; a NumPy model of
the packed arithmetic held exactly to the plain version
(``ops/distance.min_sum_matrix``) and to the JAX package's Pallas kernels
in interpret mode, on counts drawn so that lane sums reach exactly 65,535
and the clamped side holds values of 2^16 and more; and the model's
failures where the gate says ``i32``, which show what the gate guards.
The tolerance is zero: integers are compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dna_kmeres_parallel_tpu.ops import distance_pallas
from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda

PACKED, WIDE = distance_cuda.PACKED, distance_cuda.WIDE
LANE = 0xFFFF


def packed_model(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The u16x2 route's arithmetic in NumPy: int32 [S, B] x [S2, B] ->
    int32 [S, S2], with every step on uint32 words as the kernel takes it."""
    a = np.minimum(a.astype(np.int32).view(np.uint32), np.uint32(LANE))
    c = np.minimum(c.astype(np.int32).view(np.uint32), np.uint32(LANE))
    S, B = a.shape
    S2 = c.shape[0]
    if S2 % 2:
        c = np.vstack([c, np.zeros((1, B), np.uint32)])
    words = c[0::2] | (c[1::2] << np.uint32(16))  # [S2 / 2, B] column pairs
    rows = a * np.uint32(0x10001)  # [S, B], the value in both lanes
    acc = np.zeros((S, words.shape[0]), np.uint32)
    for b in range(B):
        x, y = rows[:, b : b + 1], words[None, :, b]
        lo = np.minimum(x & np.uint32(LANE), y & np.uint32(LANE))
        hi = np.minimum(x >> np.uint32(16), y >> np.uint32(16))
        acc = acc + ((hi << np.uint32(16)) | lo)  # one 32-bit add, mod 2^32
    out = np.empty((S, 2 * words.shape[0]), np.int32)
    out[:, 0::2] = acc & np.uint32(LANE)
    out[:, 1::2] = acc >> np.uint32(16)
    return out[:, :S2]


def plain(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    return distance.min_sum_matrix(torch.from_numpy(a), torch.from_numpy(c)).numpy()


def route_of(*mats: np.ndarray) -> str:
    return distance_cuda.product_route(
        *distance_cuda.check_counts(*(torch.from_numpy(m) for m in mats))
    )


# -------------------------------------------------------------- the gate


@pytest.mark.parametrize(
    "bounds,route",
    [
        ((65535,), PACKED),
        ((65536,), WIDE),
        ((0,), PACKED),
        ((65535, 65535), PACKED),
        ((65536, 65536), WIDE),
        ((65536, 5), PACKED),
        ((5, 65536), PACKED),
        ((65535, (1 << 31) - 1), PACKED),
        ((None, 3), WIDE),
        ((3, None), WIDE),
        ((None,), WIDE),
        ((), WIDE),
    ],
)
def test_route_gate(bounds, route):
    assert distance_cuda.product_route(*bounds) == route


@pytest.mark.parametrize(
    "rows,want",
    [
        ([[65535]], 65535),
        ([[65536]], 65536),
        ([[40000, 25535], [1, 2]], 65535),
        ([[3, -1], [0, 0]], None),
        (np.zeros((0, 4), np.int32), 0),
    ],
)
def test_check_counts_returns_the_largest_row_sum(rows, want):
    m = torch.as_tensor(np.asarray(rows, np.int32))
    assert distance_cuda.check_counts(m) == [want]


def test_route_of_counts():
    small = np.array([[65535, 0], [7, 9]], np.int32)
    wide = np.array([[65535, 1], [7, 9]], np.int32)
    big = np.array([[1 << 20, 1 << 16], [70000, 0]], np.int32)
    assert route_of(small) == PACKED
    assert route_of(wide) == WIDE
    assert route_of(small, big) == PACKED
    assert route_of(big, small) == PACKED
    assert route_of(wide, big) == WIDE
    assert route_of(np.zeros((0, 2), np.int32), big) == PACKED
    assert route_of(small, -small) == WIDE


# --------------------------------------------- the packed arithmetic model


@st.composite
def small_rows(draw, rows: int, B: int):
    """[rows, B] counts whose rows sum to at most 65,535; each row's sum is
    drawn (65,535 itself half the time) and cut into B parts."""
    out = np.zeros((rows, B), np.int64)
    for r in range(rows):
        total = draw(st.one_of(st.just(LANE), st.integers(0, LANE)))
        cuts = sorted(draw(st.lists(st.integers(0, total), min_size=B - 1, max_size=B - 1)))
        out[r] = np.diff(np.array([0, *cuts, total]))
    return out.astype(np.int32)


@st.composite
def big_rows(draw, rows: int, B: int):
    """[rows, B] counts up to 2^20, row 0 all of 2^16 or more (a small row
    then meets it in every bin: its lane sum is the small row's sum)."""
    vals = draw(st.lists(st.integers(0, 1 << 20), min_size=rows * B, max_size=rows * B))
    out = np.array(vals, np.int64).reshape(rows, B)
    out[0] = np.maximum(out[0], 1 << 16)
    return out.astype(np.int32)


@st.composite
def shapes(draw):
    return draw(st.integers(1, 6)), draw(st.integers(1, 7)), draw(st.integers(1, 5))


@settings(max_examples=60, deadline=None)
@given(data=st.data(), shape=shapes())
def test_packed_model_equals_plain_symmetric(data, shape):
    S, _, B = shape
    a = data.draw(small_rows(S, B))
    assert route_of(a) == PACKED
    got = packed_model(a, a)
    assert np.array_equal(got, plain(a, a))
    # A row summing to 65,535 fills its own lane exactly.
    for r in np.flatnonzero(a.sum(1) == LANE):
        assert got[r, r] == LANE


@settings(max_examples=60, deadline=None)
@given(data=st.data(), shape=shapes(), swap=st.booleans())
def test_packed_model_equals_plain_clamped(data, shape, swap):
    # One side small, the other with values of 2^16 and more: clamped.
    S, S2, B = shape
    a = data.draw(small_rows(S, B))
    c = data.draw(big_rows(S2, B))
    if swap:
        a, c = c, a
    assert route_of(a, c) == PACKED
    got = packed_model(a, c)
    assert np.array_equal(got, plain(a, c))
    small = c if swap else a
    lanes = got[0] if swap else got[:, 0]
    assert np.array_equal(lanes, small.sum(1))  # big row 0 meets every bin


@settings(max_examples=8, deadline=None)
@given(data=st.data())
def test_packed_model_equals_pallas_kernels(data):
    # Fixed shapes, so that each JAX kernel traces once: 37 rows and 11
    # partners (no tile multiple), 5 bins.
    a = data.draw(small_rows(37, 5))
    c = data.draw(big_rows(11, 5))
    assert route_of(a) == PACKED and route_of(a, c) == PACKED
    tri = np.asarray(distance_pallas.min_sum_matrix_pallas_tri(jnp.asarray(a), interpret=True))
    rect = np.asarray(
        distance_pallas.min_sum_matrix_pallas(jnp.asarray(a), jnp.asarray(c), interpret=True)
    )
    assert np.array_equal(packed_model(a, a), tri)
    assert np.array_equal(packed_model(a, c), rect)
    assert np.array_equal(packed_model(c, a), rect.T)


@pytest.mark.parametrize(
    "a,c",
    [
        # A lane sum of 65,536 carries into the next column's lane.
        (np.array([[40000, 25536]], np.int32), np.array([[40000, 25536], [0, 0]], np.int32)),
        # A count of 65,536 on both sides is clamped to 65,535.
        (np.array([[65536]], np.int32), np.array([[65536]], np.int32)),
        # A negative count is clamped to 65,535 as an unsigned value.
        (np.array([[5]], np.int32), np.array([[-1]], np.int32)),
    ],
)
def test_packed_model_is_wrong_where_the_gate_says_i32(a, c):
    assert route_of(a, c) == WIDE
    assert not np.array_equal(packed_model(a, c), plain(a, c))
