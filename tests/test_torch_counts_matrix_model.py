"""K2's and P1's index arithmetic, modelled in NumPy thread by thread.

K2 (``csrc/counts_matrix.cu``): the grid read as aligned 16-byte chunks of
one stream that starts ``mis`` bytes past an aligned address, bytes
outside the grid read as 0xFF; each lane's chunk and the next as its halo;
a chunk of 16 bytes of 0xFF skipped; the bytes turned into digits and
validity bits (``digits4``, ``valid4``) and each run of 16 window starts
counted by ``count16``'s funnel shifts, only the starts that lie in the
row; rows cut into parts (the plan of ``plan_parts``) whose counts add
into one output; the block route's 16-bit halves; above 65,536 bins the
global route, every window added at row * bins + code of an output
zeroed first. The model is held
against ``histogram_cuda.counts_matrix_reference`` and against the JAX
package's ``_counts_matrix_batch`` (its Pallas kernel in interpret mode,
up to the 1,024 bins it serves).

P1 (``csrc/owner_segments.cu``): the shift reduced once per row with C's
truncating ``%`` and each word's source index with its wrap, against
``np.roll``.

The CUDA kernels themselves are held against the same plain versions on
the card in test_torch_cuda.py. Integer counts: every comparison is exact
(tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.models.engine import _counts_matrix_batch
from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda, sort_cuda

M32 = np.uint64(0xFFFFFFFF)
#: the kernel's constants (counts_matrix.cu)
WARP_MAX_BINS = 4096
BLOCK_THREADS = 512
MAX_PART_CHUNKS = 4095
MIN_WARP_PART = 256
MAX_SHARED_BINS = 1 << 16  # the global route above
H100_SMS = 132


def u64(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64)


# --------------------------------------------------------------- K2 model


def digits4(w) -> np.ndarray:
    """windows.cuh digits4: the low 2 bits of each byte of w, byte i at bits 2i."""
    return ((u64(w) & np.uint64(0x03030303)) * np.uint64(0x01041040) & M32) >> np.uint64(24)


def valid4(w) -> np.ndarray:
    """windows.cuh valid4: bit i set where byte i of w is below 4."""
    w = u64(w)
    eq = np.zeros_like(w)
    for i in range(4):
        byte_ok = ((w >> np.uint64(8 * i)) & np.uint64(0xFC)) == 0
        eq |= byte_ok.astype(np.uint64) << np.uint64(8 * i)
    return (eq * np.uint64(0x01020408) & M32) >> np.uint64(24)


def digit_rev32(x) -> np.ndarray:
    x = u64(x)
    out = np.zeros_like(x)
    for j in range(16):
        out |= ((x >> np.uint64(2 * j)) & np.uint64(3)) << np.uint64(30 - 2 * j)
    return out


def fsl(lo, hi, s: int) -> np.ndarray:
    """__funnelshift_l: the high word of (hi:lo) << s, 0 <= s < 32."""
    if s == 0:
        return u64(hi)
    return ((u64(hi) << np.uint64(s)) | (u64(lo) >> np.uint64(32 - s))) & M32


def fsr(lo, hi, s: int) -> np.ndarray:
    """__funnelshift_r: the low word of (hi:lo) >> s, 0 <= s < 32."""
    return ((u64(hi) << np.uint64(32) | u64(lo)) >> np.uint64(s)) & M32


def count16(d, v, first, limit: int, k: int, bins: int, canonical: bool) -> np.ndarray:
    """windows.cuh count16 for every lane at once: the keys its add() takes."""
    room = limit - first
    hi = np.clip(room, 0, 16).astype(np.uint64)
    lo = np.where(first < 0, -first, 0).astype(np.uint64)
    one = np.uint64(1)
    wv = u64(v)
    for t in range(1, k):
        wv &= u64(v) >> np.uint64(t)
    wv &= ((one << hi) - one) & ~((one << lo) - one)
    dlo, dhi = u64(d) & M32, u64(d) >> np.uint64(32)
    rhi, rlo = digit_rev32(dlo), digit_rev32(dhi)
    sh = np.uint64(32 - 2 * k)
    mask = np.uint64((1 << (2 * k)) - 1)
    keys = []
    for j in range(16):
        key = fsl(rlo, rhi, 2 * j) >> sh
        if canonical:
            key = np.minimum(key, ~fsr(dlo, dhi, 2 * j) & mask)
        take = ((wv >> np.uint64(j)) & one).astype(bool) & (key < np.uint64(bins))
        keys.append(key[take])
    return np.concatenate(keys).astype(np.int64)


def plan_parts(S: int, span: int, fill: int, least: int, most: int) -> tuple[int, int]:
    """counts_matrix.cu plan_parts: (parts a row, chunks a part)."""
    p = 1 if S >= fill else -(-fill // S)
    p = max(p, -(-span // most))
    q = min(max(-(-span // p), least), most)
    return -(-span // q), q


def span_of(L: int, k: int) -> int:
    """The most chunks a row's window starts touch."""
    return ((L - k) >> 4) + 2 if L >= k else 1


def plan(S: int, L: int, k: int, bins: int, sms: int = H100_SMS) -> tuple[int, int]:
    """The entry's plan: the warp route up to 4,096 bins and the global
    route above 65,536 (both a warp an item), else the block route."""
    if bins <= WARP_MAX_BINS or bins > MAX_SHARED_BINS:
        return plan_parts(S, span_of(L, k), 64 * sms, MIN_WARP_PART, 1 << 62)
    return plan_parts(S, span_of(L, k), 2 * sms, BLOCK_THREADS, MAX_PART_CHUNKS)


def aligned_stream(grid: np.ndarray, mis: int) -> np.ndarray:
    """The aligned bytes the kernel reads: the grid starts at byte mis, and
    every byte outside [mis, mis + S*L) reads as 0xFF (stream_chunk)."""
    end = grid.size + mis
    ab = np.full(16 * (-(-end // 16) + 2), 0xFF, np.uint8)
    ab[mis:end] = grid.reshape(-1)
    return ab


def model_counts(grid: np.ndarray, k: int, bins: int, canonical: bool, mis: int = 0,
                 parts: int | None = None, per: int | None = None, stats: dict | None = None):
    """What kp_counts_matrix computes, lane by lane: int32 [S, bins]."""
    S, L = grid.shape
    if parts is None:
        parts, per = plan(S, L, k, bins)
    glob = bins > MAX_SHARED_BINS
    warp = bins <= WARP_MAX_BINS or glob
    lanes = 32 if warp else BLOCK_THREADS
    ab = aligned_stream(grid, mis)
    words = ab.view("<u4").astype(np.uint64).reshape(-1, 4)  # chunk c: words[c]
    limit = L - k + 1
    out = np.zeros((S, bins), np.int64)
    flat = out.reshape(-1)  # the global route's adds: row * bins + code
    counted = skipped = 0
    for item in range(S * parts):
        row, part = divmod(item, parts)
        row_lo = row * L + mis
        if L < k:
            c0 = c1 = 0
        else:
            c0 = (row_lo >> 4) + part * per
            c1 = min(c0 + per, ((row_lo + L - k) >> 4) + 1)
        if warp:
            hist = np.zeros(bins, np.int64)
        else:
            halves = np.zeros(((bins + 1) // 2 + 3) & ~3, np.uint32)
        for step in range(c0, c1, lanes):
            c = step + np.arange(lanes)
            c = c[c < c1]  # lanes past the item load for the halo only
            cur, nxt = words[c], words[c + 1]  # the halo: the next lane's load
            full = np.bitwise_and.reduce(cur, axis=1) == M32
            skipped += int(full.sum())
            c, cur, nxt = c[~full], cur[~full], nxt[~full]
            counted += c.size
            w = np.concatenate([cur, nxt], axis=1)
            d = np.zeros(c.size, np.uint64)
            v = np.zeros(c.size, np.uint64)
            for i in range(8):
                d |= digits4(w[:, i]) << np.uint64(8 * i)
                v |= valid4(w[:, i]) << np.uint64(4 * i)
            keys = count16(d, v, 16 * c - row_lo, limit, k, bins, canonical)
            if glob:
                np.add.at(flat, row * bins + keys, 1)
            elif warp:
                np.add.at(hist, keys, 1)
            else:
                add = np.where(keys & 1, 1 << 16, 1).astype(np.uint32)
                np.add.at(halves, keys >> 1, add)  # wraps as the card's u32 does
        if glob:
            continue
        if not warp:
            widened = np.stack([halves & 0xFFFF, halves >> 16], axis=1).reshape(-1)
            hist = widened[:bins].astype(np.int64)
        if parts == 1:
            out[row] = hist
        else:
            out[row] += hist
    if stats is not None:
        stats.update(counted=counted, skipped=skipped)
    return out.astype(np.int32)


def edge_grid(S: int, L: int, seed: int) -> np.ndarray:
    """S rows of L bases: 3% N, one row all 0xFF, rows padded with 0xFF
    past a random length, and invalid bytes other than 0xFF."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, (S, L)).astype(np.uint8)
    g[rng.random((S, L)) < 0.03] = 0xFF
    for r, n in enumerate(rng.integers(0, L + 1, S)):
        if r % 3 == 2:
            g[r, n:] = 0xFF
    g[rng.random((S, L)) < 0.002] = rng.choice(np.array([4, 0x80, 0xFE], np.uint8))
    if S > 1:
        g[1] = 0xFF
    return g


def plain(grid: np.ndarray, k: int, bins: int, canonical: bool) -> np.ndarray:
    return histogram_cuda.counts_matrix_reference(
        torch.from_numpy(grid), k, bins, canonical).numpy()


KS = (1, 2, 3, 4, 5, 6, 7, 8, 10)
CASES = [(k, L) for k in KS for L in sorted({0, 1, k - 1, 15, 16, 17, 31, 33, 2000, 2001})]


def bins_of(k: int) -> int:
    return min(4**k, 1 << 16)  # k=10 keeps the codes below 65,536


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,L", CASES)
def test_model_matches_plain_and_jax(k, L, canonical):
    bins = bins_of(k)
    grid = edge_grid(6, L, 100 * k + L)
    want = plain(grid, k, bins, canonical)
    for mis in (0, 7):
        got = model_counts(grid, k, bins, canonical, mis)
        assert got.shape == (6, bins)
        assert np.array_equal(got, want), f"mis={mis}"
    if bins <= 1024 and L > 0:
        ref = np.asarray(_counts_matrix_batch(jnp.asarray(grid), k, bins, canonical, "interpret"))
        assert np.array_equal(want, ref)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,bins", [(2, 16), (3, 64), (4, 256), (6, 4096), (7, 4097), (8, 65536)])
@pytest.mark.parametrize("per", [1, 2, 3, 31, 33, 256])
def test_split_rows_combine(k, bins, per, canonical):
    """A row cut into parts of any chunk count, at any alignment, adds up
    to the whole row's counts."""
    grid = edge_grid(2, 3001, per * 11 + k)
    want = plain(grid, k, bins, canonical)
    for mis in (0, 3, 15):
        parts = -(-span_of(3001, k) // per)
        got = model_counts(grid, k, bins, canonical, mis, parts=parts, per=per)
        assert np.array_equal(got, want), f"mis={mis}"


def test_plan_splits_few_or_long_rows_and_caps_the_halves():
    # The distance path's shapes: one item a row.
    assert plan(16384, 2000, 3, 64) == (1, 256)
    assert plan(54018, 2000, 3, 64)[0] == 1
    assert plan(2048, 2000, 8, 65536) == (1, 512)
    # A few long rows: split until the card is full or a part is down to
    # 8 chunks a lane.
    assert plan(8, 4_000_000, 3, 64) == (977, MIN_WARP_PART)
    assert plan(2, 40_000, 3, 64) == (10, MIN_WARP_PART)
    # The block route: no item past 4,095 chunks (65,520 starts < 2^16),
    # however many rows there are.
    for S, L in ((8, 4_000_000), (100_000, 70_000), (1, 65_600)):
        parts, per = plan(S, L, 8, 65536)
        assert per <= MAX_PART_CHUNKS and 16 * per < 1 << 16
        assert parts * per >= span_of(L, 8)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,bins", [(9, 4**9), (10, 4**10), (11, 70_000), (12, 4**12)])
@pytest.mark.parametrize("L", [0, 8, 15, 17, 33, 2001])
def test_global_route_model_matches_plain(k, bins, L, canonical):
    """Above 65,536 bins: a warp an item as in the warp route, each window
    added at row * bins + code; codes past ``bins`` dropped."""
    grid = edge_grid(5, L, 7 * k + L)
    want = plain(grid, k, bins, canonical)
    for mis in (0, 9):
        assert np.array_equal(model_counts(grid, k, bins, canonical, mis), want), f"mis={mis}"


@pytest.mark.parametrize("per", [1, 5, 256])
def test_global_route_split_rows_combine(per):
    grid = edge_grid(3, 3001, per)
    want = plain(grid, 9, 4**9, True)
    parts = -(-span_of(3001, 9) // per)
    assert np.array_equal(model_counts(grid, 9, 4**9, True, 5, parts=parts, per=per), want)
    # The plan: the warp route's, with no cap on a part.
    assert plan(1024, 2000, 9, 4**9) == (1, MIN_WARP_PART)
    assert plan(8, 4_000_000, 9, 4**9) == (977, MIN_WARP_PART)
    assert plan(100_000, 70_000, 10, 4**10) == (1, span_of(70_000, 10))


def test_halves_hold_a_part_of_one_code():
    """A part of 4,095 chunks of one base: 65,520 windows of one code stay
    inside their 16-bit half."""
    grid = np.zeros((1, 16 * MAX_PART_CHUNKS + 7), np.uint8)
    got = model_counts(grid, 8, 65536, False, parts=2, per=MAX_PART_CHUNKS)
    assert got[0, 0] == 16 * MAX_PART_CHUNKS
    assert np.array_equal(got, plain(grid, 8, 65536, False))


def test_padding_chunks_are_skipped():
    grid = np.full((4, 2000), 0xFF, np.uint8)
    grid[:, :1000] = np.random.default_rng(5).integers(0, 4, (4, 1000))
    grid[3, :] = 0x80  # invalid, but not the padding byte: counted as chunks of no window
    stats: dict = {}
    got = model_counts(grid, 3, 64, True, stats=stats)
    assert np.array_equal(got, plain(grid, 3, 64, True))
    # Rows 0-2: 1000 bases fill 62.5 chunks; the other 62 chunks are skipped.
    assert stats == {"counted": 3 * 63 + 125, "skipped": 3 * 62}


def test_window_core_bit_tricks_on_every_byte():
    b = np.arange(256, dtype=np.uint64)
    for i in range(4):
        w = b << np.uint64(8 * i)
        assert np.array_equal(digits4(w) >> np.uint64(2 * i), b & np.uint64(3))
        assert np.array_equal(valid4(w) >> np.uint64(i) & np.uint64(1), (b < 4).astype(np.uint64))


# --------------------------------------------------------------- P1 model


def c_rem(a: int, b: int) -> int:
    """C's int % (truncating toward zero)."""
    r = abs(a) % b
    return -r if a < 0 else r


def model_roll(x: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """What kp_row_roll computes: a lane reads word c of a row from
    (c + shift) mod W, with the shift reduced once by C's % and the wrap
    taken by one compare against W - shift."""
    R, W = x.shape
    out = np.empty_like(x)
    for r in range(R):
        s = c_rem(int(shifts[r]), W)
        back = W - (s + W if s < 0 else s)
        assert 1 <= back <= W
        c = np.arange(W)
        src = np.where(c < back, c + W - back, c - back)
        assert src.min() >= 0 and src.max() < W
        out[r] = x[r, src]
    return out


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 8, 255, 256, 2048, 2049])
def test_roll_model_matches_np_roll(W):
    rng = np.random.default_rng(W)
    R = 40
    x = rng.integers(-(2**31), 2**31, (R, W)).astype(np.int32)
    shifts = rng.integers(-3 * W, 3 * W, R).astype(np.int32)
    shifts[:6] = [-(2**31), 2**31 - 1, 0, W, -W, 1 - W]
    want = np.stack([np.roll(x[r], -int(shifts[r])) for r in range(R)])
    assert np.array_equal(model_roll(x, shifts), want)
    ref = sort_cuda.row_roll_reference(torch.from_numpy(x), torch.from_numpy(shifts))
    assert np.array_equal(ref.numpy(), want)
