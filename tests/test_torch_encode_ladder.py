"""K1 and K1m's window plan, modelled in NumPy thread by thread: what
``csrc/encode_packed.cu`` computes for the 16 window starts of one plane
word (the 96-bit digit stream of three words, codes as funnel shifts of
one pre-shifted stream, validity from a doubling ladder of runs, and the
minimizers from a sparse-table ladder of window minima with one combine),
held against the plain versions ``encode_cuda.encode_packed_reference``
and ``encode_cuda.minimizers_reference``. The CUDA kernel itself is held
against the same plain versions on the card in test_torch_cuda.py.

Integer codes: every comparison is exact (tolerance zero)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_minimizer import make_stream

from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.ops import encode_cuda
from dna_kmeres_parallel_tpu_torch.utils import codec

U32 = np.uint64(0xFFFFFFFF)
#: m-mer positions a thread's windows reach (the kernel's kPos)
POS = 46
#: (window length L, its ladder levels' strides, the combine offset)
LADDER = {L: (tuple(d for d in (1, 2, 4, 8) if 2 * d <= L), L - (1 << (L.bit_length() - 1)))
          for L in range(2, 32)}


def u64(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64)


def fsr(lo, hi, s: int) -> np.ndarray:
    """__funnelshift_r: the low word of (hi:lo) >> (s & 31)."""
    return ((u64(hi) << np.uint64(32) | u64(lo)) >> np.uint64(s & 31)) & U32


def fsrc(lo, hi, s: int) -> np.ndarray:
    """__funnelshift_rc: the low word of (hi:lo) >> min(s, 32)."""
    return ((u64(hi) << np.uint64(32) | u64(lo)) >> np.uint64(min(s, 32))) & U32


def digit_rev32(x) -> np.ndarray:
    x = u64(x)
    out = np.zeros_like(x)
    for j in range(16):
        out |= ((x >> np.uint64(2 * j)) & np.uint64(3)) << np.uint64(30 - 2 * j)
    return out


def valid16(inval_be) -> np.ndarray:
    x = digit_rev32(inval_be)
    out = np.zeros_like(x)
    for j in range(16):
        out |= (((x >> np.uint64(2 * j)) & np.uint64(3)) == 0).astype(np.uint64) << np.uint64(j)
    return out


def runs_of(v: np.ndarray, k: int) -> np.ndarray:
    """The kernel's doubling ladder of runs: bit i where bits [i, i+k) of
    v are set."""
    length = 1
    while 2 * length <= k:
        v = v & (v >> np.uint64(length))
        length *= 2
    return v & (v >> np.uint64(k - length))


def window_minima(x2, x1, x0, m: int, L: int) -> np.ndarray:
    """The kernel's window_minima for every thread at once: [n, 16]."""
    pair = (x2, x1, x0, np.zeros_like(x0))
    sh = 34 - 2 * m
    mmask = np.uint64((1 << (2 * m)) - 1)
    M = np.zeros((x0.size, POS), np.uint64)
    for g in range(3):
        qlo, qhi = fsrc(pair[g + 1], pair[g], sh), fsrc(pair[g], 0, sh)
        for q in range(16):
            if 16 * g + q < POS:
                M[:, 16 * g + q] = fsr(qlo, qhi, 30 - 2 * q) & mmask
    strides, offset = LADDER[L]
    for d in strides:
        # M[i] = min(M[i], M[i + d]) for i <= POS - 2d, every read of the
        # level below (the kernel's ascending in-place order)
        n = POS - 2 * d + 1
        M[:, :n] = np.minimum(M[:, :n], M[:, d : d + n])
    return np.minimum(M[:, :16], M[:, offset : offset + 16])


def kernel_model(words_le, inval_be, n_own: int, k: int, canonical: bool, m: int | None):
    """(hi, lo[, mins]) as the kernel's threads compute and store them, in
    the plain version's dtypes."""
    wl = np.concatenate([u64(words_le.numpy().view(np.uint32)), np.zeros(2, np.uint64)])
    nw = words_le.shape[0]
    ivv = np.concatenate([valid16(inval_be.numpy().view(np.uint32)), np.zeros(2, np.uint64)])
    w = np.arange(nw)
    a, b, c = wl[w], wl[w + 1], wl[w + 2]
    v = ivv[w] | ivv[w + 1] << np.uint64(16) | ivv[w + 2] << np.uint64(32)
    room = n_own - 16 * w
    own = np.where(room >= 16, 0xFFFF, (1 << np.clip(room, 0, 16)) - 1).astype(np.uint64)
    valid = runs_of(v, k) & own
    ok = ((valid[:, None] >> np.arange(16, dtype=np.uint64)) & np.uint64(1)).astype(bool)
    x2, x1, x0 = digit_rev32(a), digit_rev32(b), digit_rev32(c)

    s = 66 - 2 * k
    y2, y1, y0 = (np.zeros_like(x2), x2, x1) if s >= 32 else (x2, x1, x0)
    s = s - 32 if s >= 32 else s
    z0, z1, z2 = fsrc(y0, y1, s), fsrc(y1, y2, s), fsrc(y2, 0, s)
    mask = U32 if k > 15 else np.uint64((1 << (2 * k)) - 1)
    hmask = np.uint64((1 << (2 * k - 32)) - 1) if k > 15 else np.uint64(0)
    lo = np.empty((nw, 16), np.uint64)
    hi = np.empty((nw, 16), np.uint64)
    for j in range(16):
        fl, fh = fsr(z0, z1, 30 - 2 * j) & mask, fsr(z1, z2, 30 - 2 * j) & hmask
        if canonical:
            rl, rh = fsr(~a & U32, ~b & U32, 2 * j) & mask, fsr(~b & U32, ~c & U32, 2 * j) & hmask
            take = (rh < fh) | ((rh == fh) & (rl < fl))
            fl, fh = np.where(take, rl, fl), np.where(take, rh, fh)
        lo[:, j] = np.where(ok[:, j], fl, U32)
        hi[:, j] = np.where(ok[:, j], fh, U32)
    lo_t = torch.from_numpy(lo.reshape(-1).astype(np.uint32).view(np.int32).copy())
    hi_t = None
    if k > 23:
        hi_t = torch.from_numpy(hi.reshape(-1).astype(np.uint32).view(np.int32).copy())
    elif k > 15:
        hi_t = torch.from_numpy((hi.reshape(-1) & np.uint64(0xFFFF)).astype(np.uint16)
                                .view(np.int16).copy())
    if m is None:
        return hi_t, lo_t
    r = window_minima(x2, x1, x0, m, k - m + 1)
    mins = np.where(ok, r, np.uint64(encode_cuda.MIN_SENTINEL)).reshape(-1).astype(np.int32)
    return hi_t, lo_t, torch.from_numpy(mins)


def planes_of(bases: np.ndarray):
    return engine.stage_batch_planes(bases, torch.device("cpu"))


def assert_same(got, want):
    for g, r in zip(got, want, strict=True):
        if r is None:
            assert g is None
        else:
            assert g.dtype == r.dtype and torch.equal(g, r)


def stream_of(kind: str, seed: int) -> np.ndarray:
    """The minimizer tests' mixed stream (all-A, all-T and N runs), or one
    of its kinds alone: all A, all T, N-rich (30% N), random (no N)."""
    b = make_stream(seed)
    if kind == "all-A":
        b[:] = 0
    elif kind == "all-T":
        b[:] = 3
    elif kind == "N-rich":
        b[np.random.default_rng(seed).random(b.size) < 0.3] = codec.INVALID_BASE
    elif kind == "random":
        b = np.random.default_rng(seed).integers(0, 4, b.size).astype(np.uint8)
    return b


def k_m_of(L: int) -> tuple[int, int]:
    """A (k, m) with window length L = k - m + 1: k as large as m < 16
    allows, so that every hi width is reached across L."""
    k = min(31, L + 14)
    return k, k - L + 1


KINDS = ["mixed", "all-A", "all-T", "N-rich", "random"]


def test_ladder_levels_and_offsets():
    # A level a power of two at most half of L, the combine's window
    # [o, o + s) ending at L: the two halves cover the window exactly.
    for L, (strides, o) in LADDER.items():
        s = 2 * strides[-1]
        assert s <= L < 2 * s and 0 <= o < s and o + s == L
        assert 15 + o <= POS - s  # M[j + o], j < 16, lies where level s is defined


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("L", range(2, 32))
def test_ladder_minima_match_reference(L, kind):
    k, m = k_m_of(L)
    bases = stream_of(kind, L)
    n = bases.size
    planes = planes_of(bases)
    got = kernel_model(*planes, n, k, False, m)
    hi, lo = encode_cuda._encode_bases_reference(torch.from_numpy(bases), n, k, False)
    want = encode_cuda.minimizers_reference(torch.from_numpy(bases), hi, lo, k, m)
    assert torch.equal(got[2], want)
    if kind != "N-rich":
        assert int((want != encode_cuda.MIN_SENTINEL).sum()) > 0


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", range(1, 32))
def test_kernel_model_words_match_plain(k, canonical):
    planes = planes_of(make_stream(100 + k))
    n_own = 2048 - 333
    assert_same(kernel_model(*planes, n_own, k, canonical, None),
                encode_cuda.encode_packed_reference(*planes, n_own, k, canonical))


@pytest.mark.parametrize("n_own", [0, 1, 15, 16, 17, 1023, 1024, 1025, 2048, 10**9, -5])
@pytest.mark.parametrize("k,m", [(31, 7), (16, 15), (13, 1), (24, 9)])
def test_kernel_model_n_own_edges(k, m, n_own):
    planes = planes_of(make_stream(k * m))
    for canonical in (False, True):
        assert_same(kernel_model(*planes, n_own, k, canonical, m),
                    encode_cuda.encode_packed_reference(*planes, n_own, k, canonical,
                                                        minimizer_m=m))


@pytest.mark.parametrize("n_words", [1, 2, 3])
@pytest.mark.parametrize("k,m", [(1, None), (5, 2), (16, 7), (21, 11), (31, 7), (31, 1)])
def test_kernel_model_short_planes(n_words, k, m):
    # One to three words: every window that runs past the planes is invalid.
    bases = np.random.default_rng(n_words * 31 + k).integers(0, 4, 16 * n_words)
    planes = planes_of(bases.astype(np.uint8))
    for canonical in (False, True):
        assert_same(kernel_model(*planes, 10**9, k, canonical, m),
                    encode_cuda.encode_packed_reference(*planes, 10**9, k, canonical,
                                                        minimizer_m=m))


@settings(max_examples=60, deadline=None)
@given(data=st.data(), kind=st.sampled_from(KINDS), seed=st.integers(0, 2**16),
       canonical=st.booleans())
def test_kernel_model_any_k_m(data, kind, seed, canonical):
    k = data.draw(st.integers(2, 31), label="k")
    m = data.draw(st.integers(1, min(k, 16) - 1), label="m")
    n_own = data.draw(st.integers(0, 2100), label="n_own")
    planes = planes_of(stream_of(kind, seed))
    assert_same(kernel_model(*planes, n_own, k, canonical, m),
                encode_cuda.encode_packed_reference(*planes, n_own, k, canonical,
                                                    minimizer_m=m))


def swizzle(c: int) -> int:
    return c ^ ((c >> 3) & 7)


@pytest.mark.parametrize("chunks", [4, 2])
def test_store_stage_is_a_conflict_free_permutation(chunks):
    # The warp's span of 32 * chunks 16-byte chunks: lane l writes chunks
    # chunks*l + q, then reads chunks 32*i + l. Each slot is used once, and
    # in every quarter warp (the 8 lanes a 16-byte access serves at once)
    # the 8 slots fall in 8 different 16-byte bank groups.
    n = 32 * chunks
    assert sorted(swizzle(c) for c in range(n)) == list(range(n))
    for quarter in range(4):
        lanes = range(8 * quarter, 8 * quarter + 8)
        for q in range(chunks):
            assert len({swizzle(chunks * lane + q) % 8 for lane in lanes}) == 8
        for i in range(chunks):
            assert len({swizzle(32 * i + lane) % 8 for lane in lanes}) == 8
