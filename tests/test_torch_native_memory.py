"""The port's host library keeps freed memory in the C library's heap
(``native.keep_freed_memory``), so its compactor and merge write into
uncleared, reused blocks: they must still give exact tables. Each case
first dirties the heap with a freed block of all-ones bytes."""

import ctypes

import numpy as np
import pytest

from dna_kmeres_parallel_tpu_torch import native

MB = 1 << 20


class MallInfo2(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks",
        "uordblks", "fordblks", "keepcost")]


def heap() -> MallInfo2:
    """glibc's account of the heap: ``hblks`` blocks mapped on their own,
    ``fordblks`` free bytes it holds."""
    mallinfo2 = ctypes.CDLL(None).mallinfo2
    mallinfo2.restype = MallInfo2
    return mallinfo2()


def dirty_heap(nbytes: int = 64 * MB) -> None:
    """Fill a block with all-ones bytes and free it: the next blocks of
    that size come back holding them."""
    a = np.empty(nbytes, np.uint8)
    a.fill(0xFF)
    del a


def test_loading_the_library_keeps_freed_memory():
    native.load()
    assert native.keep_freed_memory() is True
    mapped = heap().hblks
    a = np.empty(64 * MB, np.uint8)
    a.fill(1)
    assert heap().hblks == mapped  # served from the heap, not mapped alone
    del a
    assert heap().fordblks >= 64 * MB  # kept for the next block, not returned


def reference_table(codes: np.ndarray, kbits: int):
    valid = codes[codes < (np.uint64(1) << np.uint64(kbits))]
    return np.unique(valid, return_counts=True)


@pytest.mark.parametrize("k, hi_dtype", [(13, None), (21, np.uint16), (31, np.uint32)])
def test_compaction_into_reused_memory_is_exact(k, hi_dtype):
    rng = np.random.default_rng(k)
    n = 3 * MB
    # keys repeat: 200,000 distinct codes over 3 M words, a tenth sentinels
    pool = rng.integers(0, 1 << (2 * k), 200_000, dtype=np.uint64)
    codes = pool[rng.integers(0, pool.size, n)]
    codes[rng.random(n) < 0.1] = np.uint64((1 << 64) - 1)
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words = (lo,) if hi_dtype is None else ((codes >> np.uint64(32)).astype(hi_dtype), lo)
    native.load()
    dirty_heap()
    got_codes, got_counts = native.compact_unsorted_native(words, 2 * k)
    want_codes, want_counts = reference_table(codes, 2 * k)
    assert np.array_equal(got_codes, want_codes)
    assert np.array_equal(got_counts, want_counts)


@pytest.mark.parametrize("tables", [2, 5])
def test_merge_into_reused_memory_is_exact(tables):
    rng = np.random.default_rng(tables)
    pool = rng.integers(0, 1 << 42, 300_000, dtype=np.uint64)
    parts = []
    for _ in range(tables):
        c, n = np.unique(pool[rng.integers(0, pool.size, 400_000)], return_counts=True)
        parts.append((c, n.astype(np.int64)))
    native.load()
    dirty_heap()
    got_codes, got_counts = native.merge_tables_native(parts)
    all_codes = np.concatenate([c for c, _ in parts])
    want_codes, inverse = np.unique(all_codes, return_inverse=True)
    want_counts = np.bincount(inverse, np.concatenate([n for _, n in parts]).astype(np.float64))
    assert np.array_equal(got_codes, want_codes)
    assert np.array_equal(got_counts, want_counts.astype(np.int64))
