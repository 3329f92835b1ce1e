"""Split-word k-mer codes for sparse counting, on torch tensors.

The port of ``dna_kmeres_parallel_tpu/ops/sparse.py``'s word layout and
its plain encode. A window's 2k-bit code is split into words whose
lexicographic order is the code's order:

  k <= 15:       one word, lo (code < 2^30; sentinel 0xFFFFFFFF)
  16 <= k <= 23: (hi u16, lo u32); hi holds the first 2k-32 <= 14 bits.
                 At k=16 the all-T k-mer has lo == 0xFFFFFFFF and hi == 0:
                 only the u16 sentinel 0xFFFF tells it from an invalid window.
  24 <= k <= 31: (hi u32, lo u32)

lo always holds the last min(k, 16) bases. Invalid and unowned windows
hold all-ones in every word. Device planes are int32/int16 tensors holding
those unsigned bits; the plain encode below computes in int64.
"""

from __future__ import annotations

import torch

MAX_SPARSE_K = 31

_LO_BASES = 16  # bases held in the lo word

#: largest k whose codes fit a single u32 strictly below the sentinel
MAX_SINGLE_WORD_K = 15
#: largest k whose hi word fits strictly below the u16 sentinel
MAX_U16_HI_K = 23


def _lo_bases(k: int) -> int:
    return min(k, _LO_BASES)


def key_words(k: int) -> int:
    """Number of key words for this k (1 or 2)."""
    return 1 if k <= MAX_SINGLE_WORD_K else 2


def hi_dtype(k: int) -> torch.dtype | None:
    """Torch dtype of the hi plane (None if single-word): int16 holding the
    u16 word for k <= 23, else int32 holding the u32 word."""
    if k <= MAX_SINGLE_WORD_K:
        return None
    return torch.int16 if k <= MAX_U16_HI_K else torch.int32


def rolling_codes_split(bases: torch.Tensor, k: int):
    """[T] base codes (0..3 valid, anything else invalid) ->
    ((hi, lo) int64 [T-k+1], valid bool [T-k+1]).

    hi holds the first k-16 bases (0 if k <= 16), lo the last min(k, 16)."""
    if not (1 <= k <= MAX_SPARSE_K):
        raise ValueError(f"k must be in [1, {MAX_SPARSE_K}]")
    T = bases.shape[-1]
    n = T - k + 1
    if n <= 0:
        raise ValueError(f"window axis too short: T={T} < k={k}")
    nhi = k - _lo_bases(k)
    b64 = bases.to(torch.int64)
    hi = torch.zeros(n, dtype=torch.int64, device=bases.device)
    lo = torch.zeros(n, dtype=torch.int64, device=bases.device)
    valid = torch.ones(n, dtype=torch.bool, device=bases.device)
    for t in range(k):
        w = b64[t : t + n]
        valid &= (w >= 0) & (w < 4)
        b = w & 3
        if t < nhi:
            hi = (hi << 2) | b
        else:
            lo = (lo << 2) | b
    return (hi, lo), valid


def revcomp_split(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """Reverse complement of int64 split codes (digit reverse + complement):
    walk the digits from the end of the k-mer and roll the complemented
    digits into the result, most significant first."""
    nlo = _lo_bases(k)
    nhi = k - nlo
    rc_hi = torch.zeros_like(hi)
    rc_lo = torch.zeros_like(lo)
    src_hi, src_lo = hi, lo
    for i in range(k):
        d = src_lo & 3
        src_lo = (src_lo >> 2) | ((src_hi & 3) << (2 * (nlo - 1)))
        src_hi = src_hi >> 2
        if i < nhi:
            rc_hi = (rc_hi << 2) | (d ^ 3)
        else:
            rc_lo = (rc_lo << 2) | (d ^ 3)
    return rc_hi, rc_lo


def canonicalize_split(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """Lexicographic min of (hi, lo) and its reverse complement."""
    rc_hi, rc_lo = revcomp_split(hi, lo, k)
    take_rc = (rc_hi < hi) | ((rc_hi == hi) & (rc_lo < lo))
    return torch.where(take_rc, rc_hi, hi), torch.where(take_rc, rc_lo, lo)


def narrow_words(hi, lo, k: int):
    """(hi, lo) planes from the encoder -> the adaptive word tuple: (lo,)
    for k <= 15, else (hi, lo)."""
    if k <= MAX_SINGLE_WORD_K:
        return (lo,)
    return (hi, lo)


def encode_words_planes(
    words_le: torch.Tensor,
    inval_be: torch.Tensor,
    n_own: int,
    k: int,
    canonical: bool = False,
    minimizer_m: int | None = None,
):
    """Staged u32 planes [Tw] -> the adaptive UNSORTED word tuple over the
    16*Tw window starts, natural order, all-ones sentinels; with
    ``minimizer_m``, (word tuple, int32 minimizer plane in the same order).

    The planes' device picks the route and nothing else does: on the card
    the hand-written kernel (``encode_cuda.encode_packed``), on the CPU
    its plain version."""
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda

    dev = words_le.device.type
    args = (words_le, inval_be, n_own, k, canonical, minimizer_m)
    if dev == "cuda":
        out = encode_cuda.encode_packed(*args)
    elif dev == "cpu":
        out = encode_cuda.encode_packed_reference(*args)
    else:
        raise ValueError(f"no encoder for device {words_le.device}")
    words = narrow_words(out[0], out[1], k)
    return words if minimizer_m is None else (words, out[2])


def encode_words(
    bases: torch.Tensor, n_own: int, k: int, canonical: bool = False
):
    """A staged u8 base stream [T] -> the adaptive UNSORTED word tuple over
    its T window starts, natural order, all-ones sentinels.

    The stream's device picks the route and nothing else does: on the
    card the hand-written kernel (``encode_cuda.encode_stream``, K9), on
    the CPU its plain version."""
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda

    dev = bases.device.type
    if dev == "cuda":
        hi, lo = encode_cuda.encode_stream(bases, n_own, k, canonical)
    elif dev == "cpu":
        hi, lo = encode_cuda.encode_stream_reference(bases, n_own, k, canonical)
    else:
        raise ValueError(f"no encoder for device {bases.device}")
    return narrow_words(hi, lo, k)


# ---------------------------------------------------------------------------
# The device-sort route: sorted words, row-sorted words, run starts and
# run-length records. Words sort in the UNSIGNED lexicographic order of
# the split words, so the all-ones sentinel tail sorts last: a single u32
# word as int32 biased by INT32_MIN, two words as one int64 key (hi << 32
# | lo; valid codes are below 2^62) with invalid windows mapped to
# INT64_MAX, whose all-ones hi word would otherwise read as -1 and sort
# first.
# ---------------------------------------------------------------------------

_INT32_MIN = -(1 << 31)
_INT64_MAX = (1 << 63) - 1


def word_sentinel(dtype: torch.dtype) -> int:
    """The all-ones sentinel of an int16 or int32 word plane, as the
    signed value that holds its bits: -1."""
    if dtype not in (torch.int16, torch.int32):
        raise ValueError(f"word planes are int16 or int32, got {dtype}")
    return -1


def _unsigned(w: torch.Tensor) -> torch.Tensor:
    """int16/int32 bits -> the unsigned word they hold, in int64."""
    return w.to(torch.int64) & (0xFFFF if w.dtype == torch.int16 else 0xFFFFFFFF)


def _bits_as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 holding an unsigned word -> an int16/int32 plane with its bits."""
    width = 16 if dtype == torch.int16 else 32
    return torch.where(x >= 1 << (width - 1), x - (1 << width), x).to(dtype)


def _sort_key(words) -> torch.Tensor:
    """The sort key of a word tuple: int32 (single word, biased) or int64."""
    if len(words) == 1:
        return words[0] ^ _INT32_MIN
    hi, lo = words
    key = (_unsigned(hi) << 32) | _unsigned(lo)
    return torch.where(hi != word_sentinel(hi.dtype), key, _INT64_MAX)


def key_dtype(k: int) -> torch.dtype:
    """The dtype of ``_sort_key``'s keys at this k: int32 for one word,
    int64 for two."""
    return torch.int32 if k <= MAX_SINGLE_WORD_K else torch.int64


def key_sentinel(dtype: torch.dtype) -> int:
    """The key of an invalid or unowned window, which sorts last: the
    dtype's largest value (the biased all-ones word, or INT64_MAX)."""
    return torch.iinfo(dtype).max


def codes_of_keys(key: torch.Tensor) -> torch.Tensor:
    """Valid keys -> the int64 k-mer codes they order: a single word's
    bias taken off, a two-word key as it is (hi << 32 | lo, the code
    ``merged_code64`` forms on the host)."""
    if key.dtype == torch.int32:
        return (key ^ _INT32_MIN).to(torch.int64) & 0xFFFFFFFF
    return key


def _words_of_key(key: torch.Tensor, words) -> tuple:
    """Inverse of ``_sort_key``: the key back to word planes like ``words``."""
    if len(words) == 1:
        return (key ^ _INT32_MIN,)
    hi_dtype = words[0].dtype
    valid = key != _INT64_MAX
    hi = torch.where(valid, _bits_as(key >> 32, hi_dtype), word_sentinel(hi_dtype))
    lo = torch.where(valid, _bits_as(key & 0xFFFFFFFF, torch.int32), -1)
    return hi, lo


def sort_flat(words) -> tuple:
    """A word tuple -> the same words in one ascending sort (the JAX
    programs' ``lax.sort(words, num_keys=len(words))``)."""
    key = torch.sort(_sort_key(words)).values
    return _words_of_key(key, words)


def _sort_words_as_rows(words, row_len: int, pallas_sort: bool = False) -> tuple:
    """A flat word tuple -> [rows, row_len] planes, each row sorted
    ascending with its sentinel tail. The stream is padded with sentinels
    to rows * row_len (rows = ceil(n / row_len), at least 1). Single-word
    rows go to the row sort K11 when ``pallas_sort`` is set and K11 takes
    the row length (``sort_cuda.row_sort_u32``: the kernel on the card,
    its plain version on the CPU); every other case sorts with
    ``torch.sort`` along the rows."""
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    n = words[-1].shape[0]
    rows = max(1, -(-n // row_len))
    npad = rows * row_len
    shaped = []
    for w in words:
        if npad != n:
            w = torch.cat([w, w.new_full((npad - n,), word_sentinel(w.dtype))])
        shaped.append(w.reshape(rows, row_len))
    if pallas_sort and len(shaped) == 1 and sort_cuda.row_sort_fits(row_len):
        return (sort_cuda.row_sort_u32(shaped[0]),)
    key = torch.sort(_sort_key(shaped), dim=-1).values
    return _words_of_key(key, shaped)


def sort_encoded(words, n_own: int, row_len: int, pallas_sort: bool = False) -> tuple:
    """The sort half of every device-sort program: the owned windows of an
    encoder's word tuple (natural order: windows past ``n_own`` are
    unowned sentinels and are dropped), sorted as [rows, row_len] rows,
    or flat when ``row_len`` is 0."""
    words = tuple(w[:n_own] for w in words)
    if row_len:
        return _sort_words_as_rows(words, row_len, pallas_sort)
    return sort_flat(words)


def sort_words(bases: torch.Tensor, n_own: int, k: int, canonical: bool = False) -> tuple:
    """A staged u8 base stream -> the words of its owned windows, sorted
    flat, with the sentinel tail (K9, then one sort)."""
    return sort_encoded(encode_words(bases, n_own, k, canonical), n_own, 0)


def sort_words_planes(words_le, inval_be, n_own: int, k: int, canonical: bool = False) -> tuple:
    """``sort_words`` from the staged u32 planes (K1, then one sort)."""
    return sort_encoded(encode_words_planes(words_le, inval_be, n_own, k, canonical), n_own, 0)


def sort_words_rows(
    bases: torch.Tensor, n_own: int, k: int, canonical: bool = False,
    row_len: int = 2048, pallas_sort: bool = False,
) -> tuple:
    """A staged u8 base stream -> its owned windows' words as [rows,
    row_len] independently sorted rows (K9, then the row sorts). A row is
    a bag of windows: the host row compactor
    (``native.compact_rows_native``) merges the rows."""
    words = encode_words(bases, n_own, k, canonical)
    return sort_encoded(words, n_own, row_len, pallas_sort)


def sort_words_rows_planes(
    words_le, inval_be, n_own: int, k: int, canonical: bool = False,
    row_len: int = 2048, pallas_sort: bool = False,
) -> tuple:
    """``sort_words_rows`` from the staged u32 planes (K1, then the row
    sorts)."""
    words = encode_words_planes(words_le, inval_be, n_own, k, canonical)
    return sort_encoded(words, n_own, row_len, pallas_sort)


def run_starts(words, sentinel: int | None = None) -> torch.Tensor:
    """Flat sorted words -> bool run-start flags: True at the first word of
    each distinct run, False throughout the sentinel tail. ``sentinel`` is
    the first plane's (default: the words' all-ones sentinel)."""
    if sentinel is None:
        sentinel = word_sentinel(words[0].dtype)
    valid = words[0] != sentinel
    starts = valid.clone()
    neq = torch.zeros_like(valid[1:])
    for w in words:
        neq |= w[1:] != w[:-1]
    starts[1:] &= neq
    return starts


def sort_unique_starts(
    bases: torch.Tensor, n_own: int, k: int, canonical: bool = False
) -> tuple:
    """``sort_words`` plus the run-start flags: (words, starts)."""
    words = sort_words(bases, n_own, k, canonical)
    return words, run_starts(words)


def _with_counts(words, starts: torch.Tensor, k: int) -> tuple:
    """(hi, lo, counts, starts) of flat sorted words: hi widened to u32
    bits (0 for single-word codes; the sentinel kept), and counts[i] the
    distance from i to the next run start or sentinel, int32."""
    lo = words[-1]
    n = lo.shape[0]
    if len(words) == 1:
        valid = lo != -1
        hi = torch.where(valid, 0, -1).to(torch.int32)
    else:
        valid = words[0] != word_sentinel(words[0].dtype)
        hi = torch.where(valid, words[0].to(torch.int32), -1)
    idx = torch.arange(n, dtype=torch.int32, device=lo.device)
    flagged = torch.where(starts | ~valid, idx, n)
    # next_start[i] = min(flagged[i:]): a reverse cumulative min
    next_start = flagged.flip(0).cummin(0).values.flip(0)
    after = torch.cat([next_start[1:], next_start.new_full((1,), n)])
    return hi, lo, (after - idx).to(torch.int32), starts


def sort_unique_counts(
    bases: torch.Tensor, n_own: int, k: int, canonical: bool = False
) -> tuple:
    """(hi, lo, counts, starts) with the run lengths computed on the
    device (``_with_counts`` of ``sort_unique_starts``)."""
    words, starts = sort_unique_starts(bases, n_own, k, canonical)
    return _with_counts(words, starts, k)


def rle_sorted(words, sentinel: int | None = None) -> tuple:
    """Flat sorted words -> (words_c, counts_i32, n_distinct_i32): the
    distinct codes moved to the front in code order, counts[j] the j-th
    distinct code's multiplicity; entries past n_distinct are sentinels
    (and garbage counts), and a batch with no valid window gives
    n_distinct 0. Nothing here waits for the device: each run start is
    scattered to its rank among the starts, the rest to a discarded slot.
    ``sentinel`` is that of every plane (default: the words' all-ones
    sentinel; ``rle_keys`` passes a key's)."""
    lo = words[-1]
    n = lo.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"a batch of {n} windows: run positions and counts are int32; "
                         f"use a smaller batch_bases")
    if sentinel is None:
        sentinel = word_sentinel(words[0].dtype)
    starts = run_starts(words, sentinel)
    dev = lo.device
    n_distinct = starts.sum(dtype=torch.int32)
    n_valid = (words[0] != sentinel).sum(dtype=torch.int32)
    dest = torch.where(starts, torch.cumsum(starts, 0, dtype=torch.int64) - 1, n)
    words_c = []
    for w in words:
        out = w.new_full((n + 1,), sentinel)
        words_c.append(out.scatter_(0, dest, w)[:n])
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    # pos[j]: the stream index of the j-th run start (n past the last);
    # the last run ends where the sentinel tail begins, at n_valid.
    pos = idx.new_full((n + 1,), n).scatter_(0, dest, idx)[:n]
    nxt = torch.cat([pos[1:], pos.new_full((1,), n)])
    counts = torch.where(nxt == n, n_valid, nxt) - pos
    return tuple(words_c), counts.to(torch.int32), n_distinct


def rle_keys(key: torch.Tensor) -> tuple:
    """``rle_sorted`` over one ascending sorted key (``_sort_key``'s, its
    sentinel tail last): ((keys_c,), counts_i32, n_distinct_i32)."""
    return rle_sorted((key,), key_sentinel(key.dtype))


def sort_words_rle(bases: torch.Tensor, n_own: int, k: int, canonical: bool = False) -> tuple:
    """Device sort plus run-length compaction of a staged u8 base stream:
    (words_c, counts_i32, n_distinct_i32), only the distinct prefix of
    which needs to cross to the host (``compact="device-rle"``)."""
    return rle_sorted(sort_words(bases, n_own, k, canonical))


def merged_code64(hi, lo):
    """Host split words (NumPy u16/u32) -> one uint64 code per window."""
    import numpy as np

    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)
