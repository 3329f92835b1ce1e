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
):
    """Staged u32 planes [Tw] -> the adaptive UNSORTED word tuple over the
    16*Tw window starts, natural order, all-ones sentinels.

    The planes' device picks the route and nothing else does: on the card
    the hand-written kernel (``encode_cuda.encode_packed``), on the CPU
    its plain version."""
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda

    dev = words_le.device.type
    if dev == "cuda":
        hi, lo = encode_cuda.encode_packed(words_le, inval_be, n_own, k, canonical)
    elif dev == "cpu":
        hi, lo = encode_cuda.encode_packed_reference(
            words_le, inval_be, n_own, k, canonical
        )
    else:
        raise ValueError(f"no encoder for device {words_le.device}")
    return narrow_words(hi, lo, k)
