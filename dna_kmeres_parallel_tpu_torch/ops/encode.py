"""Dense window codes on torch tensors: the 2-bit unpack, and the plain
rolling encode, reverse complement and canonical fold that feed the
histogram kernels' plain versions.

The port of ``dna_kmeres_parallel_tpu/ops/encode.py``'s
``ascii_to_bases``, ``unpack_2bit``, ``unpack_mask``, ``unpack_stream``,
``rolling_codes``, ``revcomp_codes`` and ``canonicalize``. Codes are
big-endian 2-bit codes in int32, so k <= 15 (4^15 < 2^31); larger k uses
the split words of ``ops/sparse.py``.
"""

from __future__ import annotations

import torch

MAX_DENSE_K = 15

#: the base code of an invalid base (N, or the separator between records)
INVALID = 0xFF


def ascii_to_bases(ascii_u8: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> uint8 base codes on their device: A, C, G, T -> 0-3
    (case-sensitive), INVALID for every other byte."""
    x = ascii_u8.to(torch.int32)
    code = torch.full_like(x, INVALID)
    for i, ch in enumerate(b"ACGT"):
        code = torch.where(x == ch, i, code)
    return code.to(torch.uint8)


def unpack_2bit(packed_u8: torch.Tensor) -> torch.Tensor:
    """uint8 packed bytes [..., B] -> uint8 base codes [..., 4B]: base i of
    a byte at bits 2i (the data plane of ``utils/codec.pack_bases``;
    validity is the mask plane's, ``unpack_mask``)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed_u8.device)
    parts = (packed_u8.to(torch.uint8)[..., None] >> shifts) & 3
    return parts.reshape(*packed_u8.shape[:-1], -1)


def unpack_mask(mask_u8: torch.Tensor) -> torch.Tensor:
    """uint8 mask bytes [..., B] -> bool validity [..., 8B]: bit i of a
    byte for its base i."""
    bits = torch.arange(8, dtype=torch.uint8, device=mask_u8.device)
    parts = (mask_u8.to(torch.uint8)[..., None] >> bits) & 1
    return parts.reshape(*mask_u8.shape[:-1], -1).bool()


def unpack_stream(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The 2-bit packed format -> uint8 base codes [T], INVALID where a
    base is invalid.

    data: uint8 [T/4], base i at bits 2*(i % 4) of byte i // 4; mask: uint8
    [T/8], bit i % 8 of byte i // 8 set where base i is valid. The counting
    engine ships a k <= 3 batch in this form and unpacks it on the device
    with these tensor ops, outside any kernel."""
    if data.dtype != torch.uint8 or mask.dtype != torch.uint8:
        raise ValueError(f"data and mask must be uint8, got {data.dtype}, {mask.dtype}")
    if 4 * data.numel() != 8 * mask.numel():
        raise ValueError(
            f"{data.numel()} data bytes hold {4 * data.numel()} bases but "
            f"{mask.numel()} mask bytes hold {8 * mask.numel()}"
        )
    return unpack_2bit(data).masked_fill(~unpack_mask(mask), INVALID)


def planes_to_stream(words_le: torch.Tensor, inval_be: torch.Tensor) -> torch.Tensor:
    """The encoder's u32 planes [Tw] (int32 tensors holding u32 bits:
    ``words_le`` base j of a word at bits 2j, ``inval_be`` digit 11 at bits
    30-2j where base j is invalid) -> the uint8 base stream [16*Tw] they
    hold, INVALID where a base is invalid."""
    sh = 2 * torch.arange(16, device=words_le.device, dtype=torch.int64)
    w = words_le.to(torch.int64) & 0xFFFFFFFF
    iv = inval_be.to(torch.int64) & 0xFFFFFFFF
    digits = ((w[:, None] >> sh) & 3).reshape(-1).to(torch.uint8)
    bad = (((iv[:, None] >> (30 - sh)) & 3) != 0).reshape(-1)
    return digits.masked_fill(bad, INVALID)


def rolling_codes(bases: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Window codes over the trailing axis.

    bases: uint8 [..., T] base codes (0..3 valid, anything else invalid).
    Returns (codes int32 [..., T-k+1], valid bool [..., T-k+1]): codes[i]
    is the big-endian code of window [i, i+k), valid[i] iff its k bases
    are all valid."""
    if not (1 <= k <= MAX_DENSE_K):
        raise ValueError(f"rolling_codes supports 1 <= k <= {MAX_DENSE_K}, got {k}")
    T = bases.shape[-1]
    n = T - k + 1
    if n <= 0:
        raise ValueError(f"window axis too short: T={T} < k={k}")
    b = bases.to(torch.int32)
    code = torch.zeros(*bases.shape[:-1], n, dtype=torch.int32, device=bases.device)
    valid = torch.ones(*bases.shape[:-1], n, dtype=torch.bool, device=bases.device)
    for t in range(k):
        w = b[..., t : t + n]
        valid &= w < 4
        code = (code << 2) | (w & 3)
    return code, valid


def revcomp_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement in code space: complement each 2-bit digit
    (XOR 3) and reverse the digit order."""
    rc = torch.zeros_like(codes)
    c = codes
    for _ in range(k):
        rc = (rc << 2) | ((c & 3) ^ 3)
        c = c >> 2
    return rc


def canonicalize(codes: torch.Tensor, k: int) -> torch.Tensor:
    """min(code, revcomp(code)): strand-folded canonical codes."""
    return torch.minimum(codes, revcomp_codes(codes, k))
