"""Dense window codes on torch tensors: the plain rolling encode, reverse
complement and canonical fold that feed K2's plain version.

The port of ``dna_kmeres_parallel_tpu/ops/encode.py``'s ``rolling_codes``,
``revcomp_codes`` and ``canonicalize``. Codes are big-endian 2-bit codes
in int32, so k <= 15 (4^15 < 2^31); larger k uses the split words of
``ops/sparse.py``.
"""

from __future__ import annotations

import torch

MAX_DENSE_K = 15


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
