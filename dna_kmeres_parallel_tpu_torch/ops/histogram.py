"""Dense histograms and per-sequence count matrices from window codes
(plain PyTorch).

The port of ``dna_kmeres_parallel_tpu/ops/histogram.py``'s ``histogram``
and ``counts_matrix``: invalid windows, and codes outside [0, bins), are
dropped. Counts are exact int32.
"""

from __future__ import annotations

import torch


def counts_matrix(codes: torch.Tensor, valid: torch.Tensor, bins: int) -> torch.Tensor:
    """codes int32 [S, W] and valid bool [S, W] -> int32 [S, bins]: the
    number of valid windows of each row per code. Codes outside
    [0, bins) are dropped."""
    S = codes.shape[0]
    col = codes.to(torch.int64)
    col = torch.where(valid & (col >= 0) & (col < bins), col, bins)
    out = torch.zeros(S, bins + 1, dtype=torch.int32, device=codes.device)
    out.scatter_add_(1, col, torch.ones_like(col, dtype=torch.int32))
    return out[:, :bins].contiguous()


def histogram(codes: torch.Tensor, valid: torch.Tensor, bins: int) -> torch.Tensor:
    """codes int32 [W] and valid bool [W] -> int32 [bins]: the number of
    valid windows per code. Codes outside [0, bins) are dropped."""
    keep = valid & (codes >= 0) & (codes < bins)
    return torch.bincount(codes[keep].to(torch.int64), minlength=bins).to(torch.int32)
