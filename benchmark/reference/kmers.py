"""Plain references the benchmark holds the program to, in plain torch and
NumPy. They read only the generator's base streams (``gen/fasta.Records``)
and import nothing of the program and nothing of JAX.

Frozen copies of ``chip_smoke.py``'s ``reference_codes``,
``reference_table``, ``reference_counts``, ``reference_min_sums`` (its
broadcast branch: the benchmark's distances have at most 1,024 bins) and
``reference_packed``, so that a later change to that script cannot move
the yardstick. The controls are the same references with one guarantee
broken (``n_as_a_starts``: N read as A) or one precision lowered
(``bf16``): each must fail the comparison that decides ``correct``.
"""

from __future__ import annotations

import numpy as np
import torch

INVALID = 0xFF
#: windows rolled per chunk (int64 on the device: 256 MiB a tensor)
REF_CHUNK = 1 << 25


def reference_codes(stream: np.ndarray, k: int, canonical: bool, dev,
                    n_as_a_starts: np.ndarray | None = None):
    """The int64 codes of every valid window of the stream, chunk by chunk:
    the code of a window rolled over its k bases (and its reverse
    complement, for canonical). ``n_as_a_starts`` (each record's offset)
    is the control's broken guarantee: an N inside a record is read as an
    A, so windows over N are counted; the separators stay invalid."""
    b = torch.from_numpy(stream).to(dev)
    if n_as_a_starts is not None:
        b = torch.where(b == INVALID, 0, b).to(torch.uint8)
        seps = torch.from_numpy(np.asarray(n_as_a_starts[1:], np.int64) - 1).to(dev)
        b[seps] = INVALID
    n = b.numel() - k + 1
    for s in range(0, max(n, 0), REF_CHUNK):
        m = min(REF_CHUNK, n - s)
        w = b[s : s + m + k - 1].long()
        code = torch.zeros(m, dtype=torch.int64, device=dev)
        rc = torch.zeros_like(code)
        valid = torch.ones(m, dtype=torch.bool, device=dev)
        for j in range(k):
            d = w[j : j + m]
            valid &= d < 4
            code = (code << 2) | (d & 3)
            rc |= (3 - (d & 3)) << (2 * j)
        if canonical:
            code = torch.minimum(code, rc)
        yield code[valid]


def reference_table(stream: np.ndarray, k: int, canonical: bool, dev,
                    n_as_a_starts: np.ndarray | None = None):
    """Sorted distinct codes (u64) and counts (i64) of every valid window
    of the stream: ``reference_codes``, then ``torch.unique``."""
    parts = list(reference_codes(stream, k, canonical, dev, n_as_a_starts))
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    codes, counts = torch.unique(torch.cat(parts), sorted=True, return_counts=True)
    return codes.cpu().numpy().view(np.uint64), counts.cpu().numpy()


def reference_counts(stream, starts, lengths, k: int, canonical: bool, dev):
    """int32 [S, 4^k] per-record counts, in plain int64 torch: every window
    of the stream rolled into its code (and its reverse complement, for
    canonical), then one ``bincount`` of row * 4^k + code."""
    bins = 4**k
    S = lengths.size
    end = int(starts[-1] + lengths[-1])
    b = torch.from_numpy(stream[:end]).to(dev).long()
    n = end - k + 1
    code = torch.zeros(n, dtype=torch.int64, device=dev)
    rc = torch.zeros_like(code)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for j in range(k):
        d = b[j : j + n]
        valid &= d < 4
        code = (code << 2) | (d & 3)
        rc |= (3 - (d & 3)) << (2 * j)
    if canonical:
        code = torch.minimum(code, rc)
    pos = torch.arange(n, device=dev)
    row = torch.searchsorted(torch.from_numpy(starts).to(dev), pos, right=True) - 1
    idx = (row * bins + code)[valid]
    return torch.bincount(idx, minlength=S * bins).reshape(S, bins).to(torch.int32)


def reference_min_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 [S, S2] sum_p min(a_ip, b_jp): a blocked broadcast of
    ``torch.minimum`` (up to 1,024 bins)."""
    S, B = a.shape
    S2 = b.shape[0]
    if B > 1024:
        raise ValueError("the broadcast reference takes at most 1,024 bins")
    out = torch.empty(S, S2, dtype=torch.int32, device=a.device)
    rows = max(1, (1 << 27) // max(S2 * B, 1))
    for r in range(0, S, rows):
        out[r : r + rows] = torch.minimum(a[r : r + rows, None, :], b[None]).sum(-1)
    return out


def reference_packed(sums: np.ndarray, lengths: np.ndarray, k: int,
                     bf16: bool = False) -> np.ndarray:
    """float32 distances 1 - s / (min(L_i, L_j) - k + 1) in NumPy for row
    i against columns j > i, concatenated row by row: the packed strict
    upper triangle, written into one array (54,018 records: 5.8 GB).
    ``bf16`` is the control's lower precision: the sums, the denominators,
    the quotient and the distance rounded to bfloat16."""
    S = sums.shape[0]
    out = np.empty(S * (S - 1) // 2, np.float32)
    at = 0
    for i in range(S):
        s = sums[i, i + 1 :].astype(np.float32)
        denom = (np.minimum(lengths[i], lengths[i + 1 :]) - k + 1).astype(np.float32)
        if bf16:
            q = torch.from_numpy(s).bfloat16() / torch.from_numpy(denom).bfloat16()
            out[at : at + s.size] = (1 - q).float().numpy()
        else:
            out[at : at + s.size] = np.float32(1.0) - s / denom
        at += s.size
    return out
