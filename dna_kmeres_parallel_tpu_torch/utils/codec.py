"""2-bit DNA codec on the host (NumPy).

A k-mer's code is its big-endian 2-bit rolling code (A=0, C=1, G=2, T=3):
``code(s) = sum_t base(s[t]) * 4**(k-1-t)``, so codes sort like the k-mer
strings. Characters other than A, C, G and T (case-sensitive) encode as
``INVALID_BASE``; a window that holds one is not counted. Records are
joined into one flat stream with a single ``INVALID_BASE`` between them,
so no window spans two records.
"""

from __future__ import annotations

import numpy as np

#: code of a character outside {A, C, G, T}, and of the record separator
INVALID_BASE = np.uint8(0xFF)

_BASE_LUT = np.full(256, INVALID_BASE, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    _BASE_LUT[ord(_ch)] = _i


def encode_bases(seq: str | bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (0..3; INVALID_BASE elsewhere)."""
    if isinstance(seq, str):
        raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    elif isinstance(seq, (bytes, bytearray)):
        raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        raw = np.asarray(seq, dtype=np.uint8)
    return _BASE_LUT[raw]


def code_to_kmer(code: int, k: int) -> str:
    """Code -> k-mer string."""
    return "".join("ACGT"[(code >> (2 * (k - 1 - t))) & 3] for t in range(k))


def concat_with_sentinels(seqs) -> np.ndarray:
    """Encode sequences into ONE flat uint8 stream joined by single
    INVALID_BASE separators."""
    parts = []
    for i, s in enumerate(seqs):
        if i:
            parts.append(np.array([INVALID_BASE], dtype=np.uint8))
        parts.append(encode_bases(s))
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)
