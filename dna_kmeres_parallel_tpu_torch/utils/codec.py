"""2-bit DNA codec on the host (NumPy).

The port's copy of the JAX package's ``utils/codec.py`` (its NumPy half:
base codes, k-mer codes, reverse complements). A k-mer's code is its big-endian 2-bit rolling code (A=0, C=1, G=2, T=3):
``code(s) = sum_t base(s[t]) * 4**(k-1-t)``, so codes sort like the k-mer
strings. Characters other than A, C, G and T (case-sensitive) encode as
``INVALID_BASE``; a window that holds one is not counted. Records are
joined into one flat stream with a single ``INVALID_BASE`` between them,
so no window spans two records.
"""

from __future__ import annotations

import numpy as np

#: bits a base takes in the packed representation
BITS_PER_BASE = 2

#: code of a character outside {A, C, G, T}, and of the record separator
INVALID_BASE = np.uint8(0xFF)

_BASE_LUT = np.full(256, INVALID_BASE, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    _BASE_LUT[ord(_ch)] = _i
_BASE_CHARS = np.frombuffer(b"ACGT", dtype=np.uint8)


def num_bins(k: int) -> int:
    """4**k, the size of the dense histogram of k-mer length ``k``."""
    return 1 << (2 * k)


def encode_bases(seq: str | bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (0..3; INVALID_BASE elsewhere)."""
    if isinstance(seq, str):
        raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    elif isinstance(seq, (bytes, bytearray)):
        raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        raw = np.asarray(seq, dtype=np.uint8)
    return _BASE_LUT[raw]


def decode_bases(codes: np.ndarray) -> str:
    """uint8 base codes (0..3) -> ASCII string; other codes -> 'N'."""
    codes = np.asarray(codes)
    out = np.full(codes.shape, ord("N"), dtype=np.uint8)
    ok = codes < 4
    out[ok] = _BASE_CHARS[codes[ok]]
    return out.tobytes().decode("ascii")


def kmer_to_code(kmer: str) -> int:
    """k-mer string -> code. Raises ValueError on a character outside
    {A, C, G, T}."""
    code = 0
    for ch in kmer:
        b = int(_BASE_LUT[ord(ch)]) if ord(ch) < 256 else 0xFF
        if b > 3:
            raise ValueError(f"invalid base {ch!r} in k-mer {kmer!r}")
        code = (code << 2) | b
    return code


def code_to_kmer(code: int, k: int) -> str:
    """Code -> k-mer string."""
    return "".join("ACGT"[(code >> (2 * (k - 1 - t))) & 3] for t in range(k))


def kmer_codes(base_codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-window codes of a base-code array: ``(codes, valid)``, each of
    length ``max(len - k + 1, 0)``; ``codes[i]`` is the int64 code of the
    window starting at ``i`` (meaningless where invalid), ``valid[i]``
    whether all its k bases are in {A, C, G, T}."""
    base_codes = np.asarray(base_codes, dtype=np.uint8)
    n = base_codes.shape[0] - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    codes = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for t in range(k):
        window = base_codes[t : t + n]
        valid &= window < 4
        codes = (codes << 2) | (window & 3).astype(np.int64)
    return codes, valid


def all_kmers(k: int) -> list[str]:
    """All 4^k k-mer strings in code (lexicographic) order; k <= 12."""
    if k > 12:
        raise ValueError("refusing to materialize 4^k strings for k > 12")
    return [code_to_kmer(c, k) for c in range(num_bins(k))]


def revcomp_str(seq: str) -> str:
    """Reverse complement of an ACGT string (other characters -> N)."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp.get(ch, "N") for ch in reversed(seq))


def revcomp_code(code: int | np.ndarray, k: int):
    """Reverse complement in code space: each 2-bit digit complemented (b
    -> 3 - b) and the digit order reversed."""
    code = np.asarray(code)
    rc = np.zeros_like(code)
    c = code.copy()
    for _ in range(k):
        rc = (rc << 2) | ((c & 3) ^ 3)
        c = c >> 2
    if rc.ndim == 0:
        return int(rc)
    return rc


def canonical_code(code: int | np.ndarray, k: int):
    """min(code, revcomp(code)), the strand-folded code."""
    out = np.minimum(code, revcomp_code(code, k))
    if np.ndim(out) == 0:
        return int(out)
    return out


def pack_bases(base_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """uint8 base codes -> (data, mask, length): data uint8 [ceil(L/4)], 4
    bases a byte little-endian (an invalid base packs as 0); mask uint8
    [ceil(L/8)], the validity bits little-endian (``native.pack_2bit_native``'s
    format)."""
    base_codes = np.asarray(base_codes, dtype=np.uint8)
    L = base_codes.shape[0]
    valid = base_codes < 4
    safe = np.where(valid, base_codes, 0).astype(np.uint8)
    data4 = np.concatenate([safe, np.zeros((-L) % 4, dtype=np.uint8)]).reshape(-1, 4)
    packed = (data4[:, 0] | (data4[:, 1] << 2) | (data4[:, 2] << 4)
              | (data4[:, 3] << 6)).astype(np.uint8)
    return packed, np.packbits(valid, bitorder="little"), L


def unpack_bases(packed: np.ndarray, mask: np.ndarray, length: int) -> np.ndarray:
    """The inverse of ``pack_bases``: uint8 base codes, INVALID_BASE where
    the validity bit is clear."""
    packed = np.asarray(packed, dtype=np.uint8)
    flat = ((packed[:, None] >> np.arange(0, 8, 2, dtype=np.uint8)) & 3).reshape(-1)[:length]
    valid = np.unpackbits(np.asarray(mask, dtype=np.uint8), bitorder="little")[:length]
    return np.where(valid.astype(bool), flat, INVALID_BASE).astype(np.uint8)


def concat_with_sentinels(seqs) -> np.ndarray:
    """Encode sequences into ONE flat uint8 stream joined by single
    INVALID_BASE separators."""
    parts = []
    for i, s in enumerate(seqs):
        if i:
            parts.append(np.array([INVALID_BASE], dtype=np.uint8))
        parts.append(encode_bases(s))
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)
