"""ctypes binding of the port's C++ host library (``kmer_host.cpp``).

The library is built with ``g++`` at first use into ``build/torch_native/``
beside the package and loaded with ``ctypes``. Its file name carries a hash
of the source, the compiler flags and what ``-march=native`` means on the
building machine (``g++ -march=native -Q --help=target``), so a library
built for one CPU is never loaded on another: a checkout carried to a
machine with another CPU builds its own.

Entries: the FASTA parse, the 2-bit pack, the radix compactor of unsorted
window words, the host-only sparse counter, the k-way merge of sorted (code, count) tables and the
``%f`` CSV formatter. Nothing falls back: a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "kmer_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

CXX_FLAGS = (
    "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native",
    "-pthread", "-shared",
)


class _KpFasta(ctypes.Structure):
    _fields_ = [
        ("n_seqs", ctypes.c_int64),
        ("stream_len", ctypes.c_int64),
        ("stream", ctypes.POINTER(ctypes.c_uint8)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("lengths", ctypes.POINTER(ctypes.c_int64)),
        ("ids", ctypes.POINTER(ctypes.c_char)),
        ("ids_len", ctypes.c_int64),
        ("total_bases", ctypes.c_int64),
        ("invalid_bases", ctypes.c_int64),
    ]


def cxx_path() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("g++ not found on PATH: the port's host library is "
                           "built from native/kmer_host.cpp")
    return found


@functools.cache
def library_path() -> Path:
    """Where the library for this source, these flags and this CPU lives."""
    cxx = cxx_path()
    target = subprocess.run(
        [cxx, "-march=native", "-Q", "--help=target"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(target.encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libkmer_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this key has one already."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name, then rename: a concurrent build never
    # sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx_path(), *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    """The built library, with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build()))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.kp_parse_fasta.restype = ci
    lib.kp_parse_fasta.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(ctypes.POINTER(_KpFasta)),
    ]
    lib.kp_free_fasta.argtypes = [ctypes.POINTER(_KpFasta)]
    lib.kp_pack_2bit.restype = None
    lib.kp_pack_2bit.argtypes = [vp, i64, vp, vp]
    lib.kp_count_valid.restype = i64
    lib.kp_count_valid.argtypes = [vp, ci, vp, i64, ci]
    lib.kp_compact_unsorted.restype = i64
    lib.kp_compact_unsorted.argtypes = [vp, ci, vp, i64, ci, vp, vp]
    lib.kp_count_windows_valid.restype = i64
    lib.kp_count_windows_valid.argtypes = [vp, i64, ci]
    lib.kp_count_sparse_host.restype = i64
    lib.kp_count_sparse_host.argtypes = [vp, i64, ci, ci, vp, vp]
    lib.kp_merge_tables.restype = i64
    lib.kp_merge_tables.argtypes = [i64, vp, vp, vp, vp, vp]
    lib.kp_format_f6.restype = i64
    lib.kp_format_f6.argtypes = [vp, i64, ctypes.c_char_p, i64]
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@dataclass
class ParsedFasta:
    """A parsed file: the flat base stream plus per-record metadata."""

    n_seqs: int
    stream: np.ndarray  # uint8 [stream_len], 0xFF = invalid or separator
    offsets: np.ndarray  # int64 [n_seqs + 1]
    lengths: np.ndarray  # int64 [n_seqs]
    ids: list[str]
    total_bases: int
    invalid_bases: int


def parse_fasta_native(path, max_seqs: int | None = None) -> ParsedFasta:
    """Parse a FASTA (or FASTQ, or gzip) file into a flat encoded stream
    with one 0xFF separator between records."""
    lib = load()
    if max_seqs == 0:
        # The C side reads <= 0 as "no cap"; an explicit 0 means no records.
        return ParsedFasta(0, np.zeros(0, np.uint8), np.zeros(1, np.int64),
                           np.zeros(0, np.int64), [], 0, 0)
    out = ctypes.POINTER(_KpFasta)()
    rc = lib.kp_parse_fasta(os.fspath(path).encode(), int(max_seqs or 0),
                            ctypes.byref(out))
    if rc == 1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise OSError(f"native FASTA parse failed with code {rc}")
    r = out.contents
    try:
        n = int(r.n_seqs)

        def copy(ptr, count, dtype):
            if not count:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype)

        raw_ids = ctypes.string_at(r.ids, int(r.ids_len)) if r.ids_len else b""
        return ParsedFasta(
            n_seqs=n,
            stream=copy(r.stream, int(r.stream_len), np.uint8),
            offsets=copy(r.offsets, n + 1, np.int64),
            lengths=copy(r.lengths, n, np.int64),
            ids=[s.decode("ascii", "replace") for s in raw_ids.split(b"\0") if s],
            total_bases=int(r.total_bases),
            invalid_bases=int(r.invalid_bases),
        )
    finally:
        lib.kp_free_fasta(out)


def pack_2bit_native(bases: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """uint8 base codes -> (data, 4 bases per byte little-endian; validity
    mask, 8 bases per byte; length)."""
    lib = load()
    bases = np.ascontiguousarray(bases, dtype=np.uint8)
    n = bases.shape[0]
    data = np.zeros((n + 3) // 4, dtype=np.uint8)
    mask = np.zeros((n + 7) // 8, dtype=np.uint8)
    lib.kp_pack_2bit(_ptr(bases), n, _ptr(data), _ptr(mask))
    return data, mask, n


def compact_unsorted_native(
    words: tuple[np.ndarray, ...], kbits: int
) -> tuple[np.ndarray, np.ndarray]:
    """Unsorted window words (all-ones sentinel words interspersed) ->
    sorted-unique (codes_u64, counts_i64) by the MSD+LSD radix compactor.
    ``words`` is (lo_u32,) or (hi_u16|hi_u32, lo_u32); kbits = 2k."""
    lib = load()
    lo = np.ascontiguousarray(np.asarray(words[-1]).reshape(-1), dtype=np.uint32)
    n = lo.shape[0]
    if len(words) == 1:
        hi, hi_width = None, 0
    else:
        hi = np.ascontiguousarray(np.asarray(words[0]).reshape(-1))
        widths = {np.dtype(np.uint16): 2, np.dtype(np.uint32): 4}
        if hi.dtype not in widths:
            raise ValueError(f"hi word dtype {hi.dtype} unsupported")
        hi_width = widths[hi.dtype]
    hi_ptr = None if hi is None else _ptr(hi)
    cap = lib.kp_count_valid(hi_ptr, hi_width, _ptr(lo), n, kbits)
    out_code = np.zeros(cap, dtype=np.uint64)
    out_cnt = np.zeros(cap, dtype=np.int64)
    w = lib.kp_compact_unsorted(
        hi_ptr, hi_width, _ptr(lo), n, kbits, _ptr(out_code), _ptr(out_cnt)
    )
    if w < 0:
        raise MemoryError("native radix compactor: scratch allocation failed")
    return out_code[:w].copy(), out_cnt[:w].copy()


def count_sparse_host_native(
    stream: np.ndarray, k: int, canonical: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Host-only sparse k-mer count: u8 base stream (0..3 codes, 0xFF
    separators) -> sorted-unique (codes_u64, counts_i64), by a rolling
    encoder (forward and reverse complement in O(1) per base) fused into
    the radix compactor. Nothing goes to a device; the tables equal the
    device route's."""
    lib = load()
    if not (1 <= k <= 31):
        raise ValueError(f"k must be in [1, 31], got {k}")
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    n = stream.shape[0]
    cap = lib.kp_count_windows_valid(_ptr(stream), n, k)
    out_code = np.zeros(cap, dtype=np.uint64)
    out_cnt = np.zeros(cap, dtype=np.int64)
    w = lib.kp_count_sparse_host(
        _ptr(stream), n, k, int(bool(canonical)), _ptr(out_code), _ptr(out_cnt)
    )
    if w < 0:
        raise MemoryError("native radix compactor: scratch allocation failed")
    return out_code[:w].copy(), out_cnt[:w].copy()


def merge_tables_native(
    tables: list[tuple[np.ndarray, np.ndarray]]
) -> tuple[np.ndarray, np.ndarray]:
    """Merge sorted-unique (codes_u64, counts_i64) tables into one, summing
    the counts of equal codes. More than two tables reduce as a binary tree
    of pair merges (the two-pointer pair merge is far faster than the heap
    merge of many tables)."""
    tables = [t for t in tables if t[0].size]
    if not tables:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    while len(tables) > 2:
        nxt = [_merge(tables[i : i + 2]) for i in range(0, len(tables) - 1, 2)]
        if len(tables) % 2:
            nxt.append(tables[-1])
        tables = nxt
    return _merge(tables)


def _merge(tables):
    if len(tables) == 1:
        return tables[0]
    lib = load()
    m = len(tables)
    codes = [np.ascontiguousarray(t[0], dtype=np.uint64) for t in tables]
    cnts = [np.ascontiguousarray(t[1], dtype=np.int64) for t in tables]
    lens = np.array([c.shape[0] for c in codes], dtype=np.int64)
    out_code = np.zeros(int(lens.sum()), dtype=np.uint64)
    out_cnt = np.zeros(int(lens.sum()), dtype=np.int64)
    code_ptrs = np.array([_ptr(c) for c in codes], dtype=np.uint64)
    cnt_ptrs = np.array([_ptr(c) for c in cnts], dtype=np.uint64)
    w = lib.kp_merge_tables(
        m, _ptr(code_ptrs), _ptr(cnt_ptrs), _ptr(lens),
        _ptr(out_code), _ptr(out_cnt),
    )
    return out_code[:w], out_cnt[:w]


def format_f6(values: np.ndarray) -> bytes:
    """float32 values -> the reference's one-float-per-line CSV bytes
    (C's ``"%f\\n"`` each), formatted by ``snprintf`` on several threads:
    the same digits as Python's ``"%f"``."""
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.float32)
    n = values.shape[0]
    if n == 0:
        return b""
    buf = ctypes.create_string_buffer(16 * n)
    m = lib.kp_format_f6(_ptr(values), n, buf, 16 * n)
    if m < 0:
        raise RuntimeError("kp_format_f6: output buffer too small")
    return buf.raw[:m]
