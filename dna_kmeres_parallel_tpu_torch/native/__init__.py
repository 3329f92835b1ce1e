"""ctypes binding of the port's C++ host library (``kmer_host.cpp``).

The library is built with ``g++`` at first use into ``build/torch_native/``
beside the package and loaded with ``ctypes``. Its file name carries a hash
of the source, the compiler flags and what ``-march=native`` means on the
building machine (``g++ -march=native -Q --help=target``), so a library
built for one CPU is never loaded on another: a checkout carried to a
machine with another CPU builds its own.

Entries: the FASTA parse, the 2-bit pack, the radix compactor of unsorted
window words, the compactors of sorted words, row-sorted words, run-start
flags and RLE records (the device-sort route's host half), the host-only
sparse counter (one stream, or per-record tables of many records), the
k-way merge of sorted (code, count) tables, the pairwise min-sums of
per-sequence sorted tables (the sparse distance path's two-pointer) and
the ``%f`` CSV formatter. Nothing falls back: a failed build raises with the
compiler's output. Loading the library has glibc keep freed memory in its
heap (``keep_freed_memory``), so the host routes reuse pages they faulted.
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

from dna_kmeres_parallel_tpu_torch.utils import profiling

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
        ("ids_len", ctypes.c_int64),
        ("total_bases", ctypes.c_int64),
        ("invalid_bases", ctypes.c_int64),
        ("lone_cr", ctypes.c_int64),
        ("ranges", ctypes.c_int64),
        ("parse", ctypes.c_void_p),
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


#: mallopt(3)'s parameters, as glibc's malloc.h numbers them
M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4


def keep_freed_memory() -> bool:
    """Have the C library serve large blocks from its heap and keep what
    is freed there (mallopt(3): ``M_MMAP_MAX`` 0, ``M_TRIM_THRESHOLD``
    -1), instead of mapping each block afresh and unmapping it on free.

    The sparse counter's arrays of a batch (the copied window words, the
    compactor's scratch and table, each merged table) are tens to hundreds
    of MB, as are the parse's. Mapped afresh, each faults its pages in
    again, on the compactor's threads at once: a 255 Mbase call spent more
    system time than wall time, and its pace moved with the host's load.
    Kept, a count reuses pages its earlier batches and calls faulted in;
    the process's resident size stays at its peak. Returns whether the C
    library took both settings (False where it has no ``mallopt``)."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.restype = ctypes.c_int
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    return bool(mallopt(M_MMAP_MAX, 0)) & bool(mallopt(M_TRIM_THRESHOLD, -1))


@functools.cache
def load() -> ctypes.CDLL:
    """The built library, with every entry point's C signature declared.
    Loading it also keeps freed memory in the heap (``keep_freed_memory``)
    for the host routes that call it."""
    lib = ctypes.CDLL(str(build()))
    keep_freed_memory()
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.kp_parse_fasta_range.restype = ci
    lib.kp_parse_fasta_range.argtypes = [
        ctypes.c_char_p, i64, i64, i64, ctypes.POINTER(ctypes.POINTER(_KpFasta)),
    ]
    lib.kp_fasta_join.restype = None
    lib.kp_fasta_join.argtypes = [ctypes.POINTER(_KpFasta), vp, vp, vp, vp]
    lib.kp_free_fasta.restype = None
    lib.kp_free_fasta.argtypes = [ctypes.POINTER(_KpFasta)]
    lib.kp_pack_2bit.restype = None
    lib.kp_pack_2bit.argtypes = [vp, i64, vp, vp]
    lib.kp_unpack_2bit.restype = None
    lib.kp_unpack_2bit.argtypes = [vp, vp, i64, vp]
    lib.kp_count_dense.restype = None
    lib.kp_count_dense.argtypes = [vp, i64, i64, ci, ci, vp]
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
    lib.kp_format_count_lines.restype = i64
    lib.kp_format_count_lines.argtypes = [vp, vp, i64, ci, vp, i64]
    lib.kp_count_starts.restype = i64
    lib.kp_count_starts.argtypes = [vp, i64]
    lib.kp_compact_rle.restype = i64
    lib.kp_compact_rle.argtypes = [vp, vp, vp, vp, i64, vp, vp]
    lib.kp_compact_starts.restype = i64
    lib.kp_compact_starts.argtypes = [vp, ci, vp, vp, i64, vp, vp]
    lib.kp_count_distinct.restype = i64
    lib.kp_count_distinct.argtypes = [vp, ci, vp, i64]
    lib.kp_compact_sorted.restype = i64
    lib.kp_compact_sorted.argtypes = [vp, ci, vp, i64, vp, vp]
    lib.kp_rows_valid.restype = i64
    lib.kp_rows_valid.argtypes = [vp, ci, vp, i64, i64]
    lib.kp_compact_rows.restype = i64
    lib.kp_compact_rows.argtypes = [vp, ci, vp, i64, i64, vp, vp]
    lib.kp_count_tables.restype = i64
    lib.kp_count_tables.argtypes = [vp, vp, vp, vp, i64, ci, ci, vp, vp, vp]
    lib.kp_min_sum_pairs.restype = i64
    lib.kp_min_sum_pairs.argtypes = [vp, vp, vp, i64, vp]
    lib.kp_min_sum_panel.restype = i64
    lib.kp_min_sum_panel.argtypes = [vp, vp, vp, i64, i64, i64, vp]
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@dataclass
class ParsedFasta:
    """A parsed file: the flat base stream plus per-record metadata.

    ``ids`` are the header lines (with their ``>`` or ``@``), decoded from
    ``id_bytes`` (each line ended by a NUL) on first use: a caller that
    never reads them, as the counting entries, makes no Python string."""

    n_seqs: int
    stream: np.ndarray  # uint8 [stream_len], 0xFF = invalid or separator
    offsets: np.ndarray  # int64 [n_seqs + 1]
    lengths: np.ndarray  # int64 [n_seqs]
    id_bytes: np.ndarray  # uint8: the header lines, each ended by a NUL
    total_bases: int
    invalid_bases: int
    #: lines holding a CR that does not end them: where this is nonzero
    #: the records may differ from ``utils/fasta.parse_fasta``'s
    lone_cr: int = 0
    #: the record-aligned ranges the file was parsed in, on as many
    #: threads (1: the one-range path)
    ranges: int = 1

    @functools.cached_property
    def ids(self) -> list[str]:
        raw = self.id_bytes.tobytes()
        return [s.decode("ascii", "replace") for s in raw.split(b"\0") if s]

    def sequence_codes(self, i: int) -> np.ndarray:
        """Record i's base codes, a view into ``stream``."""
        return self.stream[self.offsets[i] : self.offsets[i] + self.lengths[i]]


def parse_fasta_native(path, max_seqs: int | None = None,
                       byte_range: tuple[int, int] | None = None) -> ParsedFasta:
    """Parse a FASTA (or FASTQ, or gzip) file into a flat encoded stream
    with one 0xFF separator between records.

    An uncompressed file larger than the library's thread grain is mapped
    and cut into record-aligned ranges, one a host thread
    (``num_threads``: at most 16; ``KMER_NATIVE_THREADS`` overrides): a
    FASTA range starts at a line that starts with ``>``; a FASTQ range at a
    guess, a line that starts with ``@`` whose second line after starts
    with ``+``, and where the range before does not end between two
    records the range is parsed again from where it does end. The join of
    the ranges is byte for byte the one-range parse, which gzip input
    (compressed offsets), a ``max_seqs`` cap and a small file take. The
    arrays are filled in place by the join; ``ranges`` says how many
    ranges ran.

    byte_range=(start, end) parses only the records in those bytes of the
    file (end < 0: to its end): one rank's share of a multi-host run, its
    bounds record starts (``parallel/multihost.split_fasta_byte_ranges``),
    split into ranges the same way. A byte range on gzip input raises
    ``ValueError``."""
    lib = load()
    if max_seqs == 0:
        # The C side reads <= 0 as "no cap"; an explicit 0 means no records.
        return ParsedFasta(0, np.zeros(0, np.uint8), np.zeros(1, np.int64),
                           np.zeros(0, np.int64), np.zeros(0, np.uint8), 0, 0)
    out = ctypes.POINTER(_KpFasta)()
    start, end = byte_range if byte_range is not None else (0, -1)
    rc = lib.kp_parse_fasta_range(os.fspath(path).encode(), int(start), int(end),
                                  int(max_seqs or 0), ctypes.byref(out))
    if rc == 1:
        raise FileNotFoundError(path)
    if rc == 3:
        raise ValueError(f"{path}: a byte range of a gzip file cannot be parsed (the "
                         "ranges are compressed offsets); decompress it first")
    if rc != 0:
        raise OSError(f"native FASTA parse failed with code {rc}")
    try:
        r = out.contents
        n = int(r.n_seqs)
        stream = np.empty(int(r.stream_len), np.uint8)
        offsets = np.empty(n + 1, np.int64)
        lengths = np.empty(n, np.int64)
        id_bytes = np.empty(int(r.ids_len), np.uint8)
        lib.kp_fasta_join(out, _ptr(stream), _ptr(offsets), _ptr(lengths), _ptr(id_bytes))
        return ParsedFasta(
            n_seqs=n, stream=stream, offsets=offsets, lengths=lengths,
            id_bytes=id_bytes, total_bases=int(r.total_bases),
            invalid_bases=int(r.invalid_bases), lone_cr=int(r.lone_cr),
            ranges=int(r.ranges),
        )
    finally:
        lib.kp_free_fasta(out)


def parse_fasta_text(path, max_seqs: int | None = None) -> ParsedFasta:
    """The records of ``utils/fasta.parse_fasta`` (Python's text mode,
    where a lone CR ends a line), as a ``ParsedFasta``: the native parse,
    and where it met a CR inside a line, the Python parser's records
    encoded into the same stream layout. The entries whose JAX
    counterparts read records in Python parse with this; the counting
    entries keep ``parse_fasta_native``'s reading, as theirs do."""
    parsed = parse_fasta_native(path, max_seqs=max_seqs)
    if not parsed.lone_cr:
        return parsed
    from dna_kmeres_parallel_tpu_torch.utils import codec, fasta

    records = fasta.parse_fasta(path, max_seqs=max_seqs)
    # The text is read as ASCII with errors replaced (one character a
    # byte), so the replacement encodes as an invalid base.
    seqs = [r.seq.encode("ascii", "replace") for r in records]
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths + 1)]).astype(np.int64)
    offsets[-1] -= 1 if len(seqs) else 0
    stream = codec.concat_with_sentinels(seqs)
    out = ParsedFasta(
        n_seqs=len(seqs), stream=stream, offsets=offsets, lengths=lengths,
        id_bytes=np.zeros(0, np.uint8), total_bases=int(lengths.sum()),
        invalid_bases=int(np.count_nonzero(stream == codec.INVALID_BASE)) - max(len(seqs) - 1, 0),
        lone_cr=parsed.lone_cr, ranges=parsed.ranges,
    )
    # Python's text mode may have read other header lines than the bytes.
    out.ids = [r.id for r in records]
    return out


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


def unpack_2bit_native(data: np.ndarray, mask: np.ndarray, n: int) -> np.ndarray:
    """The inverse of ``pack_2bit_native``: n uint8 base codes, INVALID
    where the validity bit is clear."""
    lib = load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if data.size < (n + 3) // 4 or mask.size < (n + 7) // 8:
        raise ValueError(f"{data.size} data and {mask.size} mask bytes cannot hold {n} bases")
    out = np.zeros(n, dtype=np.uint8)
    lib.kp_unpack_2bit(_ptr(data), _ptr(mask), n, _ptr(out))
    return out


def count_dense_native(stream: np.ndarray, k: int, n_own: int | None = None,
                       canonical: bool = False) -> np.ndarray:
    """Dense int64 [4^k] count of an encoded stream (0xFF separators) on
    the host, k <= 15: the windows that start below ``n_own`` (all when
    None)."""
    if not 1 <= k <= 15:
        raise ValueError("native dense counter supports k <= 15")
    lib = load()
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    n = stream.shape[0]
    out = np.zeros(1 << (2 * k), dtype=np.int64)
    lib.kp_count_dense(_ptr(stream), n, n if n_own is None else int(n_own), k,
                       int(canonical), _ptr(out))
    return out


def _hi_layout(words: tuple[np.ndarray, ...]):
    """(hi or None, hi_width, lo) of a word tuple (lo_u32,) or (hi_u16 |
    hi_u32, lo_u32), each contiguous; hi_width is 0, 2 or 4 bytes. The
    caller keeps the returned arrays alive while the library reads them."""
    lo = np.ascontiguousarray(words[-1], dtype=np.uint32)
    if len(words) == 1:
        return None, 0, lo
    hi = np.ascontiguousarray(words[0])
    widths = {np.dtype(np.uint16): 2, np.dtype(np.uint32): 4}
    if hi.dtype not in widths:
        raise ValueError(f"hi word dtype {hi.dtype} unsupported")
    if hi.shape != lo.shape:
        raise ValueError(f"hi {hi.shape} and lo {lo.shape} words differ in shape")
    return hi, widths[hi.dtype], lo


def compact_sorted_native(words: tuple[np.ndarray, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Flat sorted window words (ascending, all-ones sentinel tail) ->
    sorted-unique (codes_u64, counts_i64); run boundaries and lengths come
    from neighbour compares, with no device-side flags."""
    lib = load()
    hi, hi_width, lo = _hi_layout(words)
    hi_ptr = None if hi is None else _ptr(hi)
    n = lo.size
    m = lib.kp_count_distinct(hi_ptr, hi_width, _ptr(lo), n)
    out_code = np.zeros(m, dtype=np.uint64)
    out_cnt = np.zeros(m, dtype=np.int64)
    w = lib.kp_compact_sorted(hi_ptr, hi_width, _ptr(lo), n, _ptr(out_code), _ptr(out_cnt))
    if w != m:
        raise RuntimeError(f"kp_compact_sorted wrote {w} entries, sized for {m}")
    return out_code, out_cnt


def compact_rows_native(words: tuple[np.ndarray, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Row-sorted window words [rows, m] (each row ascending with an
    all-ones sentinel tail) -> ONE sorted-unique (codes_u64, counts_i64)
    table: the R-way merge the device skipped, in one pass partitioned by
    code range over threads."""
    lib = load()
    hi, hi_width, lo = _hi_layout(words)
    if lo.ndim != 2:
        raise ValueError(f"compact_rows_native expects [rows, m] words, got {lo.shape}")
    rows, m = lo.shape
    hi_ptr = None if hi is None else _ptr(hi)
    cap = lib.kp_rows_valid(hi_ptr, hi_width, _ptr(lo), rows, m)
    out_code = np.zeros(cap, dtype=np.uint64)
    out_cnt = np.zeros(cap, dtype=np.int64)
    w = lib.kp_compact_rows(hi_ptr, hi_width, _ptr(lo), rows, m, _ptr(out_code),
                            _ptr(out_cnt))
    return out_code[:w].copy(), out_cnt[:w].copy()


def compact_starts_native(
    words: tuple[np.ndarray, ...], starts: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Flat sorted window words + run-start flags -> (codes_u64,
    counts_i64): run lengths are the distances between consecutive starts,
    the last run closed by the sentinel tail."""
    lib = load()
    hi, hi_width, lo = _hi_layout(words)
    starts_u8 = np.ascontiguousarray(starts, dtype=np.uint8)
    if starts_u8.shape != lo.shape:
        raise ValueError(f"starts {starts_u8.shape} and words {lo.shape} differ in shape")
    n = lo.size
    m = lib.kp_count_starts(_ptr(starts_u8), n)
    out_code = np.zeros(m, dtype=np.uint64)
    out_cnt = np.zeros(m, dtype=np.int64)
    w = lib.kp_compact_starts(None if hi is None else _ptr(hi), hi_width, _ptr(lo),
                              _ptr(starts_u8), n, _ptr(out_code), _ptr(out_cnt))
    if w != m:
        raise RuntimeError(f"kp_compact_starts wrote {w} entries, sized for {m}")
    return out_code, out_cnt


def compact_rle_native(
    hi: np.ndarray, lo: np.ndarray, counts: np.ndarray, starts: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Masked device RLE output (u32 hi and lo words, int32 counts, run
    starts) -> (codes_u64, counts_i64) of the entries whose start is set."""
    lib = load()
    hi = np.ascontiguousarray(hi, dtype=np.uint32)
    lo = np.ascontiguousarray(lo, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    starts_u8 = np.ascontiguousarray(starts, dtype=np.uint8)
    n = lo.size
    if not hi.size == counts.size == starts_u8.size == n:
        raise ValueError("hi, lo, counts and starts must have one length")
    m = lib.kp_count_starts(_ptr(starts_u8), n)
    out_code = np.zeros(m, dtype=np.uint64)
    out_cnt = np.zeros(m, dtype=np.int64)
    lib.kp_compact_rle(_ptr(hi), _ptr(lo), _ptr(counts), _ptr(starts_u8), n,
                       _ptr(out_code), _ptr(out_cnt))
    return out_code, out_cnt


def compact_unsorted_native(
    words: tuple[np.ndarray, ...], kbits: int
) -> tuple[np.ndarray, np.ndarray]:
    """Unsorted window words (all-ones sentinel words interspersed) ->
    sorted-unique (codes_u64, counts_i64) by the MSD+LSD radix compactor.
    ``words`` is (lo_u32,) or (hi_u16|hi_u32, lo_u32); kbits = 2k."""
    lib = load()
    hi, hi_width, lo = _hi_layout(tuple(np.asarray(w).reshape(-1) for w in words))
    n = lo.shape[0]
    hi_ptr = None if hi is None else _ptr(hi)
    cap = lib.kp_count_valid(hi_ptr, hi_width, _ptr(lo), n, kbits)
    # uncleared: the compactor writes the first w entries, the rest is unread
    out_code = np.empty(cap, dtype=np.uint64)
    out_cnt = np.empty(cap, dtype=np.int64)
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
    """One native merge of ``tables``: the span ``merge.pair`` (counter
    ``rows_out``, the merged table's rows)."""
    if len(tables) == 1:
        return tables[0]
    lib = load()
    with profiling.span("merge.pair") as pair:
        m = len(tables)
        codes = [np.ascontiguousarray(t[0], dtype=np.uint64) for t in tables]
        cnts = [np.ascontiguousarray(t[1], dtype=np.int64) for t in tables]
        lens = np.array([c.shape[0] for c in codes], dtype=np.int64)
        # uncleared: the merge writes the first w entries, the rest is unread
        out_code = np.empty(int(lens.sum()), dtype=np.uint64)
        out_cnt = np.empty(int(lens.sum()), dtype=np.int64)
        code_ptrs = np.array([_ptr(c) for c in codes], dtype=np.uint64)
        cnt_ptrs = np.array([_ptr(c) for c in cnts], dtype=np.uint64)
        w = lib.kp_merge_tables(
            m, _ptr(code_ptrs), _ptr(cnt_ptrs), _ptr(lens),
            _ptr(out_code), _ptr(out_cnt),
        )
        pair.count("rows_out", w)
    return out_code[:w], out_cnt[:w]


def count_tables_native(
    stream: np.ndarray, starts: np.ndarray, lengths: np.ndarray, k: int,
    canonical: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-record sorted-unique tables of the records of a u8 base stream
    (record i is ``lengths[i]`` bases at ``starts[i]``), in one threaded
    call: (codes_u64, counts_i64, offs_i64[S+1]), record i's table at
    [offs[i], offs[i+1]). Each table equals ``count_sparse_host_native``
    of the record alone."""
    lib = load()
    if not (1 <= k <= 31):
        raise ValueError(f"k must be in [1, 31], got {k}")
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    S = lengths.size
    if starts.shape != lengths.shape or (S and int((starts + lengths).max()) > stream.size):
        raise ValueError("each record must lie inside the stream")
    caps = np.maximum(lengths - k + 1, 0)
    slot = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    out_code = np.empty(int(slot[-1]), dtype=np.uint64)
    out_cnt = np.empty(int(slot[-1]), dtype=np.int64)
    out_len = np.zeros(S, dtype=np.int64)
    lib.kp_count_tables(_ptr(stream), _ptr(starts), _ptr(lengths), _ptr(slot), S, k,
                        int(bool(canonical)), _ptr(out_code), _ptr(out_cnt), _ptr(out_len))
    row = np.repeat(np.arange(S), caps)
    keep = np.arange(int(slot[-1])) - slot[:-1][row] < out_len[row]
    offs = np.concatenate([[0], np.cumsum(out_len)]).astype(np.int64)
    return out_code[keep], out_cnt[keep], offs


def _pair_tables(codes, counts, offs):
    """Contiguous (u64 codes, int64 counts, int64 fences) of concatenated
    per-sequence tables, checked for one length and S + 1 fences."""
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    if codes.shape != counts.shape or offs.ndim != 1 or offs.size < 1:
        raise ValueError("codes and counts must have one length, offs S + 1 fences")
    if offs[0] != 0 or offs[-1] != codes.size or np.any(np.diff(offs) < 0):
        raise ValueError("offs must rise from 0 to the tables' length")
    return codes, counts, offs


def min_sum_pairs_native(
    codes: np.ndarray, counts: np.ndarray, offs: np.ndarray
) -> np.ndarray:
    """Per-sequence sorted-unique tables -> the packed strict upper
    triangle of their pairwise min-sums, int64 [S*(S-1)/2], by the
    threaded two-pointer intersection (``kp_min_sum_pairs``).

    codes/counts: the tables concatenated; offs: int64 [S+1] fences
    (sequence i's table is offs[i]..offs[i+1])."""
    lib = load()
    codes, counts, offs = _pair_tables(codes, counts, offs)
    S = offs.shape[0] - 1
    out = np.zeros(max(S * (S - 1) // 2, 1), dtype=np.int64)
    w = lib.kp_min_sum_pairs(_ptr(codes), _ptr(counts), _ptr(offs), S, _ptr(out))
    return out[: max(w, 0)]


def min_sum_panel_native(
    codes: np.ndarray, counts: np.ndarray, offs: np.ndarray, r0: int, r1: int
) -> np.ndarray:
    """The pair min-sums of rows [r0, r1) only (clamped to [0, S - 1)),
    packed from row r0 on: the streamed sparse distances' unit of work
    (``kp_min_sum_panel``)."""
    lib = load()
    codes, counts, offs = _pair_tables(codes, counts, offs)
    S = offs.shape[0] - 1
    r0 = max(int(r0), 0)
    r1 = min(int(r1), max(S - 1, 0))
    if r0 >= r1:
        return np.zeros(0, dtype=np.int64)
    n = (r1 - r0) * (S - 1) - (r1 * (r1 - 1) - r0 * (r0 - 1)) // 2
    out = np.zeros(n, dtype=np.int64)
    w = lib.kp_min_sum_panel(_ptr(codes), _ptr(counts), _ptr(offs), S, r0, r1, _ptr(out))
    if w != n:
        raise RuntimeError(f"kp_min_sum_panel wrote {w} pairs, sized for {n}")
    return out


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


def format_count_lines(codes: np.ndarray, counts: np.ndarray, k: int,
                       out: np.ndarray | None = None) -> memoryview:
    """A table's ``kmer,count`` CSV lines (no header), formatted on several
    threads: the k-mer spelled from each code, the count in decimal. The
    lines are formatted into ``out`` (u8, at least 64 bytes an entry;
    allocated here if None) and returned as a view of it."""
    lib = load()
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n = codes.shape[0]
    if counts.shape[0] != n:
        raise ValueError(f"{n} codes but {counts.shape[0]} counts")
    if n == 0:
        return memoryview(b"")
    buf = np.empty(64 * n, dtype=np.uint8) if out is None else out
    if buf.dtype != np.uint8 or not buf.flags.c_contiguous or buf.size < 64 * n:
        raise ValueError(f"out must be a contiguous u8 array of at least {64 * n} bytes")
    m = lib.kp_format_count_lines(_ptr(codes), _ptr(counts), n, int(k), _ptr(buf), buf.size)
    if m < 0:
        raise ValueError(f"kp_format_count_lines: k={k} outside 1..31")
    return memoryview(buf[:m])
