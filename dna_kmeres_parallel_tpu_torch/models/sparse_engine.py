"""Sparse (sorted-table) k-mer counting: encode on the device, compact on
the host.

The port of ``dna_kmeres_parallel_tpu/models/sparse_engine.py``'s
single-host counting route. Each batch of the flat base stream (plus a
k-1 base halo) is staged on the host (u32 planes with ``pack_input``, the
padded u8 bases without it), encoded into split window words on the
device (K1 from planes, K9 from bases), copied back, and turned into a
sorted (code, count) table by the native MSD+LSD radix compactor; a merge
ladder folds the batch tables into one. Counts are exact integers.

With ``device_sort=True`` the device also sorts each batch's words:
``sort_row_len`` rows sorted independently (K11 for single-word keys
with ``pallas_sort``, else ``torch.sort``) and merged on the host by the
native row compactor, or one flat sort (``sort_row_len=0``) compacted by
neighbour compares. ``compact`` belongs to the streaming counter
(``models/pipeline``) and is ignored here, as the JAX engine ignores it.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models.engine import (
    batch_plan,
    host_to_device,
    pack_planes_np,
)
from dna_kmeres_parallel_tpu_torch.ops import runtime
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops
from dna_kmeres_parallel_tpu_torch.utils import codec, fasta
from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig

#: Phases of SparseCountResult.phases, in the order a batch runs them.
PHASES = ("parse", "staging", "h2d", "kernel", "d2h", "compact", "merge", "sort")


def require_native() -> None:
    """Build (at first use) and load the port's C++ host library, which
    parses, packs, compacts, merges and formats; raises with the
    compiler's output if it cannot be built."""
    native.load()


def dense_from_sparse(sp: "SparseCountResult", bins: int) -> np.ndarray:
    """The dense int64 histogram [bins] of a sparse result (its codes are
    unique, so this is an indexed store): how k = 9..12 are counted."""
    hist = np.zeros(bins, dtype=np.int64)
    hist[sp.codes.astype(np.int64)] = sp.counts
    return hist


def stage_words(padded: np.ndarray, pack_input: bool) -> tuple[np.ndarray, ...]:
    """The host half of a sparse batch, as the JAX engine stages it: the
    encoder's u32 planes with ``pack_input`` (0.5 B per base, K1), else
    the padded u8 bases themselves (1 B per base, K9)."""
    return pack_planes_np(padded) if pack_input else (padded,)


def encode_staged(staged: tuple, n_own: int, k: int, canonical: bool):
    """Encode what ``stage_words`` made, once on the device: planes with
    ``sparse.encode_words_planes`` (K1), u8 bases with
    ``sparse.encode_words`` (K9). Returns the word tuple."""
    if len(staged) == 2:
        return sparse_ops.encode_words_planes(*staged, n_own, k, canonical)
    return sparse_ops.encode_words(staged[0], n_own, k, canonical)


def fetch_words(words) -> tuple[np.ndarray, ...]:
    """Word planes (on the device, or already copied to the host) -> NumPy
    arrays viewed as the unsigned words they hold (int32 -> u32, int16 ->
    u16). A plane on the card is copied, which waits for the device."""
    out = []
    for w in words:
        a = w.cpu().numpy()
        out.append(a.view(np.uint16 if a.dtype == np.int16 else np.uint32))
    return tuple(out)


def compact_unsorted(words, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Unsorted host word planes (all-ones sentinels interspersed) ->
    sorted-unique (codes_u64, counts_i64), by the native radix compactor."""
    return native.compact_unsorted_native(
        tuple(w.reshape(-1) for w in words), 2 * k
    )


def compact_table(words) -> tuple[np.ndarray, np.ndarray]:
    """Sorted host word planes -> sorted-unique (codes_u64, counts_i64).
    Flat words (one ascending sort, sentinel tail) go to the native
    neighbour-compare compactor, [rows, m] words (each row ascending with
    its sentinel tail) to the native row merge."""
    if words[-1].ndim == 2:
        return native.compact_rows_native(words)
    return native.compact_sorted_native(words)


def compact_starts(words, starts) -> tuple[np.ndarray, np.ndarray]:
    """Flat sorted host word planes and their run-start flags ->
    (codes_u64, counts_i64), run lengths from consecutive starts."""
    return native.compact_starts_native(words, np.asarray(starts))


def compact_rle(hi, lo, counts, starts) -> tuple[np.ndarray, np.ndarray]:
    """Masked RLE output with device-computed counts (``sparse
    .sort_unique_counts``, as host arrays) -> (codes_u64, counts_i64)."""
    return native.compact_rle_native(hi, lo, counts, starts)


def table_from_rle(words_c, counts, n_distinct) -> tuple[np.ndarray, np.ndarray]:
    """Device RLE output (``sparse.rle_sorted``) -> sorted-unique
    (codes_u64, counts_i64). ``n_distinct`` comes to the host first (the
    wait for the device), then exactly that prefix of the words and
    counts; the table is sorted-unique already, so no compaction runs."""
    m = int(n_distinct)
    if m == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    planes = fetch_words(tuple(w[:m] for w in words_c))
    cnt = counts[:m].cpu().numpy().astype(np.int64)
    if len(planes) == 1:
        return planes[0].astype(np.uint64), cnt
    return sparse_ops.merged_code64(*planes), cnt


def merge_sparse_tables(
    tables: list[tuple[np.ndarray, np.ndarray]]
) -> tuple[np.ndarray, np.ndarray]:
    """Merge sorted-unique (codes_u64, counts_i64) tables into one, summing
    the counts of equal codes (native k-way merge)."""
    tables = [t for t in tables if t[0].size]
    if not tables:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    if len(tables) == 1:
        return tables[0]
    return native.merge_tables_native(tables)


class MergeLadder:
    """Bounded-memory incremental merging of per-batch tables.

    Batch tables buffer up to ``buffer_max`` and collapse in one native
    k-way pass; the collapsed runs go through a geometric 2x ladder, so the
    merge work is O(n * (1 + log(batches / buffer_max))) and peak memory
    about ``buffer_max`` batch tables plus twice the final table.
    """

    def __init__(self, buffer_max: int = 32):
        self._stack: list[tuple[np.ndarray, np.ndarray]] = []
        self._buffer: list[tuple[np.ndarray, np.ndarray]] = []
        self._buffer_max = max(buffer_max, 1)

    def _collapse(self) -> None:
        if not self._buffer:
            return
        run = (
            self._buffer[0]
            if len(self._buffer) == 1
            else merge_sparse_tables(self._buffer)
        )
        self._buffer = []
        self._stack.append(run)
        while (
            len(self._stack) >= 2
            and self._stack[-2][0].size <= 2 * self._stack[-1][0].size
        ):
            b = self._stack.pop()
            a = self._stack.pop()
            self._stack.append(merge_sparse_tables([a, b]))

    def push(self, table: tuple[np.ndarray, np.ndarray]) -> None:
        if not table[0].size:
            return
        self._buffer.append(table)
        if len(self._buffer) >= self._buffer_max:
            self._collapse()

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        self._collapse()
        return merge_sparse_tables(self._stack)

    def reset_to(self, table: tuple[np.ndarray, np.ndarray]) -> None:
        """Replace all pending state with one merged table (a checkpoint's
        snapshot becomes the sole base run)."""
        self._stack = []
        self._buffer = []
        self.push(table)


@dataclass
class SparseCountResult:
    k: int
    canonical: bool
    codes: np.ndarray  # uint64 sorted distinct k-mer codes
    counts: np.ndarray  # int64 counts aligned with codes
    n_seqs: int
    total_bases: int
    elapsed_s: float = 0.0
    #: seconds per phase (PHASES), summed over batches. On the card h2d,
    #: kernel (the encode) and sort (the device sort, 0 without
    #: ``device_sort``) are device-timeline spans (CUDA events), and d2h is
    #: the rest of the host wall from the end of staging to the words'
    #: arrival on the host; the other phases are host-clock spans.
    phases: dict[str, float] = field(default_factory=dict)

    @property
    def total_kmers(self) -> int:
        return int(self.counts.sum())

    @property
    def distinct_kmers(self) -> int:
        return int(self.codes.shape[0])

    def table(self) -> dict[str, int]:
        return {
            codec.code_to_kmer(int(c), self.k): int(n)
            for c, n in zip(self.codes, self.counts)
        }


class SparseKmerEngine:
    """Single-device sparse engine over any k in 1..31.

    pallas_sort: on the device-sort route (``device_sort=True`` with
    ``sort_row_len``), sort single-word rows (k <= 15, a row length that
    is a power of two from 128 to 32,768) with the row-sort kernel K11,
    as the JAX package's ``KMER_TPU_PALLAS_SORT=1`` does; otherwise rows
    sort with ``torch.sort``."""

    def __init__(
        self,
        config: KmerConfig | None = None,
        device: str | torch.device = "cuda",
        pallas_sort: bool = False,
        **kw,
    ):
        cfg = config or KmerConfig()
        self.config = cfg.replace(**kw) if kw else cfg
        if not (1 <= self.config.k <= sparse_ops.MAX_SPARSE_K):
            raise ValueError(
                f"sparse engine supports k <= {sparse_ops.MAX_SPARSE_K}"
            )
        self.device = runtime.resolve_device(device)
        self.pallas_sort = pallas_sort
        require_native()

    def count_stream(
        self, flat: np.ndarray, total_bases: int, n_seqs: int
    ) -> SparseCountResult:
        cfg = self.config
        dev = self.device
        t_start = time.perf_counter()
        phases = dict.fromkeys(PHASES, 0.0)
        t = t_start

        def lap(name: str) -> None:
            nonlocal t
            now = time.perf_counter()
            phases[name] += now - t
            t = now

        codes = np.zeros(0, np.uint64)
        counts = np.zeros(0, np.int64)
        total = flat.shape[0]
        if total >= cfg.k:
            batch, T = batch_plan(total, cfg.k, cfg.batch_bases)
            ladder = MergeLadder()
            for start in range(0, total, batch):
                end = min(start + batch, total)
                seg = flat[start : min(end + cfg.k - 1, total)]
                padded = np.full(T, codec.INVALID_BASE, dtype=np.uint8)
                padded[: seg.shape[0]] = seg
                host = stage_words(padded, cfg.pack_input)
                lap("staging")
                m0 = runtime.mark(dev)
                staged = tuple(host_to_device(a, dev) for a in host)
                m1 = runtime.mark(dev)
                words = encode_staged(staged, end - start, cfg.k, cfg.canonical)
                m2 = runtime.mark(dev)
                if cfg.device_sort:
                    words = sparse_ops.sort_encoded(
                        words, end - start, cfg.sort_row_len, self.pallas_sort
                    )
                m3 = runtime.mark(dev)
                host = fetch_words(words)  # waits for the device
                del words
                spans = {
                    "h2d": runtime.span_s(m0, m1),
                    "kernel": runtime.span_s(m1, m2),
                    "sort": runtime.span_s(m2, m3),
                }
                for name, span in spans.items():
                    phases[name] += span
                lap("d2h")
                phases["d2h"] -= sum(spans.values())
                if cfg.device_sort:
                    table = compact_table(host)
                else:
                    table = compact_unsorted(host, cfg.k)
                lap("compact")
                ladder.push(table)
                lap("merge")
            codes, counts = ladder.result()
            lap("merge")
        return SparseCountResult(
            k=cfg.k,
            canonical=cfg.canonical,
            codes=codes,
            counts=counts,
            n_seqs=n_seqs,
            total_bases=total_bases,
            elapsed_s=time.perf_counter() - t_start,
            phases=phases,
        )

    def count_sequences(self, seqs: list[str]) -> SparseCountResult:
        flat = codec.concat_with_sentinels(seqs)
        return self.count_stream(flat, sum(len(s) for s in seqs), len(seqs))

    def count_file(self, source) -> SparseCountResult:
        cfg = self.config
        t0 = time.perf_counter()
        if cfg.parser_variant == "modern" and isinstance(
            source, (str, os.PathLike)
        ):
            parsed = native.parse_fasta_native(source, max_seqs=cfg.max_seqs)
            parse_s = time.perf_counter() - t0
            res = self.count_stream(
                parsed.stream, parsed.total_bases, parsed.n_seqs
            )
        else:
            if cfg.parser_variant == "modern":
                records = fasta.parse_fasta(source, max_seqs=cfg.max_seqs)
            else:
                records = fasta.parse_fasta_reference(
                    source, variant=cfg.parser_variant, max_seqs=cfg.max_seqs
                )
            seqs = [r.seq for r in records]
            parse_s = time.perf_counter() - t0
            res = self.count_sequences(seqs)
        res.phases["parse"] = parse_s
        return res
