"""Sparse (sorted-table) k-mer counting: encode on the device, compact on
the host.

The port of ``dna_kmeres_parallel_tpu/models/sparse_engine.py``'s
single-host counting route. Each batch of the flat base stream (plus a
k-1 base halo) is packed into u32 planes on the host, encoded into split
window words by K1 on the device, copied back, and turned into a sorted
(code, count) table by the native MSD+LSD radix compactor; a merge ladder
folds the batch tables into one. Counts are exact integers.

The JAX engine has more routes (a device sort, host-only and super-k-mer
compaction); the port has this one. ``KmerConfig`` fields that only
select among the JAX routes (``use_pallas``, ``pack_input``,
``sort_row_len``) are not read.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dna_kmeres_parallel_tpu import native
from dna_kmeres_parallel_tpu.utils import codec
from dna_kmeres_parallel_tpu.utils.config import KmerConfig
from dna_kmeres_parallel_tpu_torch.models.engine import (
    pack_planes_np,
    planes_to_device,
)
from dna_kmeres_parallel_tpu_torch.ops import runtime
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

_LANE = 128

#: Phases of SparseCountResult.phases, in the order a batch runs them.
PHASES = ("parse", "staging", "h2d", "kernel", "d2h", "compact", "merge")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def require_native() -> None:
    """Build (at first use) and load the C++ host library that parses,
    packs, compacts and merges; raise with its build error if it cannot."""
    if not native.available():
        raise RuntimeError(
            f"the native host library failed to build: {native.build_error()}"
        )


def batch_plan(total: int, k: int, batch_bases: int) -> tuple[int, int]:
    """(bases owned per batch, padded batch length T) for a stream of
    ``total`` bases: streams shorter than one batch use a power-of-two
    bucket, and every batch reads k-1 halo bases past what it owns."""
    pow2 = 1 << (max(total, _LANE) - 1).bit_length()
    batch = max(min(batch_bases, pow2), k)
    return batch, _round_up(batch + k - 1, _LANE)


def _mark(dev: torch.device):
    """A point on the device's timeline: a CUDA event recorded on the
    current stream on the card, the host clock on the CPU. Reading the
    events adds no synchronize: they are read after ``words_to_host`` has
    waited for the stream."""
    if dev.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(dev))
    return event


def _span_s(a, b) -> float:
    """Seconds between two ``_mark`` points."""
    return b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3


def words_to_host(words) -> tuple[np.ndarray, ...]:
    """Device word planes -> NumPy arrays viewed as the unsigned words they
    hold (int32 -> u32, int16 -> u16)."""
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


@dataclass
class SparseCountResult:
    k: int
    canonical: bool
    codes: np.ndarray  # uint64 sorted distinct k-mer codes
    counts: np.ndarray  # int64 counts aligned with codes
    n_seqs: int
    total_bases: int
    elapsed_s: float = 0.0
    #: seconds per phase (PHASES), summed over batches. On the card h2d
    #: and kernel are device-timeline spans (CUDA events), and d2h is the
    #: rest of the host wall from the end of staging to the words' arrival
    #: on the host; the other phases are host-clock spans.
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
    """Single-device sparse engine over any k in 1..31."""

    def __init__(
        self,
        config: KmerConfig | None = None,
        device: str | torch.device = "cuda",
        **kw,
    ):
        cfg = config or KmerConfig()
        self.config = cfg.replace(**kw) if kw else cfg
        if not (1 <= self.config.k <= sparse_ops.MAX_SPARSE_K):
            raise ValueError(
                f"sparse engine supports k <= {sparse_ops.MAX_SPARSE_K}"
            )
        if self.config.device_sort:
            raise NotImplementedError(
                "device_sort=True is not ported yet (ROADMAP items 7 and 11)"
            )
        if self.config.compact != "auto":
            raise NotImplementedError(
                f"compact={self.config.compact!r} is not ported yet "
                "(ROADMAP items 7 and 11)"
            )
        self.device = runtime.resolve_device(device)
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
                planes = pack_planes_np(padded)
                lap("staging")
                m0 = _mark(dev)
                staged = planes_to_device(planes, dev)
                m1 = _mark(dev)
                words = sparse_ops.encode_words_planes(
                    *staged, end - start, cfg.k, cfg.canonical
                )
                m2 = _mark(dev)
                host = words_to_host(words)  # waits for the device
                h2d, kernel = _span_s(m0, m1), _span_s(m1, m2)
                phases["h2d"] += h2d
                phases["kernel"] += kernel
                lap("d2h")
                phases["d2h"] -= h2d + kernel
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
        from dna_kmeres_parallel_tpu.utils import fasta

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
