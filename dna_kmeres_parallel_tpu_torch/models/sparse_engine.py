"""Sparse (sorted-table) k-mer counting: encode on the device, build the
table on the card where it fits, else on the host.

The port of ``dna_kmeres_parallel_tpu/models/sparse_engine.py``'s
single-host counting route. Each batch of the flat base stream (plus a
k-1 base halo) is staged on the host (u32 planes with ``pack_input``, the
padded u8 bases without it) and encoded into split window words on the
device (K1 from planes, K9 from bases). With ``device_sort=None`` (the
default) on a card whose free memory holds the call's windows
(``card_table_fits``), each batch's owned windows become sort keys in one
buffer of the call on the card; after the last batch one ``torch.sort``
and a run-length (``sparse.rle_keys``) build the sorted (code, count)
table there, and only its distinct rows are copied to the host. Every
other call copies each batch's words back, turns them into a table by the
native MSD+LSD radix compactor, and folds the batch tables into one by a
merge ladder. Counts are exact integers either way.

With ``device_sort=True`` the device also sorts each batch's words:
``sort_row_len`` rows sorted independently (K11 for single-word keys
with ``pallas_sort``, else ``torch.sort``) and merged on the host by the
native row compactor, or one flat sort (``sort_row_len=0``) compacted by
neighbour compares. ``compact`` belongs to the streaming counter
(``models/pipeline``) and is ignored here, as the JAX engine ignores it.

Pairwise distances over sparse per-sequence tables, at any k from 1 to 31
(the JAX module's second half): ``build_pair_tables`` (the native host
counter, or this engine for records of 4 Mbase and more), the memory and
cost gates (``dense_distance_feasible``, ``dense_distance_preferred``,
``union_dense_plan``), the union-indexed route (the tables re-indexed
against the union of their codes, one dense matrix built on the device
from the tables' entries, K3 or K4 on the card), the native threaded
two-pointer (``native.min_sum_pairs_native``, ``min_sum_panel_native``)
and its NumPy twins, the host float32 finish,
and the one-shot (``distance_sparse_packed``) and streamed, resumable
(``distance_sparse_stream_to_csv``) entries. The JAX package reads its
gates' rates, thread count, budgets and union switch from a calibration
file and the environment; here they are arguments (``DistanceRates``,
``union``, the budgets), with the H100's measured rates as defaults. A
kernel that fails raises: no route falls back to the host.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import distance_stream
from dna_kmeres_parallel_tpu_torch.models.engine import (
    batch_plan,
    host_to_device,
    min_sum_panel_mesh,
    pack_planes_np,
    seq_stream,
)
from dna_kmeres_parallel_tpu_torch.ops import distance as dist_ops
from dna_kmeres_parallel_tpu_torch.ops import distance_cuda, runtime, threshold_cuda
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops
from dna_kmeres_parallel_tpu_torch.utils import codec, fasta
from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig
from dna_kmeres_parallel_tpu_torch.utils.profiling import span

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


def fetch_words(words, ready=None) -> tuple[np.ndarray, ...]:
    """Word planes (on the device, or already copied to the host) -> NumPy
    arrays viewed as the unsigned words they hold (int32 -> u32, int16 ->
    u16). A plane on the card is copied, which waits for the device. The
    copy is the span ``d2h.copy`` (counter ``bytes``); with ``ready`` (a
    ``runtime.mark`` after the words' last kernel) the wait for the
    device is a span of its own before it, ``d2h.wait``."""
    if ready is not None:
        with span("d2h.wait"):
            runtime.wait(ready)
    with span("d2h.copy") as copy:
        out = []
        for w in words:
            a = w.cpu().numpy()
            out.append(a.view(np.uint16 if a.dtype == np.int16 else np.uint32))
            copy.count("bytes", a.nbytes)
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


def fetch_table(keys_c, runs, rows: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``rows`` entries of ``sparse.rle_keys``' output (distinct
    keys, int32 counts) -> the host table (codes_u64, counts_i64), each
    converted on the device and copied once: the span ``d2h.copy``
    (counter ``bytes``)."""
    with span("d2h.copy") as copy:
        codes = sparse_ops.codes_of_keys(keys_c[:rows]).cpu().numpy().view(np.uint64)
        counts = runs[:rows].to(torch.int64).cpu().numpy()
        copy.count("bytes", codes.nbytes + counts.nbytes)
    return codes, counts


#: the device bytes a window that the card's table build reserves: copies
#: of the window's key and of an 8-byte word (the sort's int64 indices,
#: the run-length's positions). Its peak, the call's key buffer included,
#: measured 48.22 B a window with int64 keys and 37.00 with int32 ones at
#: 257.5 M windows on an H100 (PERF.md, section 6); this reserves 56 and 44
CARD_TABLE_KEY_COPIES = 3
CARD_TABLE_INDEX_COPIES = 4


def card_table_bytes(windows: int, key_bytes: int) -> int:
    """The device memory ``SparseKmerEngine``'s table build on the card
    needs for a call of ``windows`` windows whose keys take ``key_bytes``
    bytes each."""
    return windows * (CARD_TABLE_KEY_COPIES * key_bytes + CARD_TABLE_INDEX_COPIES * 8)


def card_table_fits(device: torch.device, windows: int, key_bytes: int) -> bool:
    """Whether the card builds a call's table: the device is a card, the
    call has fewer than 2^31 windows (the run-length's positions are
    int32), and the card's free memory, with what PyTorch's allocator
    holds unused, takes ``card_table_bytes``."""
    if device.type != "cuda" or windows >= 1 << 31:
        return False
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return free >= card_table_bytes(windows, key_bytes)


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
    #: kernel (the encode) and sort (the device sort: each batch's with
    #: ``device_sort``, the call's keys' on the card route, else 0) are
    #: device-timeline spans (CUDA events), and d2h is the rest of the host
    #: wall from the end of staging to the words' arrival on the host (on
    #: the card route: of the batches' ships and the table's copy); the
    #: other phases are host-clock spans (compact, on the card route, less
    #: the sort).
    phases: dict[str, float] = field(default_factory=dict)
    #: whether the card built the table from the call's keys (one sort
    #: and run-length), not the host from per-batch tables
    table_on_card: bool = False

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

    def count_of(self, kmer: str) -> int:
        """The count of one k-mer (0 if absent); a canonical table folds
        the query, so either strand's spelling finds its count."""
        code = codec.kmer_to_code(kmer)
        if self.canonical:
            code = min(code, codec.kmer_to_code(codec.revcomp_str(kmer)))
        code = np.uint64(code)
        i = np.searchsorted(self.codes, code)
        if i < self.codes.shape[0] and self.codes[i] == code:
            return int(self.counts[i])
        return 0


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
        """Count a flat base stream (u8 codes, one 0xFF between records)
        into the sorted table. With ``device_sort=None`` on a card whose
        free memory holds the call's keys (``card_table_fits``) the card
        builds the table (``_table_on_card``); every other call builds it
        on the host from per-batch tables (``_table_on_host``)."""
        cfg = self.config
        t_start = time.perf_counter()
        phases = dict.fromkeys(PHASES, 0.0)
        codes = np.zeros(0, np.uint64)
        counts = np.zeros(0, np.int64)
        total = flat.shape[0]
        on_card = False
        if total >= cfg.k:
            on_card = cfg.device_sort is None and card_table_fits(
                self.device, total, sparse_ops.key_dtype(cfg.k).itemsize
            )
            build = self._table_on_card if on_card else self._table_on_host
            codes, counts = build(flat, phases)
        return SparseCountResult(
            k=cfg.k,
            canonical=cfg.canonical,
            codes=codes,
            counts=counts,
            n_seqs=n_seqs,
            total_bases=total_bases,
            elapsed_s=time.perf_counter() - t_start,
            phases=phases,
            table_on_card=on_card,
        )

    def _staged_batches(self, flat: np.ndarray, phases: dict):
        """(start, end, staged host arrays) of each batch: it owns the
        windows that start in [start, end) and reads k-1 halo bases past
        it, padded with 0xFF to the batch length (the ``staging`` span)."""
        cfg = self.config
        total = flat.shape[0]
        batch, T = batch_plan(total, cfg.k, cfg.batch_bases)
        for start in range(0, total, batch):
            with span("staging", phases):
                end = min(start + batch, total)
                seg = flat[start : min(end + cfg.k - 1, total)]
                padded = np.full(T, codec.INVALID_BASE, dtype=np.uint8)
                padded[: seg.shape[0]] = seg
                host = stage_words(padded, cfg.pack_input)
            yield start, end, host

    def _ship(self, host: tuple, n_own: int):
        """A staged batch copied to the device and encoded there: (the
        word tuple, device marks before the copy, after it and after the
        encode)."""
        cfg, dev = self.config, self.device
        m0 = runtime.mark(dev)
        staged = tuple(host_to_device(a, dev) for a in host)
        m1 = runtime.mark(dev)
        words = encode_staged(staged, n_own, cfg.k, cfg.canonical)
        return words, (m0, m1, runtime.mark(dev))

    def _table_on_host(self, flat: np.ndarray, phases: dict):
        """Each batch's words (sorted on the device with ``device_sort``)
        copied to the host and compacted there into a table, the tables
        merged by a ``MergeLadder``."""
        cfg, dev = self.config, self.device
        ladder = MergeLadder()
        for start, end, host in self._staged_batches(flat, phases):
            # d2h: the host wall from here to the words' arrival, less the
            # device phases it spans
            with span("d2h", phases):
                words, (m0, m1, m2) = self._ship(host, end - start)
                if cfg.device_sort:
                    words = sparse_ops.sort_encoded(
                        words, end - start, cfg.sort_row_len, self.pallas_sort
                    )
                m3 = runtime.mark(dev)
                host = fetch_words(words, m3)
                del words
                device_s = 0.0
                for name, a, b in (("h2d", m0, m1), ("kernel", m1, m2), ("sort", m2, m3)):
                    seconds = runtime.span_s(a, b)
                    phases[name] += seconds
                    device_s += seconds
            phases["d2h"] -= device_s
            with span("compact", phases) as compact:
                if cfg.device_sort:
                    table = compact_table(host)
                else:
                    table = compact_unsorted(host, cfg.k)
                compact.count("words", host[0].size)
                compact.count("rows", table[0].size)
            with span("merge", phases):
                ladder.push(table)
        with span("merge", phases):
            return ladder.result()

    def _table_on_card(self, flat: np.ndarray, phases: dict):
        """Each batch's owned windows written as sort keys into one buffer
        of the call's windows on the device, with no wait between batches;
        then one sort and run-length of the buffer (the ``compact`` span,
        less the sort's device time, which is ``sort``), and one copy of
        the distinct (code, count) rows to the host. Nothing merges."""
        cfg, dev = self.config, self.device
        keys = torch.empty(flat.shape[0], dtype=sparse_ops.key_dtype(cfg.k), device=dev)
        marks = []
        for start, end, host in self._staged_batches(flat, phases):
            # d2h: the host wall of the ships and of the table's copy, less
            # the device phases of the ships (read after the loop)
            with span("d2h", phases):
                words, m = self._ship(host, end - start)
                keys[start:end] = sparse_ops._sort_key(tuple(w[: end - start] for w in words))
                del words
            marks.append(m)
        with span("compact", phases) as compact:
            m3 = runtime.mark(dev)
            ordered = torch.sort(keys).values
            del keys
            m4 = runtime.mark(dev)
            (keys_c,), runs, n_distinct = sparse_ops.rle_keys(ordered)
            del ordered
            rows = int(n_distinct)  # waits for the device
            compact.count("words", flat.shape[0])
            compact.count("rows", rows)
        sort_s = runtime.span_s(m3, m4)
        phases["sort"] += sort_s
        phases["compact"] -= sort_s
        with span("d2h", phases):
            table = fetch_table(keys_c, runs, rows)
        for m0, m1, m2 in marks:
            for name, a, b in (("h2d", m0, m1), ("kernel", m1, m2)):
                seconds = runtime.span_s(a, b)
                phases[name] += seconds
                phases["d2h"] -= seconds
        return table

    def count_sequences(self, seqs: list[str]) -> SparseCountResult:
        with span("count_sequences") as root:
            flat = codec.concat_with_sentinels(seqs)
            res = self.count_stream(flat, sum(len(s) for s in seqs), len(seqs))
            root.count("rows", res.codes.shape[0])
            root.count("table_on_card", res.table_on_card)
        return res

    def count_file(self, source) -> SparseCountResult:
        cfg = self.config
        parse: dict[str, float] = {}
        with span("count_file") as root:
            if cfg.parser_variant == "modern" and isinstance(
                source, (str, os.PathLike)
            ):
                with span("parse", parse) as parse_span:
                    parsed = native.parse_fasta_native(source, max_seqs=cfg.max_seqs)
                    parse_span.count("records", parsed.n_seqs)
                    parse_span.count("bytes", os.path.getsize(source))
                    parse_span.count("ranges", parsed.ranges)
                res = self.count_stream(
                    parsed.stream, parsed.total_bases, parsed.n_seqs
                )
            else:
                with span("parse", parse):
                    if cfg.parser_variant == "modern":
                        records = fasta.parse_fasta(source, max_seqs=cfg.max_seqs)
                    else:
                        records = fasta.parse_fasta_reference(
                            source, variant=cfg.parser_variant, max_seqs=cfg.max_seqs
                        )
                    seqs = [r.seq for r in records]
                res = self.count_sequences(seqs)
            res.phases["parse"] = parse["parse"]
            root.count("rows", res.codes.shape[0])
            root.count("table_on_card", res.table_on_card)
        return res


# ---------------------------------------------------------------------------
# Pairwise distances over sparse per-sequence tables
# ---------------------------------------------------------------------------

#: record length from which ``build_pair_tables`` counts a record's table
#: on the device (``SparseKmerEngine``, K1) rather than with the host
#: rolling counter, as the JAX package routes it
_TPU_TABLE_MIN_BASES = 4 << 20
#: default memory budgets, in bytes, of the dense [S, 4^k] counts matrix
#: (``dense_distance_feasible``) and of the union route's matrices
#: (``union_dense_plan``): the JAX package's defaults
DENSE_DIST_BUDGET = 2 << 30
UNION_DIST_BUDGET = 2 << 30
#: the union route's switch: "auto" asks the cost gate (and a card), "on"
#: takes the route wherever the budget and int32 gates admit it, "off"
#: never takes it
UNION_MODES = ("auto", "on", "off")
#: the threshold route's switch, the same three modes: "on" takes it
#: wherever the cap and the int32 gate admit it
THRESHOLD_MODES = UNION_MODES


@dataclass(frozen=True)
class DistanceRates:
    """The rates the distance gates predict with, in place of the JAX
    package's calibration file and environment. ``ops/calibrate`` measures
    them on the card and host it runs on (``kmer-gpu calibrate``) and
    loads them back as one of these.

    Defaults: one NVIDIA H100 80GB HBM3 at 700.00 W (``nvidia-smi``'s name
    and power limit) and its 8-core host, measured by ``chip_smoke.py``
    and, for the three K3 rates since K3/K4 split their bins,
    ``kmer-gpu calibrate`` (PERF.md, section 6):

    - ``bin_pairs_per_sec``: K3's (min,+) product at a union-matrix shape,
      [2,048, 131,072] (``ops/distance.tri_time_per_pair``), the rate
      ``union_dense_plan`` reads;
    - ``dense_bin_pairs_per_sec``: K3 at a dense [S, 4^k] counts matrix,
      [1,024, 4^9], the rate ``dense_distance_preferred`` reads (36 output
      tiles in 30 bin slices there, 136 in 8 at the union shape);
    - ``sparse_entry_pairs_per_sec_per_thread``: the native two-pointer,
      table entries of a pair stepped per second by one thread;
    - ``h2d_bytes_per_sec``, ``d2h_bytes_per_sec``: pinned copies to and
      from the card; ``roundtrip_s``: a job's fixed cost on the card (a
      launch, a copy and its wait);
    - ``threads``: the two-pointer's threads; ``None`` takes the native
      library's own count (the CPUs, at most 16);
    - ``peak_bin_pairs_per_sec``: K3 with every SM busy ([16,384, 64]),
      the most the two rates above reach at bins too few to split
      (``ops/distance.minplus_time``); at 64 bins K3 is bound by its
      stores, so this is below the wide-bin rates, where the split fills
      the card;
    - ``threshold_macs_per_sec``: the threshold route's int8
      multiply-adds a second, its planes' build included
      (``threshold_plan``);
    - ``sms``: the card's SMs, which ``ops/calibrate`` reads from it (the
      H100 SXM's 132 here): the route reaches its rate only where its
      output holds an output tile for each (``ops/distance.threshold_time``)."""

    bin_pairs_per_sec: float = dist_ops.TRI_BIN_PAIRS_PER_SEC
    dense_bin_pairs_per_sec: float = 1.32e13
    sparse_entry_pairs_per_sec_per_thread: float = 8.9e7
    h2d_bytes_per_sec: float = 5.4e10
    d2h_bytes_per_sec: float = 5.5e10
    roundtrip_s: float = 1.9e-4
    threads: int | None = None
    peak_bin_pairs_per_sec: float = dist_ops.PEAK_BIN_PAIRS_PER_SEC
    threshold_macs_per_sec: float = dist_ops.THRESHOLD_MACS_PER_SEC
    sms: int = 132

    def host_threads(self) -> int:
        if self.threads is not None:
            return max(int(self.threads), 1)
        return min(max(os.cpu_count() or 1, 1), 16)


def dense_distance_feasible(
    n_seqs: int, k: int, budget_bytes: int = DENSE_DIST_BUDGET
) -> bool:
    """Whether the dense distance path's [S, 4^k] int32 counts matrix fits
    ``budget_bytes``, as the JAX package models it: the rows padded to a
    power of two with a 128-row floor, and never 8 GiB or more (so k >= 12
    is never dense, whatever the budget). A memory gate, not a k
    threshold."""
    bins = 4**k
    s_padded = max(128, 1 << max(int(n_seqs) - 1, 0).bit_length())
    dense_bytes = s_padded * bins * 4
    if dense_bytes >= (8 << 30):
        return False
    return dense_bytes <= budget_bytes


def dense_distance_preferred(
    n_seqs: int,
    k: int,
    seq_lengths=None,
    budget_bytes: int = DENSE_DIST_BUDGET,
    rates: DistanceRates = DistanceRates(),
) -> bool:
    """Dense or sparse distances, by predicted cost: dense iff feasible
    and bins / dense_bin_pairs_per_sec <= avg_table / (entry rate *
    threads),
    where a table holds min(L - k + 1, 4^k) entries. k <= 8 and calls
    without lengths keep the dense route wherever it is feasible."""
    if not dense_distance_feasible(n_seqs, k, budget_bytes):
        return False
    if k <= 8 or seq_lengths is None:
        return True
    lengths = np.asarray(seq_lengths, dtype=np.float64)
    if lengths.size == 0:
        return True
    bins = 4**k
    avg_table = float(np.minimum(np.maximum(lengths - k + 1, 1), bins).mean())
    dense_s_per_pair = bins / rates.dense_bin_pairs_per_sec
    sparse_s_per_pair = avg_table / (
        rates.sparse_entry_pairs_per_sec_per_thread * rates.host_threads()
    )
    return dense_s_per_pair <= sparse_s_per_pair


def threshold_plan(
    cmax: int,
    row_sum_max: int,
    rows: int,
    cols: int,
    bins: int,
    *,
    alt_s: float,
    device: torch.device,
    mode: str = "auto",
    cap: int | None = None,
    rates: DistanceRates = DistanceRates(),
    info: dict | None = None,
) -> int | None:
    """The threshold route's cmax for a (min,+) product of [rows, bins]
    against [cols, bins] counts whose largest count is ``cmax`` and whose
    largest row sum is ``row_sum_max``, or None to keep K3/K4 (the JAX
    engine's ``_mxu_dist_cmax``, with the rates as arguments).

    Gates, in order:
    - ``mode``: "off" never plans; "auto" plans only on the card;
    - cmax rounds up to its power-of-two bucket (the thresholds past the
      largest count add exact zeros), which must be at most ``cap``
      (``THRESHOLD_CMAX_DEFAULT`` when None);
    - every row's window total below 2^31 (int32 exactness);
    - under "auto" without an explicit ``cap``, the route's predicted
      time over the whole rectangle (``ops/distance.threshold_time`` at
      ``rates.threshold_macs_per_sec``) below ``alt_s``, the predicted
      time of the K3 or K4 launch it would displace
      (``ops/distance.minplus_time``). An explicit cap skips the
      comparison, as the JAX package's does.

    ``info``, when given, takes the two predicted times and the bucket."""
    if mode not in THRESHOLD_MODES:
        raise ValueError(f"threshold must be one of {THRESHOLD_MODES}, got {mode!r}")
    if mode == "off" or (mode == "auto" and device.type != "cuda"):
        return None
    if cmax <= 0 or rows <= 0 or cols <= 0:
        return None
    bucket = 1 << (int(cmax) - 1).bit_length()
    limit = dist_ops.THRESHOLD_CMAX_DEFAULT if cap is None else int(cap)
    t_thr = dist_ops.threshold_time(rows, cols, bins, bucket, rates.threshold_macs_per_sec,
                                   rates.sms)
    if info is not None:
        info.update(threshold_cmax=bucket, t_threshold=t_thr, t_minplus=alt_s)
    if bucket > limit or row_sum_max >= 1 << 31:
        return None
    if mode == "auto" and cap is None and t_thr >= alt_s:
        return None
    return bucket


def counts_extent(counts: torch.Tensor) -> tuple[int, int]:
    """(largest count, largest row sum) of a counts matrix, in one read
    from its device; (0, 0) for no entries."""
    if not counts.numel():
        return 0, 0
    top, row = torch.stack(
        [counts.max().to(torch.int64), counts.sum(1, dtype=torch.int64).max()]).tolist()
    return int(top), int(row)


def sorted_unique(codes: np.ndarray) -> np.ndarray:
    """``np.unique(codes)`` by one sort and a neighbour compare (NumPy
    2.3's ``np.unique`` took 96 s for 40 M u64 codes where ``np.sort``
    took 0.68 s on the H100's host, PERF.md)."""
    u = np.sort(codes)
    return u[np.concatenate([[True], u[1:] != u[:-1]])] if u.size else u


def union_dense_plan(
    codes,
    cnts,
    offs,
    *,
    device: torch.device,
    union: str = "auto",
    budget_bytes: int = UNION_DIST_BUDGET,
    panel_rows: int | None = None,
    rates: DistanceRates = DistanceRates(),
    threshold: str = "auto",
    threshold_cap: int | None = None,
    info: dict | None = None,
) -> dict | None:
    """The plan of the union-indexed dense route, or None for the host
    two-pointer.

    The pairwise min-sum only touches codes that occur, so re-indexing
    every table against the sorted union of its codes gives a dense
    [S, D] counts matrix (D = the union's size) with the same min-sums:
    absent codes add min(0, .) = 0. Shapes are bucketed to powers of two
    (Sp rows, at least 8; Dp columns, at least 128), and zero rows and
    columns are exact. On the card K3 (one shot) or K4 (each streamed
    panel) take the product, or the threshold route over the [S, D]
    matrix where ``threshold_plan`` (``threshold``, ``threshold_cap``)
    takes it: the plan's ``impl`` "threshold", its ``cmax`` the bucket;
    on the CPU their plain versions.

    Gates, in order (None keeps the host two-pointer):
    - ``union``: "off" never plans; "auto" plans only on the card;
    - the int32 matrix on the device, at most 40 bytes a table entry
      while ``union_on_device`` builds it, and the output (the [Sp, Sp]
      square and its packed triangle, or one [panel_rows, Sp] panel)
      within ``budget_bytes``, and with the threshold route its planes
      (a byte a threshold and entry, at most the matrix's bytes; without
      the route where they would not fit);
    - every sequence's window total below 2^31 (int32 exactness);
    - under "auto", the predicted device time (K3 over the padded pairs,
      or the threshold route over the [S, S] square, half of it when
      streamed; the round trip, the H2D of the entries that
      ``union_on_device`` ships, and the [S, S] D2H) below the host
      two-pointer's (``rates``).

    Counts ship as int8 (the plan's ``dtype``) where the power-of-two
    bucket of the largest count is at most 127, else as int32.

    ``info``, when given, takes the predicted times as soon as they are
    known, also when the gate declines."""
    if union not in UNION_MODES:
        raise ValueError(f"union must be one of {UNION_MODES}, got {union!r}")
    if union == "off":
        return None
    S = int(offs.shape[0] - 1)
    N = int(codes.shape[0])
    if S < 2 or N == 0:
        return None
    on_card = device.type == "cuda"
    if union == "auto" and not on_card:
        return None
    codes_union = sorted_unique(codes)
    D = int(codes_union.shape[0])
    Sp = 1 << max(S - 1, 7).bit_length()
    Dp = 1 << max(D - 1, 127).bit_length()
    cmax_true = int(np.asarray(cnts).max(initial=0))
    cmax_b = 1 << max(cmax_true - 1, 0).bit_length() if cmax_true > 0 else 0
    dtype = np.int8 if cmax_b <= 127 else np.int32
    out_bytes = Sp * Sp * 8 if panel_rows is None else min(panel_rows, Sp) * Sp * 8
    approx_bytes = Sp * Dp * 4 + N * 40 + out_bytes
    if info is not None:
        info.update(union_bins=D, union_bytes=approx_bytes)
    if approx_bytes > budget_bytes:
        return None
    # Window totals by a cumsum at the fences (a sequence shorter than k
    # has an empty table).
    cs = np.concatenate([[0], np.cumsum(np.asarray(cnts, dtype=np.int64))])
    per_seq_windows = cs[np.asarray(offs[1:])] - cs[np.asarray(offs[:-1])]
    row_max = int(per_seq_windows.max()) if per_seq_windows.size else 0
    if row_max >= (1 << 31):
        return None
    pairs = S * (S - 1) / 2.0
    pairs_exec = Sp * (Sp - 1) / 2.0  # the padded rows run too
    t_dev_pair = dist_ops.tri_time_per_pair(Dp, rates.bin_pairs_per_sec)
    t_host_pair = (N / S) / (rates.sparse_entry_pairs_per_sec_per_thread * rates.host_threads())
    # The threshold route against the K3 launch (one shot) or the first
    # K4 panel it would displace.
    minplus = dict(rate=rates.bin_pairs_per_sec, rate_rows=dist_ops.UNION_RATE_ROWS,
                   peak=rates.peak_bin_pairs_per_sec)
    if panel_rows is None:
        rows, alt_s = S, dist_ops.minplus_time(Sp, Sp, Dp, True, **minplus)
    else:
        rows = min(panel_rows, S)
        alt_s = dist_ops.minplus_time(min(panel_rows, Sp), Sp, Dp, False, **minplus)
    cmax_thr = threshold_plan(cmax_true, row_max, rows, S, D, alt_s=alt_s, device=device,
                              mode=threshold, cap=threshold_cap, rates=rates, info=info)
    # The planes: a byte a threshold and entry of the matrix, at most the
    # matrix's own bytes (``threshold_cuda.plane_chunks``).
    planes = min(cmax_thr or 0, 4) * Sp * Dp
    if cmax_thr is not None and approx_bytes + max(
            planes, threshold_cuda.MIN_PLANE_BYTES) > budget_bytes:
        cmax_thr = None
    if cmax_thr is None:
        t_min_sum = pairs_exec * t_dev_pair
    else:
        t_min_sum = dist_ops.threshold_time(S, S, D, cmax_thr, rates.threshold_macs_per_sec,
                                            rates.sms)
        t_min_sum *= 1.0 if panel_rows is None else 0.5
    t_dev_total = (
        t_min_sum
        + rates.roundtrip_s
        + union_ship_bytes(N, D, S, dtype) / rates.h2d_bytes_per_sec
        + S * S * 4 / rates.d2h_bytes_per_sec
    )
    t_host_total = pairs * t_host_pair
    if info is not None:
        info.update(t_dev_total=t_dev_total, t_host_total=t_host_total)
    if union == "auto" and t_dev_total >= t_host_total:
        return None
    if cmax_thr is not None:
        impl = "threshold"
    else:
        impl = "cuda" if on_card else "plain"
    return {
        "union": codes_union,
        "D": D,
        "Sp": Sp,
        "Dp": Dp,
        "cmax": cmax_b,
        "cmax_true": cmax_true,
        "dtype": dtype,
        "impl": impl,
        "t_dev_total": t_dev_total,
        "t_host_total": t_host_total,
        "t_host_pair": t_host_pair,
    }


def union_ship_bytes(n_entries: int, n_union: int, n_seqs: int, dtype) -> int:
    """Bytes ``union_on_device`` ships: each entry's code (8) and count
    (``dtype``), the union's codes and the table fences (8 each)."""
    return n_entries * (8 + np.dtype(dtype).itemsize) + (n_union + n_seqs) * 8


def union_on_device(codes, cnts, offs, plan, device: torch.device) -> torch.Tensor:
    """The [Sp, Dp] int32 union-indexed counts matrix of a plan, built on
    ``device`` from the tables' entries (``union_ship_bytes``, not the
    Sp x Dp matrix, cross the link): each entry's column is its code's
    rank in the union (``torch.searchsorted``; codes of k <= 31 fit an
    int64), its count (shipped as the plan's ``dtype``) is widened to
    int32 and scattered into a zeroed matrix there."""
    S = int(offs.shape[0] - 1)
    codes_d = host_to_device(np.ascontiguousarray(codes, np.uint64).view(np.int64), device)
    union_d = host_to_device(plan["union"].view(np.int64), device)
    cnts_d = host_to_device(np.asarray(cnts).astype(plan["dtype"]), device)
    sizes = host_to_device(np.diff(offs).astype(np.int64), device)
    rows = torch.repeat_interleave(
        torch.arange(S, device=device), sizes, output_size=codes_d.shape[0])
    mat = torch.zeros(plan["Sp"], plan["Dp"], dtype=torch.int32, device=device)
    mat[rows, torch.searchsorted(union_d, codes_d)] = cnts_d.to(torch.int32)
    return mat


def union_product(mat: torch.Tensor, plan: dict, r0: int, r1: int, S: int, mesh=None):
    """The int32 min-sums of the union matrix's rows [r0, r1) against its
    rows from r0 on, by the plan's route: the threshold route over the
    real [S, D] part (rows [r0, r1) against [r0, S)), else K3 over the
    whole padded square (``r0 == 0``, ``r1 == S``, one shot) or K4 over
    rows [r0, r1) against [r0, S) (a panel); a panel over a ``mesh``
    shards the partner rows (``engine.min_sum_panel_mesh``)."""
    cmax = plan["cmax"] if plan["impl"] == "threshold" else None
    if cmax is not None:
        mat = mat[:, : plan["D"]]
    panel, other = mat[r0:r1], mat[r0:S]
    if mesh is not None:
        return min_sum_panel_mesh(panel, other, mesh, threshold=cmax)
    if cmax is not None:
        return threshold_cuda.min_sum_matrix_threshold(
            panel, cmax, None if (r0, r1) == (0, S) else other)
    if (r0, r1) == (0, S):
        return distance_cuda.min_sum_matrix_tri(mat)
    return distance_cuda.min_sum_matrix_rect(panel, other)


def union_dense_min_sums(codes, cnts, offs, plan, device: torch.device) -> np.ndarray:
    """Run a plan in one shot: the packed strict-upper-triangle int64
    min-sums of the [S, S] product over the union matrix (K3 or the
    threshold route on the card, their plain versions on the CPU; the
    padding rows sliced off on the device before the copy to the host).
    A failing kernel raises."""
    S = int(offs.shape[0] - 1)
    mat = union_on_device(codes, cnts, offs, plan, device)
    sq = union_product(mat, plan, 0, S, S)[:S, :S].cpu().numpy()
    out = np.empty(S * (S - 1) // 2, dtype=np.int64)
    w = 0
    for i in range(S - 1):
        m = S - 1 - i
        out[w : w + m] = sq[i, i + 1 :]
        w += m
    return out


def min_sum_pairs_python(codes, counts, offs) -> np.ndarray:
    """NumPy twin of ``native.min_sum_pairs_native``: the packed pair
    min-sums by ``np.intersect1d`` per pair."""
    return min_sum_panel_python(codes, counts, offs, 0, offs.shape[0] - 2)


def min_sum_panel_python(codes, counts, offs, r0: int, r1: int) -> np.ndarray:
    """NumPy twin of ``native.min_sum_panel_native``: the pair min-sums of
    rows [r0, r1), packed from row r0 on."""
    S = offs.shape[0] - 1
    r0, r1 = max(r0, 0), min(r1, max(S - 1, 0))
    if r0 >= r1:
        return np.zeros(0, dtype=np.int64)
    parts = []
    for i in range(r0, r1):
        ci = codes[offs[i] : offs[i + 1]]
        ni = counts[offs[i] : offs[i + 1]]
        row = np.zeros(S - 1 - i, dtype=np.int64)
        for w, j in enumerate(range(i + 1, S)):
            cj = codes[offs[j] : offs[j + 1]]
            nj = counts[offs[j] : offs[j + 1]]
            _, ia, ib = np.intersect1d(ci, cj, assume_unique=True, return_indices=True)
            row[w] = np.minimum(ni[ia], nj[ib]).sum()
        parts.append(row)
    return np.concatenate(parts)


def _finish_packed_rows(
    flat_sums: np.ndarray, lengths: np.ndarray, k: int, r0: int, r1: int
) -> np.ndarray:
    """Packed min-sums of rows r0..r1-1 -> float32 distances, a row at a
    time: 1 - s / (min(L_i, L_j) - k + 1) with NumPy's IEEE division."""
    S = lengths.shape[0]
    out = np.empty(flat_sums.shape[0], dtype=np.float32)
    w = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(r0, r1):
            m = S - 1 - i
            denom = (np.minimum(lengths[i], lengths[i + 1 :]) - k + 1).astype(np.float32)
            out[w : w + m] = np.float32(1.0) - flat_sums[w : w + m].astype(np.float32) / denom
            w += m
    return out


def finish_distances_packed(sums: np.ndarray, lengths: np.ndarray, k: int) -> np.ndarray:
    """All packed pair min-sums -> float32 distances (the host finish, a
    row at a time, with no [S, S] array)."""
    S = lengths.shape[0]
    return _finish_packed_rows(sums, lengths, k, 0, max(S - 1, 0))


def build_pair_tables(
    seqs: list[str], k: int, canonical: bool = False, device: torch.device | str = "cuda"
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-sequence sorted-unique tables, concatenated: (codes_u64,
    counts_i64, offs_i64[S+1]), sequence i's table at [offs[i],
    offs[i+1]). Records shorter than ``_TPU_TABLE_MIN_BASES`` are counted
    together by the native host counter (``native.count_tables_native``,
    one threaded call; each table equals ``count_sparse_host_native`` of
    the record alone), each longer one by ``SparseKmerEngine`` on
    ``device`` (K1 on the card)."""
    device = runtime.resolve_device(device)
    short = [i for i, s in enumerate(seqs) if len(s) < _TPU_TABLE_MIN_BASES]
    codes, cnts, offs = native.count_tables_native(
        *seq_stream([seqs[i] for i in short]), k, canonical)
    if len(short) == len(seqs):
        return codes, cnts, offs
    engine = SparseKmerEngine(KmerConfig(k=k, canonical=canonical), device=device)
    parts: list[tuple[np.ndarray, np.ndarray]] = []
    j = 0  # the next short record's table
    for i, s in enumerate(seqs):
        if j < len(short) and short[j] == i:
            parts.append((codes[offs[j] : offs[j + 1]], cnts[offs[j] : offs[j + 1]]))
            j += 1
        else:
            sp = engine.count_sequences([s])
            parts.append((sp.codes, sp.counts))
    out_offs = np.concatenate([[0], np.cumsum([c.size for c, _ in parts])]).astype(np.int64)
    return (np.concatenate([c for c, _ in parts]), np.concatenate([n for _, n in parts]),
            out_offs)


def distance_sparse_packed(
    seqs: list[str],
    k: int,
    canonical: bool = False,
    *,
    device: str | torch.device = "cuda",
    union: str = "auto",
    union_budget_bytes: int = UNION_DIST_BUDGET,
    rates: DistanceRates = DistanceRates(),
    threshold: str = "auto",
    threshold_cap: int | None = None,
    info: dict | None = None,
) -> np.ndarray:
    """Packed strict-upper-triangle float32 distances over sparse
    per-sequence tables, at any k from 1 to 31: where the dense [S, 4^k]
    counts matrix cannot exist (every k > 15, and mid k past the memory
    budget).

    The tables come from ``build_pair_tables``. Where ``union_dense_plan``
    takes the union route, K3 or the threshold route (``threshold``,
    ``threshold_cap``: ``threshold_plan``'s mode and cap) takes the
    min-sums over the union matrix on the card; otherwise the native
    threaded two-pointer does on the host.
    A kernel that fails raises: nothing falls back to the host. The
    float32 finish runs on the host either way.

    ``info``, when given, receives the route ("union/cuda",
    "union/threshold", "union/plain" or "host/sparse"), the plan's
    predictions and the seconds of each phase (tables, plan, min_sum,
    finish)."""
    dev = runtime.resolve_device(device)
    phases: dict[str, float] = {}
    info = {} if info is None else info
    with span("tables", phases):
        codes, cnts, offs = build_pair_tables(seqs, k, canonical, dev)
        lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    with span("plan", phases):
        plan = union_dense_plan(
            codes, cnts, offs, device=dev, union=union, budget_bytes=union_budget_bytes,
            rates=rates, threshold=threshold, threshold_cap=threshold_cap, info=info,
        )
    with span("min_sum", phases):
        if plan is not None:
            sums = union_dense_min_sums(codes, cnts, offs, plan, dev)
            info.update(route=f"union/{plan['impl']}", cmax=plan["cmax"])
        else:
            sums = native.min_sum_pairs_native(codes, cnts, offs)
            info["route"] = "host/sparse"
    with span("finish", phases):
        out = finish_distances_packed(sums, lengths, k)
    info["phases"] = phases
    return out


def make_sparse_panel_fn(
    codes,
    cnts,
    offs,
    lengths,
    k: int,
    panel_rows: int,
    *,
    device: str | torch.device = "cuda",
    mesh=None,
    union: str = "auto",
    union_budget_bytes: int = UNION_DIST_BUDGET,
    rates: DistanceRates = DistanceRates(),
    threshold: str = "auto",
    threshold_cap: int | None = None,
    info: dict | None = None,
):
    """Panel closure over per-sequence sparse tables: panel_fn(r0, r1) ->
    float32 packed distances of rows r0..r1-1 (row i: columns i+1..S-1),
    the sparse twin of ``KmerEngine.make_dense_panel_fn``.

    One decision a job: where ``union_dense_plan`` takes the union route,
    the union matrix goes to the device once (widened to int32 there) and
    every panel is one K4 (or threshold route, as the plan says) of its
    rows against the rows from r0 on (over a ``mesh``, those partner rows
    padded to a multiple of D and sharded, one a shard:
    ``engine.min_sum_panel_mesh``); else every panel runs the
    native two-pointer (``kp_min_sum_panel``), which no mesh shards. The
    finish runs on the host."""
    dev = runtime.resolve_device(device)
    S = int(offs.shape[0] - 1)
    lengths = np.asarray(lengths, dtype=np.int64)
    info = {} if info is None else info
    plan = union_dense_plan(
        codes, cnts, offs, device=dev, union=union, budget_bytes=union_budget_bytes,
        panel_rows=panel_rows, rates=rates, threshold=threshold, threshold_cap=threshold_cap,
        info=info,
    )
    if plan is not None:
        mat = union_on_device(codes, cnts, offs, plan, dev)
        info.update(route=f"union/{plan['impl']}", cmax=plan["cmax"], streamed=True)

        def panel_fn(r0: int, r1: int) -> np.ndarray:
            sums = union_product(mat, plan, r0, r1, S, mesh).cpu().numpy()
            return dist_ops.finish_upper(sums, lengths[r0:r1], lengths[r0:], k, r0, r0)

        return panel_fn

    info.update(route="host/sparse", streamed=True)

    def panel_fn_host(r0: int, r1: int) -> np.ndarray:
        sums = native.min_sum_panel_native(codes, cnts, offs, r0, r1)
        return _finish_packed_rows(sums, lengths, k, r0, r1)

    return panel_fn_host


def distance_sparse_stream_to_csv(
    seqs: list[str],
    k: int,
    output_path,
    canonical: bool = False,
    *,
    panel_rows: int = 2048,
    checkpoint_path=None,
    max_panels: int | None = None,
    mesh=None,
    row_lo: int = 0,
    row_hi: int | None = None,
    device: str | torch.device = "cuda",
    union: str = "auto",
    union_budget_bytes: int = UNION_DIST_BUDGET,
    rates: DistanceRates = DistanceRates(),
    threshold: str = "auto",
    threshold_cap: int | None = None,
    info: dict | None = None,
) -> dict:
    """Streamed, resumable sparse distances to the reference's CSV: panels
    of ``panel_rows`` rows from ``make_sparse_panel_fn`` go through
    ``distance_stream.stream_panels_to_csv`` (fsync, then checkpoint; a
    resumed run is byte-identical). The tables are rebuilt on every leg,
    resumed or not. row_lo/row_hi bound the rows this writer owns. The
    result carries the writer's keys, ``route`` and ``phases`` (tables,
    and the writer's write). ``mesh``: see ``make_sparse_panel_fn``."""
    phases: dict[str, float] = {}
    with span("tables", phases):
        dev = runtime.resolve_device(device)
        codes, cnts, offs = build_pair_tables(seqs, k, canonical, dev)
        lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    info = {} if info is None else info
    panel_fn = make_sparse_panel_fn(
        codes, cnts, offs, lengths, k, panel_rows, device=dev, mesh=mesh, union=union,
        union_budget_bytes=union_budget_bytes, rates=rates, threshold=threshold,
        threshold_cap=threshold_cap, info=info,
    )
    meta = {
        "k": k,
        "canonical": canonical,
        "n_seqs": len(seqs),
        "regime": "sparse",
        "input_sha": distance_stream.input_fingerprint(seqs),
    }
    report = distance_stream.stream_panels_to_csv(
        output_path, len(seqs), panel_rows, panel_fn, meta=meta,
        checkpoint_path=checkpoint_path, max_panels=max_panels,
        row_lo=row_lo, row_hi=row_hi,
    )
    report["route"] = info["route"]
    report["phases"] = {"tables": phases["tables"], "write": report["write_s"]}
    return report
