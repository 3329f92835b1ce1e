"""Resumable streaming counter: batches, metrics, checkpoint and resume.

The port of ``dna_kmeres_parallel_tpu/models/pipeline.py``'s
``StreamingCounter``: native parse -> flat base stream -> fixed-shape
batches -> a periodic checkpoint of (partial counts, stream cursor), so a
run that is stopped or killed resumes at a batch boundary. The
checkpoint file is the JAX package's (``utils/checkpoint.py``), so a run
of either package resumes in the other.

Per batch, a one-thread prefetcher pads the next batch and stages it on
the host (planes or u8 bases, in pinned memory) while the main thread
ships the current one and launches its kernel. Every copy and kernel
runs on the main thread's current stream, so stream order alone orders
a batch's H2D copy, its kernel and the D2H copy of its words; the
prefetch thread never touches the card's streams.

- Dense (4^k <= 65,536, k <= 8): one int32 accumulator on the device,
  added into the host int64 histogram before a batch that could take it
  past ``engine.FLUSH_WINDOWS`` windows (``engine.flush_first``) and at
  every checkpoint.
- k = 9..12: counted by the sparse arm and densified at the end, as the
  JAX counter does; its checkpoints are sparse tables.
- Sparse: ``compact`` picks where each batch's table is built.
  ``"device"``: the card encodes (K1 from planes, K9 from u8 bases), the
  words come back into pinned memory, and the native radix compactor
  builds the table; batch t is drained only after batch t+1 has been
  dispatched. With ``device_sort=True`` the card also sorts the words
  (rows of ``sort_row_len``, K11 for single-word rows with
  ``pallas_sort``, or one flat sort) and the native compactor of sorted
  words builds the table. ``"device-rle"``: the card sorts flat and
  collapses the runs; only the distinct (code, count) prefix comes back.
  ``"host"``: the native engine counts the host-resident stream (nothing
  crosses the link). ``"auto"``: device batches 2-3 and host batch 4
  race, the faster route carries on, and every ``_COMPACT_RECHECK``-th
  batch re-probes the loser, flipping when its EWMA rate beats the
  winner's by ``_COMPACT_HYSTERESIS``.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
``compact="device-super"`` (super-k-mer records) and a mesh. The JAX
counter's "auto" also probes the super-k-mer records as a sub-route of
its device arm; that probe stays off here until ``device-super`` is
ported, which changes which route runs and never a table.
"""

from __future__ import annotations

import itertools
import math
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import sparse_engine
from dna_kmeres_parallel_tpu_torch.models.engine import (
    CountResult,
    KmerEngine,
    batch_plan,
    flush_first,
    host_to_device,
    pin_host,
)
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
    MergeLadder,
    SparseCountResult,
    dense_from_sparse,
)
from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda, runtime
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops
from dna_kmeres_parallel_tpu_torch.utils import checkpoint as ckpt_mod
from dna_kmeres_parallel_tpu_torch.utils import codec, fasta
from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig
from dna_kmeres_parallel_tpu_torch.utils.metrics import Metrics
from dna_kmeres_parallel_tpu_torch.utils.profiling import trace

#: 'auto': after the initial race, every Nth batch runs on the LOSING
#: route to refresh its EWMA rate (0 = never re-probe)
_COMPACT_RECHECK = 16
#: 'auto' flips routes only when the loser's EWMA rate beats the winner's
#: by this factor (a guard against flapping)
_COMPACT_HYSTERESIS = 1.25

#: exception names or messages that mark a failure worth retrying
_TRANSIENT = ("Internal", "Unavailable", "DataLoss", "RESOURCE")


def _prefetched(items, fn, depth: int = 2):
    """Yield (item, fn(item)) over items, fn running one or two items
    ahead on one worker thread: batch i+1's host staging overlaps batch
    i's device work and host compaction."""
    it = iter(items)
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = deque()
        for item in itertools.islice(it, depth):
            futs.append((item, ex.submit(fn, item)))
        for item in it:
            done_item, fut = futs.popleft()
            yield done_item, fut.result()
            futs.append((item, ex.submit(fn, item)))
        while futs:
            done_item, fut = futs.popleft()
            yield done_item, fut.result()


def _count_batch(eng: KmerEngine, staged: tuple, n_own: int, acc: torch.Tensor) -> None:
    """The dense arm's device call: ship one staged batch and add its
    histogram into ``acc`` (``KmerEngine._ship_and_count``)."""
    eng._ship_and_count(staged, n_own, acc)


def _start_fetch(words: tuple):
    """Enqueue the copy of a batch's word planes into pinned host memory
    behind its kernel, and an event after the copies. Returns (the host
    planes, the event); on the CPU the planes as they are and None."""
    if words[0].device.type != "cuda":
        return words, None
    host = []
    for w in words:
        out = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
        out.copy_(w, non_blocking=True)
        host.append(out)
    ready = torch.cuda.Event()
    ready.record()
    return tuple(host), ready


class StreamingCounter:
    """Streamed, resumable, metered counting over a FASTA file or stream,
    or a list of them."""

    def __init__(
        self,
        config: KmerConfig | None = None,
        device: str | torch.device = "cuda",
        checkpoint_path: str | None = None,
        checkpoint_every_bases: int = 1 << 28,
        max_batches: int | None = None,
        max_retries: int = 2,
        trace_dir: str | None = None,
        pallas_sort: bool = False,
    ):
        """device: "cuda" (the kernels; raises without CUDA) or "cpu" (the
        kernels' plain versions). checkpoint_path: where the checkpoint is
        read at the start and written every checkpoint_every_bases bases
        and at the end. max_batches: stop after N batches, checkpointing
        the progress (bounded work slices, and crash simulation in tests).
        max_retries: transient failures of a batch's device call are
        retried this many times before they surface. trace_dir: write a
        ``torch.profiler`` trace of the run there. pallas_sort: with
        ``device_sort=True``, sort single-word rows with the row-sort
        kernel K11 (``SparseKmerEngine``'s argument)."""
        self.config = config or KmerConfig()
        if math.prod(self.config.mesh_shape) > 1:
            raise NotImplementedError(
                "a mesh (data-parallel streaming over several cards) is not "
                "ported yet (ROADMAP item 10)"
            )
        self.device = runtime.resolve_device(device)
        sparse_engine.require_native()
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every_bases = checkpoint_every_bases
        self.max_batches = max_batches
        self.max_retries = max_retries
        self.trace_dir = trace_dir
        self.pallas_sort = pallas_sort
        self.metrics = Metrics()

    def _with_retry(self, fn):
        """Run fn(), retrying the failures whose type name or message
        names a transient cause. A launch that fails raises here; a fault
        during a kernel's run surfaces at the next wait for the device,
        and a poisoned CUDA context is never retried (its errors carry
        none of the transient names)."""
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except Exception as e:
                name = type(e).__name__
                transient = any(t in name or t in str(e) for t in _TRANSIENT)
                if not transient or attempt == self.max_retries:
                    raise
                self.metrics.count("batch_retries")

    # ------------------------------------------------------------------
    def _load_stream(self, source):
        cfg = self.config
        if isinstance(source, (list, tuple)):
            # Several files: their streams joined by one separator (no
            # window spans two files); max_seqs counts across the files.
            streams, total_bases, n_seqs = [], 0, 0
            saved_max = cfg.max_seqs
            for s in source:
                if saved_max is not None and n_seqs >= saved_max:
                    break
                if saved_max is not None:
                    self.config = cfg.replace(max_seqs=saved_max - n_seqs)
                try:
                    flat, tb, ns = self._load_stream(s)
                finally:
                    self.config = cfg
                if streams and flat.size:
                    streams.append(np.array([codec.INVALID_BASE], np.uint8))
                streams.append(flat)
                total_bases += tb
                n_seqs += ns
            flat = np.concatenate(streams) if streams else np.zeros(0, np.uint8)
            return flat, total_bases, n_seqs
        with self.metrics.phase("parse"):
            if cfg.parser_variant == "modern" and isinstance(source, (str, os.PathLike)):
                parsed = native.parse_fasta_native(source, max_seqs=cfg.max_seqs)
                self.metrics.count("invalid_bases", parsed.invalid_bases)
                return parsed.stream, parsed.total_bases, parsed.n_seqs
            if cfg.parser_variant == "modern":
                records = fasta.parse_fasta(source, max_seqs=cfg.max_seqs)
            else:
                records = fasta.parse_fasta_reference(
                    source, variant=cfg.parser_variant, max_seqs=cfg.max_seqs
                )
            seqs = [r.seq for r in records]
            return codec.concat_with_sentinels(seqs), sum(map(len, seqs)), len(seqs)

    def _maybe_resume(self, total: int):
        cfg = self.config
        if not self.checkpoint_path or not os.path.exists(self.checkpoint_path):
            return None
        ck = ckpt_mod.load_checkpoint(self.checkpoint_path)
        if ck.k != cfg.k or ck.canonical != cfg.canonical or ck.cursor > total:
            return None  # incompatible checkpoint: start fresh
        return ck

    def _save(self, cursor: int, total_bases: int, hist=None, sparse=None):
        if not self.checkpoint_path:
            return
        with self.metrics.phase("checkpoint"):
            ck = ckpt_mod.CountCheckpoint(
                k=self.config.k,
                canonical=self.config.canonical,
                cursor=cursor,
                total_bases=total_bases,
                hist=hist,
                sparse_codes=sparse[0] if sparse else None,
                sparse_counts=sparse[1] if sparse else None,
            )
            ckpt_mod.save_checkpoint(self.checkpoint_path, ck)
            self.metrics.count("checkpoints")

    def _batches(self, total: int, start: int):
        """(start, end, T) of every batch from the cursor on: each owns the
        windows that start in [start, end) and is padded to T bases."""
        batch, T = batch_plan(total, self.config.k, self.config.batch_bases)
        for pos in range(start, total, batch):
            yield pos, min(pos + batch, total), T

    def _padded(self, flat: np.ndarray, start: int, end: int, T: int) -> np.ndarray:
        """Bases [start, end + k - 1) of the stream, padded with the
        separator to T."""
        seg = flat[start : min(end + self.config.k - 1, flat.shape[0])]
        padded = np.full(T, codec.INVALID_BASE, dtype=np.uint8)
        padded[: seg.shape[0]] = seg
        return padded

    # ------------------------------------------------------------------
    def run(self, source):
        """Count a FASTA source (a path, a text stream, or a list of
        them). Returns CountResult (dense, k <= 12 by default) or
        SparseCountResult (sorted table)."""
        cfg = self.config
        t0 = time.perf_counter()
        flat, total_bases, n_seqs = self._load_stream(source)
        with trace(self.trace_dir):
            if not cfg.dense:
                return self._run_sparse(flat, total_bases, n_seqs, t0)
            if cfg.bins <= histogram_cuda.MAX_BINS:
                return self._run_dense(flat, total_bases, n_seqs, t0)
            # k = 9..12: count sparse, densify once at the end.
            sp = self._run_sparse(flat, total_bases, n_seqs, t0)
            return CountResult(
                k=cfg.k,
                canonical=cfg.canonical,
                hist=dense_from_sparse(sp, cfg.bins),
                n_seqs=n_seqs,
                total_bases=total_bases,
                elapsed_s=time.perf_counter() - t0,
            )

    def _run_dense(self, flat, total_bases, n_seqs, t0) -> CountResult:
        cfg, dev = self.config, self.device
        eng = KmerEngine(cfg, device=dev)
        total = flat.shape[0]
        hist = np.zeros(cfg.bins, dtype=np.int64)
        cursor = 0
        ck = self._maybe_resume(total)
        if ck is not None and ck.dense:
            hist = ck.hist.astype(np.int64)
            cursor = ck.cursor
            self.metrics.count("resumed_from_base", cursor)

        acc = torch.zeros(cfg.bins, dtype=torch.int32, device=dev)
        acc_windows = 0
        since_ckpt = 0
        done_batches = 0
        stopped = False

        def flush() -> None:
            nonlocal acc_windows
            if acc_windows:
                hist[:] += acc.cpu().numpy()  # waits for the queued batches
                acc.zero_()
                acc_windows = 0

        def prep(bounds):
            start, end, T = bounds
            return pin_host(eng._stage(self._padded(flat, start, end, T)), dev)

        for (start, end, _), staged in _prefetched(self._batches(total, cursor), prep):
            if self.max_batches is not None and done_batches >= self.max_batches:
                # Early stop: checkpoint this boundary, and not the end.
                flush()
                self._save(start, total_bases, hist=hist)
                stopped = True
                break
            done_batches += 1
            if flush_first(acc_windows, end - start, cfg.batch_bases):
                flush()
            with self.metrics.phase("device"):
                self._with_retry(lambda: _count_batch(eng, staged, end - start, acc))
            self.metrics.count("bases", end - start)
            self.metrics.count("batches")
            since_ckpt += end - start
            acc_windows += end - start
            if since_ckpt >= self.checkpoint_every_bases:
                flush()
                self._save(end, total_bases, hist=hist)
                since_ckpt = 0
        flush()
        if not stopped:
            self._save(total, total_bases, hist=hist)
        return CountResult(
            k=cfg.k,
            canonical=cfg.canonical,
            hist=hist,
            n_seqs=n_seqs,
            total_bases=total_bases,
            elapsed_s=time.perf_counter() - t0,
        )

    def _resolve_compact(self) -> bool | None:
        """KmerConfig.compact -> host_mode: True counts on the host, False
        on the device, None is undecided ('auto': race, then re-check)."""
        cfg = self.config
        if cfg.compact == "device-super":
            raise NotImplementedError(
                "compact='device-super' (super-k-mer records) is not ported "
                "yet (ROADMAP item 11)"
            )
        if cfg.compact == "host":
            return True
        if cfg.compact in ("device", "device-rle"):
            return False
        return None

    def _run_sparse(self, flat, total_bases, n_seqs, t0) -> SparseCountResult:
        cfg, dev = self.config, self.device
        k, canonical = cfg.k, cfg.canonical
        total = flat.shape[0]
        host_mode = self._resolve_compact()
        tables = MergeLadder()
        cursor = 0
        ck = self._maybe_resume(total)
        if ck is not None and not ck.dense:
            tables.push((ck.sparse_codes, ck.sparse_counts))
            cursor = ck.cursor
            self.metrics.count("resumed_from_base", cursor)

        since_ckpt = 0
        done_batches = 0
        stopped = False
        # 'auto': EWMA bases/s of each route. The first decision races the
        # drain walls of device batches 2 and 3 (batch 1 pays the kernels'
        # load) against host batch 4, and is re-checked for the rest of
        # the stream.
        adaptive = host_mode is None
        rate: dict[str, float | None] = {"device": None, "host": None}

        def rate_update(key: str, n_bases: int, wall: float) -> None:
            r = n_bases / max(wall, 1e-9)
            rate[key] = r if rate[key] is None else 0.5 * rate[key] + 0.5 * r

        def stage(start: int, end: int, T: int):
            padded = self._padded(flat, start, end, T)
            return pin_host(sparse_engine.stage_words(padded, cfg.pack_input), dev)

        def prep(bounds):
            # Reads the CURRENT mode: around an 'auto' flip the thread may
            # stage a batch or two that the host route then never ships.
            return None if host_mode is True else stage(*bounds)

        # The device arm's output: "words" (unsorted, radix compaction),
        # "sorted" (device_sort: the compactor of sorted words or rows) or
        # "rle" (distinct codes and counts, fetched by their count).
        kind = "rle" if cfg.compact == "device-rle" else (
            "sorted" if cfg.device_sort else "words")

        # Software pipelining: batch t is drained (words to the host,
        # compaction) only after batch t+1 has been dispatched.
        pending = None  # (words, ready event, start, end, batch number)

        def book(p_start: int, p_end: int) -> None:
            nonlocal since_ckpt
            self.metrics.count("bases", p_end - p_start)
            self.metrics.count("batches")
            since_ckpt += p_end - p_start
            if since_ckpt >= self.checkpoint_every_bases:
                # A full merge only serves the checkpoint's snapshot.
                if self.checkpoint_path:
                    with self.metrics.phase("merge"):
                        snap = tables.result()
                        tables.reset_to(snap)
                    self._save(p_end, total_bases, sparse=snap)
                since_ckpt = 0

        def maybe_flip() -> None:
            nonlocal host_mode
            if not adaptive or host_mode is None:
                return
            if rate["device"] is None or rate["host"] is None:
                return
            cur, other = ("host", "device") if host_mode else ("device", "host")
            if rate[other] > _COMPACT_HYSTERESIS * rate[cur]:
                host_mode = not host_mode
                self.metrics.count("compact_mode_flips")

        def drain(p) -> None:
            words, ready, p_start, p_end, p_idx = p
            t_d = time.perf_counter()
            with self.metrics.phase("compact"):
                with self.metrics.phase("fetch"):
                    if ready is not None:
                        ready.synchronize()
                    if kind == "rle":
                        table = sparse_engine.table_from_rle(*words)
                    else:
                        host = sparse_engine.fetch_words(words)
                if kind == "sorted":
                    table = sparse_engine.compact_table(host)
                elif kind == "words":
                    table = sparse_engine.compact_unsorted(host, k)
                tables.push(table)
            if adaptive and p_idx >= 2:
                # The device route's whole cost per batch in the pipelined
                # steady state: the wait for the device and the D2H copy,
                # then the compaction.
                rate_update("device", p_end - p_start, time.perf_counter() - t_d)
                maybe_flip()
            book(p_start, p_end)

        for (start, end, T), staged in _prefetched(self._batches(total, cursor), prep):
            if self.max_batches is not None and done_batches >= self.max_batches:
                if pending is not None:
                    drain(pending)
                    pending = None
                with self.metrics.phase("merge"):
                    snap = tables.result()
                    tables.reset_to(snap)
                self._save(start, total_bases, sparse=snap)
                stopped = True
                break
            done_batches += 1
            # Once decided, every _COMPACT_RECHECK-th batch runs on the
            # losing route to refresh its rate.
            probe = (
                adaptive
                and host_mode is not None
                and _COMPACT_RECHECK > 0
                and done_batches % _COMPACT_RECHECK == 0
            )
            if host_mode is None:
                use_host = done_batches == 4
            else:
                use_host = host_mode != probe
            if use_host:
                # Count off the host-resident stream: the segment carries the
                # k-1 halo, so it owns exactly the windows starting in
                # [start, end).
                if pending is not None:
                    drain(pending)
                    pending = None
                seg = flat[start : min(end + k - 1, total)]
                t_h = time.perf_counter()
                with self.metrics.phase("host_count"):
                    tables.push(native.count_sparse_host_native(seg, k, canonical))
                if adaptive:
                    rate_update("host", end - start, time.perf_counter() - t_h)
                book(start, end)
                if adaptive and host_mode is None and None not in rate.values():
                    host_mode = rate["host"] > rate["device"]
                    self.metrics.count("compact_host_selected", int(host_mode))
                elif adaptive:
                    maybe_flip()
                continue
            if staged is None:  # staged for the host route: stage it now
                staged = stage(start, end, T)
            with self.metrics.phase("device"):
                n_own = end - start
                words = self._with_retry(
                    lambda: sparse_engine.encode_staged(
                        tuple(host_to_device(a, dev) for a in staged), n_own, k, canonical
                    )
                )
                if kind == "sorted":
                    words = sparse_ops.sort_encoded(
                        words, n_own, cfg.sort_row_len, self.pallas_sort)
                if kind == "rle":
                    words = sparse_ops.rle_sorted(sparse_ops.sort_encoded(words, n_own, 0))
                    ready = None  # the drain waits on n_distinct
                else:
                    words, ready = _start_fetch(words)
            if pending is not None:
                drain(pending)
            pending = (words, ready, start, end, done_batches)
        if pending is not None:
            drain(pending)
        with self.metrics.phase("merge"):
            codes, counts = tables.result()
        if not stopped:
            self._save(total, total_bases, sparse=(codes, counts))
        return SparseCountResult(
            k=k,
            canonical=canonical,
            codes=codes,
            counts=counts,
            n_seqs=n_seqs,
            total_bases=total_bases,
            elapsed_s=time.perf_counter() - t0,
        )
