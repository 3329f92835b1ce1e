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
- Sparse: ``compact`` picks, once for the run, where every batch's table
  is built (``StreamingCounter._resolve_compact``). ``"device"`` and
  ``"auto"``: the card encodes (K1 from planes, K9 from u8 bases), the
  words come back into pinned memory, and the native radix compactor
  builds the table; batch t is drained only after batch t+1 has been
  dispatched. With ``device_sort=True`` the card also sorts the words
  (rows of ``sort_row_len``, K11 for single-word rows with
  ``pallas_sort``, or one flat sort) and the native compactor of sorted
  words builds the table. ``"device-rle"``: the card sorts flat and
  collapses the runs; only the distinct (code, count) prefix comes back.
  ``"host"``: the native engine counts the host-resident stream (nothing
  crosses the link). ``"device-super"``: the card cuts each batch into
  super-k-mer records (runs of windows sharing a minimizer position,
  ``bucketed.superkmer_records_device``), only the records come back,
  and the host expands and counts them (``bucketed.table_from_superkmers``).

A mesh (``KmerConfig.mesh_shape`` of more than one device: a
``LocalMesh`` of D shards on the counter's device) runs each batch data
parallel, as the JAX counter does. Dense: the batch's u8 bases as D equal
shards (``sharded_count.shard_rows``), each counting its windows with
the next shard's head as its halo, the D histograms summed into the one
accumulator (``sharded_count.count_sharded``: K7, K6 or K8 per shard).
Sparse: D halo-carrying shards (``bucketed.shard_stream_with_halo``),
staged as planes with ``pack_input``, encoded (and row-sorted with
``device_sort``) shard by shard (``sharded_sparse.encode_shards``), one
compaction a shard in the drain. A mesh always takes the device arm, and
refuses ``device-rle`` and ``device-super``. Checkpoints hold no mesh: a
run stopped on a mesh resumes on one device, and the reverse.
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
from dna_kmeres_parallel_tpu_torch.parallel import bucketed, sharded_count, sharded_sparse
from dna_kmeres_parallel_tpu_torch.parallel.mesh import make_mesh
from dna_kmeres_parallel_tpu_torch.utils import checkpoint as ckpt_mod
from dna_kmeres_parallel_tpu_torch.utils import codec, fasta
from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig
from dna_kmeres_parallel_tpu_torch.utils.metrics import Metrics
from dna_kmeres_parallel_tpu_torch.utils.profiling import trace

#: minimizer length of the super-k-mer records (the JAX counter's)
_SUPER_M = 7

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


def _count_batch(eng: KmerEngine, staged: tuple, n_own: int, acc: torch.Tensor,
                 mesh=None) -> None:
    """The dense arm's device call: ship one staged batch and add its
    histogram into ``acc`` (``KmerEngine._ship_and_count``; on a mesh,
    ``sharded_count.count_sharded`` of its u8 shard rows)."""
    if mesh is None:
        eng._ship_and_count(staged, n_own, acc)
        return
    rows = host_to_device(staged[0], mesh.device)
    cfg = eng.config
    sharded_count.count_sharded(rows, cfg.k, cfg.bins, cfg.canonical, mesh, n_own=n_own,
                                acc=acc)


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
        ``torch.profiler`` trace of the run there, and its spans as
        ``spans.jsonl`` (``utils/profiling.trace``). pallas_sort: with
        ``device_sort=True``, sort single-word rows with the row-sort
        kernel K11 (``SparseKmerEngine``'s argument)."""
        self.config = config or KmerConfig()
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

    def _mesh(self):
        """The mesh of a data-parallel stream (``KmerConfig.mesh_shape``):
        a ``LocalMesh`` of its devices' product on the counter's device,
        or None for one device (a mesh of one is the single-device path)."""
        n = math.prod(self.config.mesh_shape)
        return make_mesh(n, self.device) if n > 1 else None

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

        mesh = self._mesh()

        def prep(bounds):
            start, end, T = bounds
            padded = self._padded(flat, start, end, T)
            if mesh is not None:
                # Data parallel: u8 shard rows, as the JAX counter stages
                # its mesh batches (K7, K6 or K8 per shard, not K5).
                return pin_host((sharded_count.shard_rows(padded, mesh),), dev)
            return pin_host(eng._stage(padded), dev)

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
                self._with_retry(lambda: _count_batch(eng, staged, end - start, acc, mesh))
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

    def _resolve_compact(self, mesh) -> str:
        """The route that builds every sparse batch's table, fixed for the
        run by ``compact``, ``device_sort`` and the mesh: "host" (the
        native engine counts the host-resident stream), or what the device
        arm returns: "words" (unsorted words, radix compaction), "sorted"
        (``device_sort=True``: the compactor of sorted words or rows),
        "rle" (distinct codes and counts) or "super" (super-k-mer
        records). On a mesh the shards return words or sorted words, and
        "rle" and "super" are refused.

        "auto" is the device arm's words: measured on an H100, a batch
        counted on the host took about 1.5x a device batch's drain, and the
        super-k-mer records took 1.5-4x the words' wall."""
        cfg = self.config
        if cfg.compact == "host":
            return "host"
        if cfg.compact in ("device-rle", "device-super"):
            if mesh is not None:
                raise ValueError(
                    f"compact={cfg.compact!r} is a single-chip D2H mode; "
                    "mesh streams route compressed records/codes over ICI "
                    "instead (parallel/bucketed.py exchanges)"
                )
            return "rle" if cfg.compact == "device-rle" else "super"
        return "sorted" if cfg.device_sort else "words"

    def _run_sparse(self, flat, total_bases, n_seqs, t0) -> SparseCountResult:
        cfg, dev = self.config, self.device
        k, canonical = cfg.k, cfg.canonical
        total = flat.shape[0]
        mesh = self._mesh()
        route = self._resolve_compact(mesh)
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

        def prep(bounds):
            # Stages a batch in its route's one format.
            if route == "host":
                return None
            start, end, _ = bounds
            padded = self._padded(flat, *bounds)
            if mesh is not None:
                # Data parallel: halo-carrying shards, as planes for K1 or
                # as u8 for K9, and each shard's owned windows.
                shards, n_own = bucketed.shard_stream_with_halo(
                    padded, k, mesh, total_own=end - start)
                inputs = sharded_sparse.stage_shard_planes(shards) if cfg.pack_input else (shards,)
                return pin_host(inputs, dev), n_own
            if route == "super":
                return pin_host((padded,), dev)  # the records read the u8 bases
            return pin_host(sparse_engine.stage_words(padded, cfg.pack_input), dev)

        def dispatch(staged, n_own: int):
            """Launch a batch's device work: (its output, the event after
            the copy of its words to the host, or None where the drain
            waits on a count: rle and records)."""
            if mesh is not None:
                inputs, n_own_d = staged
                words = self._with_retry(lambda: sharded_sparse.encode_shards(
                    inputs, n_own_d, k, canonical, mesh, device_sort=bool(cfg.device_sort),
                    row_len=cfg.sort_row_len or sharded_sparse.ROW_LEN,
                    pallas_sort=self.pallas_sort))
                return _start_fetch(words)
            if route == "super":
                bases = host_to_device(staged[0], dev)
                return self._with_retry(
                    lambda: bucketed.superkmer_records_device(bases, n_own, k, _SUPER_M)), None
            words = self._with_retry(
                lambda: sparse_engine.encode_staged(
                    tuple(host_to_device(a, dev) for a in staged), n_own, k, canonical
                )
            )
            if route == "rle":
                return sparse_ops.rle_sorted(sparse_ops.sort_encoded(words, n_own, 0)), None
            if route == "sorted":
                words = sparse_ops.sort_encoded(words, n_own, cfg.sort_row_len, self.pallas_sort)
            return _start_fetch(words)

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

        def drain(p) -> None:
            out, ready, p_start, p_end = p
            with self.metrics.phase("compact"):
                with self.metrics.phase("fetch"):
                    if ready is not None:
                        ready.synchronize()
                    if route == "rle":
                        new = [sparse_engine.table_from_rle(*out)]
                    elif route != "super":
                        host = sparse_engine.fetch_words(out)
                if route == "super":
                    new = [bucketed.table_from_superkmers(*out, k, _SUPER_M, canonical)]
                elif mesh is not None:
                    new = sharded_sparse.compact_shards(host, k, route == "sorted")
                elif route == "sorted":
                    new = [sparse_engine.compact_table(host)]
                elif route == "words":
                    new = [sparse_engine.compact_unsorted(host, k)]
                for table in new:
                    tables.push(table)
            book(p_start, p_end)

        # Software pipelining: batch t is drained (words to the host,
        # compaction) only after batch t+1 has been dispatched.
        pending = None  # (device output, ready event, start, end)
        for (start, end, _), staged in _prefetched(self._batches(total, cursor), prep):
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
            if route == "host":
                # Count off the host-resident stream: the segment carries the
                # k-1 halo, so it owns exactly the windows starting in
                # [start, end).
                seg = flat[start : min(end + k - 1, total)]
                with self.metrics.phase("host_count"):
                    tables.push(native.count_sparse_host_native(seg, k, canonical))
                book(start, end)
                continue
            with self.metrics.phase("device"):
                out, ready = dispatch(staged, end - start)
            if pending is not None:
                drain(pending)
            pending = (out, ready, start, end)
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
