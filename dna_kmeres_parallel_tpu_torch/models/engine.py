"""Host staging of the device batches, and the dense engine: dense
counting and dense distances.

The port of ``dna_kmeres_parallel_tpu/models/engine.py``: its plane
staging (``pack_planes_np``, ``stage_batch_planes``), and its
``KmerEngine`` with the dense counting entries (``count_stream``,
``count_sequences``, ``count_file``) and the distance entries
(``counts_matrix``, ``distance_sequences``, ``distance_file``,
``distance_stream_to_csv``, ``make_dense_panel_fn``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import distance_stream
from dna_kmeres_parallel_tpu_torch.ops import distance as dist_ops
from dna_kmeres_parallel_tpu_torch.ops import distance_cuda, histogram_cuda, runtime
from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
from dna_kmeres_parallel_tpu_torch.ops.encode_cuda import host_planes_from_packfmt
from dna_kmeres_parallel_tpu_torch.utils import codec, fasta
from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig


_LANE = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def batch_plan(total: int, k: int, batch_bases: int) -> tuple[int, int]:
    """(bases owned per batch, padded batch length T) for a stream of
    ``total`` bases: streams shorter than one batch use a power-of-two
    bucket, and every batch reads k-1 halo bases past what it owns."""
    pow2 = 1 << (max(total, _LANE) - 1).bit_length()
    batch = max(min(batch_bases, pow2), k)
    return batch, _round_up(batch + k - 1, _LANE)


def host_tensor(a) -> torch.Tensor:
    """A NumPy array as a CPU tensor sharing its memory (u32 viewed as
    int32, which holds the same bits); a tensor as it is."""
    if isinstance(a, torch.Tensor):
        return a
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def pin_host(host: tuple, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The host half of a batch as CPU tensors, in pinned memory when they
    are bound for the card (the streaming counter's prefetch thread pins
    a batch while the main thread ships the one before)."""
    out = tuple(host_tensor(a) for a in host)
    if device.type == "cuda":
        out = tuple(t.pin_memory() for t in out)
    return out


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A NumPy array or CPU tensor as a tensor on ``device``; to the card
    it goes through pinned host memory, without waiting for the copy."""
    t = host_tensor(a)
    if device.type == "cuda":
        if not t.is_pinned():
            t = t.pin_memory()
        t = t.to(device, non_blocking=True)
    return t


def pack_planes_np(flat_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack a padded u8 base stream (length a multiple of 16) with the
    native packer and build the encoder's u32 (words_le, inval_be) planes,
    NumPy in and NumPy out."""
    data, mask, _ = native.pack_2bit_native(flat_u8)
    return host_planes_from_packfmt(data, mask)


def stage_batch_planes(
    padded: np.ndarray, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Planes of a padded batch on ``device`` (int32 tensors holding the u32
    bits): 0.5 B per base."""
    return tuple(host_to_device(plane, device) for plane in pack_planes_np(padded))


# ---------------------------------------------------------------------------
# Dense counting
# ---------------------------------------------------------------------------

#: the most windows the int32 device accumulator takes between two adds
#: into the host int64 histogram: no count can then pass 2^31 - 1
FLUSH_WINDOWS = (1 << 31) - 1


def flush_first(acc_windows: int, batch_windows: int, batch_bases: int) -> bool:
    """Whether the accumulator, holding ``acc_windows`` windows, must be
    added into the host histogram before a batch of ``batch_windows``
    windows is added to it: when the two together could pass
    FLUSH_WINDOWS. A batch that could pass it alone raises ValueError: the
    kernels add the whole batch into that int32."""
    if batch_windows > FLUSH_WINDOWS:
        raise ValueError(
            f"batch_bases={batch_bases} makes batches of {batch_windows} windows, "
            f"more than the {FLUSH_WINDOWS} an int32 accumulator takes; use a "
            f"smaller batch_bases"
        )
    return acc_windows + batch_windows > FLUSH_WINDOWS

#: Phases of CountResult.phases, in the order a batch runs them.
COUNT_PHASES = ("parse", "staging", "h2d", "kernel", "d2h")


@dataclass
class CountResult:
    k: int
    canonical: bool
    hist: np.ndarray  # int64 [4^k] dense histogram
    n_seqs: int
    total_bases: int
    elapsed_s: float = 0.0
    #: seconds per phase (COUNT_PHASES), summed over batches. On the card
    #: h2d and kernel are device-timeline spans (CUDA events) and d2h is the
    #: host wall of the accumulator's copies to the host, which wait for the
    #: batches still queued; staging and parse are host-clock spans. k =
    #: 9..12 carry the sparse engine's phases (sparse_engine.PHASES).
    phases: dict[str, float] = field(default_factory=dict)

    def table(self) -> dict[str, int]:
        nz = np.nonzero(self.hist)[0]
        return {codec.code_to_kmer(int(c), self.k): int(self.hist[c]) for c in nz}

    @property
    def total_kmers(self) -> int:
        return int(self.hist.sum())

    @property
    def distinct_kmers(self) -> int:
        return int(np.count_nonzero(self.hist))


# ---------------------------------------------------------------------------
# Dense pairwise distances: the reference workload
# ---------------------------------------------------------------------------

#: largest k with dense distances: 4^8 = 65,536 bins, K2's widest
MAX_DIST_K = 8
#: bytes of one K2 launch's u8 grid (rows x the longest row of the chunk)
GRID_BYTES = 1 << 30

#: Phases of DistanceResult.phases, in the order a run goes through them.
DIST_PHASES = ("parse", "counts", "min_sum", "d2h", "finish", "write")


@dataclass
class DistanceResult:
    k: int
    n: int
    ids: list[str]
    packed: np.ndarray  # float32 [n*(n-1)/2] strict upper triangle
    counts: np.ndarray | None = None  # int32 [n, 4^k] per-sequence counts
    elapsed_s: float = 0.0
    #: seconds per phase (DIST_PHASES). On the card ``counts`` (grid
    #: staging, H2D and K2) and ``min_sum`` (K3 or K4) are spans of the
    #: device timeline between CUDA events, and ``d2h`` is the rest of the
    #: host wall until the results are on the host; the other phases are
    #: host-clock spans.
    phases: dict[str, float] = field(default_factory=dict)


def row_chunks(lengths: np.ndarray, max_bytes: int = GRID_BYTES) -> list[tuple[int, int, int]]:
    """Consecutive row ranges (lo, hi, L) whose grid of hi - lo rows by L
    (the longest row of the range, at least 1) stays within max_bytes,
    or holds a single row."""
    out = []
    lo, width = 0, 1
    for i, n in enumerate(np.asarray(lengths).tolist()):
        w = max(width, n)
        if i > lo and (i + 1 - lo) * w > max_bytes:
            out.append((lo, i, width))
            lo, w = i, max(n, 1)
        width = w
    if len(lengths):
        out.append((lo, len(lengths), width))
    return out


def seq_stream(seqs: list[str]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sequences -> (flat u8 stream with one separator between records,
    int64 record offsets, int64 lengths)."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.cumsum(lengths + 1) - (lengths + 1)
    return codec.concat_with_sentinels(seqs), offsets, lengths


class KmerEngine:
    """Single-device dense engine.

    Counting, k <= 15 (``count_*``): a dense int64 histogram of 4^k bins,
    from the histogram kernels (K5 from the encoder's planes, K6 and K7
    from bases) up to 65,536 bins (k <= 8), and from the sparse engine,
    densified, above.
    Distances, k <= 8 (``distance_*``): the per-sequence counts matrix
    (K2), the (min,+) product (K3 for all pairs, K4 for a streamed panel),
    and the float32 finish on the host."""

    def __init__(
        self,
        config: KmerConfig | None = None,
        device: str | torch.device = "cuda",
        **kw,
    ):
        cfg = config or KmerConfig()
        self.config = cfg.replace(**kw) if kw else cfg
        if self.config.k > encode_ops.MAX_DENSE_K:
            raise NotImplementedError(
                f"the dense engine serves k <= {encode_ops.MAX_DENSE_K}; "
                f"SparseKmerEngine counts k={self.config.k}"
            )
        self.device = runtime.resolve_device(device)
        native.load()

    def _require_distance_k(self) -> None:
        if self.config.k > MAX_DIST_K:
            raise NotImplementedError(
                f"distances at k={self.config.k} need more than 4^{MAX_DIST_K} "
                "dense bins: they go through sparse tables, which are not "
                "ported yet (ROADMAP item 8)"
            )

    # ------------------------------------------------------------- counting
    def _stage(self, padded: np.ndarray) -> tuple[np.ndarray, ...]:
        """The host half of a batch, as the JAX engine's ``_count_batch*``
        route it: with ``pack_input``, the encoder's u32 planes for k = 4..8
        (K5) or the packed bytes and validity bits for k <= 3 (unpacked on
        the device, then K7); without it, the u8 bases (K7 or K6)."""
        cfg = self.config
        if cfg.pack_input and cfg.k >= 4:
            return pack_planes_np(padded)
        if cfg.pack_input:
            return native.pack_2bit_native(padded)[:2]
        return (padded,)

    def _ship_and_count(self, host: tuple, n_own: int, acc: torch.Tensor):
        """The device half of a batch: copy what ``_stage`` made (NumPy
        arrays, or their tensors from ``pin_host``) to the device and add
        its histogram into ``acc``. Returns the event marks before the
        copy, after it and after the kernel."""
        cfg, dev = self.config, self.device
        planes = cfg.pack_input and cfg.k >= 4
        m0 = runtime.mark(dev)
        staged = tuple(host_to_device(a, dev) for a in host)
        m1 = runtime.mark(dev)
        if planes:
            histogram_cuda.histogram_planes(*staged, n_own, cfg.k, cfg.canonical, acc)
        else:
            bases = encode_ops.unpack_stream(*staged) if cfg.pack_input else staged[0]
            histogram_cuda.histogram_stream(bases, n_own, cfg.k, cfg.bins, cfg.canonical, acc)
        return m0, m1, runtime.mark(dev)

    def count_stream(self, flat: np.ndarray, total_bases: int, n_seqs: int) -> CountResult:
        """Count a flat base stream (u8 codes, one 0xFF between records).

        Each batch owns the windows that start in [start, end) and reads
        k-1 halo bases past it, padded with 0xFF to the batch length. The
        batches add into one int32 accumulator on the device, with no wait
        between them; it is added into the host int64 histogram at the end,
        and before any batch that could take it past FLUSH_WINDOWS
        windows (``flush_first``)."""
        cfg, dev = self.config, self.device
        t0 = time.perf_counter()
        if cfg.bins > histogram_cuda.MAX_BINS:  # k = 9..12: count sparse, densify
            from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
                SparseKmerEngine,
                dense_from_sparse,
            )

            sp = SparseKmerEngine(cfg, device=dev).count_stream(flat, total_bases, n_seqs)
            return CountResult(
                k=cfg.k, canonical=cfg.canonical,
                hist=dense_from_sparse(sp, cfg.bins), n_seqs=n_seqs,
                total_bases=total_bases, elapsed_s=time.perf_counter() - t0,
                phases=sp.phases,
            )
        phases = dict.fromkeys(COUNT_PHASES, 0.0)
        hist = np.zeros(cfg.bins, dtype=np.int64)
        total = flat.shape[0]
        if total >= cfg.k:
            batch, T = batch_plan(total, cfg.k, cfg.batch_bases)
            acc = torch.zeros(cfg.bins, dtype=torch.int32, device=dev)
            acc_windows = 0
            marks: list = []

            def drain() -> None:
                nonlocal acc_windows
                t = time.perf_counter()
                hist[:] += acc.cpu().numpy()  # waits for the queued batches
                acc.zero_()
                acc_windows = 0
                phases["d2h"] += time.perf_counter() - t

            for start in range(0, total, batch):
                end = min(start + batch, total)
                if flush_first(acc_windows, end - start, cfg.batch_bases):
                    drain()
                t = time.perf_counter()
                seg = flat[start : min(end + cfg.k - 1, total)]
                padded = np.full(T, codec.INVALID_BASE, dtype=np.uint8)
                padded[: seg.shape[0]] = seg
                host = self._stage(padded)
                phases["staging"] += time.perf_counter() - t
                marks.append(self._ship_and_count(host, end - start, acc))
                acc_windows += end - start
            if acc_windows:
                drain()
            for m0, m1, m2 in marks:
                phases["h2d"] += runtime.span_s(m0, m1)
                phases["kernel"] += runtime.span_s(m1, m2)
        return CountResult(
            k=cfg.k, canonical=cfg.canonical, hist=hist, n_seqs=n_seqs,
            total_bases=total_bases, elapsed_s=time.perf_counter() - t0,
            phases=phases,
        )

    def count_sequences(self, seqs: list[str]) -> CountResult:
        flat = codec.concat_with_sentinels(seqs)
        return self.count_stream(flat, sum(len(s) for s in seqs), len(seqs))

    def count_file(self, source) -> CountResult:
        """Count a FASTA file: the native parser for a path with the modern
        record semantics, the Python parsers otherwise."""
        cfg = self.config
        t0 = time.perf_counter()
        if cfg.parser_variant == "modern" and isinstance(source, (str, os.PathLike)):
            parsed = native.parse_fasta_native(source, max_seqs=cfg.max_seqs)
            parse_s = time.perf_counter() - t0
            res = self.count_stream(parsed.stream, parsed.total_bases, parsed.n_seqs)
        else:
            seqs = [r.seq for r in self._parse(source)]
            parse_s = time.perf_counter() - t0
            res = self.count_sequences(seqs)
        res.phases["parse"] = parse_s
        return res

    def _parse(self, source) -> list[fasta.FastaRecord]:
        cfg = self.config
        if cfg.parser_variant == "modern":
            return fasta.parse_fasta(source, max_seqs=cfg.max_seqs)
        return fasta.parse_fasta_reference(
            source, variant=cfg.parser_variant, max_seqs=cfg.max_seqs
        )

    # ------------------------------------------------------------- counts
    def _counts_on_device(
        self, stream: np.ndarray, offsets: np.ndarray, lengths: np.ndarray
    ) -> torch.Tensor:
        """int32 [S, 4^k] counts on the engine's device: each chunk of rows
        is laid into a u8 grid (0xFF past a row's end), staged and counted
        by ``histogram_cuda.counts_matrix_grid``."""
        cfg, dev = self.config, self.device
        S = len(lengths)
        out = torch.empty(S, cfg.bins, dtype=torch.int32, device=dev)
        for lo, hi, L in row_chunks(lengths):
            grid = np.full((hi - lo, L), codec.INVALID_BASE, dtype=np.uint8)
            for row, (o, n) in enumerate(zip(offsets[lo:hi].tolist(),
                                             lengths[lo:hi].tolist())):
                grid[row, :n] = stream[o : o + n]
            out[lo:hi] = histogram_cuda.counts_matrix_grid(
                host_to_device(grid, dev), cfg.k, cfg.bins, cfg.canonical
            )
        return out

    def counts_matrix(self, seqs: list[str]) -> np.ndarray:
        """Per-sequence count vectors, int32 [S, 4^k], on the host."""
        self._require_distance_k()
        return self._counts_on_device(*seq_stream(seqs)).cpu().numpy()

    # ------------------------------------------------------------- distances
    def _distances(self, stream, offsets, lengths, ids, phases, t0) -> DistanceResult:
        cfg, dev = self.config, self.device
        t = time.perf_counter()
        m0 = runtime.mark(dev)
        counts = self._counts_on_device(stream, offsets, lengths)
        m1 = runtime.mark(dev)
        sums = distance_cuda.min_sum_matrix_tri(counts)
        m2 = runtime.mark(dev)
        sums_np = sums.cpu().numpy()  # waits for the device
        counts_np = counts.cpu().numpy()
        del sums
        phases["counts"] = runtime.span_s(m0, m1)
        phases["min_sum"] = runtime.span_s(m1, m2)
        phases["d2h"] = time.perf_counter() - t - phases["counts"] - phases["min_sum"]
        t = time.perf_counter()
        packed = dist_ops.finish_packed(sums_np, lengths, cfg.k)
        phases["finish"] = time.perf_counter() - t
        n = len(lengths)
        return DistanceResult(
            k=cfg.k,
            n=n,
            ids=ids or [f">seq{i}" for i in range(n)],
            packed=packed,
            counts=counts_np,
            elapsed_s=time.perf_counter() - t0,
            phases=phases,
        )

    def distance_sequences(
        self, seqs: list[str], ids: list[str] | None = None
    ) -> DistanceResult:
        """Packed pairwise distances of in-memory sequences."""
        self._require_distance_k()
        t0 = time.perf_counter()
        phases = dict.fromkeys(DIST_PHASES, 0.0)
        return self._distances(*seq_stream(seqs), ids, phases, t0)

    def distance_file(self, source) -> DistanceResult:
        """Packed pairwise distances of the records of a FASTA file (the
        native parser for a path with the modern record semantics, the
        Python parsers otherwise)."""
        self._require_distance_k()
        cfg = self.config
        t0 = time.perf_counter()
        phases = dict.fromkeys(DIST_PHASES, 0.0)
        if cfg.parser_variant == "modern" and isinstance(source, (str, os.PathLike)):
            parsed = native.parse_fasta_native(source, max_seqs=cfg.max_seqs)
            args = (parsed.stream, parsed.offsets[:-1], parsed.lengths, parsed.ids)
        else:
            records = self._parse(source)
            args = (*seq_stream([r.seq for r in records]), [r.id for r in records])
        phases["parse"] = time.perf_counter() - t0
        return self._distances(*args, phases, t0)

    def distance_stream_to_csv(
        self,
        seqs: list[str],
        output_path,
        panel_rows: int = 2048,
        checkpoint_path=None,
        max_panels: int | None = None,
        row_lo: int = 0,
        row_hi: int | None = None,
    ) -> dict:
        """Large-S distances straight to the reference's CSV: the [S, S]
        matrix never exists. The counts matrix stays on the device; each
        panel of ``panel_rows`` rows takes its (min,+) product against the
        partner rows after its first row (K4 on the card), is finished on
        the host and appended by ``distance_stream.stream_panels_to_csv``
        (fsync, then checkpoint; a resumed run is byte-identical).
        max_panels bounds the panels of this call; row_lo/row_hi stream one
        row block. The result carries the writer's keys plus ``phases``."""
        self._require_distance_k()
        cfg = self.config
        t0 = time.perf_counter()
        phases = dict.fromkeys(DIST_PHASES, 0.0)
        stream, offsets, lengths = seq_stream(seqs)
        m0 = runtime.mark(self.device)
        counts = self._counts_on_device(stream, offsets, lengths)
        m1 = runtime.mark(self.device)
        panel_fn = self.make_dense_panel_fn(counts, lengths, phases)
        meta = {
            "k": cfg.k,
            "canonical": cfg.canonical,
            "n_seqs": len(seqs),
            "regime": "dense",
            "input_sha": distance_stream.input_fingerprint(seqs),
        }
        out = distance_stream.stream_panels_to_csv(
            output_path, len(seqs), panel_rows, panel_fn, meta=meta,
            checkpoint_path=checkpoint_path, max_panels=max_panels,
            row_lo=row_lo, row_hi=row_hi,
        )
        phases["counts"] = runtime.span_s(m0, m1)
        phases["write"] = out["write_s"]
        out["phases"] = phases
        out["elapsed_s"] = time.perf_counter() - t0
        return out

    def make_dense_panel_fn(self, counts, lengths, phases=None):
        """Panel closure over the [S, bins] int32 counts (a tensor or an
        array; kept on the engine's device):
        panel_fn(r0, r1) -> float32 packed distances of rows r0..r1-1 (row
        i: columns i+1..S-1). Adds its seconds to ``phases`` (min_sum,
        d2h, finish) when given one."""
        self._require_distance_k()
        cfg, dev = self.config, self.device
        counts = torch.as_tensor(counts).to(dev)
        lengths = np.asarray(lengths, dtype=np.int64)
        phases = dict.fromkeys(DIST_PHASES, 0.0) if phases is None else phases

        def panel_fn(r0: int, r1: int) -> np.ndarray:
            t = time.perf_counter()
            m0 = runtime.mark(dev)
            sums = distance_cuda.min_sum_matrix_rect(counts[r0:r1], counts[r0:])
            m1 = runtime.mark(dev)
            host = sums.cpu().numpy()  # waits for the device
            min_sum = runtime.span_s(m0, m1)
            phases["min_sum"] += min_sum
            phases["d2h"] += time.perf_counter() - t - min_sum
            t = time.perf_counter()
            flat = dist_ops.finish_upper(host, lengths[r0:r1], lengths[r0:], cfg.k, r0, r0)
            phases["finish"] += time.perf_counter() - t
            return flat

        return panel_fn
