"""Host staging of the device batches, and the dense engine: dense
counting and dense distances.

The port of ``dna_kmeres_parallel_tpu/models/engine.py``: its plane
staging (``pack_planes_np``, ``stage_batch_planes``), and its
``KmerEngine`` with the dense counting entries (``count_stream``,
``count_sequences``, ``count_file``) and the distance entries
(``counts_matrix``, ``distance_sequences``, ``distance_file``,
``distance_stream_to_csv``, ``make_dense_panel_fn``) and the
differential check against the NumPy oracle (``verify_against_oracle``).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import distance_stream
from dna_kmeres_parallel_tpu_torch.ops import distance as dist_ops
from dna_kmeres_parallel_tpu_torch.ops import distance_cuda, histogram_cuda, runtime, threshold_cuda
from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
from dna_kmeres_parallel_tpu_torch.ops.encode_cuda import host_planes_from_packfmt
from dna_kmeres_parallel_tpu_torch.utils import codec, fasta
from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig
from dna_kmeres_parallel_tpu_torch.utils.profiling import span


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
    #: staging, H2D and K2), ``min_sum`` (K3 or K4) and ``finish`` (the
    #: finish kernel) are spans of the device timeline between CUDA
    #: events, and ``d2h`` is the rest of the host wall until the results
    #: are on the host; the other phases are host-clock spans.
    phases: dict[str, float] = field(default_factory=dict)
    #: the (min,+) product's route: "threshold" or "minplus" (K3, or K4
    #: over a mesh)
    route: str = ""


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


def min_sum_panel_mesh(panel: torch.Tensor, other: torch.Tensor, mesh,
                       threshold: int | None = None) -> torch.Tensor:
    """int32 [Pr, S2] min-sums of a row panel against partner rows over a
    mesh (``sharded_count.min_sum_panel_sharded``: K4 per shard, or the
    threshold route at cmax ``threshold``): the partner rows padded with
    zero-count rows to a multiple of D (their min-sums are 0) and the
    padding's columns sliced off. A shard's K4 route
    (``distance_cuda.product_route``) follows its own rows' sums; every
    route gives the same sums."""
    from dna_kmeres_parallel_tpu_torch.parallel.sharded_count import min_sum_panel_sharded

    S2 = other.shape[0]
    pad = (-S2) % mesh.size
    if pad:
        other = torch.cat([other, other.new_zeros(pad, other.shape[1])])
    return min_sum_panel_sharded(panel, other, mesh, threshold=threshold)[:, :S2]


def seq_stream(seqs: list[str]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sequences -> (flat u8 stream with one separator between records,
    int64 record offsets, int64 lengths)."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.cumsum(lengths + 1) - (lengths + 1)
    return codec.concat_with_sentinels(seqs), offsets, lengths


class KmerEngine:
    """The dense engine: one device, and with ``mesh_shape`` its distance
    panels partner-sharded over a mesh of that many shards on the device.

    Counting, k <= 15 (``count_*``): a dense int64 histogram of 4^k bins,
    from the histogram kernels (K5 from the encoder's planes, K6 and K7
    from bases) up to 65,536 bins (k <= 8), and from the sparse engine,
    densified, above.
    Distances, k <= 15 (``distance_*``): the per-sequence counts matrix
    (K2), the (min,+) product (K3 for all pairs, K4 for a streamed panel,
    or the threshold route where ``sparse_engine.threshold_plan`` takes
    it: ``threshold`` "auto", "on" or "off", ``threshold_cap``, under
    ``rates``), and the float32 finish on the same device (the finish
    kernel on the card), whose packed triangle alone comes to the host.
    Above 4^8 bins (k = 9..15) a run must pass
    ``sparse_engine.dense_distance_feasible`` (the [S, 4^k] int32 matrix
    within 2 GiB): else it raises, and the sparse tables of
    ``sparse_engine.distance_sparse_packed`` serve it."""

    def __init__(
        self,
        config: KmerConfig | None = None,
        device: str | torch.device = "cuda",
        *,
        threshold: str = "auto",
        threshold_cap: int | None = None,
        rates=None,
        **kw,
    ):
        from dna_kmeres_parallel_tpu_torch.models import sparse_engine

        if threshold not in sparse_engine.THRESHOLD_MODES:
            raise ValueError(f"threshold must be one of {sparse_engine.THRESHOLD_MODES}, "
                             f"got {threshold!r}")
        self.threshold = threshold
        self.threshold_cap = threshold_cap
        self.rates = sparse_engine.DistanceRates() if rates is None else rates
        cfg = config or KmerConfig()
        self.config = cfg.replace(**kw) if kw else cfg
        if self.config.k > encode_ops.MAX_DENSE_K:
            raise NotImplementedError(
                f"the dense engine serves k <= {encode_ops.MAX_DENSE_K}; "
                f"SparseKmerEngine counts k={self.config.k}"
            )
        self.device = runtime.resolve_device(device)
        native.load()

    def _mesh(self):
        """The mesh of the distance panels (``KmerConfig.mesh_shape``): a
        ``LocalMesh`` of its devices' product on the engine's device, or
        None for one device (whose triangle kernel beats a mesh of one).
        Counting ignores it, as the JAX engine's does."""
        from dna_kmeres_parallel_tpu_torch.parallel.mesh import make_mesh

        n = math.prod(self.config.mesh_shape)
        return make_mesh(n, self.device) if n > 1 else None

    def _require_distance_k(self, n_seqs: int) -> None:
        """Raise unless the [n_seqs, 4^k] counts matrix of a distance run
        may exist: any k <= 8, and above 4^8 bins what
        ``dense_distance_feasible`` admits (the constructor has refused
        k > 15 already)."""
        from dna_kmeres_parallel_tpu_torch.models import sparse_engine

        k = self.config.k
        if self.config.bins > histogram_cuda.MAX_BINS and not (
            sparse_engine.dense_distance_feasible(n_seqs, k)
        ):
            raise ValueError(
                f"the dense [{n_seqs}, 4^{k}] counts matrix is over the memory "
                "budget (sparse_engine.dense_distance_feasible): use "
                "sparse_engine.distance_sparse_packed"
            )

    def _threshold_cmax(self, counts: torch.Tensor, rows: int, symmetric: bool,
                        info: dict | None = None) -> int | None:
        """The threshold route's cmax for the products over ``counts``
        (``sparse_engine.threshold_plan``), or None for K3/K4: ``rows``
        rows against all S (one panel; all S and ``symmetric`` for K3's
        square), against K3/K4 at the dense rate."""
        from dna_kmeres_parallel_tpu_torch.models import sparse_engine

        if self.threshold == "off":
            return None
        S, bins = counts.shape
        cmax, row_max = sparse_engine.counts_extent(counts)
        r = self.rates
        alt_s = dist_ops.minplus_time(
            rows, S, bins, symmetric, rate=r.dense_bin_pairs_per_sec,
            rate_rows=dist_ops.DENSE_RATE_ROWS, peak=r.peak_bin_pairs_per_sec)
        return sparse_engine.threshold_plan(
            cmax, row_max, rows, S, bins, alt_s=alt_s, device=self.device,
            mode=self.threshold, cap=self.threshold_cap, rates=r, info=info)

    # ------------------------------------------------------------- counting
    def _stage(self, padded: np.ndarray) -> tuple[np.ndarray, ...]:
        """The host half of a batch, as the JAX engine's ``_count_batch*``
        route it: with ``pack_input``, the encoder's u32 planes for k = 4..8
        (K5) or the packed bytes and validity bits for k <= 3 (K7 reads
        them as they are); without it, the u8 bases (K7 or K6)."""
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
        dev = self.device
        m0 = runtime.mark(dev)
        staged = tuple(host_to_device(a, dev) for a in host)
        m1 = runtime.mark(dev)
        self.count_staged(staged, n_own, acc)
        return m0, m1, runtime.mark(dev)

    def count_staged(self, staged: tuple, n_own: int, acc: torch.Tensor) -> None:
        """Add the histogram of one batch, staged on the device as
        ``_stage`` made it, into ``acc``: K5 from planes, K7 from the
        packed batch, K7 or K6 from u8 bases (the plain versions on the
        CPU)."""
        cfg = self.config
        if cfg.pack_input and cfg.k >= 4:
            histogram_cuda.histogram_planes(*staged, n_own, cfg.k, cfg.canonical, acc)
        elif cfg.pack_input:
            histogram_cuda.histogram_packed(*staged, n_own, cfg.k, cfg.bins, cfg.canonical, acc)
        else:
            histogram_cuda.histogram_stream(*staged, n_own, cfg.k, cfg.bins, cfg.canonical, acc)

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
                with span("d2h", phases):
                    hist[:] += acc.cpu().numpy()  # waits for the queued batches
                    acc.zero_()
                    acc_windows = 0

            for start in range(0, total, batch):
                end = min(start + batch, total)
                if flush_first(acc_windows, end - start, cfg.batch_bases):
                    drain()
                with span("staging", phases):
                    seg = flat[start : min(end + cfg.k - 1, total)]
                    padded = np.full(T, codec.INVALID_BASE, dtype=np.uint8)
                    padded[: seg.shape[0]] = seg
                    host = self._stage(padded)
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
        """Count in-memory sequences; the root span ``count_sequences``
        counts the table's rows (the histogram's 4^k bins)."""
        with span("count_sequences") as root:
            flat = codec.concat_with_sentinels(seqs)
            res = self.count_stream(flat, sum(len(s) for s in seqs), len(seqs))
            root.count("rows", res.hist.shape[0])
        return res

    def count_file(self, source) -> CountResult:
        """Count a FASTA file: the native parser for a path with the modern
        record semantics, the Python parsers otherwise. The root span
        ``count_file`` counts the histogram's 4^k bins as ``rows``."""
        cfg = self.config
        parse: dict[str, float] = {}
        with span("count_file") as root:
            if cfg.parser_variant == "modern" and isinstance(source, (str, os.PathLike)):
                with span("parse", parse) as parse_span:
                    parsed = native.parse_fasta_native(source, max_seqs=cfg.max_seqs)
                    parse_span.count("ranges", parsed.ranges)
                res = self.count_stream(parsed.stream, parsed.total_bases, parsed.n_seqs)
            else:
                with span("parse", parse):
                    seqs = [r.seq for r in self._parse(source)]
                res = self.count_sequences(seqs)
            res.phases["parse"] = parse["parse"]
            root.count("rows", res.hist.shape[0])
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
        self._require_distance_k(len(seqs))
        return self._counts_on_device(*seq_stream(seqs)).cpu().numpy()

    # ------------------------------------------------------------- distances
    def _distances(self, stream, offsets, lengths, ids, phases, t0) -> DistanceResult:
        cfg, dev = self.config, self.device
        # d2h: the host wall from here to the results' arrival, less the
        # device phases it spans
        with span("d2h", phases):
            lens = host_to_device(np.asarray(lengths, dtype=np.int64), dev)
            m0 = runtime.mark(dev)
            counts = self._counts_on_device(stream, offsets, lengths)
            m1 = runtime.mark(dev)
            mesh = self._mesh()
            S = len(lengths)
            cmax = self._threshold_cmax(counts, S, mesh is None) if S else None
            if mesh is not None and S:
                # The whole square as one partner-sharded panel (K4 or the
                # threshold route per shard).
                sums = min_sum_panel_mesh(counts, counts, mesh, threshold=cmax)
            elif cmax is not None:
                sums = threshold_cuda.min_sum_matrix_threshold(counts, cmax)
            else:
                sums = distance_cuda.min_sum_matrix_tri(counts)
            m2 = runtime.mark(dev)
            packed = self._finish(sums, lens, lens, 0)
            m3 = runtime.mark(dev)
            del sums  # only the packed triangle and the counts come back
            with span("d2h.wait"):
                runtime.wait(m3)
            with span("d2h.copy") as copy:
                packed_np = packed.cpu().numpy()
                counts_np = counts.cpu().numpy()
                copy.count("bytes", packed_np.nbytes + counts_np.nbytes)
            phases["counts"] = runtime.span_s(m0, m1)
            phases["min_sum"] = runtime.span_s(m1, m2)
            phases["finish"] = runtime.span_s(m2, m3)
        phases["d2h"] -= phases["counts"] + phases["min_sum"] + phases["finish"]
        n = len(lengths)
        return DistanceResult(
            k=cfg.k,
            n=n,
            ids=ids or [f">seq{i}" for i in range(n)],
            packed=packed_np,
            counts=counts_np,
            elapsed_s=time.perf_counter() - t0,
            phases=phases,
            route="minplus" if cmax is None else "threshold",
        )

    def _finish(self, sums, lengths_rows, lengths_cols, r0: int) -> torch.Tensor:
        """The packed float32 distances of a panel whose rows start at
        sequence ``r0`` and columns at ``r0`` (the square at 0), on the
        sums' device (``distance_cuda.finish_upper_packed``: the finish
        kernel on the card). Its span counts ``device_pairs``, the pairs
        the kernel finished (0 on the CPU)."""
        with span("finish") as fin:
            out = distance_cuda.finish_upper_packed(
                sums, lengths_rows, lengths_cols, self.config.k, r0, r0)
            fin.count("device_pairs", out.numel() if out.is_cuda else 0)
        return out

    def distance_sequences(
        self, seqs: list[str], ids: list[str] | None = None
    ) -> DistanceResult:
        """Packed pairwise distances of in-memory sequences; the root span
        ``distance_sequences`` counts the pairs as ``rows``."""
        self._require_distance_k(len(seqs))
        t0 = time.perf_counter()
        phases = dict.fromkeys(DIST_PHASES, 0.0)
        with span("distance_sequences") as root:
            res = self._distances(*seq_stream(seqs), ids, phases, t0)
            root.count("rows", res.packed.shape[0])
        return res

    def distance_file(self, source) -> DistanceResult:
        """Packed pairwise distances of the records of a FASTA file (the
        native parser for a path with the modern record semantics, reading
        the records ``utils/fasta.parse_fasta`` reads as the JAX engine
        does, ``native.parse_fasta_text``; the Python parsers otherwise)."""
        cfg = self.config
        t0 = time.perf_counter()
        phases = dict.fromkeys(DIST_PHASES, 0.0)
        with span("distance_file") as root:
            with span("parse", phases) as parse_span:
                if cfg.parser_variant == "modern" and isinstance(source, (str, os.PathLike)):
                    parsed = native.parse_fasta_text(source, max_seqs=cfg.max_seqs)
                    parse_span.count("ranges", parsed.ranges)
                    args = (parsed.stream, parsed.offsets[:-1], parsed.lengths, parsed.ids)
                else:
                    records = self._parse(source)
                    args = (*seq_stream([r.seq for r in records]), [r.id for r in records])
                self._require_distance_k(len(args[2]))
            res = self._distances(*args, phases, t0)
            root.count("rows", res.packed.shape[0])
        return res

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
        the device and appended by ``distance_stream.stream_panels_to_csv``
        (fsync, then checkpoint; a resumed run is byte-identical).
        max_panels bounds the panels of this call; row_lo/row_hi stream one
        row block. The result carries the writer's keys plus ``phases``."""
        self._require_distance_k(len(seqs))
        cfg = self.config
        t0 = time.perf_counter()
        phases = dict.fromkeys(DIST_PHASES, 0.0)
        stream, offsets, lengths = seq_stream(seqs)
        m0 = runtime.mark(self.device)
        counts = self._counts_on_device(stream, offsets, lengths)
        m1 = runtime.mark(self.device)
        route: dict = {}
        panel_fn = self.make_dense_panel_fn(counts, lengths, phases, panel_rows, route)
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
        out["route"] = route["route"]
        out["elapsed_s"] = time.perf_counter() - t0
        return out

    def make_dense_panel_fn(self, counts, lengths, phases=None, panel_rows=None, info=None):
        """Panel closure over the [S, bins] int32 counts (a tensor or an
        array; kept on the engine's device):
        panel_fn(r0, r1) -> float32 packed distances of rows r0..r1-1 (row
        i: columns i+1..S-1). One route a job: K4 a panel (per shard over
        a mesh), or the threshold route where ``threshold_plan`` takes it
        for a panel of ``panel_rows`` (all S when None) rows. Adds its
        seconds to ``phases`` (min_sum, d2h, finish) when given one;
        ``info``, when given, receives the ``route`` and the gate's
        predictions."""
        self._require_distance_k(len(counts))
        dev = self.device
        counts = torch.as_tensor(counts).to(dev)
        lengths = host_to_device(np.asarray(lengths, dtype=np.int64), dev)
        phases = dict.fromkeys(DIST_PHASES, 0.0) if phases is None else phases
        mesh = self._mesh()
        info = {} if info is None else info
        S = counts.shape[0]
        rows = S if panel_rows is None else min(panel_rows, S)
        cmax = self._threshold_cmax(counts, rows, False, info) if S else None
        info["route"] = "minplus" if cmax is None else "threshold"

        def panel_fn(r0: int, r1: int) -> np.ndarray:
            with span("d2h", phases):
                m0 = runtime.mark(dev)
                if mesh is not None:
                    sums = min_sum_panel_mesh(counts[r0:r1], counts[r0:], mesh, threshold=cmax)
                elif cmax is not None:
                    sums = threshold_cuda.min_sum_matrix_threshold(counts[r0:r1], cmax, counts[r0:])
                else:
                    sums = distance_cuda.min_sum_matrix_rect(counts[r0:r1], counts[r0:])
                m1 = runtime.mark(dev)
                flat = self._finish(sums, lengths[r0:r1], lengths[r0:], r0)
                m2 = runtime.mark(dev)
                del sums
                host = flat.cpu().numpy()  # waits for the device
                min_sum, finish = runtime.span_s(m0, m1), runtime.span_s(m1, m2)
            phases["min_sum"] += min_sum
            phases["finish"] += finish
            phases["d2h"] -= min_sum + finish
            return host

        return panel_fn

    # ------------------------------------------------------------- verification
    def verify_against_oracle(self, seqs: list[str]) -> dict:
        """Differential check against the NumPy oracle: the summed
        histogram and the packed distances, each exactly equal."""
        from dna_kmeres_parallel_tpu_torch.models import oracle

        cfg = self.config
        got = self.count_sequences(seqs)
        want = sum(
            (oracle.count_vector(s, cfg.k, cfg.canonical) for s in seqs),
            np.zeros(cfg.bins, dtype=np.int64),
        )
        d_got = self.distance_sequences(seqs).packed
        d_want = oracle.distance_matrix_packed(seqs, cfg.k, cfg.canonical)
        return {
            "counts_equal": bool(np.array_equal(got.hist, want)),
            "distances_equal": bool(np.array_equal(d_got, d_want)),
            "n_seqs": len(seqs),
            "total_kmers": int(want.sum()),
        }
