"""Host staging of the device encoder's planes, and the dense distance
engine.

The port of ``dna_kmeres_parallel_tpu/models/engine.py``'s plane staging
(``pack_planes_np``, ``stage_batch_planes``) and of its ``KmerEngine``
distance entries (``counts_matrix``, ``distance_sequences``,
``distance_file``, ``distance_stream_to_csv``, ``make_dense_panel_fn``).
The dense counting entries come with ROADMAP item 6.
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
from dna_kmeres_parallel_tpu_torch.ops.encode_cuda import host_planes_from_packfmt
from dna_kmeres_parallel_tpu_torch.utils import codec, fasta
from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig


def pack_planes_np(flat_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack a padded u8 base stream (length a multiple of 16) with the
    native packer and build the encoder's u32 (words_le, inval_be) planes,
    NumPy in and NumPy out."""
    data, mask, _ = native.pack_2bit_native(flat_u8)
    return host_planes_from_packfmt(data, mask)


def planes_to_device(
    planes: tuple[np.ndarray, np.ndarray], device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """u32 NumPy planes -> int32 tensors on ``device`` with the same bits.
    To the card they go through pinned host memory."""
    out = []
    for plane in planes:
        t = torch.from_numpy(plane.view(np.int32))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out[0], out[1]


def stage_batch_planes(
    padded: np.ndarray, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Planes of a padded batch on ``device``: 0.5 B per base."""
    return planes_to_device(pack_planes_np(padded), device)


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
    """Single-device dense distance engine, k <= 8: the per-sequence
    counts matrix (K2), the (min,+) product (K3 for all pairs, K4 for a
    streamed panel), and the float32 finish on the host."""

    def __init__(
        self,
        config: KmerConfig | None = None,
        device: str | torch.device = "cuda",
        **kw,
    ):
        cfg = config or KmerConfig()
        self.config = cfg.replace(**kw) if kw else cfg
        if self.config.k > MAX_DIST_K:
            raise NotImplementedError(
                f"distances at k={self.config.k} need more than 4^{MAX_DIST_K} "
                "dense bins: they go through sparse tables, which are not "
                "ported yet (ROADMAP item 8)"
            )
        self.device = runtime.resolve_device(device)
        native.load()

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
            g = torch.from_numpy(grid)
            if dev.type == "cuda":
                g = g.pin_memory().to(dev, non_blocking=True)
            out[lo:hi] = histogram_cuda.counts_matrix_grid(
                g, cfg.k, cfg.bins, cfg.canonical
            )
        return out

    def counts_matrix(self, seqs: list[str]) -> np.ndarray:
        """Per-sequence count vectors, int32 [S, 4^k], on the host."""
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
        t0 = time.perf_counter()
        phases = dict.fromkeys(DIST_PHASES, 0.0)
        return self._distances(*seq_stream(seqs), ids, phases, t0)

    def distance_file(self, source) -> DistanceResult:
        """Packed pairwise distances of the records of a FASTA file (the
        native parser for a path with the modern record semantics, the
        Python parsers otherwise)."""
        cfg = self.config
        t0 = time.perf_counter()
        phases = dict.fromkeys(DIST_PHASES, 0.0)
        if cfg.parser_variant == "modern" and isinstance(source, (str, os.PathLike)):
            parsed = native.parse_fasta_native(source, max_seqs=cfg.max_seqs)
            args = (parsed.stream, parsed.offsets[:-1], parsed.lengths, parsed.ids)
        else:
            if cfg.parser_variant == "modern":
                records = fasta.parse_fasta(source, max_seqs=cfg.max_seqs)
            else:
                records = fasta.parse_fasta_reference(
                    source, variant=cfg.parser_variant, max_seqs=cfg.max_seqs
                )
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
