"""Multi-host counting and distances: one rank per card.

The port of ``dna_kmeres_parallel_tpu/parallel/multihost.py``, on
``torch.distributed`` and the port's meshes (``parallel/mesh``):

1. every process calls ``init_distributed()`` (torchrun's environment, or
   arguments): one rank per card, NCCL between cards;
2. the input FASTA is split into record-aligned byte ranges, one per rank
   (``split_fasta_byte_ranges``): every range starts at a record header,
   so no record is dropped, split or counted twice;
3. each rank parses its range with the native parser
   (``encode_range_stream``) and contributes its slab of the global stream
   (``make_global_stream``);
4. the data-parallel programs (``parallel/sharded_count``,
   ``parallel/bucketed``) run over the mesh: the histogram merge is an
   integer all-reduce, exact at any rank count.

A mesh says who takes part: a ``ProcessGroupMesh`` is one shard per rank
of a process group; a ``LocalMesh`` is one process's mesh, so the run is
that process's alone and reads the whole file. The resumable entries keep
two checkpoint generations per rank (``{base}.p{rank}.g{gen}.npz``, the
``.npz`` format of ``utils/checkpoint``, the JAX package's file names),
and a restart resumes from the newest step every rank has on disk.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models.engine import host_to_device
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import DistanceRates, merge_sparse_tables
from dna_kmeres_parallel_tpu_torch.ops import runtime
from dna_kmeres_parallel_tpu_torch.ops.encode import INVALID
from dna_kmeres_parallel_tpu_torch.parallel import bucketed, sharded_count
from dna_kmeres_parallel_tpu_torch.parallel.mesh import ProcessGroupMesh
from dna_kmeres_parallel_tpu_torch.parallel.sharded_sparse import stage_shard_planes
from dna_kmeres_parallel_tpu_torch.utils import checkpoint as ckpt_mod
from dna_kmeres_parallel_tpu_torch.utils import fasta

#: the failures of reading one checkpoint generation that make it absent
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def split_fasta_byte_ranges(path: str, n_parts: int) -> list[tuple[int, int]]:
    """Split a FASTA file into n record-aligned byte ranges.

    Each range starts at the beginning of a record header line ('>' at file
    start or right after a newline). Ranges partition the file: every byte
    belongs to exactly one range, and every record lies entirely within one
    range (records are never split because boundaries are record starts).
    """
    size = os.path.getsize(path)
    if n_parts <= 1 or size == 0:
        return [(0, size)]
    bounds = [0]
    with open(path, "rb") as f:
        for i in range(1, n_parts):
            target = size * i // n_parts
            search_start = max(target - 1, 0)
            f.seek(search_start)
            # Scan forward for the next "\n>" (a record start), keeping a
            # 1-byte overlap so the pattern is seen across read boundaries.
            pos = None
            abs_pos = search_start
            overlap = b""
            while pos is None:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                buf = overlap + chunk
                j = buf.find(b"\n>")
                if j >= 0:
                    pos = abs_pos - len(overlap) + j + 1
                    break
                abs_pos += len(chunk)
                overlap = buf[-1:]
            bounds.append(pos if pos is not None else size)
        bounds.append(size)
    # Ranges may collapse (a record longer than a part) but keep order.
    return [(a, max(a, b)) for a, b in zip(bounds[:-1], bounds[1:])]


def read_range_records(path: str, start: int, end: int) -> list[fasta.FastaRecord]:
    """Parse the records whose header starts within [start, end), in
    Python (``utils/fasta.parse_fasta``)."""
    with open(path, "rb") as f:
        f.seek(start)
        data = f.read(end - start)
    return fasta.parse_fasta(data)


def encode_range_stream(path: str, start: int, end: int) -> tuple[np.ndarray, int, int]:
    """Byte range -> (flat encoded stream with 0xFF separators, real bases,
    records): one rank's share of the input, by the native parser."""
    parsed = native.parse_fasta_native(path, byte_range=(start, end))
    return parsed.stream, parsed.total_bases, parsed.n_seqs


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> torch.device:
    """Join this process to the run's process group; returns the device
    its entries run on.

    Arguments left None come from torchrun's environment: the coordinator
    ``MASTER_ADDR:MASTER_PORT`` (a URL such as ``file:///...`` or
    ``tcp://host:port`` is taken as it is), ``WORLD_SIZE`` and ``RANK``.
    ``device`` defaults to "cuda": a "cuda" without an index is the card
    ``LOCAL_RANK`` names (else the rank modulo the cards), bound with
    ``torch.cuda.set_device`` before the group starts; "cpu" asks for the
    CPU. The backend is NCCL on cards and gloo on the CPU, or the one
    given (gloo lets several ranks share one card). With one process, or
    inside a group that exists, nothing is started."""
    import torch.distributed as dist

    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if "LOCAL_RANK" in env:
            local = int(env["LOCAL_RANK"])
        else:
            local = process_id % max(torch.cuda.device_count(), 1)
        dev = torch.device("cuda", local)
    dev = runtime.resolve_device(dev)
    if num_processes <= 1 or dist.is_initialized():
        return dev
    if coordinator_address is None:
        if "MASTER_ADDR" not in env:
            raise ValueError("a run of several processes needs its coordinator: pass "
                             "coordinator_address or set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=coordinator_address, world_size=num_processes, rank=process_id,
    )
    return dev


def _rank_count(mesh) -> tuple[int, int]:
    """(this process's rank, processes): a ``ProcessGroupMesh`` is one
    shard per rank; any other mesh is one process's."""
    if isinstance(mesh, ProcessGroupMesh):
        return mesh.rank, mesh.size
    return 0, 1


def _per_process(obj, mesh) -> list:
    """Every process's ``obj``, in rank order (one all-gather)."""
    if isinstance(mesh, ProcessGroupMesh):
        return mesh.gather([obj])
    return [obj]


def _local_stream(path: str, mesh) -> tuple[np.ndarray, int, int]:
    """This rank's byte range of ``path``, encoded (``encode_range_stream``)."""
    rank, pcount = _rank_count(mesh)
    ranges = split_fasta_byte_ranges(path, pcount)
    return encode_range_stream(path, *ranges[rank % len(ranges)])


def make_global_stream(local_flat: np.ndarray, mesh) -> torch.Tensor:
    """This process's part of the global stream, as the local shards' rows
    on the mesh's device.

    On a ``LocalMesh`` of D shards: the stream padded with INVALID to a
    multiple of D, as [D, T/D] rows (``sharded_count.shard_stream``). On a
    ``ProcessGroupMesh``: this rank's slab, [1, target]; every rank pads
    to the same ``target``, the longest rank's length plus one, so every
    slab ends in INVALID."""
    if not isinstance(mesh, ProcessGroupMesh):
        return sharded_count.shard_stream(local_flat, mesh)
    # target is max + 1, NOT max: each rank's records are complete, so no
    # window may span two ranks' slabs. Without a trailing INVALID the
    # longest slab (which gets no padding) would sit flush against the
    # next rank's first record, and the halo exchange would count k-1
    # phantom windows across the two ranks.
    target = max(_per_process(int(local_flat.shape[0]), mesh)) + 1
    slab = np.full((1, target), INVALID, dtype=np.uint8)
    slab[0, : local_flat.shape[0]] = local_flat
    return host_to_device(slab, mesh.device)


def _require_dense(config, name: str) -> None:
    if not config.dense:
        raise ValueError(
            f"{name} is the dense-histogram path (k={config.k} is past "
            f"dense_bins_limit); bucket-sharded sparse counting is "
            "count_file_bucketed_multihost_resumable"
        )


def count_file_multihost(path: str, config, mesh):
    """Each rank counts its record-aligned range; the shards' histograms
    are summed over the mesh (``sharded_count.count_sharded``).

    Returns (the replicated dense histogram as np.int64, this rank's real
    bases, this rank's records)."""
    _require_dense(config, "count_file_multihost")
    flat, total_bases, n_seqs = _local_stream(path, mesh)
    stream = make_global_stream(flat, mesh)
    hist = sharded_count.count_sharded(stream, config.k, config.bins, config.canonical, mesh)
    return hist.cpu().numpy().astype(np.int64), total_bases, n_seqs


def _ckpt_file(base: str, rank: int, gen: int) -> str:
    return f"{base}.p{rank}.g{gen}.npz"


def _save_step(checkpoint_path: str, rank: int, steps_done: int, batch: int, max_len: int,
               config, **state) -> None:
    """Save the state after ``steps_done`` steps into generation
    steps_done % 2 (the other generation keeps the step before)."""
    ckpt_mod.save_checkpoint(
        _ckpt_file(checkpoint_path, rank, steps_done % 2),
        ckpt_mod.CountCheckpoint(k=config.k, canonical=config.canonical,
                                 cursor=steps_done * batch, total_bases=max_len, **state),
    )


def _common_resume_step(checkpoint_path: str, rank: int, mesh, batch: int, max_len: int,
                        config, want_dense: bool):
    """Two-generation resume: the newest step EVERY rank has a valid
    checkpoint for (a kill can leave the ranks' saves one step apart; the
    older generation covers that gap). One all-gather of each rank's two
    newest steps. Returns (checkpoint or None, first step)."""
    mine = {}
    for gen in (0, 1):
        try:
            ck = ckpt_mod.load_checkpoint(_ckpt_file(checkpoint_path, rank, gen))
        except _UNREADABLE:
            continue
        # cursor is in BASES (steps_done * batch at save time), so a
        # resume with a different batch size is accepted only when it
        # divides the saved progress cleanly.
        if (ck.dense == want_dense and ck.k == config.k and ck.canonical == config.canonical
                and ck.total_bases == max_len and ck.cursor % batch == 0):
            mine[ck.cursor] = ck
    have = sorted(mine, reverse=True)[:2]
    every = _per_process(have, mesh)
    for s in have:
        if s and all(s in other for other in every):
            return mine[s], s // batch
    return None, 0


def count_file_multihost_resumable(
    path: str,
    config,
    mesh,
    checkpoint_path: str | None = None,
    batch_bases: int | None = None,
    max_steps: int | None = None,
):
    """Batched, checkpointed multi-host dense count (a restart resumes
    from the last merged histogram).

    Every rank runs the SAME number of steps, ceil(longest range /
    batch): step s takes the local range's [s*batch, s*batch + batch + k
    - 1) (the k-1 tail completes the windows that start inside the batch),
    lays it into an INVALID-guarded slab of batch + k bases rounded up to
    the local shards, and sums the step's histogram over the mesh. After
    each step every rank saves (steps done, merged histogram) into its
    own two-generation checkpoint; a restart resumes from the newest step
    every rank has on disk. Integer adds make the resumed result equal to
    a single-shot run at any rank or shard count.

    max_steps: stop after N steps in this call (with progress saved).
    Returns (hist, this rank's real bases, its records, steps done,
    steps)."""
    _require_dense(config, "count_file_multihost_resumable")
    k, bins = config.k, config.bins
    batch = int(batch_bases or config.batch_bases)
    rank, _ = _rank_count(mesh)
    flat, total_bases, n_seqs = _local_stream(path, mesh)
    max_len = max(_per_process(int(flat.shape[0]), mesh))
    n_steps = max(-(-max_len // batch), 1)
    n_local = len(mesh.local_shards)
    slab = batch + k  # + (k-1) halo + >= 1 guaranteed trailing INVALID
    slab += (-slab) % n_local

    hist = np.zeros(bins, dtype=np.int64)
    first_step = 0
    if checkpoint_path:
        ck, first_step = _common_resume_step(checkpoint_path, rank, mesh, batch, max_len,
                                             config, want_dense=True)
        if ck is not None:
            hist = ck.hist.astype(np.int64)

    steps_done = first_step
    for step in range(first_step, n_steps):
        if max_steps is not None and steps_done - first_step >= max_steps:
            break
        lo = step * batch
        seg = flat[lo : lo + batch + k - 1]
        buf = np.full(slab, INVALID, dtype=np.uint8)
        buf[: seg.shape[0]] = seg
        rows = host_to_device(buf.reshape(n_local, -1), mesh.device)
        h = sharded_count.count_sharded(rows, k, bins, config.canonical, mesh)
        hist += h.cpu().numpy()
        steps_done = step + 1
        if checkpoint_path:
            _save_step(checkpoint_path, rank, steps_done, batch, max_len, config, hist=hist)
    return hist, total_bases, n_seqs, steps_done, n_steps


def count_file_bucketed_multihost_resumable(
    path: str,
    config,
    mesh,
    checkpoint_path: str | None = None,
    batch_bases: int | None = None,
    max_steps: int | None = None,
    owner_mode: str = "prefix",
):
    """Batched, checkpointed bucket-sharded sparse count (BASELINE config
    5, k up to 31, with the dense path's resume contract).

    Per step s, every rank takes its range's [s*batch, s*batch + batch +
    k - 1), cuts it into its local shards' grid [n_local, span + k - 1]
    (row r owns the windows that start in [r*span, (r+1)*span) of the
    batch; span from the agreed batch, so every rank's send capacity is
    the same), stages the rows' planes (K1, or K1m for minimizer owners)
    and runs the aggregated exchange over the mesh
    (``bucketed.count_bucket_sharded``). Each rank compacts only its own
    shards' rows (owners partition the code space, so the ranks' tables
    are disjoint) into its running table, and saves (cursor, table) under
    the dense path's two-generation protocol.

    Returns (codes_u64, counts_i64, this rank's real bases, its records,
    steps done, steps): the codes this rank's shards own; the union over
    the ranks is the global table."""
    k = config.k
    batch = int(batch_bases or config.batch_bases)
    rank, _ = _rank_count(mesh)
    n_local = len(mesh.local_shards)
    flat, total_bases, n_seqs = _local_stream(path, mesh)
    max_len = max(_per_process(int(flat.shape[0]), mesh))
    n_steps = max(-(-max_len // batch), 1)
    span = max(-(-batch // n_local), 1)  # owned windows per local shard
    halo = k - 1

    codes = np.zeros(0, np.uint64)
    counts = np.zeros(0, np.int64)
    first_step = 0
    if checkpoint_path:
        ck, first_step = _common_resume_step(checkpoint_path, rank, mesh, batch, max_len,
                                             config, want_dense=False)
        if ck is not None:
            codes = ck.sparse_codes.astype(np.uint64)
            counts = ck.sparse_counts.astype(np.int64)

    steps_done = first_step
    for step in range(first_step, n_steps):
        if max_steps is not None and steps_done - first_step >= max_steps:
            break
        seg = flat[step * batch : step * batch + batch + halo]
        local = np.full((n_local, span + halo), INVALID, dtype=np.uint8)
        n_own = np.zeros(n_local, dtype=np.int32)
        for r in range(n_local):
            s0 = r * span
            piece = seg[s0 : s0 + span + halo]
            local[r, : piece.shape[0]] = piece
            n_own[r] = int(np.clip(batch - s0, 0, span))
        hi, lo_w, cnt, starts, overflow = bucketed.count_bucket_sharded(
            stage_shard_planes(local), n_own, k, config.canonical, mesh,
            owner_mode=owner_mode, staged_planes=True,
        )
        if overflow:
            raise RuntimeError(
                "bucketed send capacity overflow — re-run with a smaller "
                "batch_bases (capacity scales with the per-step window "
                "count)"
            )
        codes, counts = merge_sparse_tables(
            [(codes, counts), bucketed.gather_table(hi, lo_w, cnt, starts)])
        steps_done = step + 1
        if checkpoint_path:
            _save_step(checkpoint_path, rank, steps_done, batch, max_len, config,
                       sparse_codes=codes, sparse_counts=counts)
    return codes, counts, total_bases, n_seqs, steps_done, n_steps


def _record_strings(parsed) -> list[str]:
    """The parsed records as strings, every invalid character as 'N'
    (what counting and distances read of a record is the same)."""
    letters = np.frombuffer(b"ACGTN", dtype=np.uint8)
    chars = letters[np.minimum(parsed.stream, 4)]
    return [chars[o : o + n].tobytes().decode("ascii")
            for o, n in zip(parsed.offsets[:-1].tolist(), parsed.lengths.tolist())]


def distance_file_multihost_resumable(
    path: str,
    config,
    output_path: str,
    checkpoint_path: str | None = None,
    panel_rows: int = 2048,
    max_panels: int | None = None,
    stitch: bool = True,
    *,
    rates: DistanceRates = DistanceRates(),
    threshold: str = "auto",
    threshold_cap: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Multi-host pairwise distances with resume.

    Ownership is by row range of the packed strict upper triangle: rank p
    of the process group (one process when there is none) streams the
    pair-balanced row block ``balanced_row_splits(S, P)[p]`` to
    ``{output}.part{p}`` with the resumable writer (its own checkpoint
    ``{checkpoint}.p{p}``; fsync, then checkpoint). Every rank parses the
    whole input with the native parser (each row block needs every
    partner's counts), reading the records of ``utils/fasta.parse_fasta``
    as the JAX package does (``native.parse_fasta_text``). The regime is
    dense (``KmerEngine``'s counts matrix and (min,+) panels) or sparse
    (``distance_sparse_stream_to_csv``), by ``dense_distance_preferred``
    under rank 0's ``rates``, which every rank takes (one broadcast), so
    ranks with different calibrations take one regime. ``threshold`` and
    ``threshold_cap`` are the threshold route's gate
    (``sparse_engine.threshold_plan``) in either regime.

    The ranks then all-gather their completion flags; when every block is
    done, rank 0 concatenates the parts in rank order into
    ``output_path`` (the single-process byte stream), with fsync and an
    atomic rename, so a kill during the stitch re-runs it.

    max_panels bounds this call's panels (a preemption in tests). Returns
    this rank's report with ``regime``, ``rows`` and ``all_complete``."""
    import torch.distributed as dist

    from dna_kmeres_parallel_tpu_torch.models import distance_stream
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
        dense_distance_preferred,
        distance_sparse_stream_to_csv,
    )
    from dna_kmeres_parallel_tpu_torch.ops.encode import MAX_DENSE_K

    dev = runtime.resolve_device(device)
    grouped = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    pcount = dist.get_world_size() if grouped else 1
    if pcount > 1:
        shared = [rates]
        dist.broadcast_object_list(shared, src=0)
        rates = shared[0]
    parsed = native.parse_fasta_text(path)
    seqs = _record_strings(parsed)
    S = len(seqs)
    splits = distance_stream.balanced_row_splits(S, pcount)
    lo, hi = splits[rank % len(splits)]
    part = f"{output_path}.part{rank}"
    ck = f"{checkpoint_path}.p{rank}" if checkpoint_path else None
    k = config.k
    kw = dict(panel_rows=panel_rows, checkpoint_path=ck, max_panels=max_panels, row_lo=lo,
              row_hi=hi)
    if k <= MAX_DENSE_K and dense_distance_preferred(S, k, parsed.lengths, rates=rates):
        report = KmerEngine(config, device=dev, threshold=threshold, threshold_cap=threshold_cap,
                            rates=rates).distance_stream_to_csv(seqs, part, **kw)
        report["regime"] = "dense"
    else:
        report = distance_sparse_stream_to_csv(seqs, k, part, config.canonical, device=dev,
                                               rates=rates, threshold=threshold,
                                               threshold_cap=threshold_cap, **kw)
        report["regime"] = "sparse"
    done = bool(report["completed"])
    if pcount > 1:
        every: list = [None] * pcount
        dist.all_gather_object(every, done)
    else:
        every = [done]
    complete = all(every)
    report["all_complete"] = complete
    report["rows"] = [int(lo), int(hi)]
    if complete and stitch and rank == 0:
        tmp = f"{output_path}.stitch.tmp"
        with open(tmp, "wb") as out_f:
            for p in range(len(splits)):
                with open(f"{output_path}.part{p}", "rb") as in_f:
                    while chunk := in_f.read(1 << 24):
                        out_f.write(chunk)
            out_f.flush()
            os.fsync(out_f.fileno())
        os.replace(tmp, output_path)
        report["output"] = str(output_path)
    return report
