"""Data-parallel dense counting and distances over a mesh.

The counterpart of ``dna_kmeres_parallel_tpu/parallel/sharded_count.py``.
A flat base stream is cut into D equal shards; each shard counts the
windows that start in it, reading the next k-1 bases of the stream as its
halo (``stream_halo``), with the single-device histogram kernels
(``ops/histogram_cuda.histogram_stream``: K7 up to 64 bins, K6 for a
power of two up to 65,536 bins, K8 otherwise), and the shards' integer
histograms are summed (``mesh.sum_reduce``): exact, so the result equals
the single-device count at any D. The (min,+) distance products run K4
(or the threshold route, ``ops/threshold_cuda``) per shard: rows sharded
against the gathered matrix (``min_sum_matrix_sharded``), or a
replicated row panel against sharded partner rows with the outputs side
by side and no collective (``min_sum_panel_sharded``).

A sharded operand is given as the rows of the mesh's local shards,
stacked (``parallel/mesh``): on a ``LocalMesh`` the whole operand, on a
``ProcessGroupMesh`` the rank's block; results likewise. On the card the
shards run the kernels, on the CPU their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch.models.engine import host_to_device
from dna_kmeres_parallel_tpu_torch.ops import distance_cuda, histogram_cuda, threshold_cuda
from dna_kmeres_parallel_tpu_torch.ops.encode import INVALID


def _count_shard(bases: torch.Tensor, n_own: int, k: int, bins: int, canonical: bool,
                 acc: torch.Tensor) -> torch.Tensor:
    """acc += the histogram of one halo-carrying shard's windows that start
    below n_own (``histogram_stream``: K7, K6 or K8 by ``bins`` on the
    card, as the JAX package's ``histogram_pallas`` routes)."""
    return histogram_cuda.histogram_stream(bases, n_own, k, bins, canonical, acc)


def _by_shard(x: torch.Tensor, mesh, name: str) -> dict[int, torch.Tensor]:
    """Shard index -> that shard's rows of a sharded operand (the local
    shards' equal row blocks). The operand's global row count must divide
    by D."""
    n = len(mesh.local_shards)
    if x.shape[0] % n or (n == mesh.size and x.shape[0] % mesh.size):
        raise ValueError(f"{name}: {x.shape[0]} rows are not divisible by the "
                         f"mesh's {mesh.size} shards")
    rows = x.shape[0] // n
    return {s: x[i * rows : (i + 1) * rows] for i, s in enumerate(mesh.local_shards)}


def halo_exchange(shards: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """[local, Ts] uint8 shards -> [local, Ts + h]: each shard followed by
    the next shard's first h = min(k-1, Ts) bases, the last shard by
    INVALID bases (the stream's end)."""
    heads = shards[:, : k - 1].contiguous()
    return torch.cat([shards, mesh.halo(heads)], dim=1)


def stream_halo(shards: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """[local, Ts] uint8 shards -> [local, Ts + k - 1]: each shard followed
    by the next k-1 bases of the stream, INVALID past its end.

    Where Ts >= k - 1 those are the next shard's head (``halo_exchange``).
    A shorter shard's halo spans several shards, where ``halo_exchange``
    would hand over only Ts bases and lose the windows that reach past the
    next shard: every shard's row is gathered (``mesh.all_gather``) and
    each halo is read off the flat stream."""
    h = k - 1
    Ts = shards.shape[1]
    if Ts >= h:
        return halo_exchange(shards, k, mesh)
    flat = mesh.all_gather(shards.contiguous()).reshape(-1)
    flat = torch.cat([flat, flat.new_full((h,), INVALID)])
    first = (torch.tensor(mesh.local_shards, device=shards.device) + 1) * Ts
    idx = first[:, None] + torch.arange(h, device=shards.device)[None, :]
    return torch.cat([shards, flat[idx]], dim=1)


def count_sharded(bases: torch.Tensor, k: int, bins: int, canonical: bool, mesh,
                  n_own: int | None = None, acc: torch.Tensor | None = None) -> torch.Tensor:
    """A base stream sharded over ``mesh`` -> int32 [bins], ``acc`` (zeros
    when None) plus the histogram summed over every shard.

    bases: a flat uint8 [T] stream (T divisible by D, cut into D shards of
    T/D) or the local shards' rows, [local, T/D] (``shard_stream``).
    n_own: count only the windows whose GLOBAL start is below it (the
    streaming counter's rule: a batch's k-1 tail bases complete its last
    windows but start none), so shard d owns min(T/D, max(n_own - d T/D,
    0)) windows. Every shard launches its kernel once."""
    D = mesh.size
    if bases.dim() == 1:
        if bases.shape[0] % D:
            raise ValueError(f"stream length {bases.shape[0]} is not divisible by the "
                             f"mesh's {D} shards")
        bases = bases.reshape(D, -1)[mesh.local_shards]
    Ts = bases.shape[1]
    with_halo = _by_shard(stream_halo(bases, k, mesh), mesh, "count_sharded")
    if acc is None:
        acc = torch.zeros(bins, dtype=torch.int32, device=bases.device)

    def add(s: int, out: torch.Tensor) -> None:
        own = Ts if n_own is None else min(Ts, max(int(n_own) - s * Ts, 0))
        _count_shard(with_halo[s][0], own, k, bins, canonical, out)

    return mesh.sum_reduce(add, acc)


def _rect(panel: torch.Tensor, other: torch.Tensor, threshold: int | None) -> torch.Tensor:
    """One shard's [Pr, S2] product: K4, or the threshold route at cmax
    ``threshold`` (``ops/threshold_cuda``)."""
    if threshold is None:
        return distance_cuda.min_sum_matrix_rect(panel, other)
    return threshold_cuda.min_sum_matrix_threshold(panel, threshold, other)


def min_sum_matrix_sharded(counts: torch.Tensor, mesh,
                           threshold: int | None = None) -> torch.Tensor:
    """Row-sharded (min,+) matrix: each shard's rows of the int32 [S, B]
    counts against the gathered matrix (K4 per shard, or the threshold
    route at cmax ``threshold``). Returns the local shards' rows of the
    [S, S] int32 min-sums. S must divide by D."""
    blocks = _by_shard(counts, mesh, "min_sum_matrix_sharded")
    full = mesh.all_gather(counts)
    return torch.cat(mesh.run(lambda s: _rect(blocks[s], full, threshold)))


def min_sum_panel_sharded(panel: torch.Tensor, other: torch.Tensor, mesh,
                          threshold: int | None = None) -> torch.Tensor:
    """Partner-sharded (min,+) panel: the replicated row panel [Pr, B]
    against each shard's partner rows of ``other`` [S2, B] (K4 per shard,
    or the threshold route at cmax ``threshold``), the outputs side by
    side along columns, no collective. Returns the local shards' columns
    of the [Pr, S2] int32 min-sums. S2 must divide by D: pad with
    zero-count rows (their min-sums are 0) and slice them off, as
    ``models/engine.min_sum_panel_mesh`` does."""
    blocks = _by_shard(other, mesh, "min_sum_panel_sharded")
    return torch.cat(mesh.run(lambda s: _rect(panel, blocks[s], threshold)), dim=1)


def shard_rows(flat: np.ndarray, mesh) -> np.ndarray:
    """A host uint8 stream padded with INVALID to a multiple of D, as the
    local shards' rows: [local, T/D] (all D rows on a ``LocalMesh``)."""
    D = mesh.size
    pad = (-flat.shape[0]) % D
    if pad:
        flat = np.concatenate([flat, np.full(pad, INVALID, dtype=np.uint8)])
    return np.ascontiguousarray(flat.reshape(D, -1)[mesh.local_shards])


def shard_stream(flat: np.ndarray, mesh) -> torch.Tensor:
    """``shard_rows`` on the mesh's device: the counterpart of the JAX
    package's ``device_put_sharded_stream``."""
    return host_to_device(shard_rows(flat, mesh), mesh.device)
