"""Data-parallel sparse counting: each shard encodes (and sorts) its own
part of the stream on the device, the host compacts each shard's words
and merges the tables.

The counterpart of ``dna_kmeres_parallel_tpu/parallel/sharded_sparse.py``.
The stream is cut into D halo-carrying shards
(``bucketed.shard_stream_with_halo``: shard d owns ``n_own[d]`` windows
and reads k-1 bases past them), so every window is counted by exactly one
shard, and the integer merge makes the table equal to a single-device
count at any D. No collective: the shards' words come to the host.

Four routes, as the JAX module has them, picked by the staging
(``pack_input``: u32 planes for K1, ``stage_shard_planes``; u8 shards for
K9) and by ``device_sort`` (each shard's words then also sorted as rows of
``row_len``: K11 for single-word rows with ``pallas_sort``, ``torch.sort``
otherwise). Each shard's input goes to the device in its turn; the
outputs are stacked [local shards, ...] on the mesh's device, with
all-ones sentinels in unused slots.
"""

from __future__ import annotations

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch.models.engine import host_to_device, pack_planes_np
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
    compact_table,
    compact_unsorted,
    fetch_words,
    merge_sparse_tables,
)
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops
from dna_kmeres_parallel_tpu_torch.ops.encode import INVALID

#: rows of the sharded device sorts when ``sort_row_len`` is 0 (the JAX
#: package's: a mesh always sorts rows)
ROW_LEN = 2048


def stage_shard_planes(shards: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[D, Ts] uint8 halo-carrying shards -> ([D, Tw] words_le u32, [D, Tw]
    inval_be u32), Tw = ceil(Ts / 16).

    Rows pad to a 16-base multiple with INVALID (pad windows are invalid
    or past n_own either way), then ONE flattened pack and plane build
    serves every row: row spans stay word-aligned."""
    D, Ts = shards.shape
    Tp = -(-Ts // 16) * 16
    if Tp != Ts:
        padded = np.full((D, Tp), INVALID, dtype=np.uint8)
        padded[:, :Ts] = shards
    else:
        padded = shards
    w_le, iv_be = pack_planes_np(np.ascontiguousarray(padded).reshape(-1))
    return w_le.reshape(D, -1), iv_be.reshape(D, -1)


def _ship(inputs, s: int, mesh) -> tuple[torch.Tensor, ...]:
    """Shard s's rows of each [D, ...] host input (arrays or CPU tensors),
    on the mesh's device."""
    return tuple(host_to_device(a[s], mesh.device) for a in inputs)


def _stacked(mesh, shard_words, rows: int | None = None) -> tuple[torch.Tensor, ...]:
    """Each local shard's word tuple (``shard_words(s)``), written into
    stacked planes [local, ...] as it is made, so no shard's words and
    temporaries outlive its turn. With ``rows``, each plane is [local,
    rows, row_len] and a shard's missing rows stay all sentinels (empty
    bags for the row compactor)."""
    out: list[torch.Tensor] = []
    local = {s: i for i, s in enumerate(mesh.local_shards)}

    def put(s: int) -> None:
        got = shard_words(s)
        if not out:
            out.extend(g.new_full((len(local), *((rows, g.shape[1]) if rows else g.shape)),
                                  sparse_ops.word_sentinel(g.dtype)) for g in got)
        for o, g in zip(out, got, strict=True):
            o[local[s], : g.shape[0]] = g

    mesh.run(put)
    return tuple(out)


def encode_words_sharded(shards, n_own_per_shard, k: int, canonical: bool, mesh):
    """[D, Ts] uint8 halo-carrying shards -> each local shard's UNSORTED
    word tuple, planes [local, Ts] (K9 per shard). The host radix
    compactor absorbs each shard's plane."""
    return _stacked(mesh, lambda s: sparse_ops.encode_words(
        *_ship((shards,), s, mesh), int(n_own_per_shard[s]), k, canonical))


def encode_words_planes_sharded(words_le, inval_be, n_own_per_shard, k: int, canonical: bool,
                                mesh):
    """[D, Tw] u32 plane shards (``stage_shard_planes``) -> each local
    shard's UNSORTED word tuple, planes [local, 16 Tw] (K1 per shard)."""
    return _stacked(mesh, lambda s: sparse_ops.encode_words_planes(
        *_ship((words_le, inval_be), s, mesh), int(n_own_per_shard[s]), k, canonical))


def _sorted_rows(shard_words, n_own_per_shard, mesh, row_len: int, pallas_sort: bool):
    """Each local shard's owned words (``shard_words(s)``) sorted as rows of
    ``row_len`` (``sparse.sort_encoded``), stacked [local, rows, row_len]
    with the rows of the shard that owns the most windows."""
    rows = max(1, -(-int(max(n_own_per_shard[s] for s in mesh.local_shards)) // row_len))
    return _stacked(mesh, lambda s: sparse_ops.sort_encoded(
        shard_words(s), int(n_own_per_shard[s]), row_len, pallas_sort), rows)


def sort_words_rows_sharded(shards, n_own_per_shard, k: int, canonical: bool, mesh,
                            row_len: int = ROW_LEN, pallas_sort: bool = False):
    """[D, Ts] uint8 halo-carrying shards -> each local shard's owned
    windows as [rows, row_len] independently sorted rows, stacked [local,
    rows, row_len] (K9, then the row sorts, per shard)."""
    def words(s):
        return sparse_ops.encode_words(*_ship((shards,), s, mesh), int(n_own_per_shard[s]), k,
                                       canonical)

    return _sorted_rows(words, n_own_per_shard, mesh, row_len, pallas_sort)


def sort_words_rows_planes_sharded(words_le, inval_be, n_own_per_shard, k: int,
                                   canonical: bool, mesh, row_len: int = ROW_LEN,
                                   pallas_sort: bool = False):
    """``sort_words_rows_sharded`` from [D, Tw] u32 plane shards (K1, then
    the row sorts, per shard)."""
    def words(s):
        return sparse_ops.encode_words_planes(*_ship((words_le, inval_be), s, mesh),
                                              int(n_own_per_shard[s]), k, canonical)

    return _sorted_rows(words, n_own_per_shard, mesh, row_len, pallas_sort)


def encode_shards(inputs: tuple, n_own_per_shard, k: int, canonical: bool, mesh, *,
                  device_sort: bool, row_len: int = ROW_LEN, pallas_sort: bool = False):
    """One of the four routes: ``inputs`` is the [D, Tw] (words_le,
    inval_be) plane pair of ``stage_shard_planes`` (K1) or the [D, Ts] u8
    shards alone (K9); ``device_sort`` adds the row sorts."""
    if device_sort and len(inputs) == 2:
        return sort_words_rows_planes_sharded(*inputs, n_own_per_shard, k, canonical, mesh,
                                              row_len, pallas_sort)
    if device_sort:
        return sort_words_rows_sharded(*inputs, n_own_per_shard, k, canonical, mesh, row_len,
                                       pallas_sort)
    if len(inputs) == 2:
        return encode_words_planes_sharded(*inputs, n_own_per_shard, k, canonical, mesh)
    return encode_words_sharded(*inputs, n_own_per_shard, k, canonical, mesh)


def compact_shards(host_words, k: int, sorted_rows: bool) -> list:
    """Host word planes [local, ...] -> one sorted (codes, counts) table
    per shard: the row compactor for sorted rows, else the radix compactor
    of unsorted words."""
    tables = []
    for d in range(host_words[-1].shape[0]):
        plane = tuple(w[d] for w in host_words)
        tables.append(compact_table(plane) if sorted_rows else compact_unsorted(plane, k))
    return tables


def count_sparse_sharded(
    flat: np.ndarray,
    k: int,
    canonical: bool,
    mesh,
    row_len: int = ROW_LEN,
    total_own=None,
    device_sort: bool = True,
    pack_input: bool = True,
    pallas_sort: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """A flat host stream -> its exact sorted (codes_u64, counts_i64)
    table, counted data-parallel over ``mesh``: halo shards, one of the
    four routes (K1 from planes with ``pack_input``, K9 from u8 shards;
    row sorts with ``device_sort``), one compaction a shard, one merge.
    total_own: only windows starting before it are owned."""
    # bucketed imports this module (stage_shard_planes): import it here
    from dna_kmeres_parallel_tpu_torch.parallel.bucketed import shard_stream_with_halo

    shards, n_own = shard_stream_with_halo(flat, k, mesh, total_own)
    inputs = stage_shard_planes(shards) if pack_input else (shards,)
    words = encode_shards(inputs, n_own, k, canonical, mesh, device_sort=device_sort,
                          row_len=row_len, pallas_sort=pallas_sort)
    tables = compact_shards(fetch_words(words), k, device_sort)
    return merge_sparse_tables(mesh.gather(tables))
