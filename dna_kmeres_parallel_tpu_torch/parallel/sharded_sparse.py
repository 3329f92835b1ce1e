"""Host staging of a sharded stream's encoder planes.

The counterpart of ``dna_kmeres_parallel_tpu/parallel/sharded_sparse.py``'s
``stage_shard_planes``; the rest of that module (data-parallel sparse
counting) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from dna_kmeres_parallel_tpu_torch.models.engine import pack_planes_np
from dna_kmeres_parallel_tpu_torch.ops.encode import INVALID


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
