"""Checkpoint files.

The counting stream's checkpoint (``CountCheckpoint``): the partial
counts (a dense int64 histogram or a sorted sparse table) and the stream
cursor, in the JAX package's ``.npz`` format version 1, so a checkpoint
written by either package resumes in the other. A JSON ``meta`` blob (as
u8) holds the scalars; the file is compressed below 16 MB of arrays and
published by writing a temporary file and renaming it.

The distance stream's checkpoint: one JSON object, replaced the same way.
Either way a reader sees the old state or the new one and never a torn
file.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np

FORMAT_VERSION = 1


@dataclass
class CountCheckpoint:
    k: int
    canonical: bool
    cursor: int  # bases of the flat stream fully counted
    total_bases: int  # real bases of the whole input
    hist: np.ndarray | None = None  # dense int64 [4^k]
    sparse_codes: np.ndarray | None = None  # uint64 sorted distinct codes
    sparse_counts: np.ndarray | None = None  # int64

    @property
    def dense(self) -> bool:
        return self.hist is not None


def save_checkpoint(path, ckpt: CountCheckpoint) -> None:
    meta = {
        "format_version": FORMAT_VERSION,
        "k": ckpt.k,
        "canonical": ckpt.canonical,
        "cursor": ckpt.cursor,
        "total_bases": ckpt.total_bases,
        "dense": ckpt.dense,
    }
    arrays = {"meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)}
    if ckpt.dense:
        arrays["hist"] = ckpt.hist
    else:
        arrays["sparse_codes"] = (
            ckpt.sparse_codes if ckpt.sparse_codes is not None else np.zeros(0, np.uint64)
        )
        arrays["sparse_counts"] = (
            ckpt.sparse_counts if ckpt.sparse_counts is not None else np.zeros(0, np.int64)
        )
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    # Sparse tables hardly compress, and gzip would dominate a large one's
    # checkpoint time: compress only small states.
    total_bytes = sum(a.nbytes for a in arrays.values())
    save = np.savez_compressed if total_bytes < (16 << 20) else np.savez
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            save(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path) -> CountCheckpoint:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('format_version')}"
            )
        scalars = dict(
            k=meta["k"],
            canonical=meta["canonical"],
            cursor=meta["cursor"],
            total_bases=meta["total_bases"],
        )
        if meta["dense"]:
            return CountCheckpoint(**scalars, hist=z["hist"])
        return CountCheckpoint(
            **scalars, sparse_codes=z["sparse_codes"], sparse_counts=z["sparse_counts"]
        )


def save_json_atomic(path, state: dict) -> None:
    tmp = f"{os.fspath(path)}.tmp"
    with open(tmp, "w", encoding="ascii") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def load_json(path) -> dict:
    with open(path, "r", encoding="ascii") as f:
        return json.load(f)
