"""The streamed, resumable distance-CSV writer.

The port of ``dna_kmeres_parallel_tpu/models/distance_stream.py``. At the
reference's design scale (54K sequences, 1.46G pairs, a 13 GB CSV) the
distance matrix never sits in memory: packed row panels stream through
this writer, which checkpoints after every durable panel and resumes byte
for byte:

- the CSV is append-only; a panel's bytes are flushed and fsynced before
  the checkpoint (next row, durable byte offset, pair count) is replaced
  atomically;
- resume checks the checkpoint against the run's fingerprint (k,
  canonical, S, panel_rows, row range, input hash) and truncates the CSV
  to the last durable offset, dropping any bytes a kill left mid-panel;
- ``row_lo``/``row_hi`` bound the rows this writer owns, so row blocks
  streamed to separate files concatenate to the single-run CSV.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.utils import checkpoint


def input_fingerprint(seqs: list[str]) -> str:
    """Full-content fingerprint of a distance run's input: (lengths,
    every base). Hashing every base costs ~0.3 s/GB — noise against the
    runs the checkpoint protects, and the only thing that can tell two
    same-shaped datasets apart (a single-base edit must refuse to
    resume, not silently mix panels)."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    h = hashlib.sha256(np.ascontiguousarray(lengths).tobytes())
    for s in seqs:
        h.update(s.encode())
    return h.hexdigest()[:16]


def stream_panels_to_csv(
    output_path,
    S: int,
    panel_rows: int,
    panel_flat_fn,
    *,
    meta: dict,
    checkpoint_path=None,
    max_panels: int | None = None,
    row_lo: int = 0,
    row_hi: int | None = None,
) -> dict:
    """Stream packed distance rows [row_lo, row_hi) to ``output_path``.

    ``panel_flat_fn(r0, r1) -> np.float32[flat]`` returns the packed
    strict-upper-triangle entries of rows r0..r1 (row i contributes
    columns i+1..S-1, the reference's layout), already finished to
    float32 distances on the host.

    ``meta`` identifies the run for resume validation; it must contain
    at least k/canonical/n_seqs and SHOULD contain input_sha (see
    input_fingerprint). panel_rows, row_lo, row_hi are stamped in
    automatically. max_panels bounds the panels processed this call
    (testing / cooperative yielding). The result's ``write_s`` is the
    seconds spent formatting, writing and checkpointing.
    """
    t0 = time.perf_counter()
    if row_hi is None:
        row_hi = max(S - 1, 0)
    row_hi = min(row_hi, max(S - 1, 0))
    meta = dict(meta)
    meta.update(
        format_version=2,
        panel_rows=panel_rows,
        row_lo=row_lo,
        row_hi=row_hi,
    )
    n_pairs = 0
    start_r0 = row_lo
    csv_bytes = 0
    resumed = False
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        ck = checkpoint.load_json(checkpoint_path)
        mismatched = {
            key: (ck.get(key), val)
            for key, val in meta.items()
            if ck.get(key) != val
        }
        if mismatched:
            raise ValueError(
                "distance checkpoint does not match this run: "
                + ", ".join(
                    f"{key}: checkpoint {a!r} != run {b!r}"
                    for key, (a, b) in sorted(mismatched.items())
                )
            )
        start_r0 = int(ck["next_r0"])
        csv_bytes = int(ck["csv_bytes"])
        n_pairs = int(ck["n_pairs"])
        resumed = True
        if not os.path.exists(output_path):
            raise FileNotFoundError(
                f"distance checkpoint present but CSV missing: "
                f"{output_path}"
            )
        if os.path.getsize(output_path) < csv_bytes:
            # truncate() would EXTEND a short file with NULs and the
            # stream would continue after the hole — refuse instead.
            raise ValueError(
                f"distance CSV shorter than the checkpoint's durable "
                f"offset ({os.path.getsize(output_path)} < {csv_bytes} "
                f"bytes): the output was damaged; delete both to restart"
            )

    def _save_ckpt(next_r0: int) -> None:
        state = dict(meta)
        state.update(
            next_r0=next_r0, csv_bytes=csv_bytes, n_pairs=n_pairs
        )
        checkpoint.save_json_atomic(checkpoint_path, state)

    panels_done = 0
    stopped = False
    write_s = 0.0
    with open(output_path, "r+b" if resumed else "wb") as f:
        if resumed:
            # Drop any bytes written after the last durable checkpoint
            # (a panel interrupted mid-write) — the resumed output is
            # byte-identical to a single-shot run.
            f.truncate(csv_bytes)
            f.seek(csv_bytes)
        for r0 in range(start_r0, row_hi, panel_rows):
            if max_panels is not None and panels_done >= max_panels:
                stopped = True
                break
            r1 = min(r0 + panel_rows, row_hi)
            flat = np.asarray(panel_flat_fn(r0, r1), dtype=np.float32)
            tw = time.perf_counter()
            buf = native.format_f6(flat)
            f.write(buf)
            n_pairs += flat.shape[0]
            csv_bytes += len(buf)
            panels_done += 1
            if checkpoint_path is not None:
                f.flush()
                os.fsync(f.fileno())
                _save_ckpt(r1)
            write_s += time.perf_counter() - tw
    return {
        "n_seqs": S,
        "n_pairs": n_pairs,
        "elapsed_s": time.perf_counter() - t0,
        "output": str(output_path),
        "resumed": resumed,
        "completed": not stopped,
        "write_s": write_s,
    }


def balanced_row_splits(S: int, n_parts: int) -> list[tuple[int, int]]:
    """Split rows 0..S-1 of the strict upper triangle into ``n_parts``
    contiguous blocks with ~equal PAIR counts (row i has S-1-i partners,
    so equal-row blocks would leave the first process with most of the
    work). For row-sharded runs: process p streams rows
    [lo_p, hi_p); the shard CSVs concatenate in rank order to the exact
    single-process byte stream."""
    total = S * (S - 1) / 2.0
    bounds = [0]
    for p in range(1, n_parts):
        # rows [0, r) cover r*S - r(r+1)/2 pairs; solve for the target.
        target = total * p / n_parts
        # quadratic: r^2 - (2S-1) r + 2*target = 0, smaller root.
        disc = (2 * S - 1) ** 2 - 8 * target
        r = int(round(((2 * S - 1) - disc**0.5) / 2)) if disc > 0 else S - 1
        r = min(max(r, bounds[-1]), max(S - 1, 0))
        bounds.append(r)
    bounds.append(max(S - 1, 0))
    return [(a, b) for a, b in zip(bounds[:-1], bounds[1:])]
