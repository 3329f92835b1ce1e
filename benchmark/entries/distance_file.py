"""Entry ``distance_file``: ``dna_kmeres_parallel_tpu_torch.distance_file(
path, **args, device=...)``, all-pairs k-mer distances of one generated
FASTA file a call, into the packed float32 upper triangle.

Work: the pairs i < j. Check: the per-record counts and every distance of
the returned result against the plain reference worked out anew from the
generator's own records (``reference/kmers``: bincount counts, blocked
``torch.minimum`` min-sums, the NumPy float32 finish).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import kmers


def call(cfg: dict, inp, device: str):
    import dna_kmeres_parallel_tpu_torch as port

    return port.distance_file(inp.path, device=device, **cfg["args"])


def warm_up(cfg: dict, inputs: list, device: str, tmp_dir: str) -> None:
    """One whole call on each input: the (min,+) product's shape is the
    whole file's."""
    for inp in inputs:
        call(cfg, inp, device)


def work(cfg: dict, inp) -> float:
    """Pairs i < j of the file's records."""
    S = int(inp.records.lengths.size)
    return S * (S - 1) / 2


def phases(res) -> dict:
    return dict(res.phases)


def outputs(res) -> dict:
    return {"packed": res.packed, "counts": res.counts}


def _reference(cfg: dict, inp, device: str, bf16: bool) -> dict:
    a = cfg["args"]
    r = inp.records
    counts = kmers.reference_counts(r.stream, r.starts, r.lengths, a["k"],
                                    a.get("canonical", False), device)
    sums = kmers.reference_min_sums(counts, counts).cpu().numpy()
    packed = kmers.reference_packed(sums, r.lengths, a["k"], bf16=bf16)
    out = {"packed": packed, "counts": counts.cpu().numpy()}
    del sums, counts
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def reference(cfg: dict, inp, device: str) -> dict:
    return _reference(cfg, inp, device, bf16=False)


def control(cfg: dict, inp, device: str) -> dict:
    """The reference with its finish in bfloat16, the precision below the
    float32 the configuration states."""
    return _reference(cfg, inp, device, bf16=True)


#: pairs compared a block (the full matrix holds 1.46e9 at 54,018 records)
CMP_BLOCK = 1 << 26


def compare(cfg: dict, inp, got: dict, ref: dict) -> dict:
    gp, rp = np.asarray(got["packed"]), ref["packed"]
    gc, rc = np.asarray(got["counts"]), ref["counts"]
    m = min(gp.size, rp.size)
    err = 0.0
    for a in range(0, m, CMP_BLOCK):
        b = min(a + CMP_BLOCK, m)
        d = float(np.max(np.abs(gp[a:b] - rp[a:b])))
        err = max(err, d) if d == d and err == err else float("nan")  # a NaN stays
    rows = min(gc.shape[0], rc.shape[0])
    if gc.shape[1:] == rc.shape[1:]:
        bad_rows = int(np.count_nonzero((gc[:rows] != rc[:rows]).any(axis=1)))
    else:
        bad_rows = rows
    return {
        "distance_max_abs_err": err,
        "pairs_missing": abs(gp.size - rp.size),
        "counts_rows_differing": bad_rows + abs(gc.shape[0] - rc.shape[0]),
    }
