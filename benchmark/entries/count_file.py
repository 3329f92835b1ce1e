"""Entry ``count_file``: ``dna_kmeres_parallel_tpu_torch.count_file(path,
**args, device=...)``, one generated FASTA file a call, into the sorted
(code, count) table.

Work: the file's input bases. Check: the table (codes and counts, every
row), the bases and the records of the returned result against the plain
reference's table of the generator's own base stream
(``reference/kmers.reference_table``).
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.gen import fasta
from benchmark.reference import kmers


def call(cfg: dict, inp, device: str):
    import dna_kmeres_parallel_tpu_torch as port

    return port.count_file(inp.path, device=device, **cfg["args"])


#: the batch the sparse counter stages by default, and its staging lane
BATCH_BASES = 1 << 24
LANE = 128


def batch_shapes(stream_len: int, k: int, batch_bases: int = BATCH_BASES) -> list[int]:
    """The padded length T of each batch the sparse counter stages for a
    parsed stream of ``stream_len`` bases, as today's route stages them
    (streams shorter than one batch take a power-of-two bucket, every
    batch reads k - 1 halo bases, T is a multiple of LANE): the shapes the
    warm-up makes. Only the warm-up reads this; the roofline counts the
    work from the stream alone."""
    if stream_len < k:
        return []
    pow2 = 1 << (max(stream_len, LANE) - 1).bit_length()
    batch = max(min(batch_bases, pow2), k)
    T = -(-(batch + k - 1) // LANE) * LANE
    return [T] * -(-stream_len // batch)


def warm_up(cfg: dict, inputs: list, device: str, tmp_dir: str) -> None:
    """One call on a single-record file for each batch shape the inputs
    stage (``batch_shapes``), as long as the input's first batch: the
    kernels and the host library are built or loaded, and each shape's
    buffers made, without a whole call."""
    k = cfg["args"]["k"]
    batch = cfg["args"].get("batch_bases", BATCH_BASES)
    shapes: dict[int, int] = {}
    for inp in inputs:
        n = inp.records.stream.size
        Ts = batch_shapes(n, k, batch)
        if Ts:
            shapes.setdefault(Ts[0], min(n, batch))
    for i, (T, bases) in enumerate(sorted(shapes.items())):
        path = os.path.join(tmp_dir, f"warm{i}.fasta")
        fasta.single_record(bases, i, path)
        call(cfg, fasta.InputFile(-1, path, None), device)
        os.unlink(path)


def work(cfg: dict, inp) -> float:
    """Input bases of the file."""
    return float(inp.records.bases)


def phases(res) -> dict:
    return dict(res.phases)


def outputs(res) -> dict:
    return {"codes": res.codes, "counts": res.counts,
            "total_bases": res.total_bases, "n_seqs": res.n_seqs}


def reference(cfg: dict, inp, device: str) -> dict:
    a = cfg["args"]
    codes, counts = kmers.reference_table(inp.records.stream, a["k"],
                                          a.get("canonical", False), device)
    return {"codes": codes, "counts": counts, "total_bases": inp.records.bases,
            "n_seqs": int(inp.records.lengths.size)}


def control(cfg: dict, inp, device: str) -> dict:
    """The reference with the guarantee that no window spans an N broken:
    N read as A."""
    a = cfg["args"]
    codes, counts = kmers.reference_table(inp.records.stream, a["k"],
                                          a.get("canonical", False), device,
                                          n_as_a_starts=inp.records.starts)
    return {"codes": codes, "counts": counts, "total_bases": inp.records.bases,
            "n_seqs": int(inp.records.lengths.size)}


def rows_differing(c, n, rc, rn) -> int:
    """Rows of two sorted tables that differ in code or count, the rows
    one has past the other's end included: 0 exactly when they are equal."""
    m = min(len(c), len(rc))
    d = np.count_nonzero((c[:m] != rc[:m]) | (n[:m] != rn[:m]))
    return int(d) + abs(len(c) - len(rc))


def compare(cfg: dict, inp, got: dict, ref: dict) -> dict:
    return {
        "table_rows_differing": rows_differing(
            np.asarray(got["codes"]), np.asarray(got["counts"]), ref["codes"], ref["counts"]),
        "bases_differing": abs(int(got["total_bases"]) - ref["total_bases"]),
        "records_differing": abs(int(got["n_seqs"]) - ref["n_seqs"]),
    }
