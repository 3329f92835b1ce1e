"""The benchmark's one traffic generator: seeded multi-record FASTA files,
made with vectorised NumPy from the parameters of a workload file.

The record format is a frozen, vectorised copy of
``dna_kmeres_parallel_tpu_torch/utils/datagen.random_fasta``: a header
``>seq<i> synthetic``, the bases in lines of ``line_width``, one empty line
after each record; and the base stream of ``chip_smoke.smoke_records``:
codes 0-3 for ACGT, ``INVALID`` (0xFF) for N and one ``INVALID``
separator between records. The stream is what the plain reference reads;
the program reads only the written file.

Parameters (a workload file's ``params`` object):

- ``files``: how many files;
- ``records``: records per file, ``[lo, hi]``;
- ``record_bases``: ``[lo, hi]`` bases per record; or ``file_bases``:
  ``[lo, hi]`` bases per file, cut into the file's records at seeded
  points, each record at least ``min_record_bases`` long;
- every size is drawn evenly spaced over its range, in a seeded order, so
  every seed has the same work;
- ``n_fraction``: the share of bases written as N;
- ``line_width``: bases per line.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

INVALID = 0xFF
_LETTERS = np.full(256, ord("N"), np.uint8)
_LETTERS[:4] = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class Records:
    """One file's records: ``stream`` u8 (0-3, INVALID for N, one INVALID
    between records), and each record's offset and length in it."""

    stream: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray

    @property
    def bases(self) -> int:
        return int(self.lengths.sum())


@dataclass
class InputFile:
    """A generated file: its path, its records and its index."""

    index: int
    path: str
    records: Records


def _sizes(rng: np.random.Generator, lo: int, hi: int, n: int) -> np.ndarray:
    """n sizes evenly spread over [lo, hi], in a seeded order."""
    sizes = lo + ((np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(np.int64)
    return rng.permutation(np.minimum(sizes, hi))


def _cut(rng: np.random.Generator, total: int, parts: int, least: int) -> np.ndarray:
    """``parts`` record lengths of at least ``least`` that add up to
    ``total``, cut at seeded points."""
    parts = max(1, min(parts, total // max(least, 1)))
    spare = total - parts * least
    cuts = np.sort(rng.integers(0, spare + 1, parts - 1))
    return np.diff(np.concatenate([[0], cuts, [spare]])) + least


def record_lengths(params: dict, rng: np.random.Generator) -> list[np.ndarray]:
    """Each file's record lengths, from the traffic parameters."""
    files = int(params["files"])
    lo_r, hi_r = params["records"]
    if "record_bases" in params:
        n_recs = _sizes(rng, lo_r, hi_r, files)
        lo, hi = params["record_bases"]
        return [_sizes(rng, lo, hi, int(n)) for n in n_recs]
    lo, hi = params["file_bases"]
    totals = _sizes(rng, lo, hi, files)
    n_recs = _sizes(rng, lo_r, hi_r, files)
    least = int(params.get("min_record_bases", 1))
    return [_cut(rng, int(t), int(n), least) for t, n in zip(totals, n_recs)]


def make_records(lengths: np.ndarray, n_fraction: float, rng: np.random.Generator) -> Records:
    """Uniform random bases for records of these lengths, about
    ``n_fraction`` of them N, with one INVALID between records."""
    lengths = np.asarray(lengths, np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]]).astype(np.int64)
    size = int(lengths.sum()) + lengths.size - 1
    stream = rng.integers(0, 4, size, dtype=np.uint8)
    if n_fraction > 0:
        stream[rng.integers(0, size, rng.binomial(size, n_fraction))] = INVALID
    stream[starts[1:] - 1] = INVALID
    return Records(stream, starts, lengths)


def fasta_bytes(rec: Records, line_width: int = 80) -> list[bytes]:
    """The records as FASTA chunks: header, full lines as one reshaped
    block, the last short line, one empty line."""
    out = []
    for i, (s, n) in enumerate(zip(rec.starts.tolist(), rec.lengths.tolist())):
        seq = _LETTERS[rec.stream[s : s + n]]
        full = n // line_width * line_width
        lines = np.full((full // line_width, line_width + 1), ord("\n"), np.uint8)
        lines[:, :line_width] = seq[:full].reshape(-1, line_width)
        out.append(b">seq%d synthetic\n" % i)
        out.append(lines.tobytes())
        if n > full:
            out.append(seq[full:].tobytes() + b"\n")
        out.append(b"\n")
    return out


def write_fasta(path: str, rec: Records, line_width: int = 80) -> None:
    """Write the records and wait for the disk: the write-back then falls
    in the run's set-up, not in its measured window."""
    with open(path, "wb") as f:
        f.writelines(fasta_bytes(rec, line_width))
        f.flush()
        os.fsync(f.fileno())


def generate(params: dict, seed: int, out_dir: str, stem: str = "input") -> list[InputFile]:
    """Write the workload's files under ``out_dir`` from ``seed``; the same
    seed writes the same bytes."""
    rng = np.random.default_rng(seed)
    width = int(params.get("line_width", 80))
    n_fraction = float(params.get("n_fraction", 0.0))
    files = []
    for i, lengths in enumerate(record_lengths(params, rng)):
        rec = make_records(lengths, n_fraction, rng)
        path = os.path.join(out_dir, f"{stem}{i:04d}.fasta")
        write_fasta(path, rec, width)
        files.append(InputFile(i, path, rec))
    return files


def single_record(bases: int, seed: int, path: str, line_width: int = 80) -> Records:
    """One record of ``bases`` uniform bases, written to ``path`` (a
    warm-up input of a given shape)."""
    rec = make_records(np.array([bases]), 0.0, np.random.default_rng(seed))
    write_fasta(path, rec, line_width)
    return rec
