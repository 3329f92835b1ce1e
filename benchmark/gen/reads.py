"""Seeded FASTQ read sets of one sequenced genome, made with vectorised
NumPy from the parameters of a workload file: the traffic of a canonical
count of reads.

A uniform genome of ``genome_bases`` is drawn from the seed. Each read
starts at a uniform position of it and is taken from either strand with
chance one half: a read of the minus strand is written as the reverse
complement of its bases. Each read base is then substituted at
``substitution_rate`` (to one of the three other bases, drawn evenly) and
written as N at ``n_fraction``. A file holds 4-line FASTQ records: ``@r<i>``,
the bases, ``+``, and a Phred+33 quality line of characters ``#``..``J``
drawn evenly, so that some quality lines begin with ``@`` or ``+``, the
known trap of a FASTQ parser.

The base stream (``gen/fasta.Records``) holds the reads as written, with one
``INVALID`` between reads: what the plain reference reads. The program reads
only the written file.

Parameters (a workload file's ``params`` object):

- ``files``, ``records``, ``record_bases``: as ``gen/fasta``'s, read by
  ``fasta.record_lengths``; ``record_bases`` is ``[L, L]``, one read length
  as a sequencer writes, and the reads of every file come from one genome;
- ``genome_bases``: the genome's length;
- ``coverage``: the read bases of all files over the genome's bases; a
  statement that the other numbers must bear out, within 1%;
- ``minus_share``: the share of reads from the minus strand (default 0.5);
- ``substitution_rate``, ``n_fraction``: shares of the read bases;
- ``format``: ``"fastq"``, the one format written.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from benchmark.gen import fasta
from benchmark.gen.fasta import INVALID, InputFile, Records

#: reads copied from the genome, or written, a chunk
CHUNK_READS = 1 << 15
#: Phred+33 quality characters, '#' (Q2) to 'J' (Q41)
QUAL_LO, QUAL_HI = ord("#"), ord("J")


@dataclass
class Reads:
    """One file's reads and where each came from: ``pos``, the genome
    offset of its first base on the plus strand; ``minus``, read from the
    minus strand; ``substituted``, the stream offsets of the substituted
    bases (an N may later cover one)."""

    records: Records
    pos: np.ndarray
    minus: np.ndarray
    substituted: np.ndarray


def read_length(lengths: np.ndarray) -> int:
    """The one length of the reads, as a sequencer writes them (a
    workload's ``record_bases`` is ``[L, L]``)."""
    if lengths.size and int(lengths.min()) != int(lengths.max()):
        raise ValueError("the reads of a file share one length")
    return int(lengths[0]) if lengths.size else 0


def sample_reads(genome: np.ndarray, lengths, minus_share: float, substitution_rate: float,
                 n_fraction: float, rng: np.random.Generator) -> Reads:
    """Reads of these lengths (all one) from ``genome``, as the module's
    docstring says, in one stream with an ``INVALID`` between reads. Each
    read is a row copied from the windows of the genome and of its
    reverse complement, laid end to end."""
    lengths = np.asarray(lengths, np.int64)
    n, L, G = lengths.size, read_length(lengths), genome.size
    if L > G:
        raise ValueError("a read is longer than the genome")
    pos = rng.integers(0, G - L + 1, n)
    minus = rng.random(n) < minus_share
    windows = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([genome, 3 - genome[::-1]]), L)
    row = np.where(minus, 2 * G - L - pos, pos)  # the minus read's window of the complement
    rows = np.full((n, L + 1), INVALID, np.uint8)
    for a in range(0, n, CHUNK_READS):
        rows[a : a + CHUNK_READS, :L] = windows[row[a : a + CHUNK_READS]]
    stream = rows.reshape(-1)[: max(n * (L + 1) - 1, 0)]
    total = n * L
    subs = rng.choice(total, rng.binomial(total, substitution_rate), replace=False)
    subs += subs // max(L, 1)  # base number to stream offset: one separator a read
    stream[subs] = (stream[subs] + rng.integers(1, 4, subs.size, dtype=np.uint8)) % 4
    ns = rng.choice(total, rng.binomial(total, n_fraction), replace=False)
    stream[ns + ns // max(L, 1)] = INVALID
    starts = np.arange(n, dtype=np.int64) * (L + 1)
    return Reads(Records(stream, starts, lengths), pos, minus, np.sort(subs))


def fastq_chunks(rec: Records, rng: np.random.Generator):
    """The records as FASTQ bytes, at most ``CHUNK_READS`` records a NumPy
    array of rows: the records whose ids have one number of digits have
    one size, so each column of a row is one field."""
    n, L = rec.lengths.size, read_length(rec.lengths)
    bases = rec.stream if n == 0 else np.append(rec.stream, INVALID).reshape(n, L + 1)
    for d in range(1, len(str(max(n - 1, 0))) + 1):
        for a in range(10 ** (d - 1) if d > 1 else 0, min(10**d, n), CHUNK_READS):
            ids = np.arange(a, min(a + CHUNK_READS, 10**d, n))
            out = np.empty((ids.size, 2 * L + d + 7), np.uint8)  # @r<id> bases + quality
            out[:, 0] = ord("@")
            out[:, 1] = ord("r")
            for p in range(d):
                out[:, 2 + p] = ord("0") + ids // 10 ** (d - 1 - p) % 10
            out[:, 2 + d] = ord("\n")
            out[:, 3 + d : 3 + d + L] = fasta._LETTERS[bases[ids[0] : ids[-1] + 1, :L]]
            out[:, 3 + d + L : 6 + d + L] = np.frombuffer(b"\n+\n", np.uint8)
            out[:, 6 + d + L : -1] = rng.integers(QUAL_LO, QUAL_HI + 1, (ids.size, L),
                                                  dtype=np.uint8)
            out[:, -1] = ord("\n")
            yield out


def write_fastq(path: str, rec: Records, rng: np.random.Generator) -> None:
    """Write the records and wait for the disk, as ``fasta.write_fasta``."""
    with open(path, "wb") as f:
        for chunk in fastq_chunks(rec, rng):
            f.write(chunk.data)
        f.flush()
        os.fsync(f.fileno())


def make_reads(params: dict, seed: int) -> tuple[np.ndarray, list[Reads], np.random.Generator]:
    """The genome and each file's reads of a seed, before any is written;
    the generator is returned as the qualities' source."""
    rng = np.random.default_rng(seed)
    lengths = fasta.record_lengths(params, rng)
    genome = rng.integers(0, 4, int(params["genome_bases"]), dtype=np.uint8)
    read_bases = sum(int(x.sum()) for x in lengths)
    if "coverage" in params and abs(read_bases / genome.size / params["coverage"] - 1) > 0.01:
        raise ValueError(f"{read_bases} read bases are not {params['coverage']}x "
                         f"of {genome.size} genome bases")
    if params.get("format", "fastq") != "fastq":
        raise ValueError(f"reads are written as FASTQ, not {params['format']!r}")
    minus = float(params.get("minus_share", 0.5))
    sub = float(params.get("substitution_rate", 0.0))
    nf = float(params.get("n_fraction", 0.0))
    return genome, [sample_reads(genome, x, minus, sub, nf, rng) for x in lengths], rng


def generate(params: dict, seed: int, out_dir: str, stem: str = "input") -> list[InputFile]:
    """Write the workload's FASTQ files under ``out_dir`` from ``seed``;
    the same seed writes the same bytes."""
    _, reads, rng = make_reads(params, seed)
    files = []
    for i, r in enumerate(reads):
        path = os.path.join(out_dir, f"{stem}{i:04d}.fastq")
        write_fastq(path, r.records, rng)
        files.append(InputFile(i, path, r.records))
    return files
