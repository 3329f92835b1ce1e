"""The range split of the native parse (``native.parse_fasta_native``).

An uncompressed file above the library's thread grain is cut into
record-aligned ranges, each parsed on its own thread, and the ranges
joined. These tests hold that parse (``KMER_NATIVE_THREADS`` unset, 3 or
8) field for field to the one-range parse (``KMER_NATIVE_THREADS=1``) and
to the JAX package's parser, on files of several ranges whose cuts fall
where the formats are hard: CRLF, blank lines, lone CRs, header-only
records, junk and no final newline in FASTA; quality lines that begin
with ``@`` or ``+``, zero-length reads and multi-line records, where the
FASTQ guess of a record start is wrong and the range is parsed again, in
FASTQ. gzip, small files and a ``max_seqs`` cap take one range.
"""

from __future__ import annotations

import gzip
import sys
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu import native as jax_native
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.parallel import multihost
from dna_kmeres_parallel_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmark import run as bench_run  # noqa: E402
from benchmark import spans, trace  # noqa: E402

#: comfortably above 8 ranges of the library's 256 KiB thread grain
BIG = 3 << 20


def _bases(rng, n: int, alphabet: bytes = b"ACGT") -> bytes:
    return bytes(np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), n)])


def _qual(rng, n: int, first: bytes | None = None) -> bytes:
    q = bytes(rng.integers(ord("#"), ord("J") + 1, n).astype(np.uint8))
    return (first + q[1:]) if (first and n) else q


def _records(make) -> bytes:
    """``make(i)``'s records, i = 0, 1, ..., joined until they pass BIG."""
    out, size, i = [], 0, 0
    while size < BIG:
        out.append(make(i))
        size += len(out[-1])
        i += 1
    return b"".join(out)


def fasta_messy(rng) -> bytes:
    """FASTA with junk before the first header, CRLF and LF lines, blank
    lines, lone CRs inside lines, header-only records, lowercase and N,
    and no final newline."""

    def record(i):
        eol = b"\r\n" if i % 3 == 0 else b"\n"
        out = [b">rec%d description %d" % (i, i % 7) + eol]
        if i % 11 == 5:  # header-only record
            return out[0]
        for j in range(int(rng.integers(1, 40))):
            line = _bases(rng, int(rng.integers(1, 81)), b"ACGTACGTACGTNacgt")
            if (i + j) % 29 == 3:
                line = line[: len(line) // 2] + b"\r" + line[len(line) // 2:]
            out.append(line + eol)
            if j % 13 == 7:
                out.append(b"\n" if j % 2 else b"\r\n")
        return b"".join(out)

    return b"junk line\r\nmore junk ACGT\n\n" + _records(record) + b">last\nACGTNNACG"


def fasta_junk_head(rng) -> bytes:
    """A third of the file junk before the first header, so that the first
    record starts in a later range, which then writes no sentinel before
    it."""
    junk = b"".join(b"junk %d ACGT\n" % i for i in range(BIG // 30))
    return junk + fasta_messy(rng)


def fastq_4line(rng) -> bytes:
    """4-line FASTQ whose quality lines all begin with '@' or '+', so every
    cut's search passes such lines; a few reads carry N."""

    def record(i):
        n = int(rng.integers(40, 160))
        seq = _bases(rng, n, b"ACGTACGTACGTACGTN")
        return b"@r%d/%d\n%s\n+\n%s\n" % (i, i % 2 + 1, seq, _qual(rng, n, b"@+"[i % 2:i % 2 + 1]))

    return _records(record)


def fastq_zero_length(rng) -> bytes:
    """FASTQ with zero-length reads, written with and without their empty
    sequence and quality lines, between reads whose quality begins with
    '@'; ``@z\\n+\\n`` after an '@' quality line makes the guess of a
    record start land on that quality line."""

    def record(i):
        if i % 5 == 1:
            return b"@z%d\n\n+\n\n" % i
        if i % 5 == 3:
            return b"@z%d\n+\n" % i
        n = int(rng.integers(20, 120))
        return b"@r%d\n%s\n+\n%s\n" % (i, _bases(rng, n), _qual(rng, n, b"@"))

    return _records(record)


def fastq_multiline(rng) -> bytes:
    """Multi-line FASTQ: each read's bases and quality wrapped on three
    lines, the quality's first line beginning with '@' and its last with
    '+'. Every line that looks like a record start (an '@' line whose
    second line after begins with '+') is a quality line, so every guessed
    cut is wrong and each range is parsed again from where the one before
    ends."""

    def record(i):
        w = int(rng.integers(10, 60))
        seq = _bases(rng, 3 * w)
        q = _qual(rng, 3 * w)
        return b"@m%d\n%s\n%s\n%s\n+\n@%s\n%s\n+%s\n" % (
            i, seq[:w], seq[w:2 * w], seq[2 * w:], q[1:w], q[w:2 * w], q[2 * w + 1:])

    return _records(record)


FILES = {"fasta_messy": fasta_messy, "fasta_junk_head": fasta_junk_head,
            "fastq_4line": fastq_4line,
            "fastq_zero_length": fastq_zero_length, "fastq_multiline": fastq_multiline}


def _write(tmp_path, name: str, data: bytes, suffix: str = ""):
    path = tmp_path / (name + suffix)
    path.write_bytes(data)
    return path


def _parse(monkeypatch, threads, path, **kw):
    if threads is None:
        monkeypatch.delenv("KMER_NATIVE_THREADS", raising=False)
    else:
        monkeypatch.setenv("KMER_NATIVE_THREADS", str(threads))
    return native.parse_fasta_native(path, **kw)


def assert_same(got, want, lone_cr: bool = True) -> None:
    """Every field a caller reads, equal (``lone_cr`` where both parsers
    report it)."""
    assert got.n_seqs == want.n_seqs
    for f in ("stream", "offsets", "lengths"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert list(got.ids) == list(want.ids)
    assert got.total_bases == want.total_bases
    assert got.invalid_bases == want.invalid_bases
    if lone_cr:
        assert got.lone_cr == want.lone_cr


def first_guess(data: bytes, p: int) -> int:
    """Where the FASTQ cut after byte p lands: the first line start at or
    after p that begins with '@' and whose second line after begins with
    '+' (as ``kmer_host.cpp``'s ``next_cut``)."""
    s = data.rfind(b"\n", 0, p) + 1
    if s < p:
        s = data.index(b"\n", p) + 1
    while s < len(data):
        l1 = data.find(b"\n", s) + 1
        l2 = data.find(b"\n", l1) + 1 if l1 else 0
        if data[s:s + 1] == b"@" and l2 and data[l2:l2 + 1] == b"+":
            return s
        s = l1 if l1 else len(data)
    return len(data)


@pytest.mark.parametrize("threads", [None, 3, 8])
@pytest.mark.parametrize("name", sorted(FILES))
def test_ranges_equal_one_range_and_jax(tmp_path, monkeypatch, name, threads):
    data = FILES[name](np.random.default_rng(len(name)))
    path = _write(tmp_path, name, data)
    one = _parse(monkeypatch, 1, path)
    got = _parse(monkeypatch, threads, path)
    assert one.ranges == 1
    if threads is not None:
        assert got.ranges == threads
    assert_same(got, one)
    assert_same(got, jax_native.parse_fasta_native(str(path)), lone_cr=False)
    assert got.n_seqs > 1000
    if name.startswith("fasta"):
        assert got.lone_cr > 0 and got.invalid_bases > 0
        assert (got.lengths == 0).any()


def test_multiline_guesses_land_on_quality_lines():
    # the guess is wrong at every cut of the multi-line file: the reparse,
    # not the guess, makes test_ranges_equal_one_range_and_jax pass there
    data = fastq_multiline(np.random.default_rng(len("fastq_multiline")))
    for t in range(1, 8):
        cut = first_guess(data, len(data) * t // 8)
        assert cut < len(data) and not data.startswith(b"@m", cut)  # not a header


@pytest.mark.parametrize("threads", [None, 8])
def test_small_file_takes_one_range(tmp_path, monkeypatch, threads):
    data = fastq_4line(np.random.default_rng(3))[: 100_000]
    data = data[: data.rindex(b"\n@") + 1]
    path = _write(tmp_path, "small", data)
    got = _parse(monkeypatch, threads, path)
    assert got.ranges == 1
    assert_same(got, jax_native.parse_fasta_native(str(path)), lone_cr=False)


@pytest.mark.parametrize("name", ["fasta_messy", "fastq_4line"])
def test_gzip_takes_one_range(tmp_path, monkeypatch, name):
    data = FILES[name](np.random.default_rng(len(name)))
    plain = _write(tmp_path, name, data)
    gz = _write(tmp_path, name, gzip.compress(data, compresslevel=1), ".gz")
    got = _parse(monkeypatch, 8, gz)
    assert got.ranges == 1
    split = _parse(monkeypatch, 8, plain)
    assert split.ranges == 8
    assert_same(got, split)
    assert_same(got, jax_native.parse_fasta_native(str(gz)), lone_cr=False)


@pytest.mark.parametrize("max_seqs", [0, 1, 997])
@pytest.mark.parametrize("name", ["fasta_messy", "fastq_multiline"])
def test_max_seqs_takes_one_range(tmp_path, monkeypatch, name, max_seqs):
    data = FILES[name](np.random.default_rng(len(name)))
    path = _write(tmp_path, name, data)
    got = _parse(monkeypatch, 8, path, max_seqs=max_seqs)
    assert got.ranges == 1 and got.n_seqs == max_seqs
    assert_same(got, _parse(monkeypatch, 1, path, max_seqs=max_seqs))
    assert_same(got, jax_native.parse_fasta_native(str(path), max_seqs=max_seqs),
                lone_cr=False)


@pytest.mark.parametrize("threads", [3, 8])
@pytest.mark.parametrize("name", ["fasta_messy", "fastq_4line"])
def test_byte_ranges_split_the_same_way(tmp_path, monkeypatch, name, threads):
    # one rank's share of a multi-host run: record-aligned byte ranges of
    # a file three times the size, each split into ranges of its own
    rng = np.random.default_rng(7)
    data = b"".join(FILES[name](rng) for _ in range(3))
    path = _write(tmp_path, name, data)
    if name.startswith("fasta"):
        bounds = multihost.split_fasta_byte_ranges(str(path), 3)
    else:
        cuts = [0] + [data.index(b"\n@r", len(data) * t // 3) + 1 for t in (1, 2)]
        bounds = list(zip(cuts, cuts[1:] + [-1]))
    assert len(bounds) == 3
    seen = 0
    for start, end in bounds:
        got = _parse(monkeypatch, threads, path, byte_range=(start, end))
        assert got.ranges == threads
        assert_same(got, _parse(monkeypatch, 1, path, byte_range=(start, end)))
        assert_same(got, jax_native.parse_fasta_native(str(path), byte_range=(start, end)),
                    lone_cr=False)
        seen += got.n_seqs
    assert seen == _parse(monkeypatch, 8, path).n_seqs


def test_ids_decode_on_first_use(tmp_path, monkeypatch):
    path = _write(tmp_path, "reads", fastq_4line(np.random.default_rng(1)))
    got = _parse(monkeypatch, 8, path)
    assert "ids" not in vars(got)  # nothing decoded until a caller asks
    ids = got.ids
    assert ids is got.ids and len(ids) == got.n_seqs
    assert ids == jax_native.parse_fasta_native(str(path)).ids
    assert ids[:2] == ["@r0/1", "@r1/2"]


# ------------------------------------------- the counter and its reader


@pytest.mark.parametrize("entry", ["count_file21", "count_file5", "distance_file"])
def test_parse_spans_count_the_ranges(tmp_path, monkeypatch, entry):
    rng = np.random.default_rng(11)
    path = _write(tmp_path, "few_long", b"".join(
        b">long%d\n%s\n" % (i, _bases(rng, 400_000)) for i in range(8)))
    monkeypatch.setenv("KMER_NATIVE_THREADS", "8")
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):  # spans log under the profiler
            if entry == "distance_file":
                port.distance_file(path, k=3, device="cpu")
            else:
                port.count_file(path, k=int(entry[10:]), device="cpu")
        records = profiling.records()
    finally:
        profiling.clear()
    (parse,) = [r for r in records if r["name"] == "parse"]
    assert parse["counters"]["ranges"] == 8
    # the benchmark's reader of the counter, over a window holding the call
    inp = type("Input", (), {})()
    calls = [bench_run.Call(inp, -1e9, 1e9, 1.0, {})]
    tr = trace.Trace(device=[dict(ph="X", cat="kernel", name="k", ts=0, dur=1)])
    window = bench_run.Run(type("Cell", (), {"config": {}})(), calls, 20.0, 5.0, tr)
    reader = bench_run.load_module(REPO / "benchmark" / "metrics" / "parse_ranges.py")
    monkeypatch.setattr(spans, "log", lambda: list(records))
    assert reader.read(window) == 8.0
