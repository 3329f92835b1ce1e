"""FASTA ingestion on the host, in Python.

- ``parse_fasta``: headers start with '>', a record's sequence is the
  concatenation of the following non-header lines, blank lines and a
  trailing CR are ignored; a source whose first significant byte is '@'
  goes to ``parse_fastq``. The native parser (``native.parse_fasta_native``)
  has the same record semantics and is the engines' path for files.
- ``parse_fasta_reference``: the reference's two record splitters,
  ``importSeqs`` (variant "blank_line") and ``importSeqsNoNL``
  ("no_blank_line"), with their ``max_seqs`` cap.
- ``iter_fasta_records``: the records of ``parse_fasta`` a chunk of the
  file at a time; ``write_fasta``: records out.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import Iterable, Iterator


@dataclass(frozen=True)
class FastaRecord:
    id: str  # full header line including '>'
    seq: str

    def __iter__(self):  # allow tuple-unpacking: id, seq = record
        return iter((self.id, self.seq))


def _open_text(source) -> io.TextIOBase:
    if isinstance(source, (str, os.PathLike)):
        # Transparent gzip: sniff the magic rather than trusting extensions.
        with open(source, "rb") as probe:
            magic = probe.read(2)
        if magic == b"\x1f\x8b":
            import gzip

            return io.TextIOWrapper(
                gzip.open(source, "rb"), encoding="ascii", errors="replace"
            )
        return open(source, "r", encoding="ascii", errors="replace")
    if isinstance(source, bytes):
        return io.StringIO(source.decode("ascii", errors="replace"))
    if isinstance(source, io.TextIOBase):
        return source
    raise TypeError(f"unsupported FASTA source: {type(source)!r}")


def parse_fastq(source, max_seqs: int | None = None) -> list[FastaRecord]:
    """FASTQ parser (4-state record machine: header '@' -> sequence lines
    -> '+' separator -> quality of matching length). '@' or '+' at the
    start of a quality line never begins a record. Returns the same
    FastaRecord type (quality is dropped: counting only needs bases)."""
    records: list[FastaRecord] = []
    f = _open_text(source)
    state = "hdr"
    header = ""
    parts: list[str] = []
    qual_seen = 0
    try:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            if state == "hdr":
                if not line.startswith("@"):
                    continue  # tolerate junk between records
                if max_seqs is not None and len(records) >= max_seqs:
                    return records
                header = line
                parts = []
                state = "seq"
            elif state == "seq":
                if line.startswith("+"):
                    if not parts or not any(parts):
                        # Zero-length read: no quality bytes follow — waiting
                        # in qual state would eat the next '@' header.
                        records.append(FastaRecord(header, ""))
                        state = "hdr"
                    else:
                        state = "qual"
                        qual_seen = 0
                else:
                    parts.append(line)
            else:  # qual
                qual_seen += len(line)
                if qual_seen >= sum(len(x) for x in parts):
                    records.append(FastaRecord(header, "".join(parts)))
                    state = "hdr"
        if state in ("seq", "qual"):
            # EOF flush: accept a trailing record with truncated/absent
            # quality (counting needs only the bases).
            records.append(FastaRecord(header, "".join(parts)))
    finally:
        if not isinstance(source, io.TextIOBase):
            f.close()
    return records


def parse_fasta(source, max_seqs: int | None = None) -> list[FastaRecord]:
    """Robust FASTA parser. ``source`` is a path, bytes, or text file object
    (gzip paths handled transparently). A source whose first significant
    byte is '@' is dispatched to the FASTQ parser, so every call site
    accepts both formats."""
    if isinstance(source, (str, os.PathLike)):
        probe = _open_text(source)
        first = ""
        try:
            for line in probe:
                if line.strip():
                    first = line.lstrip()[0]
                    break
        finally:
            probe.close()
        if first == "@":
            return parse_fastq(source, max_seqs=max_seqs)
    elif isinstance(source, bytes):
        if source.lstrip()[:1] == b"@":
            return parse_fastq(source, max_seqs=max_seqs)
    elif isinstance(source, io.TextIOBase):
        # Streams can't be rewound portably: materialize, then dispatch.
        content = source.read()
        if content.lstrip()[:1] == "@":
            return parse_fastq(content.encode("ascii", "replace"), max_seqs=max_seqs)
        source = io.StringIO(content)
    records: list[FastaRecord] = []
    header: str | None = None
    parts: list[str] = []

    def flush():
        nonlocal header, parts
        if header is not None:
            records.append(FastaRecord(header, "".join(parts)))
        header, parts = None, []

    f = _open_text(source)
    try:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            if line.startswith(">"):
                flush()
                if max_seqs is not None and len(records) >= max_seqs:
                    return records
                header = line
            elif header is not None:
                parts.append(line)
        flush()
    finally:
        if not isinstance(source, io.TextIOBase):
            f.close()
    if max_seqs is not None:
        records = records[:max_seqs]
    return records


def parse_fasta_reference(
    source, variant: str = "blank_line", max_seqs: int | None = 100
) -> list[FastaRecord]:
    """Emulate the reference's record-splitting semantics.

    blank_line (importSeqs, main.cu:474-545): after a header, body lines are
    accumulated until a blank line or a line starting with CR (ASCII 13,
    main.cu:504). A subsequent '>' line inside the body would be swallowed as
    sequence content — which is exactly why the reference grew the second
    variant; we reproduce that behavior faithfully for differential tests.

    no_blank_line (importSeqsNoNL, main.cu:401-473): the body additionally
    ends at the next '>' line (main.cu:431-432), which then opens the next
    record.
    """
    if variant not in ("blank_line", "no_blank_line"):
        raise ValueError(f"unknown variant {variant!r}")
    records: list[FastaRecord] = []
    f = _open_text(source)
    try:
        lines = [ln.rstrip("\n") for ln in f]
    finally:
        if not isinstance(source, io.TextIOBase):
            f.close()

    i = 0
    header: str | None = None
    while i < len(lines):
        line = lines[i]
        if not line:
            i += 1
            continue
        if line.startswith(">"):
            header = line
            i += 1
            # Body: first line after header unconditionally (main.cu:502/429),
            # then lines until terminator.
            if i >= len(lines):
                break
            acc = lines[i]
            i += 1
            while i < len(lines):
                nxt = lines[i]
                is_blank = nxt == "" or nxt.startswith("\r")
                is_hdr = nxt.startswith(">")
                if is_blank or (variant == "no_blank_line" and is_hdr):
                    if not is_hdr:
                        i += 1  # blank/CR terminator is consumed
                    break
                acc += nxt
                i += 1
            records.append(FastaRecord(header, acc))
            if max_seqs is not None and len(records) >= max_seqs:
                break
        else:
            i += 1
    return records


def iter_fasta_records(
    source, chunk_bytes: int = 1 << 20
) -> Iterator[FastaRecord]:
    """Yield the (id, seq) records of a FASTA source ``chunk_bytes`` at a
    time, each as soon as it is complete, with ``parse_fasta``'s record
    semantics. A gzip path is sniffed from its magic bytes; FASTQ is not
    read here (``parse_fasta`` dispatches it)."""
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as probe:
            magic = probe.read(2)
        if magic == b"\x1f\x8b":
            import gzip

            f = gzip.open(source, "rb")
        else:
            f = open(source, "rb")
        close = True
    elif isinstance(source, bytes):
        f = io.BytesIO(source)
        close = True
    else:
        f = source
        close = False
    try:
        header: bytes | None = None
        parts: list[bytes] = []
        tail = b""
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            data = tail + chunk
            lines = data.split(b"\n")
            tail = lines.pop()  # possibly-incomplete last line
            for raw in lines:
                line = raw.rstrip(b"\r")
                if not line:
                    continue
                if line.startswith(b">"):
                    if header is not None:
                        yield FastaRecord(
                            header.decode("ascii", errors="replace"),
                            b"".join(parts).decode("ascii", errors="replace"),
                        )
                    header = line
                    parts = []
                elif header is not None:
                    parts.append(line)
        last = tail.rstrip(b"\r")
        if last:
            if last.startswith(b">"):
                if header is not None:
                    yield FastaRecord(
                        header.decode("ascii", errors="replace"),
                        b"".join(parts).decode("ascii", errors="replace"),
                    )
                header, parts = last, []
            elif header is not None:
                parts.append(last)
        if header is not None:
            yield FastaRecord(
                header.decode("ascii", errors="replace"),
                b"".join(parts).decode("ascii", errors="replace"),
            )
    finally:
        if close:
            f.close()


def write_fasta(path, records: Iterable[tuple[str, str]], width: int = 70):
    """Write records as FASTA (used by tests and fixture generators)."""
    with open(path, "w", encoding="ascii") as f:
        for rid, seq in records:
            if not rid.startswith(">"):
                rid = ">" + rid
            f.write(rid + "\n")
            for off in range(0, len(seq), width):
                f.write(seq[off : off + width] + "\n")
            f.write("\n")
