"""parse_gbytes_per_s: the file bytes the native parse read (the ``parse``
spans' counter ``bytes``) over the spans' host-clock seconds, in GB/s
(program span). A FASTQ file carries about 2.1 bytes a base and a FASTA
file about 1.01, so a rate of file bytes compares the two parsers."""

from benchmark.spans import counter, named, seconds, window_calls


def read(run):
    recs = named(window_calls(run), "parse")
    s = seconds(recs)
    nbytes = counter(recs, "bytes")
    return nbytes / s / 1e9 if nbytes > 0 and s > 0 else None
