#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--bases N] [--records N]

Phases, each printing its lines; the first failure raises and the script
exits nonzero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the native host library's build;
2. the kernels' build from ``dna_kmeres_parallel_tpu_torch/csrc`` (nvcc);
3. K1 against its plain PyTorch version on the card, element for element,
   and both timed with CUDA events at the main path's batch; then the
   dense histogram kernels K5-K8 the same way: k in {1, 2, 3, 4, 6, 7, 8}
   x canonical x four ``n_own`` on an N-rich stream, K8 at 1,000, 3,000
   and 4^11 bins, each timed at one 16 Mbase batch; then K9 (the u8-stream
   encoder) at every split-word width x canonical x four ``n_own``, on
   streams shorter than k and unaligned, and timed at the k=21 batch;
4. the main path: exact k-mer counting of a seeded random FASTA of
   ``--bases`` bases (default 256 Mbase, about one large human
   chromosome) through ``count_file`` and ``SparseKmerEngine``. Each table
   is checked code for code and count for count against a plain reference
   that shares no code with the port: every window of the generated
   records encoded in int64 on the card, then ``torch.unique``. The
   kernel's launch count is checked against the batch count. Then the
   dense path on the same file: ``count_file`` at k=3 (K7 after the
   device unpack), canonical k=6 and k=8 (K5), and with
   ``pack_input=False`` at k=2 (K7), k=5 and canonical k=8 (K6), and at k=9
   (K1, densified), each histogram against ``torch.bincount`` of the same
   reference codes and each run launching only its route's kernel, once
   per batch; and ``histogram_stream`` at 3,000 bins over the whole
   stream (K8, one launch). Then the streaming counter
   (``StreamingCounter``) on the same file: k=21 with ``compact="device"``
   through K9 (``pack_input=False``) and through K1, ``compact="host"``
   (no launch), ``compact="auto"`` (its decision and flips), canonical
   k=11 through K9, dense k=8 (K5) with a checkpoint every 64 Mbase, a
   child process killed by SIGKILL after its second checkpoint and resumed
   here, and ``count_file(k=21, pack_input=False)`` (K9). Each reference
   is computed once per (k, canonical) and shared by the runs held against
   it;
5. the distance kernels (K2 counts matrix, K3 and K4 (min,+)) against
   their plain PyTorch versions on the card, element for element on edge
   shapes, then timed with CUDA events at the distance path's shapes,
   beside their plain versions and, for K3/K4, ``torch.cdist(p=1)``;
6. the distance path on a seeded FASTA of ``--records`` records of
   1,000-2,000 bases (default 54,018, the reference program's design
   scale): (a) ``distance_file`` at k=3 on the first 16,384 records, (b)
   ``KmerEngine(k=8).distance_sequences`` on the first 2,048, (c)
   ``distance_stream_to_csv`` at k=3 over all records, one panel of 2,048
   rows. Each is held against a plain reference that shares no code with
   the port (int64 rolled codes and ``bincount`` on the card, blocked
   ``torch.minimum(...).sum``, a NumPy float32 finish): counts and
   min-sums exactly, distances bit for bit, sampled CSV lines byte for
   byte. Every kernel's launch count is checked against what the run
   implies;
7. the bucketed exchange (BASELINE config 5): K1m (K1 with its minimizer
   plane), K10 (owner segments) and P1 (the row roll) against their plain
   versions on edge cases, then timed at the config-5 shapes (one 64 Mbase
   shard at k=31, m=7; K10 over [32768, 2048] x 2 planes at D=4; P1 at
   [32768, 2048]); then ``count_bucket_auto`` on the main path's FASTA
   (parsed by the port's native parser) on a local mesh of 4 shards on the
   card: k=31 with minimizer owners (config 5), the same canonical, and
   prefix owners, each against ``reference_table``, with its launches and
   phase split, and the row route timed against the global sort at one
   shard; then, on the first 16 Mbase, the global route, the aggregated and
   super-k-mer exchanges, k=21, a mesh of 5, a homopolymer-rich stream
   on which auto falls back to the aggregated exchange, and a 1-rank NCCL
   process group, each against its reference;
8. the device-sort route: K11 (the row sort) against its plain version at
   row lengths 128, 512, 2048 and 32768 (random u32 with top-bit values,
   sentinel tails), then timed at the route's [8192, 2048] rows of one
   16 Mbase batch beside its plain version and ``torch.sort(dim=-1)``;
   then ``SparseKmerEngine`` on the main path's FASTA in paired,
   alternating order: at k=21 no device sort, ``device_sort`` rows
   (``torch.sort``) and one flat sort; at canonical k=11 no device sort,
   ``torch.sort`` rows and K11 rows (``pallas_sort``, one launch per
   batch); ``StreamingCounter(compact="device-rle")`` at k=21 on the FASTA
   and on two duplicated inputs (the records of its first 16 Mbase four
   times, of its first 4 Mbase sixteen times); and the aggregated
   exchange on a one-shard mesh at k=13. Each table against
   its reference, each run's launches against its route.

The script imports the port and nothing of JAX or of the JAX package.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and the line before that the kernels'
JSON record. Without CUDA, or without the rest of the repository beside
it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: (k, canonical) cases of the kernel-vs-plain check
KERNEL_CASES = [
    (11, True), (13, False), (15, False), (16, False), (16, True),
    (21, False), (21, True), (23, True), (24, False), (31, False), (31, True),
]
#: (k, canonical) cases timed at the main path's batch shape
TIMED_CASES = [(21, False), (11, True)]
CHECK_BASES = 4 << 20
#: the base stream's code for an invalid base and for the separator
#: between records (A, C, G, T are 0..3)
INVALID = 0xFF
#: windows per chunk of the reference encode
REF_CHUNK = 1 << 25
#: k of the dense kernels' check, each with and without canonical
DENSE_KS = (1, 2, 3, 4, 6, 7, 8)
#: K8's (k, bins) checks: two bin counts that are not powers of two, and
#: one above the shared-memory slices
ANY_CASES = ((5, 1000), (6, 3000), (11, 4**11))
#: the dense path's count_file runs: (name, k, canonical, pack_input, the
#: kernel its route launches once per batch)
DENSE_RUNS = (
    ("count_file(k=3)", 3, False, True, "hist_u8_small"),
    ("count_file(k=6, canonical)", 6, True, True, "hist_planes"),
    ("count_file(k=8)", 8, False, True, "hist_planes"),
    ("count_file(k=2, pack_input=False)", 2, False, False, "hist_u8_small"),
    ("count_file(k=5, pack_input=False)", 5, False, False, "hist_u8"),
    ("count_file(k=8, canonical, pack_input=False)", 8, True, False, "hist_u8"),
    ("count_file(k=9)", 9, False, True, "encode_packed"),
)
#: K8 on the dense path: the routing entry at bins that are not a power of
#: two, over the whole stream
ANY_RUN = ("histogram_stream(k=6, bins=3000)", 6, 3000)
#: the run whose launches the kernels line reports for each dense kernel
DENSE_MAIN = {
    "hist_planes": "count_file(k=8)",
    "hist_u8": "count_file(k=5, pack_input=False)",
    "hist_u8_small": "count_file(k=3)",
    "hist_u8_any": ANY_RUN[0],
}
#: the card's peaks for the bound of a kernel (NVIDIA's H100 SXM data
#: sheet): device-memory bytes per second, and operations per second
#: outside the tensor cores (the float32 rate; the data sheet gives no
#: int32 rate, and the min-sum kernels' min and add are int32)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
#: the distance path's shapes: records (a) counts at k=3, (b) at k=8, and
#: the rows of (c)'s one streamed panel
DIST_ROWS_A = 16384
DIST_ROWS_B = 2048
PANEL_ROWS = 2048
#: k of K9's check (every width of the split words), each with and
#: without canonical
STREAM_KS = (1, 11, 13, 15, 16, 21, 23, 24, 31)
#: K9's check stream: not a multiple of the kernel's 2,048-window tile
STREAM_CHECK_BASES = CHECK_BASES + 777
#: the streaming path's batch (None: KmerConfig's 16 Mbase) and the bases
#: between its checkpoints
STREAM_BATCH_BASES = None
STREAM_CKPT_BASES = 64 << 20
#: the streaming run whose launches the kernels line reports for K9
STREAM_MAIN = "StreamingCounter(k=21, compact=device, pack_input=False)"
#: K1m's check: every m of {7, 11, 15} below k, for k in {17, 21, 31}
MIN_CASES = [(k, m) for k in (17, 21, 31) for m in (7, 11, 15) if m < k]
#: the bucketed path (config 5): shards on the card, k, minimizer length
BUCKET_D = 4
BUCKET_K = 31
BUCKET_M = 7
#: the bucketed path's smaller runs: the first bases of the main FASTA
BUCKET_SMALL_BASES = 16 << 20
#: K10's and P1's timed shape: the row route's rows of one 64 Mbase shard
SEG_ROWS = 32768
ROW_W = 2048
#: the config-5 run, whose launches the kernels line reports for K1m, K10
#: and P1
BUCKET_MAIN = f"count_bucket_auto(k={BUCKET_K}, minimizer, D={BUCKET_D})"
#: K11's check: (row length, rows), one per word-per-thread instantiation
#: and the widest row; then timed at the device-sort route's rows of one
#: 16 Mbase batch (16,777,216 windows as [8192, 2048])
SORT_CHECKS = ((128, 1000), (512, 333), (2048, 129), (32768, 37))
SORT_ROWS = 8192
#: the device-sort path's batch (None: KmerConfig's 16 Mbase), and its
#: duplicated inputs, (bases, copies): the records starting in the first
#: bases of the main FASTA, repeated. 16 Mbase x 4 repeats whole batches;
#: 4 Mbase x 16 puts four copies in each batch, where the RLE collapses
#: them on the card.
SORT_BATCH_BASES = None
SORT_DUPS = ((16 << 20, 4), (4 << 20, 16))
#: the one-shard aggregated run's input: the main FASTA's first bases
SORT_SMALL_BASES = 16 << 20
#: the device-sort run whose launches the kernels line reports for K11
SORT_MAIN = "SparseKmerEngine(k=11, canonical, device_sort, pallas_sort)"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


def check_stream(rng, n_bases: int):
    """Seeded u8 base stream: ~1% isolated N, a few N runs, and an all-T
    homopolymer stretch of 64 bases."""
    import numpy as np

    b = rng.integers(0, 4, n_bases, dtype=np.uint8)
    b[rng.random(n_bases) < 0.01] = INVALID
    for s in rng.integers(0, n_bases - 512, 5):
        b[s : s + int(rng.integers(20, 400))] = INVALID
    b[1000:1064] = 3
    return b


def time_ms(fn, iters: int) -> float:
    """Mean CUDA-event milliseconds per call, after two warm-up calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, ref) -> int:
    """Largest |kernel - plain| over the planes; raises unless every
    plane has the plain version's dtype and shape."""
    worst = 0
    for g, r in zip(got, ref, strict=True):
        if g.dtype != r.dtype or g.shape != r.shape:
            raise AssertionError(
                f"plane {g.dtype}{tuple(g.shape)} != plain {r.dtype}{tuple(r.shape)}"
            )
        worst = max(worst, int((g.long() - r.long()).abs().max()))
    return worst


def phase_kernels(dev, card: str) -> dict:
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import stage_batch_planes
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import batch_plan
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda
    from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

    def both(planes, n_own, k, canonical):
        got = sparse_ops.encode_words_planes(*planes, n_own, k, canonical)
        ref = sparse_ops.narrow_words(
            *encode_cuda.encode_packed_reference(*planes, n_own, k, canonical), k
        )
        torch.cuda.synchronize()
        return got, ref

    rng = np.random.default_rng(0)
    planes = stage_batch_planes(check_stream(rng, CHECK_BASES), dev)
    n_own = CHECK_BASES - 1000
    for k, canonical in KERNEL_CASES:
        got, ref = both(planes, n_own, k, canonical)
        err = max_abs_err(got, ref)
        n_valid = int((got[0] != -1).sum())
        log(f"kernel check k={k} canonical={canonical}: {CHECK_BASES} windows, "
            f"{n_valid} valid, max_abs_err={err}")
        if err:
            raise AssertionError(f"kernel disagrees with plain at k={k} canonical={canonical}")

    # Time at the main path's batch: batch_bases owned + a (k-1) halo,
    # padded (models/sparse_engine.batch_plan).
    record = {}
    for k, canonical in TIMED_CASES:
        batch, T = batch_plan(1 << 40, k, KmerConfig().batch_bases)
        planes = stage_batch_planes(check_stream(rng, T), dev)
        got, ref = both(planes, batch, k, canonical)
        err = max_abs_err(got, ref)
        if err:
            raise AssertionError(f"kernel disagrees with plain at T={T} k={k}")
        del got, ref
        ms = time_ms(lambda: encode_cuda.encode_packed(*planes, batch, k, canonical), 50)
        plain_ms = time_ms(
            lambda: encode_cuda.encode_packed_reference(*planes, batch, k, canonical), 5
        )
        out_bytes = T * (4 + (sparse_ops.hi_dtype(k).itemsize if k > 15 else 0))
        log(f"kernel time k={k} canonical={canonical} T={T}: kernel {ms:.4f} ms "
            f"({T / ms / 1e6:.2f} Gwindow/s, {out_bytes / ms / 1e6:.1f} GB/s stored), "
            f"plain {plain_ms:.3f} ms, max_abs_err={err} [{card}]")
        record[(k, canonical)] = (ms, plain_ms, err)
    return record


def smoke_records(bases: int):
    """Seeded records of 200-300 kbase (0.1% N) totalling about ``bases``
    bases, as (stream, starts, lengths): the u8 base stream with one
    INVALID separator between records, and each record's offset and
    length in it."""
    import numpy as np

    rng = np.random.default_rng(0)
    n_seqs = max(1, round(bases / 250_000))
    lengths = rng.integers(200_000, 300_001, n_seqs)
    starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]])
    stream = rng.integers(0, 4, int(lengths.sum()) + n_seqs - 1, dtype=np.uint8)
    stream[rng.random(stream.size) < 0.001] = INVALID
    stream[starts[1:] - 1] = INVALID
    return stream, starts, lengths


def write_fasta(path: Path, stream, starts, lengths) -> None:
    """The records as FASTA: ACGT and N, 80 bases per line."""
    import numpy as np

    letters = np.full(256, ord("N"), np.uint8)
    letters[:4] = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, (s, n) in enumerate(zip(starts, lengths)):
            rec = letters[stream[s : s + n]]
            full = n // 80 * 80
            lines = np.full((full // 80, 81), ord("\n"), np.uint8)
            lines[:, :80] = rec[:full].reshape(-1, 80)
            f.write(b">seq%d synthetic\n" % i)
            f.write(lines.tobytes())
            if n > full:
                f.write(rec[full:].tobytes() + b"\n")


def reference_codes(stream, k: int, canonical: bool, dev):
    """The int64 codes of every valid window of the stream, chunk by chunk,
    in plain torch on the card: the code of a window rolled over its k
    bases (and its reverse complement, for canonical). Shares no code with
    the port."""
    import torch

    b = torch.from_numpy(stream).to(dev)
    n = b.numel() - k + 1
    for s in range(0, n, REF_CHUNK):
        m = min(REF_CHUNK, n - s)
        w = b[s : s + m + k - 1].long()
        code = torch.zeros(m, dtype=torch.int64, device=dev)
        rc = torch.zeros_like(code)
        valid = torch.ones(m, dtype=torch.bool, device=dev)
        for j in range(k):
            d = w[j : j + m]
            valid &= d < 4
            code = (code << 2) | (d & 3)
            rc |= (3 - (d & 3)) << (2 * j)
        if canonical:
            code = torch.minimum(code, rc)
        yield code[valid]


def reference_table(stream, k: int, canonical: bool, dev):
    """Sorted distinct codes (u64) and counts (i64) of every valid window
    of the stream: ``reference_codes``, then ``torch.unique``."""
    import torch

    parts = list(reference_codes(stream, k, canonical, dev))
    codes, counts = torch.unique(torch.cat(parts), sorted=True, return_counts=True)
    return codes.cpu().numpy().view("u8"), counts.cpu().numpy()


def reference_hist(stream, k: int, canonical: bool, dev, bins: int | None = None):
    """int64 [bins] (default 4^k) counts of the valid windows' codes below
    ``bins``: ``reference_codes``, then ``torch.bincount``."""
    import torch

    bins = 4**k if bins is None else bins
    hist = torch.zeros(bins, dtype=torch.int64, device=dev)
    for codes in reference_codes(stream, k, canonical, dev):
        hist += torch.bincount(codes[codes < bins], minlength=bins)
    return hist.cpu().numpy()


def cached(refs: dict, key: tuple, make):
    """``refs[key]``, made by ``make()`` the first time: each reference is
    computed once per (kind, k, canonical) and shared by every run held
    against it."""
    if key not in refs:
        refs[key] = make()
    return refs[key]


def phase_main_path(records, path: Path, dev, card: str, refs: dict | None = None) -> int:
    import numpy as np
    import torch

    import dna_kmeres_parallel_tpu_torch as port
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
        SparseKmerEngine,
        batch_plan,
    )

    stream, _, lengths = records
    refs = {} if refs is None else refs
    runs = [
        ("count_file(k=21)", 21, False,
         lambda: port.count_file(str(path), k=21, device=dev)),
        ("SparseKmerEngine(k=21, canonical)", 21, True,
         lambda: SparseKmerEngine(KmerConfig(k=21, canonical=True), device=dev)
         .count_file(str(path))),
        ("SparseKmerEngine(k=11, canonical)", 11, True,
         lambda: SparseKmerEngine(KmerConfig(k=11, canonical=True), device=dev)
         .count_file(str(path))),
    ]
    main_launches = None
    for name, k, canonical, run in runs:
        t = time.perf_counter()
        ref_codes, ref_counts = cached(
            refs, ("table", k, canonical), lambda: reference_table(stream, k, canonical, dev)
        )
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t
        batch, _ = batch_plan(stream.size, k, KmerConfig().batch_bases)
        n_batches = math.ceil(stream.size / batch)
        reset_launches()
        t = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t
        got = read_launches()
        launches = got["encode_packed"]
        if any(got[n] for n in got if n != "encode_packed"):
            raise AssertionError(f"{name}: other kernels launched: {got}")
        if (res.n_seqs, res.total_bases) != (lengths.size, int(lengths.sum())):
            raise AssertionError(
                f"{name}: {res.n_seqs} records of {res.total_bases} bases parsed"
            )
        if not (
            np.array_equal(res.codes, ref_codes)
            and np.array_equal(res.counts, ref_counts)
        ):
            raise AssertionError(f"{name}: table differs from the reference")
        if launches != n_batches:
            raise AssertionError(
                f"{name}: {launches} kernel launches for {n_batches} batches"
            )
        if main_launches is None:  # the first run is the main path's
            main_launches = launches
        phases = " ".join(f"{p}={s:.3f}" for p, s in res.phases.items())
        log(f"{name}: {res.distinct_kmers} distinct, {res.total_kmers} k-mers, "
            f"equal to the reference ({ref_s:.2f} s); "
            f"{launches} launches for {n_batches} batches; "
            f"wall {wall:.3f} s, {res.total_bases / wall / 1e9:.4f} Gbase/s; "
            f"phases s: {phases} [{card}]")
    return main_launches


def phase_dense_kernels(dev, card: str) -> dict:
    """K5-K8 against their plain versions on an N-rich stream, element for
    element, then each timed at one 16 Mbase batch beside its plain
    version. Returns each kernel's record."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan, stage_batch_planes
    from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda as hc

    worst = dict.fromkeys(("hist_planes", "hist_u8", "hist_u8_small", "hist_u8_any"), 0)

    def check(name, got, ref, what):
        torch.cuda.synchronize()
        err = max_abs_err((got,), (ref,))
        worst[name] = max(worst[name], err)
        if err:
            raise AssertionError(f"{name} disagrees with plain at {what}")

    rng = np.random.default_rng(4)
    bases = check_stream(rng, CHECK_BASES)
    planes = stage_batch_planes(bases, dev)
    b = torch.from_numpy(bases).to(dev)
    owns = (0, 1, CHECK_BASES // 2 + 5, CHECK_BASES)
    for k in DENSE_KS:
        for canonical in (False, True):
            for n_own in owns:
                what = f"k={k} canonical={canonical} n_own={n_own}"
                check("hist_planes", hc.hist_planes_cuda(*planes, n_own, k, canonical),
                      hc.hist_planes_reference(*planes, n_own, k, canonical), what)
                ref = hc.hist_u8_reference(b, n_own, k, 4**k, canonical)
                check("hist_u8", hc.hist_u8_cuda(b, n_own, k, 4**k, canonical), ref, what)
                if 4**k <= hc.SMALL_BINS:
                    check("hist_u8_small", hc.hist_u8_small_cuda(b, n_own, k, 4**k, canonical),
                          ref, what)
            log(f"kernel check dense k={k} canonical={canonical}: {CHECK_BASES} bases, "
                f"n_own in {owns}: K5, K6{', K7' if k <= 3 else ''} equal their plain "
                f"versions, {int(ref.sum())} windows at full n_own")
    for k, bins in ANY_CASES:
        for canonical in (False, True):
            for n_own in owns:
                check("hist_u8_any", hc.hist_u8_any_cuda(b, n_own, k, bins, canonical),
                      hc.hist_u8_reference(b, n_own, k, bins, canonical),
                      f"k={k} bins={bins} canonical={canonical} n_own={n_own}")
        log(f"kernel check dense K8 k={k} bins={bins}: equal to plain")

    # One 16 Mbase batch: batch_bases owned + a (k-1) halo, padded.
    batch, T = batch_plan(1 << 40, 8, KmerConfig().batch_bases)
    bases = check_stream(rng, T)
    planes = stage_batch_planes(bases, dev)
    b = torch.from_numpy(bases).to(dev)
    rec = {}

    def timed(name, shape, bins, kernel, plain, in_bytes):
        check(name, kernel(None), plain(), f"T={T} {shape}")
        acc = torch.zeros(bins, dtype=torch.int32, device=dev)
        rec[name] = dict(
            ms=time_ms(lambda: kernel(acc), 20),
            plain_ms=time_ms(plain, 3),
            library_ms=None,
            bound=bound_ms(in_bytes + 2 * 4 * bins, batch),
            shape=shape,
        )

    timed("hist_planes", "k=8 planes", 4**8,
          lambda acc: hc.hist_planes_cuda(*planes, batch, 8, False, acc),
          lambda: hc.hist_planes_reference(*planes, batch, 8), T // 2)
    timed("hist_u8", "k=8 u8", 4**8,
          lambda acc: hc.hist_u8_cuda(b, batch, 8, 4**8, False, acc),
          lambda: hc.hist_u8_reference(b, batch, 8, 4**8), T)
    timed("hist_u8_small", "k=3 u8", 64,
          lambda acc: hc.hist_u8_small_cuda(b, batch, 3, 64, False, acc),
          lambda: hc.hist_u8_reference(b, batch, 3, 64), T)
    _, k8, bins8 = ANY_RUN
    timed("hist_u8_any", f"k={k8} bins={bins8} u8", bins8,
          lambda acc: hc.hist_u8_any_cuda(b, batch, k8, bins8, False, acc),
          lambda: hc.hist_u8_reference(b, batch, k8, bins8), T)
    acc = torch.zeros(4**11, dtype=torch.int32, device=dev)
    wide_ms = time_ms(lambda: hc.hist_u8_any_cuda(b, batch, 11, 4**11, False, acc), 20)
    log(f"kernel time hist_u8_any k=11 bins={4**11} u8 T={T}: {wide_ms:.4f} ms, bound "
        f"{bound_ms(T + 8 * 4**11, batch)[0]:.4f} ms [{card}]")
    for name, r in rec.items():
        r["max_abs_err"] = worst[name]
        log(f"kernel time {name} {r['shape']} T={T}: kernel {r['ms']:.4f} ms "
            f"({batch / r['ms'] / 1e6:.2f} Gwindow/s), plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), max_abs_err={worst[name]} [{card}]")
    return rec


def phase_dense_path(records, path: Path, dev, card: str, refs: dict | None = None) -> dict:
    """The dense counting runs (DENSE_RUNS, then ANY_RUN) on the main
    path's FASTA, each against ``reference_hist``. Returns each run's launch
    counts."""
    import numpy as np
    import torch

    import dna_kmeres_parallel_tpu_torch as port
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan
    from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda

    stream, _, lengths = records
    refs = {} if refs is None else refs
    none = dict.fromkeys(read_launches(), 0)
    launches = {}
    for name, k, canonical, pack_input, kernel in DENSE_RUNS:
        t = time.perf_counter()
        ref = cached(refs, ("hist", k, canonical),
                     lambda: reference_hist(stream, k, canonical, dev))
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t
        batch, _ = batch_plan(stream.size, k, KmerConfig().batch_bases)
        n_batches = math.ceil(stream.size / batch)
        reset_launches()
        t = time.perf_counter()
        res = port.count_file(str(path), k=k, canonical=canonical,
                              pack_input=pack_input, device=dev)
        wall = time.perf_counter() - t
        launches[name] = expect_launches(name, {**none, kernel: n_batches})
        if (res.n_seqs, res.total_bases) != (lengths.size, int(lengths.sum())):
            raise AssertionError(f"{name}: {res.n_seqs} records of {res.total_bases} bases parsed")
        if res.hist.dtype != np.int64 or not np.array_equal(res.hist, ref):
            raise AssertionError(f"{name}: histogram differs from the reference")
        phases = " ".join(f"{p}={s:.3f}" for p, s in res.phases.items())
        log(f"{name}: {res.distinct_kmers} distinct, {res.total_kmers} k-mers, equal to "
            f"the reference ({ref_s:.2f} s); {n_batches} {kernel} launches for "
            f"{n_batches} batches; wall {wall:.3f} s, "
            f"{res.total_bases / wall / 1e9:.4f} Gbase/s; phases s: {phases} [{card}]")

    name, k, bins = ANY_RUN
    ref = reference_hist(stream, k, False, dev, bins)
    b = torch.from_numpy(stream).to(dev)
    reset_launches()
    t = time.perf_counter()
    got = histogram_cuda.histogram_stream(b, b.numel(), k, bins).cpu().numpy()
    wall = time.perf_counter() - t
    launches[name] = expect_launches(name, {**none, "hist_u8_any": 1})
    if got.shape != (bins,) or not np.array_equal(got, ref):
        raise AssertionError(f"{name}: histogram differs from the reference")
    log(f"{name} over {b.numel()} bases on the card: {int(got.sum())} windows, equal to "
        f"the reference; 1 hist_u8_any launch; wall {wall:.3f} s [{card}]")
    return launches


def phase_stream_kernel(dev, card: str) -> dict:
    """K9 against its plain version, element for element: every k of
    STREAM_KS x canonical x four n_own on an N-rich stream whose length is
    not a multiple of the kernel's tile, plus streams shorter than k and an
    unaligned view; then timed at the main path's 16 Mbase batch (k=21)
    beside its plain version. Returns the kernel's record."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda
    from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

    def check(b, n_own, k, canonical) -> int:
        got = sparse_ops.encode_words(b, n_own, k, canonical)
        ref = sparse_ops.narrow_words(
            *encode_cuda.encode_stream_reference(b, n_own, k, canonical), k
        )
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err:
            raise AssertionError(
                f"encode_stream disagrees with plain at T={b.numel()} n_own={n_own} "
                f"k={k} canonical={canonical}"
            )
        return int((got[-1] != -1).sum())

    rng = np.random.default_rng(5)
    T = STREAM_CHECK_BASES
    b = torch.from_numpy(check_stream(rng, T)).to(dev)
    owns = (0, 1, T // 2, None)  # None: T - k + 1, the last window's start + 1
    for k in STREAM_KS:
        for canonical in (False, True):
            valid = [check(b, T - k + 1 if n is None else n, k, canonical) for n in owns]
            if k > 1:
                check(b[3 : 3 + k - 1], k, k, canonical)  # shorter than one window
            check(b[5 : 5 + 10_001], 10_001, k, canonical)  # unaligned start
        log(f"kernel check encode_stream k={k}: T={T}, n_own in "
            f"{tuple(T - k + 1 if n is None else n for n in owns)}, canonical and not: "
            f"equal to plain; {valid[-1]} valid windows at full n_own")

    batch, T = batch_plan(1 << 40, 21, KmerConfig().batch_bases)
    b = torch.from_numpy(check_stream(rng, T)).to(dev)
    check(b, batch, 21, False)
    ms = time_ms(lambda: encode_cuda.encode_stream(b, batch, 21, False), 50)
    plain_ms = time_ms(lambda: encode_cuda.encode_stream_reference(b, batch, 21, False), 5)
    bound = bound_ms(T + 6 * T, 0)  # T bytes read, lo (4 B) and hi (2 B) stored
    log(f"kernel time encode_stream k=21 T={T}: kernel {ms:.4f} ms "
        f"({T / ms / 1e6:.2f} Gwindow/s, {6 * T / ms / 1e6:.1f} GB/s stored), plain "
        f"{plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), max_abs_err=0 [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound=bound, max_abs_err=0)


#: the child of the kill-and-resume run: counts on ``dev`` with a
#: checkpoint every ``every`` bases and SIGKILLs itself once its second
#: checkpoint is published
_KILLED_CHILD = r"""
import os, signal, sys
sys.path.insert(0, sys.argv[1])
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
from dna_kmeres_parallel_tpu_torch.utils import checkpoint

root, path, ckpt, dev, every, batch = sys.argv[1:7]
save = checkpoint.save_checkpoint
published = []

def save_then_die(*a, **kw):
    save(*a, **kw)
    published.append(1)
    if len(published) == 2:
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)

checkpoint.save_checkpoint = save_then_die
kw = {} if batch == "None" else {"batch_bases": int(batch)}
StreamingCounter(KmerConfig(k=21, **kw), device=dev, checkpoint_path=ckpt,
                 checkpoint_every_bases=int(every)).run(path)
"""


def phase_stream_path(records, path: Path, dev, card: str, refs: dict | None = None) -> dict:
    """The streaming counter on the main path's FASTA: k=21 through K9
    (``pack_input=False``) and K1, the host route, the 'auto' race,
    canonical k=11 through K9, dense k=8 with a checkpoint every
    STREAM_CKPT_BASES bases, a child killed after its second checkpoint and
    resumed here, and ``count_file(k=21, pack_input=False)``. Each table or
    histogram is held against the cached plain reference, and each run's
    launches against its route. Returns each run's launch counts."""
    import signal

    import numpy as np
    import torch

    import dna_kmeres_parallel_tpu_torch as port
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
    from dna_kmeres_parallel_tpu_torch.utils import checkpoint

    stream, _, lengths = records
    refs = {} if refs is None else refs
    none = dict.fromkeys(read_launches(), 0)
    size = {} if STREAM_BATCH_BASES is None else {"batch_bases": STREAM_BATCH_BASES}
    batch, _ = batch_plan(stream.size, 21, KmerConfig(**size).batch_bases)
    n_batches = math.ceil(stream.size / batch)
    launches = {}

    def table_ref(k, canonical):
        return cached(refs, ("table", k, canonical),
                      lambda: reference_table(stream, k, canonical, dev))

    def equal_to_ref(name, res, k, canonical):
        if (res.n_seqs, res.total_bases) != (lengths.size, int(lengths.sum())):
            raise AssertionError(f"{name}: {res.n_seqs} records of {res.total_bases} bases")
        if hasattr(res, "hist"):
            if k <= 8:
                want = cached(refs, ("hist", k, canonical),
                              lambda: reference_hist(stream, k, canonical, dev))
            else:
                codes, counts = table_ref(k, canonical)
                want = np.zeros(4**k, np.int64)
                want[codes.astype(np.int64)] = counts
            ok = res.hist.dtype == np.int64 and np.array_equal(res.hist, want)
        else:
            codes, counts = table_ref(k, canonical)
            ok = np.array_equal(res.codes, codes) and np.array_equal(res.counts, counts)
        if not ok:
            raise AssertionError(f"{name}: result differs from the reference")
        torch.cuda.empty_cache()

    def report(name, wall, res, metrics, got):
        fired = {n: c for n, c in got.items() if c}
        phases = " ".join(f"{p}={s:.3f}" for p, s in metrics.phase_seconds.items())
        log(f"{name}: equal to the reference; wall {wall:.3f} s, "
            f"{res.total_bases / wall / 1e9:.4f} Gbase/s; phases s: {phases}; "
            f"counters {dict(metrics.counters)}; launches {fired or 'none'} [{card}]")

    def streamed(name, k, canonical, kw, want=None, **sc_kw):
        """One StreamingCounter run; ``want`` is its exact launch count by
        kernel (None: checked by the caller)."""
        cfg = KmerConfig(k=k, canonical=canonical, **size, **kw)
        sc = StreamingCounter(cfg, device=dev, **sc_kw)
        reset_launches()
        t = time.perf_counter()
        res = sc.run(str(path))
        wall = time.perf_counter() - t
        got = read_launches() if want is None else expect_launches(name, {**none, **want})
        launches[name] = got
        equal_to_ref(name, res, k, canonical)
        report(name, wall, res, sc.metrics, got)
        return res, sc.metrics, got

    streamed(STREAM_MAIN, 21, False, {"compact": "device", "pack_input": False},
             {"encode_stream": n_batches})
    streamed("StreamingCounter(k=21, compact=device)", 21, False,
             {"compact": "device"}, {"encode_packed": n_batches})
    streamed("StreamingCounter(k=21, compact=host)", 21, False, {"compact": "host"}, {})
    name = "StreamingCounter(k=21, compact=auto)"
    _, m, got = streamed(name, 21, False, {"compact": "auto"})
    # Batches 1-3 always run on the card and batch 4 on the host; the rest
    # follow the race.
    if {n for n, c in got.items() if c} != {"encode_packed"} or not (
        3 <= got["encode_packed"] <= n_batches - 1
    ):
        raise AssertionError(f"{name}: launches {got} for {n_batches} batches")
    log(f"{name}: decided {'host' if m.counters['compact_host_selected'] else 'device'}, "
        f"{m.counters.get('compact_mode_flips', 0)} flips, "
        f"{got['encode_packed']} of {n_batches} batches on the card [{card}]")
    streamed("StreamingCounter(k=11, canonical, compact=device, pack_input=False)", 11, True,
             {"compact": "device", "pack_input": False}, {"encode_stream": n_batches})

    ckpt = path.with_name("stream.npz")
    name = f"StreamingCounter(k=8, checkpoint_every_bases={STREAM_CKPT_BASES})"
    _, m, _ = streamed(name, 8, False, {}, {"hist_planes": n_batches},
                       checkpoint_path=str(ckpt), checkpoint_every_bases=STREAM_CKPT_BASES)
    final = checkpoint.load_checkpoint(ckpt)
    if not final.dense or final.cursor != stream.size or m.counters["checkpoints"] < 2:
        raise AssertionError(f"{name}: {m.counters['checkpoints']} checkpoints, "
                             f"the last at {final.cursor} of {stream.size}")
    ckpt.unlink()

    # A real kill: the child SIGKILLs itself once its second checkpoint is
    # on disk, and this process resumes from that file.
    name = "StreamingCounter(k=21) killed after its second checkpoint, resumed"
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _KILLED_CHILD, str(ROOT), str(path), str(ckpt), str(dev),
         str(STREAM_CKPT_BASES), str(STREAM_BATCH_BASES)],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
    )
    child_s = time.perf_counter() - t
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"{name}: the child exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    saved = checkpoint.load_checkpoint(ckpt)
    per_ckpt = -(-STREAM_CKPT_BASES // batch) * batch
    if saved.dense or saved.cursor != 2 * per_ckpt:
        raise AssertionError(f"{name}: the child's checkpoint is at {saved.cursor}, "
                             f"not {2 * per_ckpt}")
    res, m, _ = streamed(name, 21, False, {}, None, checkpoint_path=str(ckpt),
                         checkpoint_every_bases=1 << 62)
    if m.counters.get("resumed_from_base") != saved.cursor:
        raise AssertionError(f"{name}: resumed from {m.counters.get('resumed_from_base')}")
    log(f"{name}: child killed by SIGKILL after {child_s:.1f} s with its checkpoint at "
        f"base {saved.cursor}; resumed_from_base={m.counters['resumed_from_base']} "
        f"[{card}]")
    ckpt.unlink()

    name = "count_file(k=21, pack_input=False)"
    reset_launches()
    t = time.perf_counter()
    res = port.count_file(str(path), k=21, pack_input=False, device=dev, **size)
    wall = time.perf_counter() - t
    launches[name] = expect_launches(name, {**none, "encode_stream": n_batches})
    equal_to_ref(name, res, 21, False)
    phases = " ".join(f"{p}={s:.3f}" for p, s in res.phases.items())
    log(f"{name}: equal to the reference; {n_batches} encode_stream launches for "
        f"{n_batches} batches; wall {wall:.3f} s, {res.total_bases / wall / 1e9:.4f} "
        f"Gbase/s; phases s: {phases} [{card}]")
    return launches


def seg_rows(n_rows: int, D: int, seed: int, dev):
    """Row-sorted int32 planes [n_rows, ROW_W] (two) grouped by a seeded
    owner, and their starts [n_rows, D+1], on ``dev``: row 0 one owner for
    the whole row (cut at any row_cap below ROW_W), row 1 all sentinels
    (every segment empty), and no owner in every seventh column."""
    import torch

    g = torch.Generator().manual_seed(seed)
    owner = torch.randint(0, D, (n_rows, ROW_W), generator=g)
    owner[0] = D - 1
    owner[1] = D
    owner[2:, ::7] = D
    words = torch.randint(-(2**31), 2**31 - 1, (2, n_rows, ROW_W), generator=g,
                          dtype=torch.int64).to(torch.int32)
    key, order = torch.sort(owner.to(dev), dim=1)
    planes = tuple(w.to(dev).gather(1, order).contiguous() for w in words)
    th = torch.arange(D + 1, device=dev).expand(n_rows, D + 1).contiguous()
    return planes, torch.searchsorted(key, th, out_int32=True)


def phase_bucket_kernels(dev, card: str, shard_bases: int) -> dict:
    """K1m, K10 and P1 against their plain versions, element for element,
    then each timed at the config-5 shapes beside its plain version.
    Returns each kernel's record."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch.models.engine import stage_batch_planes
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda, sort_cuda
    from dna_kmeres_parallel_tpu_torch.parallel import bucketed

    worst = dict.fromkeys(("encode_packed_minimizer", "owner_segments", "row_roll"), 0)

    def check(name, got, ref, what):
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        worst[name] = max(worst[name], err)
        if err:
            raise AssertionError(f"{name} disagrees with plain at {what}")

    rng = np.random.default_rng(6)
    planes = stage_batch_planes(check_stream(rng, CHECK_BASES), dev)
    owns = (0, 1, CHECK_BASES // 2 + 5, CHECK_BASES)
    for k, m in MIN_CASES:
        for canonical in (False, True):
            for n_own in owns:
                what = f"k={k} m={m} canonical={canonical} n_own={n_own}"
                got = encode_cuda.encode_packed(*planes, n_own, k, canonical, minimizer_m=m)
                check("encode_packed_minimizer", got, encode_cuda.encode_packed_reference(
                    *planes, n_own, k, canonical, minimizer_m=m), what)
                check("encode_packed_minimizer", got[:2],
                      encode_cuda.encode_packed(*planes, n_own, k, canonical),
                      what + ": words with the plane against K1's without it")
            n_valid = int((got[0] != -1).sum())
        log(f"kernel check encode_packed_minimizer k={k} m={m}: {CHECK_BASES} windows, "
            f"n_own in {owns}, canonical and not: equal to plain, words equal K1's; "
            f"{n_valid} valid windows at full n_own")

    for D in (1, 4, 5, 8):
        planes2, starts = seg_rows(333, D, D, dev)
        for canonical in (False, True):
            row_cap = bucketed.row_capacity(ROW_W, D, canonical)
            for n_planes in (1, 2):
                what = f"D={D} row_cap={row_cap} planes={n_planes}"
                got = sort_cuda.extract_owner_segments(planes2[:n_planes], starts, row_cap, D)
                check("owner_segments", got, sort_cuda.owner_segments_reference(
                    planes2[:n_planes], starts, row_cap, D), what)
        lens = (starts[:, 1:] - starts[:, :-1]).cpu()
        log(f"kernel check owner_segments D={D}: [333, {ROW_W}] rows, 1 and 2 planes, "
            f"row_cap at 2x and 4x: equal to plain; {int((lens == 0).sum())} empty "
            f"segments, longest {int(lens.max())}")

    x = torch.arange(8 * 256, dtype=torch.int32, device=dev).reshape(8, 256)
    s = torch.arange(8, dtype=torch.int32, device=dev) * 3 + 1
    want = np.stack([np.roll(np.arange(8 * 256).reshape(8, 256)[r], -(3 * r + 1))
                     for r in range(8)])
    check("row_roll", (sort_cuda.row_roll(x, s),), (torch.from_numpy(want).to(torch.int32)
                                                     .to(dev),), "the probe's [8, 256] tile")
    g = torch.Generator().manual_seed(9)
    xr = torch.randint(-(2**31), 2**31 - 1, (SEG_ROWS, ROW_W), generator=g,
                       dtype=torch.int64).to(torch.int32).to(dev)
    sr = torch.randint(-3 * ROW_W, 3 * ROW_W, (SEG_ROWS,), generator=g).to(torch.int32).to(dev)
    check("row_roll", (sort_cuda.row_roll(xr, sr),), (sort_cuda.row_roll_reference(xr, sr),),
          f"[{SEG_ROWS}, {ROW_W}]")
    log(f"kernel check row_roll: the probe's [8, 256] tile equals np.roll, [{SEG_ROWS}, "
        f"{ROW_W}] with shifts in [-{3 * ROW_W}, {3 * ROW_W}) equals plain")

    rec = {}
    # K1m at one config-5 shard: 64 Mbase owned + a (k-1) halo, in planes.
    k, m, T = BUCKET_K, BUCKET_M, -(-(shard_bases + BUCKET_K - 1) // 16) * 16
    planes = stage_batch_planes(check_stream(rng, T), dev)
    check("encode_packed_minimizer",
          encode_cuda.encode_packed(*planes, shard_bases, k, False, minimizer_m=m),
          encode_cuda.encode_packed_reference(*planes, shard_bases, k, False, minimizer_m=m),
          f"T={T}")
    rec["encode_packed_minimizer"] = dict(
        ms=time_ms(lambda: encode_cuda.encode_packed(*planes, shard_bases, k, False,
                                                     minimizer_m=m), 20),
        plain_ms=time_ms(lambda: encode_cuda.encode_packed_reference(
            *planes, shard_bases, k, False, minimizer_m=m), 3),
        # planes read (0.5 B per base); lo, hi and the minimizer stored
        bound=bound_ms(T // 2 + 12 * T, 0),
        shape=f"k={k} m={m} T={T}",
    )
    del planes
    torch.cuda.empty_cache()
    D = BUCKET_D
    row_cap = bucketed.row_capacity(ROW_W, D, False)
    planes2, starts = seg_rows(SEG_ROWS, D, 11, dev)
    check("owner_segments", sort_cuda.extract_owner_segments(planes2, starts, row_cap, D),
          sort_cuda.owner_segments_reference(planes2, starts, row_cap, D),
          f"[{SEG_ROWS}, {ROW_W}] D={D}")
    rec["owner_segments"] = dict(
        ms=time_ms(lambda: sort_cuda.extract_owner_segments(planes2, starts, row_cap, D), 20),
        plain_ms=time_ms(lambda: sort_cuda.owner_segments_reference(planes2, starts,
                                                                    row_cap, D), 3),
        # both planes read, both planes' send slots written, the starts read
        bound=bound_ms(2 * 4 * SEG_ROWS * (ROW_W + D * row_cap) + 4 * SEG_ROWS * (D + 1), 0),
        shape=f"[{SEG_ROWS}, {ROW_W}] x 2 planes, D={D}, row_cap={row_cap}",
    )
    del planes2, starts
    rec["row_roll"] = dict(
        ms=time_ms(lambda: sort_cuda.row_roll(xr, sr), 20),
        plain_ms=time_ms(lambda: sort_cuda.row_roll_reference(xr, sr), 3),
        bound=bound_ms(2 * 4 * SEG_ROWS * ROW_W + 4 * SEG_ROWS, 0),
        shape=f"[{SEG_ROWS}, {ROW_W}]",
    )
    del xr, sr
    torch.cuda.empty_cache()
    for name, r in rec.items():
        r["max_abs_err"] = worst[name]
        r["library_ms"] = None
        log(f"kernel time {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"max_abs_err={worst[name]} [{card}]")
    return rec


def phase_bucket_path(records, path: Path, dev, card: str, refs: dict | None = None) -> dict:
    """The bucketed exchange on the main path's FASTA: config 5 and its
    variants at full size, then the smaller runs (see the module
    docstring), each table against ``reference_table`` and each run's
    launches against its route. Returns each run's launch counts."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dna_kmeres_parallel_tpu_torch import native
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda
    from dna_kmeres_parallel_tpu_torch.parallel import bucketed
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh, ProcessGroupMesh
    from dna_kmeres_parallel_tpu_torch.parallel.sharded_sparse import stage_shard_planes

    stream = records[0]
    refs = {} if refs is None else refs
    none = dict.fromkeys(read_launches(), 0)
    launches = {}
    k, m, D = BUCKET_K, BUCKET_M, BUCKET_D

    t = time.perf_counter()
    flat = native.parse_fasta_native(str(path)).stream
    parse_s = time.perf_counter() - t
    if not np.array_equal(flat, stream):
        raise AssertionError("the parsed stream differs from the generated records")
    log(f"bucketed path: parsed {flat.size} stream bases in {parse_s:.3f} s [{card}]")

    def run(name, data, ref_key, k, canonical, mesh, want, parse=None, **kw):
        ref = cached(refs, ref_key, lambda: reference_table(data, k, canonical, dev))
        torch.cuda.empty_cache()
        phases = {} if parse is None else {"parse": parse}
        reset_launches()
        t = time.perf_counter()
        table = bucketed.count_bucket_auto(data, k, canonical, mesh, phases=phases, **kw)
        wall = time.perf_counter() - t + (parse or 0.0)
        launches[name] = expect_launches(name, {**none, **want})
        if not (np.array_equal(table[0], ref[0]) and np.array_equal(table[1], ref[1])):
            raise AssertionError(f"{name}: table differs from the reference")
        torch.cuda.empty_cache()
        split = " ".join(f"{p}={s:.3f}" for p, s in phases.items())
        fired = {n: c for n, c in launches[name].items() if c}
        log(f"{name}: {table[0].size} distinct, {int(table[1].sum())} k-mers, equal to the "
            f"reference; wall {wall:.3f} s{' with the parse' if parse else ''}, "
            f"{data.size / wall / 1e9:.4f} Gbase/s; phases s: {split or 'none (not raw)'}; "
            f"launches {fired or 'none'} [{card}]")
        return table

    mesh = LocalMesh(D, dev)
    # The config-5 run probes the card with P1 before its first K10 launch,
    # as a fresh process does.
    sort_cuda._PROBED.discard(str(dev))
    run(BUCKET_MAIN, flat, ("table", k, False), k, False, mesh,
        {"encode_packed_minimizer": D, "owner_segments": D, "row_roll": 1}, parse_s,
        owner_mode="minimizer", minimizer_m=m)
    run(f"count_bucket_auto(k={k}, canonical, minimizer, D={D})", flat, ("table", k, True), k,
        True, mesh, {"encode_packed_minimizer": D, "owner_segments": D}, parse_s,
        owner_mode="minimizer", minimizer_m=m)
    run(f"count_bucket_auto(k={k}, prefix, D={D})", flat, ("table", k, False), k, False, mesh,
        {"encode_packed": D, "owner_segments": D}, parse_s)

    # The row route against the global sort, at one config-5 shard.
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh)
    planes = stage_shard_planes(shards[:1])
    inp = tuple(torch.from_numpy(p[0].view(np.int32)).to(dev) for p in planes)
    n_windows = planes[0].shape[1] * 16 - k + 1
    del shards, planes
    ms = {}
    for row in (True, False, False, True):
        fn = bucketed.raw_shard_fn(n_windows, k, False, D, "minimizer", m, row_partition=row)
        if dev.type == "cuda":
            ms.setdefault(row, []).append(time_ms(lambda: fn(inp, int(n_own[0])), 3))
        else:  # a rehearsal: the host clock
            t = time.perf_counter()
            fn(inp, int(n_own[0]))
            ms.setdefault(row, []).append((time.perf_counter() - t) * 1e3)
    del inp
    torch.cuda.empty_cache()
    log(f"route timing, one shard of config 5 ({n_windows} windows, k={k}, m={m}, D={D}): "
        f"row route (K1m, row sorts, K10) {ms[True][0]:.3f} / {ms[True][1]:.3f} ms, global "
        f"route (K1m, one sort, slot gather) {ms[False][0]:.3f} / {ms[False][1]:.3f} ms "
        f"[{card}]")

    small = flat[:BUCKET_SMALL_BASES]
    tag = f"{BUCKET_SMALL_BASES / 2**20:g} Mbase"
    mins = {"encode_packed_minimizer": D}
    local = run(f"{tag}: global route (row_partition=False)", small, ("small", k, False), k,
                False, mesh, mins, owner_mode="minimizer", row_partition=False)
    run(f"{tag}: exchange=agg", small, ("small", k, False), k, False, mesh, mins,
        owner_mode="minimizer", exchange="agg")
    run(f"{tag}: exchange=super", small, ("small", k, False), k, False, mesh, {},
        minimizer_m=m, exchange="super")
    run(f"{tag}: k=21, minimizer", small, ("small", 21, False), 21, False, mesh,
        {**mins, "owner_segments": D}, owner_mode="minimizer")
    run(f"{tag}: D=5", small, ("small", k, False), k, False, LocalMesh(5, dev),
        {"encode_packed_minimizer": 5, "owner_segments": 5}, owner_mode="minimizer")
    # Shards 1 and 2 all A: one minimizer, one owner. The row route and the
    # global route overflow, and auto counts through the aggregated
    # exchange: three K1m launches per shard, K10 on the row route only.
    skew = small.copy()
    skew[small.size // 4 : 3 * small.size // 4] = 0
    run(f"{tag}, half of it one homopolymer: auto falls back to agg", skew, ("skew", k, False),
        k, False, mesh, {"encode_packed_minimizer": 3 * D, "owner_segments": D},
        owner_mode="minimizer")
    with tempfile.TemporaryDirectory(prefix="kmer_pg_") as tmp:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{tmp}/pg", rank=0, world_size=1)
        try:
            pg = run(f"{tag}: a 1-rank {backend} process group", small, ("small", k, False), k,
                     False, ProcessGroupMesh(dev),
                     {"encode_packed_minimizer": 1, "owner_segments": 1},
                     owner_mode="minimizer")
        finally:
            dist.destroy_process_group()
    if not (np.array_equal(pg[0], local[0]) and np.array_equal(pg[1], local[1])):
        raise AssertionError("the process group's table differs from the local mesh's")
    return launches


def sort_rows_input(R: int, m: int, seed: int, dev):
    """int32 [R, m] of seeded u32 bits (half with the top bit set), the
    bias-order extremes in row 0, a sentinel tail in every third row and
    one row all sentinels, on ``dev``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-(2**31), 2**31, (R, m), generator=g, dtype=torch.int64).to(torch.int32)
    x[0, :4] = torch.tensor([0, -1, 2**31 - 1, -(2**31)], dtype=torch.int32)
    x[::3, m - m // 3 :] = -1
    x[R // 2] = -1
    return x.to(dev)


def phase_sort_kernel(dev, card: str) -> dict:
    """K11 against its plain version, element for element, at each row
    length of SORT_CHECKS; then timed at the route's [8192, 2048] rows of
    K1's k=11 words (a 16 Mbase batch) beside its plain version and
    ``torch.sort(dim=-1)`` of the biased keys (the library call). Returns
    the kernel's record."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan, stage_batch_planes
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda
    from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

    worst = 0

    def check(x, what) -> None:
        nonlocal worst
        got = sort_cuda.row_sort_u32(x)
        torch.cuda.synchronize()
        err = max_abs_err((got,), (sort_cuda.row_sort_u32_reference(x),))
        if err:
            raise AssertionError(f"row_sort disagrees with plain at {what}: max_abs_err={err}")
        worst = max(worst, err)

    for m, R in SORT_CHECKS:
        check(sort_rows_input(R, m, m, dev), f"[{R}, {m}]")
        log(f"kernel check row_sort [{R}, {m}]: random u32 with top-bit values, the bias-order "
            f"extremes and sentinel tails: equal to plain")

    m = KmerConfig().sort_row_len
    batch, T = batch_plan(1 << 40, 11, SORT_ROWS * m)
    planes = stage_batch_planes(check_stream(np.random.default_rng(8), T), dev)
    x = sparse_ops.encode_words_planes(*planes, batch, 11, True)[0][:batch].reshape(SORT_ROWS, m)
    x = x.contiguous()
    del planes
    check(x, f"K1's k=11 words as [{SORT_ROWS}, {m}]")
    biased = x ^ sort_cuda.INT32_MIN
    passes = m.bit_length() - 1
    passes = passes * (passes + 1) // 2
    rec = dict(
        ms=time_ms(lambda: sort_cuda.row_sort_u32(x), 20),
        plain_ms=time_ms(lambda: sort_cuda.row_sort_u32_reference(x), 3),
        library_ms=time_ms(lambda: torch.sort(biased, dim=-1), 5),
        # each word read and written once; one min or max per word per pass
        bound=bound_ms(8 * x.numel(), passes * x.numel()),
        max_abs_err=worst,
        shape=f"[{SORT_ROWS}, {m}]",
    )
    log(f"kernel time row_sort {rec['shape']} (k=11 words, {passes} passes): kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, torch.sort "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound'][0]:.4f} ms ({rec['bound'][1]}), "
        f"max_abs_err={rec['max_abs_err']} [{card}]")
    del x, biased
    torch.cuda.empty_cache()
    return rec


def dup_records(records, n_bases: int, copies: int):
    """The records starting in the first ``n_bases`` stream bases, repeated
    ``copies`` times, as (stream, starts, lengths)."""
    import numpy as np

    stream, starts, lengths = records
    keep = max(1, int((starts < n_bases).sum()))
    starts, lengths = np.tile(starts[:keep], copies), np.tile(lengths[:keep], copies)
    parts = [stream[s : s + n] for s, n in zip(starts, lengths)]
    new_starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]])
    out = np.full(int(lengths.sum()) + lengths.size - 1, INVALID, np.uint8)
    for s, part in zip(new_starts, parts):
        out[s : s + part.size] = part
    return out, new_starts, lengths


def phase_sort_path(records, path: Path, dev, card: str, refs: dict | None = None) -> dict:
    """The device-sort route on the main path's FASTA, each table against
    the cached reference and each run's launches against its route, in
    paired alternating order so the walls compare: at k=21 the default
    route (no device sort), rows sorted by torch.sort and one flat sort
    (default, rows, flat, flat, rows, default); at canonical k=11 the
    default, torch.sort rows and K11 rows (``pallas_sort``); then
    ``StreamingCounter(compact="device-rle")`` at k=21 on the FASTA and
    on a duplicated input, and the aggregated exchange on a one-shard mesh
    at k=13. Returns each run's launch counts."""
    import statistics

    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine
    from dna_kmeres_parallel_tpu_torch.parallel import bucketed
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

    stream, _, lengths = records
    refs = {} if refs is None else refs
    none = dict.fromkeys(read_launches(), 0)
    size = {} if SORT_BATCH_BASES is None else {"batch_bases": SORT_BATCH_BASES}
    launches, walls = {}, {}

    def n_batches(data, k):
        return math.ceil(data.size / batch_plan(data.size, k, KmerConfig(**size).batch_bases)[0])

    def check(name, res, data, n_recs, ref_key, k, canonical, want, wall, phases):
        launches[name] = expect_launches(name, {**none, **want})
        ref = cached(refs, ref_key, lambda: reference_table(data, k, canonical, dev))
        torch.cuda.empty_cache()
        if res.n_seqs != n_recs:
            raise AssertionError(f"{name}: {res.n_seqs} records, not {n_recs}")
        if not (np.array_equal(res.codes, ref[0]) and np.array_equal(res.counts, ref[1])):
            raise AssertionError(f"{name}: table differs from the reference")
        split = " ".join(f"{p}={s:.3f}" for p, s in phases.items())
        fired = {n: c for n, c in launches[name].items() if c}
        log(f"{name}: {res.distinct_kmers} distinct, {res.total_kmers} k-mers, equal to the "
            f"reference; wall {wall:.3f} s, {res.total_bases / wall / 1e9:.4f} Gbase/s; "
            f"phases s: {split}; launches {fired} [{card}]")

    def engine_run(label, k, canonical, kw, pallas_sort=False):
        name = f"SparseKmerEngine(k={k}{', canonical' if canonical else ''}, {label})"
        cfg = KmerConfig(k=k, canonical=canonical, **size, **kw)
        n = n_batches(stream, k)
        reset_launches()
        t = time.perf_counter()
        res = SparseKmerEngine(cfg, device=dev, pallas_sort=pallas_sort).count_file(str(path))
        wall = time.perf_counter() - t
        want = {"encode_packed": n, **({"row_sort": n} if pallas_sort else {})}
        check(name, res, stream, lengths.size, ("table", k, canonical), k, canonical, want,
              wall, res.phases)
        walls.setdefault(name, []).append(wall)

    routes21 = (("no device sort", {}), ("device_sort", {"device_sort": True}),
                ("device_sort, sort_row_len=0", {"device_sort": True, "sort_row_len": 0}))
    for label, kw in routes21 + routes21[::-1]:
        engine_run(label, 21, False, kw)
    # The K11 route's name is SORT_MAIN: each of its runs sets the counts
    # to 0 before it and reads them after.
    routes11 = (("no device sort", {}, False), ("device_sort", {"device_sort": True}, False),
                ("device_sort, pallas_sort", {"device_sort": True}, True))
    for label, kw, pallas_sort in routes11 + routes11[::-1]:
        engine_run(label, 11, True, kw, pallas_sort)
    log("device-sort route timing (paired, alternating; median wall s): " + "; ".join(
        f"{name} {statistics.median(w):.3f} ({' / '.join(f'{x:.3f}' for x in w)})"
        for name, w in walls.items()) + f" [{card}]")

    def rle_run(name, data, fasta, n_recs, ref_key):
        cfg = KmerConfig(k=21, compact="device-rle", **size)
        sc = StreamingCounter(cfg, device=dev)
        reset_launches()
        t = time.perf_counter()
        res = sc.run(str(fasta))
        wall = time.perf_counter() - t
        check(name, res, data, n_recs, ref_key, 21, False,
              {"encode_packed": n_batches(data, 21)}, wall, sc.metrics.phase_seconds)

    rle_run("StreamingCounter(k=21, compact=device-rle)", stream, path, lengths.size,
            ("table", 21, False))
    dup_path = path.with_name("dup.fasta")
    for n_bases, copies in SORT_DUPS:
        dup = dup_records(records, n_bases, copies)
        write_fasta(dup_path, *dup)
        rle_run(f"StreamingCounter(k=21, compact=device-rle) on the records of the first "
                f"{n_bases} bases x {copies} ({dup[0].size} bases)", dup[0], dup_path,
                dup[2].size, ("dup", n_bases, copies))
        dup_path.unlink()
        del dup

    # The aggregated exchange on a one-shard mesh at k=13 (single-word
    # keys): every window's owner is 0.
    name = "count_bucket_auto(k=13, D=1, exchange=agg)"
    small = stream[:SORT_SMALL_BASES]
    ref = cached(refs, ("small", 13, False), lambda: reference_table(small, 13, False, dev))
    reset_launches()
    t = time.perf_counter()
    table = bucketed.count_bucket_auto(small, 13, False, LocalMesh(1, dev), exchange="agg")
    wall = time.perf_counter() - t
    launches[name] = expect_launches(name, {**none, "encode_packed": 1})
    if not (np.array_equal(table[0], ref[0]) and np.array_equal(table[1], ref[1])):
        raise AssertionError(f"{name}: table differs from the reference")
    log(f"{name}: {table[0].size} distinct, equal to the reference; wall {wall:.3f} s [{card}]")
    torch.cuda.empty_cache()
    return launches


#: every kernel's launch counter: (module, attribute) by kernel name
COUNTERS = {
    "encode_packed": ("encode_cuda", "LAUNCHES"),
    "encode_stream": ("encode_cuda", "STREAM_LAUNCHES"),
    "counts_matrix": ("histogram_cuda", "COUNTS_LAUNCHES"),
    "min_sum_tri": ("distance_cuda", "TRI_LAUNCHES"),
    "min_sum_rect": ("distance_cuda", "RECT_LAUNCHES"),
    "hist_planes": ("histogram_cuda", "PLANES_LAUNCHES"),
    "hist_u8": ("histogram_cuda", "U8_LAUNCHES"),
    "hist_u8_small": ("histogram_cuda", "SMALL_LAUNCHES"),
    "hist_u8_any": ("histogram_cuda", "ANY_LAUNCHES"),
    "encode_packed_minimizer": ("encode_cuda", "MIN_LAUNCHES"),
    "owner_segments": ("sort_cuda", "OWNER_LAUNCHES"),
    "row_roll": ("sort_cuda", "ROLL_LAUNCHES"),
    "row_sort": ("sort_cuda", "ROW_SORT_LAUNCHES"),
}


def _counter_module(name: str):
    import importlib

    return importlib.import_module(f"dna_kmeres_parallel_tpu_torch.ops.{name}")


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for module, attr in COUNTERS.values():
        setattr(_counter_module(module), attr, 0)


def read_launches() -> dict:
    return {
        kernel: getattr(_counter_module(module), attr)
        for kernel, (module, attr) in COUNTERS.items()
    }


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def distance_records(n_seqs: int):
    """Seeded records of 1,000-2,000 bases (0.1% N), as (stream, starts,
    lengths): the u8 base stream with one INVALID separator between
    records, and each record's offset and length in it."""
    import numpy as np

    rng = np.random.default_rng(1)
    lengths = rng.integers(1000, 2001, n_seqs)
    starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]])
    stream = rng.integers(0, 4, int(lengths.sum()) + n_seqs - 1, dtype=np.uint8)
    stream[rng.random(stream.size) < 0.001] = INVALID
    stream[starts[1:] - 1] = INVALID
    return stream, starts, lengths


def record_strings(stream, starts, lengths) -> list[str]:
    import numpy as np

    letters = np.frombuffer(b"ACGTN", np.uint8)
    return [
        letters[np.minimum(stream[s : s + n], 4)].tobytes().decode()
        for s, n in zip(starts, lengths)
    ]


def record_grid(stream, starts, lengths):
    """u8 grid [S, longest record], INVALID past each record's end."""
    import numpy as np

    grid = np.full((lengths.size, int(lengths.max())), INVALID, np.uint8)
    for r, (s, n) in enumerate(zip(starts, lengths)):
        grid[r, :n] = stream[s : s + n]
    return grid


def reference_counts(stream, starts, lengths, k: int, canonical: bool, dev):
    """int32 [S, 4^k] per-record counts, in plain int64 torch on the card:
    every window of the stream rolled into its code (and its reverse
    complement, for canonical), then one ``bincount`` of row * 4^k + code.
    Shares no code with the port."""
    import torch

    bins = 4**k
    S = lengths.size
    end = int(starts[-1] + lengths[-1])
    b = torch.from_numpy(stream[:end]).to(dev).long()
    n = end - k + 1
    code = torch.zeros(n, dtype=torch.int64, device=dev)
    rc = torch.zeros_like(code)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for j in range(k):
        d = b[j : j + n]
        valid &= d < 4
        code = (code << 2) | (d & 3)
        rc |= (3 - (d & 3)) << (2 * j)
    if canonical:
        code = torch.minimum(code, rc)
    pos = torch.arange(n, device=dev)
    row = torch.searchsorted(torch.from_numpy(starts).to(dev), pos, right=True) - 1
    idx = (row * bins + code)[valid]
    return torch.bincount(idx, minlength=S * bins).reshape(S, bins).to(torch.int32)


def reference_min_sums(a, b):
    """int32 [S, S2] sum_p min(a_ip, b_jp), plain torch on the card. Up to
    1,024 bins: a blocked broadcast of ``torch.minimum``. Past that (k=8's
    sparse rows, where a broadcast would move a terabyte) the identity
    min(x, y) = sum_{t >= 1} [x >= t] [y >= t] as float32 matrix products:
    exact, since every product is 0 or 1, every sum stays below 2^24 and
    TF32 is off."""
    import torch

    S, B = a.shape
    S2 = b.shape[0]
    if B <= 1024:
        out = torch.empty(S, S2, dtype=torch.int32, device=a.device)
        rows = max(1, (1 << 27) // max(S2 * B, 1))
        for r in range(0, S, rows):
            out[r : r + rows] = torch.minimum(a[r : r + rows, None, :], b[None]).sum(-1)
        return out
    if max(int(a.sum(1).max()), int(b.sum(1).max())) >= 1 << 24:
        raise ValueError("row sums too large for the float32 reference")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = torch.zeros(S, S2, dtype=torch.float32, device=a.device)
        for t in range(1, int(max(a.max(), b.max())) + 1):
            acc += (a >= t).float() @ (b >= t).float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return acc.to(torch.int32)


def reference_packed(sums, len_rows, len_cols, k: int):
    """float32 distances 1 - s / (min(L_i, L_j) - k + 1) in NumPy for row
    i against columns j > i (rows and columns both start at sequence 0),
    concatenated row by row: the packed strict upper triangle."""
    import numpy as np

    out = []
    for i in range(sums.shape[0]):
        s = sums[i, i + 1 :].astype(np.float32)
        denom = (np.minimum(len_rows[i], len_cols[i + 1 :]) - k + 1).astype(np.float32)
        out.append(np.float32(1.0) - s / denom)
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def same_bits(a, b) -> bool:
    import numpy as np

    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def check_csv(path: Path, want, n_sample: int = 100_000) -> int:
    """One line per value, and ``n_sample`` seeded lines equal to Python's
    ``"%f"`` of the reference's values. Returns the lines checked."""
    import numpy as np

    data = np.fromfile(path, dtype=np.uint8)
    nl = np.flatnonzero(data == ord("\n"))
    if nl.size != want.size or (data.size and data[-1] != ord("\n")):
        raise AssertionError(f"{path.name}: {nl.size} lines for {want.size} pairs")
    begin = np.concatenate([[0], nl[:-1] + 1])
    rng = np.random.default_rng(2)
    idx = rng.choice(want.size, size=min(n_sample, want.size), replace=False)
    for i in idx:
        line = data[begin[i] : nl[i] + 1].tobytes()
        if line != ("%f\n" % want[i]).encode():
            raise AssertionError(f"{path.name} line {i}: {line!r} != %f of {want[i]!r}")
    return idx.size


def phase_distance_kernels(dev, card: str, records) -> dict:
    """K2, K3 and K4 against their plain versions on edge shapes, then
    timed at the distance path's shapes. Returns each kernel's record."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda, histogram_cuda

    worst = {"counts_matrix": 0, "min_sum_tri": 0, "min_sum_rect": 0}

    def check(name, got, ref, what):
        torch.cuda.synchronize()
        err = max_abs_err((got,), (ref,))
        log(f"kernel check {name} {what}: max_abs_err={err}")
        worst[name] = max(worst[name], err)
        if err:
            raise AssertionError(f"{name} disagrees with plain at {what}")

    rng = np.random.default_rng(3)
    # 600 rows of 0-2,000 bases: N runs, rows shorter than k, empty rows.
    g = rng.integers(0, 4, (600, 2000)).astype(np.uint8)
    g[rng.random(g.shape) < 0.01] = INVALID
    g[:50, 100:400] = INVALID
    for r, n in enumerate(rng.integers(0, 2001, 600)):
        g[r, n if r % 7 else r % 9 :] = INVALID
    grid = torch.from_numpy(g).to(dev)
    for k in (3, 5, 8):
        for canonical in (False, True):
            check("counts_matrix",
                  histogram_cuda.counts_matrix_cuda(grid, k, 4**k, canonical),
                  histogram_cuda.counts_matrix_reference(grid, k, 4**k, canonical),
                  f"k={k} canonical={canonical} grid {tuple(g.shape)}")
    for B, S, S2 in ((64, 1000, 777), (1024, 1000, 777), (65536, 300, 130)):
        a = rng.integers(0, 200, (S, B)).astype(np.int32)
        a[rng.random(a.shape) < 0.5] = 0
        a = torch.from_numpy(a).to(dev)
        check("min_sum_tri", distance_cuda.min_sum_tri_cuda(a),
              distance.min_sum_matrix(a), f"[{S}, {B}]")
        check("min_sum_rect", distance_cuda.min_sum_rect_cuda(a[:S2 // 3], a[S - S2 :]),
              distance.min_sum_matrix(a[:S2 // 3], a[S - S2 :]),
              f"[{S2 // 3}, {B}] x [{S2}, {B}]")

    # The distance path's shapes: (a)'s grid and counts at k=3, (b)'s grid
    # at k=8, and (c)'s panel against every record.
    stream, starts, lengths = records
    na, nb = min(DIST_ROWS_A, lengths.size), min(DIST_ROWS_B, lengths.size)
    grid_a = torch.from_numpy(record_grid(stream, starts[:na], lengths[:na])).to(dev)
    grid_b = grid_a[:nb].contiguous()
    grid_all = torch.from_numpy(record_grid(stream, starts, lengths)).to(dev)
    counts_a = histogram_cuda.counts_matrix_cuda(grid_a, 3, 64)
    check("counts_matrix", counts_a,
          histogram_cuda.counts_matrix_reference(grid_a, 3, 64), f"(a) {tuple(grid_a.shape)}")
    counts_all = histogram_cuda.counts_matrix_cuda(grid_all, 3, 64)
    panel = counts_all[: min(PANEL_ROWS, lengths.size)]
    out_a = torch.empty(na, na, dtype=torch.int32, device=dev)
    out_c = torch.empty(panel.shape[0], lengths.size, dtype=torch.int32, device=dev)
    distance_cuda.launch_min_sum_tri(counts_a, out_a)
    check("min_sum_tri", out_a, distance.min_sum_matrix(counts_a), f"(a) {tuple(counts_a.shape)}")
    distance_cuda.launch_min_sum_rect(panel, counts_all, out_c)
    check("min_sum_rect", out_c, distance.min_sum_matrix(panel, counts_all),
          f"(c) {tuple(panel.shape)} x {tuple(counts_all.shape)}")

    rec = {}
    sa, sl = grid_a.shape
    rec["counts_matrix"] = dict(
        ms=time_ms(lambda: histogram_cuda.counts_matrix_cuda(grid_a, 3, 64), 20),
        plain_ms=time_ms(lambda: histogram_cuda.counts_matrix_reference(grid_a, 3, 64), 3),
        library_ms=None,
        bound=bound_ms(sa * sl + sa * 64 * 4, 0),
        shape=f"k=3 grid [{sa}, {sl}]",
    )
    k8_ms = time_ms(lambda: histogram_cuda.counts_matrix_cuda(grid_b, 8, 65536), 20)
    nbytes = grid_b.numel() + nb * 65536 * 4
    log(f"kernel time counts_matrix k=8 grid {tuple(grid_b.shape)}: {k8_ms:.4f} ms, "
        f"bound {bound_ms(nbytes, 0)[0]:.4f} ms [{card}]")
    af = counts_a.float()
    rec["min_sum_tri"] = dict(
        ms=time_ms(lambda: distance_cuda.launch_min_sum_tri(counts_a, out_a), 10),
        plain_ms=time_ms(lambda: distance.min_sum_matrix(counts_a), 2),
        library_ms=time_ms(lambda: torch.cdist(af, af, p=1), 3),
        bound=bound_ms(na * 64 * 4 + na * na * 4, 2 * 64 * na * (na + 1) // 2),
        shape=f"[{na}, 64]",
    )
    pf, cf = panel.float(), counts_all.float()
    npn, nall = panel.shape[0], lengths.size
    rec["min_sum_rect"] = dict(
        ms=time_ms(lambda: distance_cuda.launch_min_sum_rect(panel, counts_all, out_c), 10),
        plain_ms=time_ms(lambda: distance.min_sum_matrix(panel, counts_all), 2),
        library_ms=time_ms(lambda: torch.cdist(pf, cf, p=1), 3),
        bound=bound_ms((npn + nall) * 64 * 4 + npn * nall * 4, 2 * 64 * npn * nall),
        shape=f"[{npn}, 64] x [{nall}, 64]",
    )
    for name, r in rec.items():
        r["max_abs_err"] = worst[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"kernel time {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, torch.cdist {lib}, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}) [{card}]")
    return rec


def expect_launches(name: str, want: dict) -> dict:
    got = read_launches()
    if got != want:
        raise AssertionError(f"{name}: launches {got}, the path implies {want}")
    return got


def phase_distance_path(records, path: Path, dev, card: str) -> dict:
    """Runs (a), (b) and (c) of the distance path, each checked against the
    plain reference. Returns each run's launch counts."""
    import numpy as np
    import torch

    import dna_kmeres_parallel_tpu_torch as port
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

    stream, starts, lengths = records
    S = lengths.size
    none = dict.fromkeys(read_launches(), 0)
    seqs = record_strings(stream, starts, lengths)
    launches = {}

    def report(name, wall, n_pairs, phases, note):
        split = " ".join(f"{p}={s:.3f}" for p, s in phases.items())
        log(f"{name}: {n_pairs} pairs, wall {wall:.3f} s, "
            f"{n_pairs / wall / 1e6:.2f} Mpairs/s; phases s: {split}; {note} [{card}]")

    def in_memory_run(name, k, n, run):
        reset_launches()
        t = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t
        launches[name] = expect_launches(
            name, {**none, "counts_matrix": 1, "min_sum_tri": 1})
        ref_counts = reference_counts(stream, starts[:n], lengths[:n], k, False, dev)
        if res.n != n or not np.array_equal(res.counts, ref_counts.cpu().numpy()):
            raise AssertionError(f"{name}: counts differ from the reference")
        counts = torch.from_numpy(res.counts).to(dev)
        ref_sums = reference_min_sums(ref_counts, ref_counts)
        if not torch.equal(distance_cuda.min_sum_tri_cuda(counts), ref_sums):
            raise AssertionError(f"{name}: K3 min-sums differ from the reference")
        want = reference_packed(ref_sums.cpu().numpy(), lengths[:n], lengths[:n], k)
        if not same_bits(res.packed, want):
            raise AssertionError(f"{name}: distances differ from the reference")
        report(name, wall, want.size, res.phases,
               "counts, min-sums and distances equal the reference")
        del counts, ref_sums, ref_counts
        torch.cuda.empty_cache()

    na, nb = min(DIST_ROWS_A, S), min(DIST_ROWS_B, S)
    in_memory_run(f"(a) distance_file(k=3, max_seqs={na})", 3, na,
                  lambda: port.distance_file(str(path), k=3, device=dev, max_seqs=na))
    in_memory_run(f"(b) KmerEngine(k=8).distance_sequences({nb} records)", 8, nb,
                  lambda: KmerEngine(KmerConfig(k=8), device=dev).distance_sequences(seqs[:nb]))

    name = f"(c) distance_stream_to_csv(k=3, {S} records, panel_rows={PANEL_ROWS}, max_panels=1)"
    csv = path.with_suffix(".csv")
    eng = KmerEngine(KmerConfig(k=3), device=dev)
    reset_launches()
    t = time.perf_counter()
    out = eng.distance_stream_to_csv(seqs, csv, panel_rows=PANEL_ROWS, max_panels=1)
    wall = time.perf_counter() - t
    launches["(c)"] = expect_launches(name, {**none, "counts_matrix": 1, "min_sum_rect": 1})
    rows = min(PANEL_ROWS, S - 1)
    ref_counts = reference_counts(stream, starts, lengths, 3, False, dev)
    ref_sums = reference_min_sums(ref_counts[:rows], ref_counts)
    want = reference_packed(ref_sums.cpu().numpy(), lengths[:rows], lengths, 3)
    if out["n_pairs"] != want.size:
        raise AssertionError(f"{name}: {out['n_pairs']} pairs, the panel has {want.size}")
    counts = eng._counts_on_device(stream, starts, lengths)
    if not torch.equal(counts, ref_counts):
        raise AssertionError(f"{name}: counts differ from the reference")
    if not torch.equal(distance_cuda.min_sum_rect_cuda(counts[:rows], counts), ref_sums):
        raise AssertionError(f"{name}: K4 min-sums differ from the reference")
    if not same_bits(eng.make_dense_panel_fn(counts, lengths)(0, rows), want):
        raise AssertionError(f"{name}: panel distances differ from the reference")
    checked = check_csv(csv, want)
    report(name, wall, want.size, out["phases"],
           f"counts, min-sums and distances equal the reference, "
           f"{csv.stat().st_size} CSV bytes, {checked} sampled lines equal %f")
    csv.unlink()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bases", type=int, default=256_000_000,
                    help="size of the main path's FASTA (default 256 Mbase)")
    ap.add_argument("--records", type=int, default=54_018,
                    help="records of the distance path's FASTA (default 54,018)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import dna_kmeres_parallel_tpu_torch

    if not Path(dna_kmeres_parallel_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError("the port must be imported from this checkout")
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
        batch_plan,
        require_native,
    )
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    # 1. the card and the host library
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t = time.perf_counter()
    require_native()
    log(f"native host library built and loaded ({time.perf_counter() - t:.1f} s)")

    # 2. the kernels
    t = time.perf_counter()
    so, build_log = kernels.build()
    kernels.load()
    log(f"kernels built in {time.perf_counter() - t:.1f} s: {so.name}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    # 3. kernel vs plain
    dev = torch.device("cuda", 0)
    timed = phase_kernels(dev, card)
    dense = phase_dense_kernels(dev, card)
    k9 = phase_stream_kernel(dev, card)

    # 4. the main path, the dense path and the streaming path, on one FASTA
    t = time.perf_counter()
    records = smoke_records(args.bases)
    tmp = tempfile.TemporaryDirectory(prefix="kmer_smoke_")
    refs: dict = {}
    try:
        path = Path(tmp.name) / "smoke.fasta"
        write_fasta(path, *records)
        stream, _, lengths = records
        log(f"fasta: {lengths.size} records, {int(lengths.sum())} bases, "
            f"{int((stream == INVALID).sum()) - lengths.size + 1} N, "
            f"{path.stat().st_size} bytes, written in {time.perf_counter() - t:.1f} s")
        launches = phase_main_path(records, path, dev, card, refs)
        dense_launches = phase_dense_path(records, path, dev, card, refs)
        stream_launches = phase_stream_path(records, path, dev, card, refs)
        bucket = phase_bucket_kernels(dev, card, -(-stream.size // BUCKET_D))
        bucket_launches = phase_bucket_path(records, path, dev, card, refs)
        row_sort = phase_sort_kernel(dev, card)
        sort_launches = phase_sort_path(records, path, dev, card, refs)
    finally:
        tmp.cleanup()
    del records, stream, refs

    # 5-6. the distance kernels and the distance path
    t = time.perf_counter()
    records = distance_records(args.records)
    tmp = tempfile.TemporaryDirectory(prefix="kmer_smoke_")
    try:
        path = Path(tmp.name) / "dist.fasta"
        write_fasta(path, *records)
        log(f"distance fasta: {records[2].size} records, {int(records[2].sum())} "
            f"bases, written in {time.perf_counter() - t:.1f} s")
        dist = phase_distance_kernels(dev, card, records)
        dist_launches = phase_distance_path(records, path, dev, card)
    finally:
        tmp.cleanup()

    ms, plain_ms, err = timed[(21, False)]
    T = batch_plan(1 << 40, 21, KmerConfig().batch_bases)[1]
    k1_bound = bound_ms(T // 2 + T * 6, 0)
    kernels_json = [{
        "name": "encode_packed",
        "route": "cuda",
        "source": "dna_kmeres_parallel_tpu_torch/csrc/encode_packed.cu",
        "replaces": "dna_kmeres_parallel_tpu/ops/encode_pallas.py:779",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
    }, {
        "name": "encode_stream",
        "route": "cuda",
        "source": "dna_kmeres_parallel_tpu_torch/csrc/encode_stream.cu",
        "replaces": "dna_kmeres_parallel_tpu/ops/encode_pallas.py:221",
        "launches": stream_launches[STREAM_MAIN]["encode_stream"],
        "max_abs_err": k9["max_abs_err"],
        "ms": k9["ms"],
        "plain_ms": k9["plain_ms"],
        "bound_ms": k9["bound"][0],
        "bound_by": k9["bound"][1],
        "library_ms": None,
    }]
    for name, src, replaces, run in (
        ("counts_matrix", "counts_matrix.cu", "histogram_pallas.py:114", "(a)"),
        ("min_sum_tri", "min_sum.cu", "distance_pallas.py:152", "(a)"),
        ("min_sum_rect", "min_sum.cu", "distance_pallas.py:191", "(c)"),
    ):
        r = dist[name]
        run_key = next(key for key in dist_launches if key.startswith(run))
        kernels_json.append({
            "name": name,
            "route": "cuda",
            "source": f"dna_kmeres_parallel_tpu_torch/csrc/{src}",
            "replaces": f"dna_kmeres_parallel_tpu/ops/{replaces}",
            "launches": dist_launches[run_key][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    for name, replaces in (
        ("hist_planes", "histogram_pallas.py:814"),
        ("hist_u8", "histogram_pallas.py:604"),
        ("hist_u8_small", "histogram_pallas.py:375"),
        ("hist_u8_any", "histogram_pallas.py:927"),
    ):
        r = dense[name]
        kernels_json.append({
            "name": name,
            "route": "cuda",
            "source": "dna_kmeres_parallel_tpu_torch/csrc/histogram.cu",
            "replaces": f"dna_kmeres_parallel_tpu/ops/{replaces}",
            "launches": dense_launches[DENSE_MAIN[name]][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    for name, src, replaces in (
        ("encode_packed_minimizer", "encode_packed.cu",
         "dna_kmeres_parallel_tpu/ops/encode_pallas.py:490"),
        ("owner_segments", "owner_segments.cu", "dna_kmeres_parallel_tpu/ops/sort_pallas.py:143"),
        ("row_roll", "owner_segments.cu", "scripts/dynroll_probe.py:37"),
    ):
        r = bucket[name]
        kernels_json.append({
            "name": name,
            "route": "cuda",
            "source": f"dna_kmeres_parallel_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": bucket_launches[BUCKET_MAIN][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    kernels_json.append({
        "name": "row_sort",
        "route": "cuda",
        "source": "dna_kmeres_parallel_tpu_torch/csrc/row_sort.cu",
        "replaces": "dna_kmeres_parallel_tpu/ops/sort_pallas.py:61",
        "launches": sort_launches[SORT_MAIN]["row_sort"],
        "max_abs_err": row_sort["max_abs_err"],
        "ms": row_sort["ms"],
        "plain_ms": row_sort["plain_ms"],
        "bound_ms": row_sort["bound"][0],
        "bound_by": row_sort["bound"][1],
        "library_ms": row_sort["library_ms"],
    })
    log(json.dumps({"kernels": kernels_json}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
