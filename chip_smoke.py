#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--bases N] [--records N]

Phases, each printing its lines; the first failure raises and the script
exits nonzero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the native host library's build;
2. the kernels' build from ``dna_kmeres_parallel_tpu_torch/csrc`` (nvcc);
3. K1 against its plain PyTorch version on the card, element for element,
   and both timed with CUDA events at the main path's batch and at one
   config-5 shard (k=31, no minimizer plane, as prefix owners launch it);
   then the dense histogram kernels K5-K8 the same way: k in {1, 2, 3, 4,
   6, 7, 8} x canonical x five ``n_own`` on an N-rich stream (K7 from u8
   and from the packed batch at k <= 3; K6 at k=8 also in clusters of 2
   and 4 blocks), on views 1..15 bytes past alignment, on a batch whose windows
   half lie in one-base runs and on batches of one base, K8 at 1,000,
   3,000, 65,535 and 4^11 bins, each timed at one 16 Mbase batch, K5 also
   at k=6, K7 also as the packed route before it (``unpack_stream`` + the
   u8 entry), K6 also at k=5 and at k=8 in each cluster size on the stream
   and on one half of whose windows lie in one-base runs; then K9 (the
   u8-stream
   encoder) at every split-word width x canonical x four ``n_own``, on
   streams shorter than k and unaligned, and timed at the k=21 batch;
4. the main path: exact k-mer counting of a seeded random FASTA of
   ``--bases`` bases (default 256 Mbase, about one large human
   chromosome) through ``count_file`` and ``SparseKmerEngine``, each on
   the card's table build (the default; the route each call took is
   printed) and on the host's (``device_sort=False``), the two tables bit
   for bit. Each table
   is checked code for code and count for count against a plain reference
   that shares no code with the port: every window of the generated
   records encoded in int64 on the card, then ``torch.unique``. The
   kernel's launch count is checked against the batch count. The card's
   build is timed step by step at each run's size (``torch.sort``,
   ``sparse.rle_keys``, the rows' copy) and its device peak held to the
   gate's ``card_table_bytes``. Then the
   dense path on the same file: ``count_file`` at k=3 (K7 from the packed
   batch, and no ``unpack_stream`` on the card), canonical k=6 and k=8
   (K5), and with
   ``pack_input=False`` at k=2 (K7), k=5 and canonical k=8 (K6), and at k=9
   (K1, densified), each histogram against ``torch.bincount`` of the same
   reference codes and each run launching only its route's kernel, once
   per batch; and ``histogram_stream`` at 3,000 bins over the whole
   stream (K8, one launch). Then the streaming counter
   (``StreamingCounter``) on the same file: k=21 with ``compact="device"``
   through K9 (``pack_input=False``) and through K1, ``compact="host"``
   (no launch), ``compact="auto"`` (K1 once a batch), canonical
   k=11 through K9, dense k=8 (K5) with a checkpoint every 64 Mbase, a
   child process killed by SIGKILL after its second checkpoint and resumed
   here, and ``count_file(k=21, pack_input=False)`` (K9). Each reference
   is computed once per (k, canonical) and shared by the runs held against
   it;
5. the distance kernels (K2 counts matrix, K3 and K4 (min,+)) against
   their plain PyTorch versions on the card, element for element on edge
   shapes (K2 at k=1-8, canonical and not, and on a grid 5 bytes past
   alignment), then timed with CUDA events at the distance path's shapes,
   beside their plain versions and, for K3/K4, ``torch.cdist(p=1)``; K2
   checked and timed at (a)'s grid, (c)'s (all records, one launch),
   (b)'s at k=8 and 8 rows of 4 Mbase (split across warps); the finish
   kernel (float32 distances of the packed upper triangle) at (c)'s first
   panel and at the triangle of all records, bit for bit against its
   plain version on the same min-sums, and timed beside it;
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
   plane; every window length k - m + 1 from 2 to 31, canonical and not,
   and one-base streams), K10 (owner segments) and P1 (the row roll)
   against their plain versions on edge cases (P1 also at W of 1-5, 255,
   2049 and 2048, one word past alignment, shifts at both int32
   extremes), then timed at the config-5 shapes (one 64 Mbase shard at
   k=31, m=7; K10 over [32768, 2048] x 2 planes at D=4; P1 at [32768,
   2048] and at the row route's [8, 256] probe tile); then ``count_bucket_auto`` on the
   main path's FASTA (parsed by the port's native parser) on a local mesh
   of 4 shards on the card: k=31 with minimizer owners (config 5), the
   same canonical, and prefix owners, each against ``reference_table``,
   with its launches and phase split, and the row route timed against the
   global sort at one shard; then, on the first 16 Mbase, the global
   route, the aggregated and super-k-mer exchanges, k=21, a mesh of 5, a
   homopolymer-rich stream on which auto falls back to the aggregated
   exchange, and a 1-rank NCCL process group, each against its reference;
8. the device-sort route: K11 (the row sort) against its plain version at
   row lengths 128, 512, 2048 and 32768 (random u32 with top-bit values,
   sentinel tails), then timed at the route's [8192, 2048] rows of one
   16 Mbase batch beside its plain version and ``torch.sort(dim=-1)``,
   and so again as rows of 128 and 32,768 words and on random u32 rows;
   then ``SparseKmerEngine`` on the main path's FASTA in paired,
   alternating order: at k=21 no device sort, ``device_sort`` rows
   (``torch.sort``) and one flat sort; at canonical k=11 no device sort,
   ``torch.sort`` rows and K11 rows (``pallas_sort``, one launch per
   batch); ``StreamingCounter(compact="device-rle")`` at k=21 on the FASTA
   and on two duplicated inputs (the records of its first 16 Mbase four
   times, of its first 4 Mbase sixteen times); and the aggregated
   exchange on a one-shard mesh at k=13. Each table against
   its reference, each run's launches against its route;
9. distances past the dense band, after phase 6 on the same card: (d)
   the union route on 2,048 reads of 1,000-2,000 bases drawn from a
   seeded 100 kbase genome (about 30x, one substitution in 5,000 bases)
   at k=21: ``distance_sparse_packed`` with the union route on (K3 over
   the [2048, 131,072] union matrix), off (the native two-pointer) and
   under ``auto`` (its route and predicted times printed), their CSVs
   byte-identical, then ``distance_sparse_stream_to_csv`` in panels of
   256 rows (K4), stopped after 2 panels and resumed, byte-identical to
   the one-shot CSV, and canonical k=21 once; (e) the host route on the
   distance FASTA's first 4,096 records at k=21, streamed to CSV by a
   child SIGKILLed after its second checkpoint and resumed here; (f) 8
   independent records of 4.2-6 Mbase at k=21, their tables from K1
   (``SparseKmerEngine``), their union declined by the ``auto`` plan; (g)
   ``KmerEngine(k=9).distance_sequences`` on 1,024 distance records (K2's
   global route, K3 at 4^9 bins) and ``distance_stream_to_csv`` at k=10
   on 256 (K4 at 4^10 bins). The sparse phases are held against plain
   per-record tables (int64 rolled codes and ``torch.unique`` on the
   card) and ``numpy.intersect1d`` per sampled pair (100,000 pairs and
   CSV lines; (f)'s 28 pairs of 5 Mbase tables by ``torch.searchsorted``
   on the card), (g) against the reference of phase 6. Then K2's global
   route (k=9, 10 and 12, canonical and not, N runs, rows shorter than k,
   8 rows of 4 Mbase) and K3/K4 at (d)'s and (g)'s widths (u16x2) and on
   slices whose row sums reach 2^16 (i32) against their plain versions,
   each timed beside its plain version, ``torch.cdist(p=1)`` and its
   bound; and the rates the distance gates read, measured by
   ``ops/calibrate`` (K3's bin-pairs a second at a dense [1024, 4^9] and
   a union [2048, 131,072] matrix, the two-pointer's entry-pairs a second
   a thread, pinned H2D and D2H, a tiny job's round trip, K3 at [16384,
   64] and the threshold route's int8 multiply-adds a second) beside the
   same rates read off the phases; then the threshold (min,+) route
   (``ops/threshold_cuda``: 0/1 planes of every threshold and one
   ``torch._int_mm``) at (a), (b), (d), (g) k=9 and (g)'s k=10 panel, on
   the matrices built above: held to K3/K4 and the plain product
   (max_abs_err 0), timed whole and its planes alone beside K3/K4,
   ``torch.cdist(p=1)`` and its bound, with the gate's choice under the
   calibrated rates and the defaults (the calibrated gate must take the
   measured faster route wherever the two differ by 1.5x or more). The
   paths above run the gate's route: (b) and (g) k=9 take the threshold
   route where it decides so, (d) once more with it off (K3) and (g)'s
   k=10 stream once more with it off (K4), their CSVs byte-identical;
10. the command line, ``kmer-gpu`` (``cli.main`` in this process, the
   default ``--device cuda``): ``calibrate`` into a directory of the run
   (its file loaded back as ``DistanceRates`` and printed beside the
   defaults and phase 9's rates, and the router's decisions at (d) and
   (g) under both), which the later commands read; ``count --k 21`` on
   the main path's FASTA to ``.npz`` (its table against phase 4's
   reference, its wall beside ``count_file``'s) and to CSV (its size and
   100,000 sampled lines against the reference, and byte for byte
   against ``count --engine native``); ``count --k 3`` and ``count --k 8
   --canonical`` against phase 4's histograms; ``distance --k 3`` on the
   first 2,048 distance records against the plain reference, and
   streamed in panels of 256 with a checkpoint, stopped after 2 panels
   and resumed, byte-identical to it; ``distance --k 21`` on (d)'s reads
   through the router (its route printed) at (d)'s sampled pairs;
   ``selftest`` at k=3, 8 and 21 on 32 records; ``stream --k 21`` with
   checkpoints over the first 24,000 distance records against their
   reference table, and
   ``merge``, ``histo``, ``query`` and ``info`` on it; ``bench`` at k=8
   and k=21, windows exact. Each run's launches are checked where its
   route fixes them;
11. the mesh and super-k-mer routes (run after phase 8 for the counting,
   after phase 10 for the rest): ``StreamingCounter`` over a
   ``LocalMesh`` of 4 shards of the card on the main path's FASTA, k=21
   through K1 and through K9 (``pack_input=False``), canonical k=11 with
   ``device_sort`` and ``pallas_sort`` (K1, K11), dense k=3 (K7) and
   canonical k=8 (K6), each against phase 4's reference;
   ``count_sharded`` at 3,000 bins (K8); dense k=8 with a checkpoint
   every 64 Mbase on the mesh, a child on the mesh SIGKILLed after its
   second checkpoint and resumed on one device; ``compact="device-super"``
   at k=21 and canonical k=31 and ``auto`` (K1 once a batch) on
   the first 256 records, with the records' D2H bytes and the peak device
   memory; on meshes of 4 and 3 shards, (a) and (c) bit and byte
   identical to phase 6's and (d)'s union stream in panels of 256 byte
   identical to phase 9's; ``count_sharded`` and
   ``min_sum_panel_sharded`` on a 1-rank NCCL group against
   ``LocalMesh(1)``; ``kmer-gpu count --k 17``, ``stream --k 21`` and
   ``distance --k 3`` with ``--mesh 4`` byte-identical to the same
   commands without it; ``graft_entry.dryrun_multichip(4)``. Every run's
   launches against its shards (D per batch or panel); the kernels line
   gains each kernel's ``phase11_launches``;
12. multi-host (``parallel/multihost``, after phase 11): a 1-rank NCCL
   process group runs ``count_file_multihost`` at canonical k=8 over the
   main FASTA (K6) against phase 4's histogram, the resumable dense count
   at k=3 in 16 Mbase steps stopped after 4 and resumed (K7), the bucketed
   resumable count at k=31 with minimizer owners (K1m) and prefix owners
   (K1) over the first 64 Mbase against ``reference_table``, and the
   row-sharded distances at k=3 on the first 4,096 distance records (K2,
   K4; byte-identical to ``distance_stream_to_csv``) and at k=21 on (d)'s
   reads (K4 on the union route; byte-identical to phase 9's CSV); then two
   child processes, the ranks of a gloo group on the card (NCCL takes one
   rank a card; the mesh's collectives go through host memory), run
   ``count_file_multihost`` and the bucketed count (stopped after 2 steps,
   resumed; the union of the ranks' tables against the reference) over
   the first 32 Mbase and the k=3 distances (stopped after 2 panels,
   resumed, stitched by rank 0). Every run's launches against its steps,
   panels and ranks; the kernels line gains ``phase12_launches``.

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
#: K8's (k, bins) checks: bin counts that are not powers of two (65,535
#: leaves a last slice of 3 bins), and one above the shared-memory slices
ANY_CASES = ((5, 1000), (6, 3000), (8, 65535), (11, 4**11))
#: K6's cluster sizes timed at 4^8 bins (the default is the faster,
#: histogram_cuda.WIDE_CLUSTER)
K6_CLUSTERS = (2, 4)
#: the dense path's count_file runs: (name, k, canonical, pack_input, the
#: kernel its route launches once per batch)
DENSE_RUNS = (
    ("count_file(k=3)", 3, False, True, "hist_packed_small"),
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
    "hist_u8_small": "count_file(k=2, pack_input=False)",
    "hist_packed_small": "count_file(k=3)",
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
#: K2's long-row shape: a few rows of 4 Mbase, split across warps
K2_LONG_ROWS = (8, 4_000_000)
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
#: K1m's check: every m of {7, 11, 15} below k, for k in {17, 21, 31}, and
#: one (k, m) for each other window length L = k - m + 1 in [2, 31], so
#: that the ladder's every level count and combine offset runs (each k
#: width: no hi, int16 and int32 hi)
MIN_CASES = [(k, m) for k in (17, 21, 31) for m in (7, 11, 15) if m < k] + [
    (16, 15), (13, 10), (19, 15), (11, 6), (22, 15), (15, 7), (24, 15), (14, 3),
    (20, 8), (27, 14), (16, 1), (31, 14), (25, 7), (29, 10), (23, 2), (31, 9),
    (26, 3), (30, 5), (28, 2), (31, 4), (30, 2), (31, 2), (31, 1),
]
#: K1m's one-base streams (every m-mer of a window ties): (base, k, m)
MIN_ONE_BASE = ((0, 31, 7), (3, 21, 11), (1, 16, 15), (2, 13, 1))
#: the bucketed path (config 5): shards on the card, k, minimizer length
BUCKET_D = 4
BUCKET_K = 31
BUCKET_M = 7
#: the bucketed path's smaller runs: the first bases of the main FASTA
BUCKET_SMALL_BASES = 16 << 20
#: K10's and P1's timed shape: the row route's rows of one 64 Mbase shard
SEG_ROWS = 32768
ROW_W = 2048
#: P1's edge shapes [R, W]: W of 1-3, not a multiple of 4, one past ROW_W
ROLL_EDGES = ((64, 1), (64, 2), (64, 3), (64, 5), (333, 255), (100, 2049), (100, ROW_W))
#: the config-5 run, whose launches the kernels line reports for K1m, K10
#: and P1
BUCKET_MAIN = f"count_bucket_auto(k={BUCKET_K}, minimizer, D={BUCKET_D})"
#: K11's check: (row length, rows), one per word-per-thread instantiation
#: and the widest row; then timed at the device-sort route's rows of one
#: 16 Mbase batch (16,777,216 windows as [8192, 2048])
SORT_CHECKS = ((128, 1000), (512, 333), (2048, 129), (32768, 37))
SORT_ROWS = 8192
#: K11's shortest and longest rows, timed on the same words
MIN_SORT_M = 128
MAX_SORT_M = 32768
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


def runs_stream(rng, n_bases: int):
    """``check_stream`` with every other 4,096 bases one repeated base: half
    the windows of a warp step share one code."""
    b = check_stream(rng, n_bases)
    for s in range(0, n_bases, 8192):
        b[s : s + 4096] = rng.integers(0, 4)
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


def _layout(t) -> str:
    return "absent" if t is None else f"{t.dtype}{tuple(t.shape)}"


def max_abs_err(got, ref) -> int:
    """Largest |kernel - plain| over the planes; raises unless every
    plane has the plain version's dtype and shape (a plane absent from
    both, as hi for k <= 15, is skipped)."""
    worst = 0
    for g, r in zip(got, ref, strict=True):
        if g is None and r is None:
            continue
        if g is None or r is None or g.dtype != r.dtype or g.shape != r.shape:
            raise AssertionError(f"plane {_layout(g)} != plain {_layout(r)}")
        worst = max(worst, int((g.long() - r.long()).abs().max()))
    return worst


def phase_kernels(dev, card: str, shard_bases: int) -> dict:
    """K1 against its plain version on the card in KERNEL_CASES, then both
    timed at the main path's batch (TIMED_CASES) and at one config-5 shard
    without the minimizer plane (k=31, prefix owners). Returns {(k,
    canonical): (ms, plain ms, max_abs_err)} and, under "shard", that
    shape's record."""
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
        del planes

    # One config-5 shard, as the prefix-owner route launches K1 on it.
    k, T = BUCKET_K, shard_windows(shard_bases)
    planes = stage_batch_planes(check_stream(rng, T), dev)
    got, ref = both(planes, shard_bases, k, False)
    err = max_abs_err(got, ref)
    if err:
        raise AssertionError(f"kernel disagrees with plain at T={T} k={k}")
    del got, ref
    torch.cuda.empty_cache()
    ms = time_ms(lambda: encode_cuda.encode_packed(*planes, shard_bases, k, False), 20)
    plain_ms = time_ms(
        lambda: encode_cuda.encode_packed_reference(*planes, shard_bases, k, False), 3
    )
    # planes read (0.5 B per base); lo and hi stored
    bound = bound_ms(T // 2 + 8 * T, 0)
    log(f"kernel time k={k} (one config-5 shard) T={T}: kernel {ms:.4f} ms "
        f"({T / ms / 1e6:.2f} Gwindow/s), plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]}), max_abs_err={err} [{card}]")
    record["shard"] = dict(ms=ms, plain_ms=plain_ms, bound=bound, max_abs_err=err,
                           shape=f"k={k} T={T}")
    del planes
    torch.cuda.empty_cache()
    return record


def smoke_lengths(bases: int):
    """The record lengths of ``smoke_records(bases)``, and the generator
    that goes on to draw their bases."""
    import numpy as np

    rng = np.random.default_rng(0)
    n_seqs = max(1, round(bases / 250_000))
    return rng, rng.integers(200_000, 300_001, n_seqs)


def smoke_shard_bases(bases: int) -> int:
    """The bases of one config-5 shard of ``smoke_records(bases)``'s
    stream (BUCKET_D shards, the last one shorter)."""
    _, lengths = smoke_lengths(bases)
    return -(-(int(lengths.sum()) + lengths.size - 1) // BUCKET_D)


def shard_windows(shard_bases: int) -> int:
    """Window slots of one shard's planes: its bases plus a (k-1) halo at
    BUCKET_K, in whole words."""
    return -(-(shard_bases + BUCKET_K - 1) // 16) * 16


def smoke_records(bases: int):
    """Seeded records of 200-300 kbase (0.1% N) totalling about ``bases``
    bases, as (stream, starts, lengths): the u8 base stream with one
    INVALID separator between records, and each record's offset and
    length in it."""
    import numpy as np

    rng, lengths = smoke_lengths(bases)
    n_seqs = lengths.size
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


def time_card_table(stream, k: int, canonical: bool, dev, ref, card: str) -> dict:
    """The card's table build of ``SparseKmerEngine`` at the main path's
    size, step by step: the call's keys (every valid window's reference
    code as its sort key, the sentinels after them) sorted by
    ``torch.sort``, run-length by ``sparse.rle_keys``, both timed by CUDA
    events, then the distinct rows copied by ``sparse_engine.fetch_table``
    (host clock), the table held to the reference. Twice: the first build
    also grows the allocator's pool. The build's device peak, the key
    buffer included, is held to ``card_table_bytes``, which the gate
    reserves (on the card; the CPU rehearses the steps)."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
        card_table_bytes,
        fetch_table,
    )
    from dna_kmeres_parallel_tpu_torch.ops import runtime
    from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

    dtype = sparse_ops.key_dtype(k)
    n = stream.size
    key_bytes = n * dtype.itemsize
    cuda = dev.type == "cuda"  # the CPU rehearses the steps, with no peak
    out = {}
    for rep in range(2):
        codes = torch.cat(list(reference_codes(stream, k, canonical, dev)))
        keys = torch.full((n,), sparse_ops.key_sentinel(dtype), dtype=dtype, device=dev)
        keys[: codes.numel()] = codes if dtype == torch.int64 else (codes - (1 << 31)).to(dtype)
        del codes
        if cuda:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        m0 = runtime.mark(dev)
        ordered = torch.sort(keys).values
        del keys
        m1 = runtime.mark(dev)
        (keys_c,), runs, n_distinct = sparse_ops.rle_keys(ordered)
        del ordered
        m2 = runtime.mark(dev)
        rows = int(n_distinct)
        peak = torch.cuda.max_memory_allocated(dev) - base + key_bytes if cuda else 0
        t = time.perf_counter()
        codes_h, counts_h = fetch_table(keys_c, runs, rows)
        copy_s = time.perf_counter() - t
        del keys_c, runs
        if not (np.array_equal(codes_h, ref[0]) and np.array_equal(counts_h, ref[1])):
            raise AssertionError(f"card table k={k}: differs from the reference")
        need = card_table_bytes(n, dtype.itemsize)
        if peak > need:
            raise AssertionError(f"card table k={k}: device peak {peak} B over the gate's "
                                 f"{need} B")
        out = {"sort_ms": runtime.span_s(m0, m1) * 1e3, "rle_ms": runtime.span_s(m1, m2) * 1e3,
               "copy_s": copy_s, "rows": rows, "peak_bytes": peak,
               "peak_per_window": peak / n, "gate_per_window": need / n}
        log(f"card table k={k}{' canonical' if canonical else ''} ({n} windows, "
            f"{dtype} keys), build {rep + 1}: torch.sort {out['sort_ms']:.3f} ms, "
            f"rle_keys {out['rle_ms']:.3f} ms, copy of {rows} rows "
            f"{copy_s * 1e3:.3f} ms ({rows * 16 / max(copy_s, 1e-9) / 1e9:.3f} GB/s); "
            f"device peak {peak} B = {peak / n:.2f} B a window, {peak / key_bytes:.2f}x "
            f"the keys (gate {need / n:.0f} B a window) [{card}]")
        if cuda:
            torch.cuda.empty_cache()
    return out


def phase_main_path(records, path: Path, dev, card: str, refs: dict | None = None) -> int:
    """Each count run on the card's table build (the default) and on the
    host's (``device_sort=False``) in turn: the route each call took, both
    tables bit for bit against each other and the reference, and the
    card's build timed step by step (``time_card_table``)."""
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
         lambda **kw: port.count_file(str(path), k=21, device=dev, **kw)),
        ("SparseKmerEngine(k=21, canonical)", 21, True,
         lambda **kw: SparseKmerEngine(KmerConfig(k=21, canonical=True, **kw), device=dev)
         .count_file(str(path))),
        ("SparseKmerEngine(k=11, canonical)", 11, True,
         lambda **kw: SparseKmerEngine(KmerConfig(k=11, canonical=True, **kw), device=dev)
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
        tables = []
        for route, kw in (("card", {}), ("host", {"device_sort": False})):
            reset_launches()
            t = time.perf_counter()
            res = run(**kw)
            wall = time.perf_counter() - t
            got = read_launches()
            launches = got["encode_packed"]
            if any(got[n] for n in got if n != "encode_packed"):
                raise AssertionError(f"{name}: other kernels launched: {got}")
            if res.table_on_card != (route == "card"):
                raise AssertionError(f"{name}, {route} route: table_on_card "
                                     f"{res.table_on_card}")
            if (res.n_seqs, res.total_bases) != (lengths.size, int(lengths.sum())):
                raise AssertionError(
                    f"{name}: {res.n_seqs} records of {res.total_bases} bases parsed"
                )
            if not (
                np.array_equal(res.codes, ref_codes)
                and np.array_equal(res.counts, ref_counts)
            ):
                raise AssertionError(f"{name}, {route} route: table differs from the reference")
            if launches != n_batches:
                raise AssertionError(
                    f"{name}: {launches} kernel launches for {n_batches} batches"
                )
            if main_launches is None:  # the first run is the main path's
                main_launches = launches
            tables.append(res)
            phases = " ".join(f"{p}={s:.3f}" for p, s in res.phases.items())
            log(f"{name}, table built on the {route} (table_on_card={res.table_on_card}): "
                f"{res.distinct_kmers} distinct, {res.total_kmers} k-mers, "
                f"equal to the reference ({ref_s:.2f} s); "
                f"{launches} launches for {n_batches} batches; "
                f"wall {wall:.3f} s, {res.total_bases / wall / 1e9:.4f} Gbase/s; "
                f"phases s: {phases} [{card}]")
            del res
        card_res, host_res = tables
        if not (card_res.codes.tobytes() == host_res.codes.tobytes()
                and card_res.counts.tobytes() == host_res.counts.tobytes()):
            raise AssertionError(f"{name}: the card's table differs from the host's")
        log(f"{name}: the card's table equals the host's bit for bit [{card}]")
        del tables, card_res, host_res
        time_card_table(stream, k, canonical, dev, (ref_codes, ref_counts), card)
    return main_launches


def phase_dense_kernels(dev, card: str) -> dict:
    """K5-K8 against their plain versions, element for element: on an
    N-rich stream (every k of DENSE_KS x canonical x n_own at the edges;
    K7 from u8 and from the packed batch at k <= 3; K6 at k=8 also in
    clusters of 2 and 4), on views offset by 1..15 bytes, and at one 16
    Mbase batch on the same kind of stream, on one whose windows half lie
    in one-base runs, and on batches of one code. Then each timed at that
    batch beside its plain version (K5 at k=6 and 8, K7 u8 and packed, and
    the packed route before it: ``unpack_stream`` + the u8 entry). Returns
    each kernel's record."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch import KmerConfig, native
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan, stage_batch_planes
    from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
    from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda as hc

    worst = dict.fromkeys(
        ("hist_planes", "hist_u8", "hist_u8_small", "hist_packed_small", "hist_u8_any"), 0)

    def check(name, got, ref, what):
        torch.cuda.synchronize()
        err = max_abs_err((got,), (ref,))
        worst[name] = max(worst[name], err)
        if err:
            raise AssertionError(f"{name} disagrees with plain at {what}")

    def packed(bases):
        data, mask, _ = native.pack_2bit_native(bases)
        return torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)

    def check_all(tag, bases, ks, owns, stages=None):
        """K5, K6 (and K7 from u8 and packed at k <= 3) on one stream, each
        k x canonical x n_own."""
        planes, b, pk = stages or (stage_batch_planes(bases, dev),
                                   torch.from_numpy(bases).to(dev), packed(bases))
        for k in ks:
            for canonical in (False, True):
                for n_own in owns(k):
                    what = f"{tag} k={k} canonical={canonical} n_own={n_own}"
                    ref = hc.hist_u8_reference(b, n_own, k, 4**k, canonical)
                    check("hist_planes", hc.hist_planes_cuda(*planes, n_own, k, canonical),
                          ref, what)
                    check("hist_u8", hc.hist_u8_cuda(b, n_own, k, 4**k, canonical), ref, what)
                    if 4**k <= hc.SMALL_BINS:
                        check("hist_u8_small",
                              hc.hist_u8_small_cuda(b, n_own, k, 4**k, canonical), ref, what)
                        check("hist_packed_small",
                              hc.hist_packed_small_cuda(*pk, n_own, k, 4**k, canonical), ref,
                              what)
        return ref

    rng = np.random.default_rng(4)
    bases = check_stream(rng, CHECK_BASES)
    n = CHECK_BASES
    owns = lambda k: (0, 1, n // 2 + 5, n - k, n)  # noqa: E731
    b = torch.from_numpy(bases).to(dev)
    planes = stage_batch_planes(bases, dev)
    pk = packed(bases)
    for k in DENSE_KS:
        ref = check_all("N-rich", bases, (k,), owns, (planes, b, pk))
        log(f"kernel check dense k={k}: {n} bases, canonical and not, n_own in {owns(k)}: "
            f"K5, K6{', K7 u8, K7 packed' if k <= 3 else ''} equal their plain versions, "
            f"{int(ref.sum())} windows at full n_own")
    if 8 in DENSE_KS:
        # K6 in each cluster size timed below, on the same stream
        for cluster in K6_CLUSTERS:
            for canonical in (False, True):
                for n_own in owns(8):
                    check("hist_u8",
                          hc.hist_u8_cuda(b, n_own, 8, 4**8, canonical, cluster=cluster),
                          hc.hist_u8_reference(b, n_own, 8, 4**8, canonical),
                          f"k=8 canonical={canonical} n_own={n_own} cluster={cluster}")
        log(f"kernel check dense K6 k=8 in clusters of {K6_CLUSTERS}: equal to plain")
    # Views that start 1..15 bytes past a 16-byte boundary: u8 streams by
    # bytes, planes by words (4 bytes), packed data by 2 bytes and its mask
    # by 1 (8 bases), each at k = 3 and 8.
    for off in range(1, 16):
        view = b[off:]
        m = view.numel()
        for k in (3, 8):
            for canonical in (False, True):
                for n_own in (0, m // 2 + 1, m - k, m):
                    what = f"offset {off} k={k} canonical={canonical} n_own={n_own}"
                    ref = hc.hist_u8_reference(view, n_own, k, 4**k, canonical)
                    check("hist_u8", hc.hist_u8_cuda(view, n_own, k, 4**k, canonical), ref, what)
                    if k <= 3:
                        check("hist_u8_small",
                              hc.hist_u8_small_cuda(view, n_own, k, 4**k, canonical), ref, what)
                    if off < 8:
                        d, mk = pk[0][2 * off:], pk[1][off:]
                        p_ref = hc.hist_u8_reference(b[8 * off:], n_own, k, 4**k, canonical)
                        if k <= 3:
                            check("hist_packed_small",
                                  hc.hist_packed_small_cuda(d, mk, n_own, k, 4**k, canonical),
                                  p_ref, f"packed {what}")
                    if off < 4:
                        w_ref = hc.hist_u8_reference(b[16 * off:], n_own, k, 4**k, canonical)
                        check("hist_planes",
                              hc.hist_planes_cuda(planes[0][off:], planes[1][off:], n_own, k,
                                                  canonical),
                              w_ref, f"planes {what}")
    log("kernel check dense on views 1..15 bytes past 16-byte alignment (planes 1..3 "
        "words, packed 1..7 mask bytes), k=3 and 8: K5, K6, K7 u8, K7 packed equal to plain")
    for k, bins in ANY_CASES:
        for canonical in (False, True):
            for n_own in owns(k):
                check("hist_u8_any", hc.hist_u8_any_cuda(b, n_own, k, bins, canonical),
                      hc.hist_u8_reference(b, n_own, k, bins, canonical),
                      f"k={k} bins={bins} canonical={canonical} n_own={n_own}")
        log(f"kernel check dense K8 k={k} bins={bins}: equal to plain")
    del b, planes, pk

    # One 16 Mbase batch: batch_bases owned + a (k-1) halo, padded.
    batch, T = batch_plan(1 << 40, 8, KmerConfig().batch_bases)
    full = lambda k: (batch, T - k)  # noqa: E731
    runs = runs_stream(rng, T)
    check_all("one-base runs", runs, (3, 6, 8), full)
    for code in (0, 3):
        # every window one code: one bin takes every count of the batch
        one = np.full(T, code, np.uint8)
        ref = check_all(f"all {'ACGT'[code]}", one, (1, 3, 6, 8), full)
        log(f"kernel check dense on a batch of one base ({'ACGT'[code]}), k in (1, 3, 6, 8): "
            f"{int(ref.max())} counts in one bin at k=8, K5, K6, K7 u8, K7 packed equal "
            f"to plain")
    del runs, one
    bases = check_stream(rng, T)
    b = torch.from_numpy(bases).to(dev)
    planes = stage_batch_planes(bases, dev)
    pk = packed(bases)
    check_all("N-rich batch", bases, (3, 6, 8), full, (planes, b, pk))
    log(f"kernel check dense on the one-base-run, one-code and N-rich batches of {T} bases: "
        "equal to plain")
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
    acc = torch.zeros(4**6, dtype=torch.int32, device=dev)
    k5_6 = time_ms(lambda: hc.hist_planes_cuda(*planes, batch, 6, False, acc), 20)
    log(f"kernel time hist_planes (K5) k=6 planes T={T}: {k5_6:.4f} ms, bound "
        f"{bound_ms(T // 2 + 8 * 4**6, batch)[0]:.4f} ms [{card}]")
    timed("hist_u8", "k=8 u8", 4**8,
          lambda acc: hc.hist_u8_cuda(b, batch, 8, 4**8, False, acc),
          lambda: hc.hist_u8_reference(b, batch, 8, 4**8), T)
    # K6 beside its record: at k=5 (the launches of its path's run), and
    # at k=8 in each cluster size, on this stream and on one half of whose
    # windows lie in one-base runs.
    runs = torch.from_numpy(runs_stream(rng, T)).to(dev)
    k6 = {}
    acc = torch.zeros(4**5, dtype=torch.int32, device=dev)
    check("hist_u8", hc.hist_u8_cuda(b, batch, 5, 4**5), hc.hist_u8_reference(b, batch, 5, 4**5),
          f"T={T} k=5")
    k6["k=5"] = time_ms(lambda: hc.hist_u8_cuda(b, batch, 5, 4**5, False, acc), 20)
    for label, stream in (("random", b), ("half one-base runs", runs)):
        for cluster in K6_CLUSTERS:
            acc = torch.zeros(4**8, dtype=torch.int32, device=dev)
            check("hist_u8", hc.hist_u8_cuda(stream, batch, 8, 4**8, False, cluster=cluster),
                  hc.hist_u8_reference(stream, batch, 8, 4**8), f"T={T} {label} C={cluster}")
            k6[f"k=8 {label} C={cluster}"] = time_ms(
                lambda: hc.hist_u8_cuda(stream, batch, 8, 4**8, False, acc, cluster=cluster), 20)
    log(f"kernel time hist_u8 (K6) T={T}, default cluster {hc.u8_plan(4**8)[0]} at 4^8 bins: "
        + "; ".join(f"{key} {ms:.4f} ms" for key, ms in k6.items()) + f" [{card}]")
    del runs
    timed("hist_u8_small", "k=3 u8", 64,
          lambda acc: hc.hist_u8_small_cuda(b, batch, 3, 64, False, acc),
          lambda: hc.hist_u8_reference(b, batch, 3, 64), T)
    timed("hist_packed_small", "k=3 packed", 64,
          lambda acc: hc.hist_packed_small_cuda(*pk, batch, 3, 64, False, acc),
          lambda: hc.hist_packed_small_reference(*pk, batch, 3, 64), T // 4 + T // 8)
    acc = torch.zeros(64, dtype=torch.int32, device=dev)
    before = time_ms(
        lambda: hc.hist_u8_small_cuda(encode_ops.unpack_stream(*pk), batch, 3, 64, False, acc), 20)
    log(f"kernel time packed k=3 route T={T}: unpack_stream + hist_u8_small {before:.4f} ms, "
        f"hist_packed_small {rec['hist_packed_small']['ms']:.4f} ms [{card}]")
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
    from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
    from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda

    stream, _, lengths = records
    refs = {} if refs is None else refs
    none = dict.fromkeys(read_launches(), 0)
    launches = {}
    # Every unpack_stream call of a run, by the device of its input: the
    # packed k <= 3 route must make none on the card (K7 reads the packed
    # batch itself).
    unpacks: list[str] = []
    real_unpack = encode_ops.unpack_stream

    def counted_unpack(data, mask):
        unpacks.append(data.device.type)
        return real_unpack(data, mask)

    for name, k, canonical, pack_input, kernel in DENSE_RUNS:
        t = time.perf_counter()
        ref = cached(refs, ("hist", k, canonical),
                     lambda: reference_hist(stream, k, canonical, dev))
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t
        batch, _ = batch_plan(stream.size, k, KmerConfig().batch_bases)
        n_batches = math.ceil(stream.size / batch)
        unpacks.clear()
        encode_ops.unpack_stream = counted_unpack
        reset_launches()
        t = time.perf_counter()
        try:
            res = port.count_file(str(path), k=k, canonical=canonical,
                                  pack_input=pack_input, device=dev)
        finally:
            encode_ops.unpack_stream = real_unpack
        wall = time.perf_counter() - t
        launches[name] = expect_launches(name, {**none, kernel: n_batches})
        if "cuda" in unpacks:
            raise AssertionError(f"{name}: {unpacks.count('cuda')} unpack_stream calls on the card")
        if (res.n_seqs, res.total_bases) != (lengths.size, int(lengths.sum())):
            raise AssertionError(f"{name}: {res.n_seqs} records of {res.total_bases} bases parsed")
        if res.hist.dtype != np.int64 or not np.array_equal(res.hist, ref):
            raise AssertionError(f"{name}: histogram differs from the reference")
        phases = " ".join(f"{p}={s:.3f}" for p, s in res.phases.items())
        log(f"{name}: {res.distinct_kmers} distinct, {res.total_kmers} k-mers, equal to "
            f"the reference ({ref_s:.2f} s); {n_batches} {kernel} launches for "
            f"{n_batches} batches, no unpack_stream on the card; wall {wall:.3f} s, "
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


#: the child of the kill-and-resume runs: counts k-mers of length ``k`` on
#: a mesh of ``mesh`` shards of ``dev`` (1: one device) with a checkpoint
#: every ``every`` bases and SIGKILLs itself once its second checkpoint is
#: published
_KILLED_CHILD = r"""
import os, signal, sys
sys.path.insert(0, sys.argv[1])
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
from dna_kmeres_parallel_tpu_torch.utils import checkpoint

root, path, ckpt, dev, every, batch, k, mesh = sys.argv[1:9]
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
StreamingCounter(KmerConfig(k=int(k), mesh_shape=(int(mesh),), **kw), device=dev,
                 checkpoint_path=ckpt, checkpoint_every_bases=int(every)).run(path)
"""


def phase_stream_path(records, path: Path, dev, card: str, refs: dict | None = None) -> dict:
    """The streaming counter on the main path's FASTA: k=21 through K9
    (``pack_input=False``) and K1, the host route, 'auto' (K1),
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
    _, m, got = streamed(name, 21, False, {"compact": "auto"}, {"encode_packed": n_batches})
    if "host_count" in m.phase_seconds:
        raise AssertionError(f"{name}: a batch was counted on the host")
    log(f"{name}: route words (the device arm), {got['encode_packed']} of {n_batches} "
        f"batches on the card [{card}]")
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
         str(STREAM_CKPT_BASES), str(STREAM_BATCH_BASES), "21", "1"],
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
            n_valid = int((got[1] != -1).sum())
        log(f"kernel check encode_packed_minimizer k={k} m={m} (L={k - m + 1}): "
            f"{CHECK_BASES} windows, n_own in {owns}, canonical and not: equal to plain, "
            f"words equal K1's; {n_valid} valid windows at full n_own")
    for base, k, m in MIN_ONE_BASE:
        one = stage_batch_planes(np.full(CHECK_BASES, base, np.uint8), dev)
        for canonical in (False, True):
            what = f"one-base stream of {base}, k={k} m={m} canonical={canonical}"
            got = encode_cuda.encode_packed(*one, CHECK_BASES, k, canonical, minimizer_m=m)
            check("encode_packed_minimizer", got, encode_cuda.encode_packed_reference(
                *one, CHECK_BASES, k, canonical, minimizer_m=m), what)
        log(f"kernel check encode_packed_minimizer on a one-base stream of {base}, k={k} "
            f"m={m}: equal to plain, canonical and not")
    del one

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
    for R, W in ROLL_EDGES:
        for offset in (0, 1):  # 1: x one word past a 16-byte boundary
            buf = torch.empty(R * W + offset, dtype=torch.int32, device=dev)
            xe = buf[offset:].view(R, W).copy_(
                torch.randint(-(2**31), 2**31 - 1, (R, W), generator=g, dtype=torch.int64)
                .to(torch.int32))
            se = torch.randint(-3 * W, 3 * W, (R,), generator=g).to(torch.int32)
            se[:2] = torch.tensor([-(2**31), 2**31 - 1])
            se = se.to(dev)
            check("row_roll", (sort_cuda.row_roll(xe, se),),
                  (sort_cuda.row_roll_reference(xe, se),), f"[{R}, {W}] offset {offset}")
    log(f"kernel check row_roll: the probe's [8, 256] tile equals np.roll, [{SEG_ROWS}, "
        f"{ROW_W}] with shifts in [-{3 * ROW_W}, {3 * ROW_W}) equals plain, and so do "
        f"{list(ROLL_EDGES)}, aligned and one word past, shifts at both int32 extremes")

    rec = {}
    # K1m at one config-5 shard: 64 Mbase owned + a (k-1) halo, in planes.
    k, m, T = BUCKET_K, BUCKET_M, shard_windows(shard_bases)
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
    rolls = []
    for xt, st in ((xr, sr), (x, s)):
        R, W = xt.shape
        bound = bound_ms(2 * 4 * R * W + 4 * R, 0)
        rolls.append(dict(
            shape=f"[{R}, {W}]", ms=time_ms(lambda: sort_cuda.row_roll(xt, st), 20),
            plain_ms=time_ms(lambda: sort_cuda.row_roll_reference(xt, st), 3),
            bound_ms=bound[0], bound_by=bound[1],
        ))
    log(f"kernel time row_roll at the path's probe tile [8, 256]: {rolls[1]['ms']:.4f} ms, "
        f"plain {rolls[1]['plain_ms']:.3f} ms, bound {rolls[1]['bound_ms']:.6f} ms [{card}]")
    rec["row_roll"] = dict(
        ms=rolls[0]["ms"], plain_ms=rolls[0]["plain_ms"],
        bound=(rolls[0]["bound_ms"], rolls[0]["bound_by"]), shape=rolls[0]["shape"], shapes=rolls,
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
    K1's k=11 words (a 16 Mbase batch; at most 4 digit passes) beside its
    plain version and ``torch.sort(dim=-1)`` of the biased keys (the
    library call), the same words as rows of 128 and of 32,768, and random
    u32 rows at [8192, 2048]. Returns the kernel's record at the route's
    shape."""
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
    passes = int(sort_cuda.row_sort_digit_passes(x).max())
    if passes > 4:
        raise AssertionError(f"K1's k=11 words take {passes} digit passes")

    def timing(x):
        biased = x ^ sort_cuda.INT32_MIN
        return dict(
            ms=time_ms(lambda: sort_cuda.row_sort_u32(x), 20),
            plain_ms=time_ms(lambda: sort_cuda.row_sort_u32_reference(x), 3),
            library_ms=time_ms(lambda: torch.sort(biased, dim=-1), 5),
            # each word read and written once
            bound=bound_ms(8 * x.numel(), 0),
        )

    rec = dict(timing(x), max_abs_err=worst, shape=f"[{SORT_ROWS}, {m}]", passes=passes)
    log(f"kernel time row_sort {rec['shape']} (k=11 words, {passes} digit passes): kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, torch.sort "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound'][0]:.4f} ms ({rec['bound'][1]}), "
        f"max_abs_err={rec['max_abs_err']} [{card}]")
    # The same words at the shortest and longest rows K11 takes, then
    # random u32 rows (4 passes) at the route's shape.
    for other in (MIN_SORT_M, MAX_SORT_M):
        y = x.reshape(-1, other)
        check(y, f"K1's k=11 words as {list(y.shape)}")
        r = timing(y)
        log(f"kernel time row_sort {list(y.shape)} (k=11 words): kernel {r['ms']:.4f} ms, "
            f"torch.sort {r['library_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms [{card}]")
    y = sort_rows_input(SORT_ROWS, m, 9, dev)
    check(y, f"random u32 as [{SORT_ROWS}, {m}]")
    r = timing(y)
    log(f"kernel time row_sort [{SORT_ROWS}, {m}] (random u32, sentinel tails, "
        f"{int(sort_cuda.row_sort_digit_passes(y).max())} digit passes): kernel {r['ms']:.4f} ms, "
        f"torch.sort {r['library_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms [{card}]")
    del x, y
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
    "counts_matrix_global": ("histogram_cuda", "COUNTS_GLOBAL_LAUNCHES"),
    "min_sum_tri": ("distance_cuda", "TRI_LAUNCHES"),
    "min_sum_rect": ("distance_cuda", "RECT_LAUNCHES"),
    "finish_upper": ("distance_cuda", "FINISH_LAUNCHES"),
    "hist_planes": ("histogram_cuda", "PLANES_LAUNCHES"),
    "hist_u8": ("histogram_cuda", "U8_LAUNCHES"),
    "hist_u8_small": ("histogram_cuda", "SMALL_LAUNCHES"),
    "hist_packed_small": ("histogram_cuda", "PACKED_LAUNCHES"),
    "hist_u8_any": ("histogram_cuda", "ANY_LAUNCHES"),
    "encode_packed_minimizer": ("encode_cuda", "MIN_LAUNCHES"),
    "owner_segments": ("sort_cuda", "OWNER_LAUNCHES"),
    "row_roll": ("sort_cuda", "ROLL_LAUNCHES"),
    "row_sort": ("sort_cuda", "ROW_SORT_LAUNCHES"),
    # not a kernel: the threshold route's products (torch._int_mm)
    "min_sum_threshold": ("threshold_cuda", "THRESHOLD_LAUNCHES"),
}


def _counter_module(name: str):
    import importlib

    return importlib.import_module(f"dna_kmeres_parallel_tpu_torch.ops.{name}")


def reset_launches() -> None:
    """Set every kernel's launch count to 0, K3/K4's counts by route and
    the threshold route's GEMM count."""
    for module, attr in COUNTERS.values():
        setattr(_counter_module(module), attr, 0)
    _counter_module("threshold_cuda").GEMM_LAUNCHES = 0
    routes = _counter_module("distance_cuda").ROUTE_LAUNCHES
    for route in routes:
        routes[route] = 0


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


def sample_lines(n_lines: int, n_sample: int = 100_000):
    """``n_sample`` seeded distinct line numbers of ``n_lines``."""
    import numpy as np

    rng = np.random.default_rng(2)
    return rng.choice(n_lines, size=min(n_sample, n_lines), replace=False)


def check_csv_lines(path: Path, n_lines: int, idx, want) -> int:
    """``n_lines`` lines, and line ``idx[i]`` equal to Python's ``"%f"`` of
    ``want[i]``. Returns the lines checked."""
    import numpy as np

    data = np.fromfile(path, dtype=np.uint8)
    nl = np.flatnonzero(data == ord("\n"))
    if nl.size != n_lines or (data.size and data[-1] != ord("\n")):
        raise AssertionError(f"{path.name}: {nl.size} lines for {n_lines} pairs")
    begin = np.concatenate([[0], nl[:-1] + 1])
    for i, w in zip(idx, want, strict=True):
        line = data[begin[i] : nl[i] + 1].tobytes()
        if line != ("%f\n" % w).encode():
            raise AssertionError(f"{path.name} line {i}: {line!r} != %f of {w!r}")
    return len(idx)


def check_csv(path: Path, want, n_sample: int = 100_000) -> int:
    """One line per value, and ``n_sample`` seeded lines equal to Python's
    ``"%f"`` of the reference's values. Returns the lines checked."""
    idx = sample_lines(want.size, n_sample)
    return check_csv_lines(path, want.size, idx, want[idx])


#: K3/K4's kernels in the SASS: (name, mangled-name fragments, outputs a
#: thread accumulates, bins a stage)
MIN_SUM_SASS = (
    ("min_sum_rect u16x2", ("min_sum_rect_kernel", "ILb1ELb0E"), 128, 32),
    ("min_sum_rect i32", ("min_sum_rect_kernel", "ILb0ELb0E"), 64, 32),
    ("min_sum_tri u16x2", ("min_sum_tri_kernel", "ILb1ELb0E"), 128, 32),
    ("min_sum_tri i32", ("min_sum_tri_kernel", "ILb0ELb0E"), 64, 32),
    ("min_sum_rect u16x2 split", ("min_sum_rect_kernel", "ILb1ELb1E"), 128, 32),
    ("min_sum_tri i32 split", ("min_sum_tri_kernel", "ILb0ELb1E"), 64, 32),
)


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output -> {function name: [(address, opcode,
    branch target or None)]}; predicates dropped, opcodes with their
    modifiers."""
    import re

    funcs: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)(.*?);", line)
        if m and cur is not None:
            target = re.search(r"0x([0-9a-f]+)", m.group(3)) if m.group(2).startswith("BRA") else None
            cur.append((int(m.group(1), 16), m.group(2), target and int(target.group(1), 16)))
    return funcs


def sass_loop_report(instrs, outputs: int, bins: int) -> dict:
    """The backward branch whose body holds the most 16x2 or 32-bit integer
    minima is the stage loop: its instructions by opcode, and the
    instructions per (pair, bin) over ``outputs`` x ``bins`` a trip."""
    best = None
    for addr, _, target in instrs:
        if target is None or target > addr:
            continue
        body = [o for a, o, _ in instrs if target <= a <= addr]
        mins = sum(o.startswith(("VIMNMX", "IMNMX")) for o in body)
        if best is None or mins > best[0]:
            best = (mins, body)
    if best is None:
        return {"loop": False}
    body = best[1]
    ops: dict = {}
    for o in body:
        ops[o] = ops.get(o, 0) + 1
    return {
        "loop": True,
        "instructions": len(body),
        "per_pair_bin": len(body) / (outputs * bins),
        "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
    }


def min_sum_sass(so: Path) -> dict:
    """K3/K4's stage loops in the built library's SASS, by kernel and route
    (``cuobjdump -sass``); {} where the toolkit has no cuobjdump."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs = sass_functions(text)
    out = {}
    for name, parts, outputs, bins in MIN_SUM_SASS:
        fn = next((f for f in funcs if all(p in f for p in parts)), None)
        if fn is not None:
            out[name] = sass_loop_report(funcs[fn], outputs, bins)
    return out


#: K3/K4's route checks: rows of either side, bins, and the kinds of counts
#: (each side's kind, the route they imply; the clamp kinds pair a side
#: whose largest row sum is 65,535 with one that holds counts of 2^16 and
#: more)
ROUTE_ROWS = (1, 127, 128, 129)
ROUTE_BINS = (1, 64, 65, 65536)
ROUTE_KINDS = (
    ("small", "small", "u16x2"),
    ("small", "big", "u16x2"),
    ("big", "small", "u16x2"),
    ("wide", "wide", "i32"),
)
#: bins either side of a slice edge of K3/K4's bin split: at ROUTE_ROWS
#: the products split 65,536 bins into 64 slices of 1,024 (ROUTE_BINS),
#: 65,535 into 63 such and one of 1,023, 65,537 into 62 of 1,056 and one
#: of 65
SPLIT_BINS = (65535, 65537)


def route_counts(rows: int, B: int, kind: str, seed: int):
    """Seeded int32 [rows, B] counts (NumPy) for the route checks. "small":
    every row sums to at most 65,535 and row 0 to exactly 65,535; "wide":
    the same with row 0 summing to 65,536; "big": counts of 0-3 with at
    least one count of 2^16 or more in every row (row sums stay far below
    2^31)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if kind == "big":
        c = rng.integers(0, 4, (rows, B))
        hot = rng.random((rows, B)) < 1e-3
        hot[np.arange(rows), rng.integers(0, B, rows)] = True
        c[hot] = rng.integers(1 << 16, 300_000, int(hot.sum()))
        return c.astype(np.int32)
    c = rng.integers(0, max(2, min(4000, (1 << 17) // B)), (rows, B)).astype(np.int64)
    sums = c.sum(1, keepdims=True)
    c = np.where(sums > 65535, c * 65535 // np.maximum(sums, 1), c)
    total = 65535 if kind == "small" else 65536
    c[0] = total // B
    c[0, : total % B] += 1
    return c.astype(np.int32)


def panel_shapes(S: int, panel_rows: int) -> list:
    """(r0, r1) of every panel of ``distance_stream_to_csv`` over S records
    (rows 0..S-2 have partners), each against the partner rows r0..S-1."""
    return [(r0, min(r0 + panel_rows, S - 1)) for r0 in range(0, S - 1, panel_rows)]


def min_sum_bound(shapes, B: int, symmetric: bool = False) -> tuple[float, str]:
    """The bound of K4 over panels [(rows, cols)] (each reads its rows and
    partners once, writes rows x cols int32, and takes 2 operations a pair
    and bin), or of K3 over [(S, S)] (one triangle's operations)."""
    n_bytes = n_ops = 0
    for rows, cols in shapes:
        pairs = rows * (rows + 1) // 2 if symmetric else rows * cols
        n_bytes += ((rows if symmetric else rows + cols) * B + rows * cols) * 4
        n_ops += 2 * B * pairs
    return bound_ms(n_bytes, n_ops)


def time_once_ms(fn) -> float:
    """CUDA-event milliseconds of one call (for the slow plain versions at
    the large shapes)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_distance_kernels(dev, card: str, records, so: Path | None = None) -> dict:
    """K2, K3 and K4 against their plain versions on edge shapes (K3 and
    K4 on both routes), then timed at the distance path's shapes: K3 at
    (a)'s 16,384 records and at all 54,018, K4 at (c)'s first panel and
    over all its panels, and the finish kernel on K4's and K3's outputs
    there. Returns each kernel's record."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda, histogram_cuda

    worst = {"counts_matrix": 0, "min_sum_tri": 0, "min_sum_rect": 0}
    routes = distance_cuda.ROUTE_LAUNCHES

    def check(name, got, ref, what):
        torch.cuda.synchronize()
        err = max_abs_err((got,), (ref,))
        log(f"kernel check {name} {what}: max_abs_err={err} [{card}]")
        worst[name] = max(worst[name], err)
        if err:
            raise AssertionError(f"{name} disagrees with plain at {what}")

    def routed(name, fn, want, *mats):
        """fn(*mats) on the card, held to the plain version; the launch must
        take route ``want``. Returns max_abs_err."""
        before = dict(routes)
        got = fn(*mats)
        torch.cuda.synchronize()
        taken = [r for r in routes if routes[r] != before[r]]
        if taken != [want]:
            raise AssertionError(f"{name}: route {taken}, the row sums imply {want}")
        err = max_abs_err((got,), (distance.min_sum_matrix(*mats),))
        worst[name] = max(worst[name], err)
        if err:
            shapes = " x ".join(str(tuple(m.shape)) for m in mats)
            raise AssertionError(f"{name} ({want}) disagrees with plain at {shapes}")
        return err

    def finish_shape(run, sums, lr, lc, what):
        """The finish kernel on the min-sums ``sums`` (rows and columns both
        from sequence 0), held bit for bit to its plain version on the same
        tensors, then both timed; the bound is 8 bytes a pair (the int32
        read, the float32 written)."""
        R, C = sums.shape
        got = distance_cuda.finish_upper_cuda(sums, lr, lc, 3)
        want = distance.finish_upper_plain(sums, lr, lc, 3)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"finish_upper disagrees with plain at {what} [{R}, {C}]")
        pairs = got.numel()
        del got, want
        bound = bound_ms(8 * pairs, 0)
        sh = dict(
            run=run, shape=f"[{R}, {C}] min-sums, {pairs} pairs",
            ms=time_ms(lambda: distance_cuda.finish_upper_cuda(sums, lr, lc, 3), 10),
            plain_ms=time_ms(lambda: distance.finish_upper_plain(sums, lr, lc, 3), 2),
            bound_ms=bound[0], bound_by=bound[1],
        )
        log(f"kernel check finish_upper {what} [{R}, {C}]: bit for bit its plain version; "
            f"kernel {sh['ms']:.4f} ms, plain {sh['plain_ms']:.3f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}, {pairs} pairs) [{card}]")
        return sh

    if so is not None:
        for name, rep in min_sum_sass(so).items():
            if not rep.get("loop"):
                log(f"sass {name}: no stage loop found [{card}]")
                continue
            top = ", ".join(f"{op} {n}" for op, n in list(rep["ops"].items())[:8])
            log(f"sass {name}: stage loop {rep['instructions']} instructions, "
                f"{rep['per_pair_bin']:.4f} per (pair, bin); {top} [{card}]")

    rng = np.random.default_rng(3)
    # 600 rows of 0-2,000 bases: N runs, rows shorter than k, empty rows.
    g = rng.integers(0, 4, (600, 2000)).astype(np.uint8)
    g[rng.random(g.shape) < 0.01] = INVALID
    g[:50, 100:400] = INVALID
    for r, n in enumerate(rng.integers(0, 2001, 600)):
        g[r, n if r % 7 else r % 9 :] = INVALID
    grid = torch.from_numpy(g).to(dev)
    for k in range(1, 9):
        for canonical in (False, True):
            check("counts_matrix",
                  histogram_cuda.counts_matrix_cuda(grid, k, 4**k, canonical),
                  histogram_cuda.counts_matrix_reference(grid, k, 4**k, canonical),
                  f"k={k} canonical={canonical} grid {tuple(g.shape)}")
    # Rows that do not start on a 16-byte boundary: the grid 5 bytes past one.
    buf = torch.empty(g.size + 5, dtype=torch.uint8, device=dev)
    view = buf[5:].view(g.shape).copy_(grid)
    for k in (3, 8):
        check("counts_matrix", histogram_cuda.counts_matrix_cuda(view, k, 4**k, True),
              histogram_cuda.counts_matrix_reference(view, k, 4**k, True),
              f"k={k} canonical grid {tuple(g.shape)} 5 bytes past alignment")
    del buf, view
    for B, S, S2 in ((64, 1000, 777), (1024, 1000, 777), (65536, 300, 130)):
        a = rng.integers(0, 200, (S, B)).astype(np.int32)
        a[rng.random(a.shape) < 0.5] = 0
        a = torch.from_numpy(a).to(dev)
        route = distance_cuda.product_route(*distance_cuda.check_counts(a))
        check("min_sum_tri", distance_cuda.min_sum_tri_cuda(a),
              distance.min_sum_matrix(a), f"[{S}, {B}] ({route})")
        route = distance_cuda.product_route(
            *distance_cuda.check_counts(a[:S2 // 3], a[S - S2 :]))
        check("min_sum_rect", distance_cuda.min_sum_rect_cuda(a[:S2 // 3], a[S - S2 :]),
              distance.min_sum_matrix(a[:S2 // 3], a[S - S2 :]),
              f"[{S2 // 3}, {B}] x [{S2}, {B}] ({route})")

    # Both routes on edge shapes: rows 1, 127, 128, 129 on either side, bins
    # 1, 64, 65, 65,536, row sums at 65,535 and 65,536.
    mats: dict = {}

    def mat(rows, B, kind, side):
        key = (rows, B, kind, side)
        if key not in mats:
            seed = ((rows * 131 + B) * 4 + ("small", "wide", "big").index(kind)) * 2 + side
            mats[key] = torch.from_numpy(route_counts(rows, B, kind, seed)).to(dev)
        return mats[key]

    for B in ROUTE_BINS:
        for kind in ("small", "wide"):
            want = "u16x2" if kind == "small" else "i32"
            err = max(routed("min_sum_tri", distance_cuda.min_sum_tri_cuda, want,
                             mat(S, B, kind, 0)) for S in ROUTE_ROWS)
            log(f"kernel check min_sum_tri {want} ({kind}) S in {ROUTE_ROWS}, B={B}: "
                f"max_abs_err={err} [{card}]")
        for ka, kc, want in ROUTE_KINDS:
            err = max(routed("min_sum_rect", distance_cuda.min_sum_rect_cuda, want,
                             mat(S, B, ka, 0), mat(S2, B, kc, 1))
                      for S in ROUTE_ROWS for S2 in ROUTE_ROWS)
            log(f"kernel check min_sum_rect {want} ({ka} x {kc}) S, S2 in {ROUTE_ROWS}, "
                f"B={B}: max_abs_err={err} [{card}]")
        mats.clear()

    # The bin split (P > 1) on both routes: the rows above either side of
    # a slice edge (129 rows: K3's mirror tile), then operands and outputs
    # off the 16-byte grid.
    def split_of(rows, cols, B, route, symmetric):
        n = distance_cuda.product_split(rows, cols, B, route, dev, symmetric)[0]
        if n < 2:
            raise AssertionError(f"[{rows}, {B}] x [{cols}, {B}] ({route}) does not split")
        return n

    for B in SPLIT_BINS:
        for kind in ("small", "wide"):
            want = "u16x2" if kind == "small" else "i32"
            splits = {split_of(S, S, B, want, True) for S in ROUTE_ROWS}
            err = max(routed("min_sum_tri", distance_cuda.min_sum_tri_cuda, want,
                             mat(S, B, kind, 0)) for S in ROUTE_ROWS)
            log(f"kernel check min_sum_tri split {sorted(splits)} {want} ({kind}) S in "
                f"{ROUTE_ROWS}, B={B}: max_abs_err={err} [{card}]")
        for ka, kc, want in ROUTE_KINDS:
            splits = {split_of(S, S2, B, want, False) for S in ROUTE_ROWS for S2 in ROUTE_ROWS}
            err = max(routed("min_sum_rect", distance_cuda.min_sum_rect_cuda, want,
                             mat(S, B, ka, 0), mat(S2, B, kc, 1))
                      for S in ROUTE_ROWS for S2 in ROUTE_ROWS)
            log(f"kernel check min_sum_rect split {sorted(splits)} {want} ({ka} x {kc}) S, S2 "
                f"in {ROUTE_ROWS}, B={B}: max_abs_err={err} [{card}]")
        mats.clear()
    for kind, want in (("small", "u16x2"), ("wide", "i32")):
        B = SPLIT_BINS[0]
        base = torch.from_numpy(route_counts(300, B, kind, 17)).to(dev)
        a, c = base[1:200], base[3:]  # rows of an odd B: 4-byte aligned only
        buf = torch.full((a.shape[0] * c.shape[0] + 1,), -1, dtype=torch.int32, device=dev)
        out = buf[1:].view(a.shape[0], c.shape[0])
        distance_cuda.launch_min_sum_rect(a, c, out, want)
        check("min_sum_rect", out, distance.min_sum_matrix(a, c),
              f"split {split_of(a.shape[0], c.shape[0], B, want, False)} {tuple(a.shape)} x "
              f"{tuple(c.shape)}, rows and output off the 16-byte grid ({want})")
        if int(buf[0]) != -1:
            raise AssertionError("min_sum_rect split wrote before its output")
        buf = torch.full((a.shape[0] ** 2 + 3,), -1, dtype=torch.int32, device=dev)
        out = buf[3:].view(a.shape[0], a.shape[0])
        distance_cuda.launch_min_sum_tri(a, out, want)
        check("min_sum_tri", out, distance.min_sum_matrix(a),
              f"split {split_of(a.shape[0], a.shape[0], B, want, True)} {tuple(a.shape)}, "
              f"rows and output off the 16-byte grid ({want})")
        if int(buf[:3].min()) != -1 or int(buf[:3].max()) != -1:
            raise AssertionError("min_sum_tri split wrote before its output")
        del base, a, c, buf, out

    # The distance path's shapes: (a)'s grid and counts at k=3, (b)'s grid
    # at k=8, and (c)'s panels against their partner rows.
    stream, starts, lengths = records
    na, nb = min(DIST_ROWS_A, lengths.size), min(DIST_ROWS_B, lengths.size)
    grid_a = torch.from_numpy(record_grid(stream, starts[:na], lengths[:na])).to(dev)
    grid_b = grid_a[:nb].contiguous()
    grid_all = torch.from_numpy(record_grid(stream, starts, lengths)).to(dev)
    g = rng.integers(0, 4, K2_LONG_ROWS, dtype=np.uint8)
    g[rng.random(K2_LONG_ROWS) < 0.001] = INVALID
    grid_long = torch.from_numpy(g).to(dev)
    del g
    # K2 at the four shapes it is timed at: (a), (c) (the reference
    # workload's one launch), (b) at k=8, and a few long rows (split
    # across warps).
    k2 = []
    for run, grid, k in (("(a)", grid_a, 3), ("(c)", grid_all, 3), ("(b)", grid_b, 8),
                         ("long rows", grid_long, 3)):
        S, L = grid.shape
        check("counts_matrix", histogram_cuda.counts_matrix_cuda(grid, k, 4**k),
              histogram_cuda.counts_matrix_reference(grid, k, 4**k), f"{run} k={k} [{S}, {L}]")
        bound = bound_ms(S * L + S * 4**k * 4, 0)
        k2.append(dict(
            run=run, shape=f"k={k} grid [{S}, {L}]",
            ms=time_ms(lambda: histogram_cuda.counts_matrix_cuda(grid, k, 4**k), 20),
            plain_ms=time_ms(lambda: histogram_cuda.counts_matrix_reference(grid, k, 4**k), 3),
            bound_ms=bound[0], bound_by=bound[1],
        ))
        log(f"kernel time counts_matrix {run} k={k} grid [{S}, {L}]: {k2[-1]['ms']:.4f} ms, "
            f"plain {k2[-1]['plain_ms']:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")
    del grid_long
    counts_a = histogram_cuda.counts_matrix_cuda(grid_a, 3, 64)
    counts_all = histogram_cuda.counts_matrix_cuda(grid_all, 3, 64)
    del grid_all
    nall = lengths.size
    panel = counts_all[: min(PANEL_ROWS, nall)]
    route = distance_cuda.product_route(*distance_cuda.check_counts(counts_all))
    log(f"distance counts at k=3: largest row sum "
        f"{int(counts_all.sum(1).max())}, route {route} [{card}]")
    out_a = torch.empty(na, na, dtype=torch.int32, device=dev)
    out_c = torch.empty(panel.shape[0], nall, dtype=torch.int32, device=dev)
    distance_cuda.launch_min_sum_tri(counts_a, out_a, route)
    check("min_sum_tri", out_a, distance.min_sum_matrix(counts_a),
          f"(a) {tuple(counts_a.shape)} ({route})")
    distance_cuda.launch_min_sum_rect(panel, counts_all, out_c, route)
    check("min_sum_rect", out_c, distance.min_sum_matrix(panel, counts_all),
          f"(c) {tuple(panel.shape)} x {tuple(counts_all.shape)} ({route})")

    rec = {"counts_matrix": dict(
        ms=k2[0]["ms"], plain_ms=k2[0]["plain_ms"], library_ms=None,
        bound=(k2[0]["bound_ms"], k2[0]["bound_by"]), shape=k2[0]["shape"], shapes=k2,
    )}
    del grid_a, grid_b
    af = counts_a.float()
    rec["min_sum_tri"] = dict(
        ms=time_ms(lambda: distance_cuda.launch_min_sum_tri(counts_a, out_a, route), 10),
        plain_ms=time_ms(lambda: distance.min_sum_matrix(counts_a), 2),
        library_ms=time_ms(lambda: torch.cdist(af, af, p=1), 3),
        bound=min_sum_bound([(na, na)], 64, symmetric=True),
        shape=f"[{na}, 64] ({route})",
        split=distance_cuda.product_split(na, na, 64, route, dev, True)[0],
    )
    wide_ms = time_ms(lambda: distance_cuda.launch_min_sum_tri(counts_a, out_a, "i32"), 10)
    check("min_sum_tri", out_a, distance.min_sum_matrix(counts_a), f"(a) {tuple(counts_a.shape)} (i32)")
    log(f"kernel time min_sum_tri [{na}, 64] on the i32 route: {wide_ms:.4f} ms [{card}]")
    del out_a, af
    pf, cf = panel.float(), counts_all.float()
    npn = panel.shape[0]
    rec["min_sum_rect"] = dict(
        ms=time_ms(lambda: distance_cuda.launch_min_sum_rect(panel, counts_all, out_c, route), 10),
        plain_ms=time_ms(lambda: distance.min_sum_matrix(panel, counts_all), 2),
        library_ms=time_ms(lambda: torch.cdist(pf, cf, p=1), 3),
        bound=min_sum_bound([(npn, nall)], 64),
        shape=f"[{npn}, 64] x [{nall}, 64] ({route})",
        split=distance_cuda.product_split(npn, nall, 64, route, dev, False)[0],
    )
    wide_ms = time_ms(lambda: distance_cuda.launch_min_sum_rect(panel, counts_all, out_c, "i32"), 10)
    check("min_sum_rect", out_c, distance.min_sum_matrix(panel, counts_all),
          f"(c) {tuple(panel.shape)} x {tuple(counts_all.shape)} (i32)")
    log(f"kernel time min_sum_rect [{npn}, 64] x [{nall}, 64] on the i32 route: "
        f"{wide_ms:.4f} ms [{card}]")
    del pf, cf
    len_all = torch.from_numpy(lengths.astype(np.int64)).to(dev)
    finish = [finish_shape("(c)", out_c, len_all[:npn], len_all, "(c)'s first panel")]
    for name, r in rec.items():
        r["max_abs_err"] = worst[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        split = f", {r['split']} bin slices" if "split" in r else ""
        log(f"kernel time {name} {r['shape']}{split}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, torch.cdist {lib}, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}) [{card}]")

    # K4 over every panel of one (c) run, kernel only (no CSV): each panel's
    # rows against its partner rows, into one buffer.
    panels = panel_shapes(nall, PANEL_ROWS)
    flat = out_c.view(-1)
    launches = []
    for r0, r1 in panels:
        o = flat[: (r1 - r0) * (nall - r0)].view(r1 - r0, nall - r0)
        launches.append((counts_all[r0:r1], counts_all[r0:], o))
    reset_launches()
    for a, c, o in launches:
        distance_cuda.launch_min_sum_rect(
            a, c, o, distance_cuda.product_route(*distance_cuda.check_counts(a, c)))
    torch.cuda.synchronize()
    n_launch, by_route = distance_cuda.RECT_LAUNCHES, dict(routes)
    r0, r1 = panels[-1]
    check("min_sum_rect", launches[-1][2], distance.min_sum_matrix(counts_all[r0:r1], counts_all[r0:]),
          f"(c) last panel [{r1 - r0}, 64] x [{nall - r0}, 64] ({route})")
    all_ms = time_ms(lambda: [distance_cuda.launch_min_sum_rect(a, c, o, route)
                              for a, c, o in launches], 5)
    plain_all = time_once_ms(lambda: [distance.min_sum_matrix(a, c) for a, c, _ in launches])
    lib_all = time_once_ms(lambda: [torch.cdist(a.float(), c.float(), p=1)
                                    for a, c, _ in launches])
    b_all = min_sum_bound([(a.shape[0], c.shape[0]) for a, c, _ in launches], 64)
    partners = sum(c.shape[0] for _, c, _ in launches)
    log(f"kernel time min_sum_rect over all {len(panels)} panels of (c) ({n_launch} launches, "
        f"routes {by_route}; {partners} partner rows, {partners / nall:.2f} first panels): "
        f"{all_ms:.4f} ms (first panel {rec['min_sum_rect']['ms']:.4f} ms), plain "
        f"{plain_all:.1f} ms, torch.cdist {lib_all:.1f} ms, bound {b_all[0]:.4f} ms "
        f"({b_all[1]}) [{card}]")
    del launches, flat, out_c, panel
    torch.cuda.empty_cache()

    # K3 over all records: three row tiles (first, middle, last) against the
    # plain version over all columns.
    out = torch.empty(nall, nall, dtype=torch.int32, device=dev)
    reset_launches()
    distance_cuda.launch_min_sum_tri(counts_all, out, route)
    torch.cuda.synchronize()
    by_route = dict(routes)
    for r0 in (0, (nall // 2) // 128 * 128, (nall - 1) // 128 * 128):
        r1 = min(r0 + 128, nall)
        check("min_sum_tri", out[r0:r1], distance.min_sum_matrix(counts_all[r0:r1], counts_all),
              f"[{nall}, 64] rows {r0}..{r1 - 1} ({route})")
    big_ms = time_ms(lambda: distance_cuda.launch_min_sum_tri(counts_all, out, route), 5)
    finish.insert(0, finish_shape("", out, len_all, len_all, "the triangle of all records"))
    rec["finish_upper"] = dict(finish[0], max_abs_err=0, shapes=finish)
    del out
    torch.cuda.empty_cache()
    plain_big = time_once_ms(lambda: distance.min_sum_matrix(counts_all))
    torch.cuda.empty_cache()
    # One torch.cdist(p=1) of [54018, 54018] fails to launch (invalid
    # configuration): it runs in blocks of 8,192 rows.
    cf = counts_all.float()
    lib_big = time_once_ms(lambda: [torch.cdist(cf[r : r + 8192], cf, p=1)
                                    for r in range(0, nall, 8192)])
    del cf
    torch.cuda.empty_cache()
    b_big = min_sum_bound([(nall, nall)], 64, symmetric=True)
    log(f"kernel time min_sum_tri [{nall}, 64] (1 launch, routes {by_route}): {big_ms:.4f} ms, "
        f"plain {plain_big:.1f} ms, torch.cdist in 8,192-row blocks {lib_big:.1f} ms, bound "
        f"{b_big[0]:.4f} ms ({b_big[1]}) [{card}]")
    return rec


def with_launches(shapes: list, kernel: str, launches: dict) -> list:
    """Each timed shape with the launches of ``kernel`` in the run whose
    name starts with the shape's ``run`` (0 for a shape on no path)."""
    return [{**sh, "launches": next(
        (n[kernel] for key, n in launches.items() if sh["run"] and key.startswith(sh["run"])), 0)}
        for sh in shapes]


def follow_route(want: dict, route: str | None = None, got: dict | None = None) -> dict:
    """``want`` with its K3/K4 launches moved to the threshold route where
    the run took it (the gate decides): by the ``route`` the run reports,
    else by the launch counts (``got``, or those just read)."""
    if route is None:
        taken = (read_launches() if got is None else got).get("min_sum_threshold", 0) > 0
    else:
        taken = "threshold" in route
    if not taken:
        return want
    products = {k: want[k] for k in ("min_sum_tri", "min_sum_rect") if k in want}
    out = {k: v for k, v in want.items() if k not in products}
    out["min_sum_threshold"] = sum(products.values())
    return out


def expect_launches(name: str, want: dict, got: dict | None = None) -> dict:
    """The launch counts of the run just read (or a child's, ``got``)
    against what its path implies."""
    got = read_launches() if got is None else got
    if got != want:
        raise AssertionError(f"{name}: launches {got}, the path implies {want}")
    return got


def report_run(name: str, wall: float, n_pairs: int, phases: dict, note: str, card: str) -> None:
    split = " ".join(f"{p}={s:.3f}" for p, s in phases.items())
    log(f"{name}: {n_pairs} pairs, wall {wall:.3f} s, "
        f"{n_pairs / max(wall, 1e-9) / 1e6:.2f} Mpairs/s; phases s: {split}; {note} [{card}]")


def routes_taken() -> dict:
    """K3/K4's launches of the run just read, by route."""
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

    return {r: n for r, n in distance_cuda.ROUTE_LAUNCHES.items() if n}


def check_in_memory_run(name: str, k: int, n: int, run, records, dev, card: str,
                        want: dict, keep: dict | None = None) -> dict:
    """Run ``run()`` (in-memory dense distances of the first n records)
    with the launch counts reset, expect ``want`` launches, and hold its
    counts, K3's min-sums of them and its distances to the plain
    reference. Returns the launch counts; ``keep`` (when given) receives
    the packed distances under the run's first three characters."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

    stream, starts, lengths = records
    reset_launches()
    t = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t
    launches = expect_launches(name, {**dict.fromkeys(read_launches(), 0),
                                      **follow_route(want, res.route)})
    taken = routes_taken()
    ref_counts = reference_counts(stream, starts[:n], lengths[:n], k, False, dev)
    if res.n != n or not np.array_equal(res.counts, ref_counts.cpu().numpy()):
        raise AssertionError(f"{name}: counts differ from the reference")
    counts = torch.from_numpy(res.counts).to(dev)
    ref_sums = reference_min_sums(ref_counts, ref_counts)
    if not torch.equal(distance_cuda.min_sum_tri_cuda(counts), ref_sums):
        raise AssertionError(f"{name}: K3 min-sums differ from the reference")
    want_packed = reference_packed(ref_sums.cpu().numpy(), lengths[:n], lengths[:n], k)
    if not same_bits(res.packed, want_packed):
        raise AssertionError(f"{name}: distances differ from the reference")
    report_run(name, wall, want_packed.size, res.phases,
               f"(min,+) route {res.route}, K3 routes {taken}; counts, min-sums and distances "
               "equal the reference", card)
    if keep is not None:
        keep[name[:3]] = res.packed
    del counts, ref_sums, ref_counts, res
    torch.cuda.empty_cache()
    return launches


def phase_distance_path(records, path: Path, dev, card: str, keep: dict | None = None) -> dict:
    """Runs (a), (b) and (c) of the distance path, each checked against the
    plain reference. Returns each run's launch counts; ``keep`` (when
    given) receives (a)'s packed distances and the path of (c)'s CSV, which
    is then left in place, for phase 11 to compare with."""
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
    in_memory = {"counts_matrix": 1, "min_sum_tri": 1, "finish_upper": 1}
    na, nb = min(DIST_ROWS_A, S), min(DIST_ROWS_B, S)
    name = f"(a) distance_file(k=3, max_seqs={na})"
    launches[name] = check_in_memory_run(
        name, 3, na, lambda: port.distance_file(str(path), k=3, device=dev, max_seqs=na),
        records, dev, card, in_memory, keep)
    name = f"(b) KmerEngine(k=8).distance_sequences({nb} records)"
    launches[name] = check_in_memory_run(
        name, 8, nb, lambda: KmerEngine(KmerConfig(k=8), device=dev).distance_sequences(seqs[:nb]),
        records, dev, card, in_memory)

    name = f"(c) distance_stream_to_csv(k=3, {S} records, panel_rows={PANEL_ROWS}, max_panels=1)"
    csv = path.with_suffix(".csv")
    eng = KmerEngine(KmerConfig(k=3), device=dev)
    reset_launches()
    t = time.perf_counter()
    out = eng.distance_stream_to_csv(seqs, csv, panel_rows=PANEL_ROWS, max_panels=1)
    wall = time.perf_counter() - t
    launches["(c)"] = expect_launches(
        name, {**none, **follow_route({"counts_matrix": 1, "min_sum_rect": 1, "finish_upper": 1},
                                      out["route"])})
    taken = routes_taken()
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
    report_run(name, wall, want.size, out["phases"],
               f"(min,+) route {out['route']}, K4 routes {taken}; counts, min-sums and "
               "distances equal the reference, "
               f"{csv.stat().st_size} CSV bytes, {checked} sampled lines equal %f", card)
    if keep is None:
        csv.unlink()
    else:
        keep["(c)"] = csv
    return launches


#: phase (d): reads of a seeded genome at about 30x (the union route)
READ_GENOME_BASES = 100_000
READ_COUNT = 2048
#: substitutions a read base
READ_SUB_RATE = 1 / 5000
#: k of the sparse phases (d)-(f)
SPARSE_K = 21
#: phase (d)'s streamed run: rows a panel, panels before the stop
READ_PANEL_ROWS = 256
READ_STOP_PANELS = 2
#: phase (e): the first records of the distance FASTA (the host route),
#: streamed in panels of HOST_PANEL_ROWS, killed after 2 checkpoints
HOST_RECORDS = 4096
HOST_PANEL_ROWS = 512
#: phase (f): long independent records, their tables from K1
LONG_RECORDS = 8
LONG_BASES = (4 << 20, 6_000_000)
#: phase (g): dense mid k, in memory at k=9 and streamed at k=10
MIDK_ROWS = 1024
MIDK_STREAM_ROWS = 256
#: the K3/K4 holds' widths, and the rows of their i32-route slices
WIDE_BINS = (131_072, 262_144)
WIDE_ROWS = 256
#: pairs held against numpy.intersect1d in phases (d) and (e)
PAIR_SAMPLE = 100_000
SPARSE_MAIN = "(d) union=on"
#: (d) with the threshold route off: the run that keeps K3 on (d)
SPARSE_OFF = "(d) K3, threshold=off"
MIDK_MAIN = "(g) k=9"
MIDK_STREAM = "(g) k=10 stream"
#: (g)'s k=10 stream with the threshold route off: the run that keeps K4
#: on (g)
MIDK_STREAM_OFF = "(g) K4 k=10 stream, threshold=off"


def read_set(n_reads: int, genome_bases: int, seed: int = 4):
    """Seeded reads of 1,000-2,000 bases drawn from one seeded genome, one
    base in READ_SUB_RATE substituted, as (stream, starts, lengths)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_bases, dtype=np.uint8)
    lengths = rng.integers(1000, 2001, n_reads)
    at = rng.integers(0, genome_bases - lengths + 1)
    starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]])
    stream = np.full(int(lengths.sum()) + n_reads - 1, INVALID, np.uint8)
    for s, a, n in zip(starts, at, lengths):
        stream[s : s + n] = genome[a : a + n]
    sub = (rng.random(stream.size) < READ_SUB_RATE) & (stream < 4)
    stream[sub] = (stream[sub] + rng.integers(1, 4, int(sub.sum()), dtype=np.uint8)) % 4
    return stream, starts, lengths


def long_records(n: int, lo: int, hi: int, seed: int = 5):
    """Seeded independent records of lo..hi bases (0.1% N), as (stream,
    starts, lengths)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]])
    stream = rng.integers(0, 4, int(lengths.sum()) + n - 1, dtype=np.uint8)
    stream[rng.random(stream.size) < 0.001] = INVALID
    stream[starts[1:] - 1] = INVALID
    return stream, starts, lengths


def first_records(records, n: int):
    """The first n records of (stream, starts, lengths)."""
    stream, starts, lengths = records
    end = int(starts[n - 1] + lengths[n - 1])
    return stream[:end], starts[:n], lengths[:n]


def reference_pair_tables(stream, starts, lengths, k: int, canonical: bool, dev):
    """Per-record sorted (u64 codes, i64 counts, int64 fences [S+1]), in
    plain torch on the card: every window of the stream rolled into its
    code (as ``reference_codes``), keyed by record * 4^k + code, then one
    ``torch.unique``. Shares no code with the port."""
    import numpy as np
    import torch

    S = lengths.size
    shift = 2 * k
    if S >= 1 << (63 - shift):
        raise ValueError("too many records to key by record and code")
    b = torch.from_numpy(stream).to(dev)
    first = torch.from_numpy(np.asarray(starts, np.int64)).to(dev)
    n = b.numel() - k + 1
    keys = [torch.zeros(0, dtype=torch.int64, device=dev)]
    for s in range(0, max(n, 0), REF_CHUNK):
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
        row = torch.searchsorted(first, torch.arange(s, s + m, device=dev), right=True) - 1
        keys.append(((row << shift) | code)[valid])
    keys, counts = torch.unique(torch.cat(keys), sorted=True, return_counts=True)
    offs = torch.searchsorted(keys >> shift, torch.arange(S + 1, device=dev))
    codes = keys & ((1 << shift) - 1)
    return codes.cpu().numpy().view(np.uint64), counts.cpu().numpy(), offs.cpu().numpy()


def pair_rows(idx, S: int):
    """Packed strict-upper-triangle indices -> (rows, columns)."""
    import numpy as np

    row_start = np.concatenate([[0], np.cumsum(np.arange(S - 1, 0, -1))])
    i = np.searchsorted(row_start, idx, side="right") - 1
    return i, i + 1 + (idx - row_start[i])


def reference_pair_distances(tables, lengths, k: int, idx):
    """float32 distances of the packed pairs ``idx``: each pair's min-sum by
    ``numpy.intersect1d`` of the two tables, then 1 - s / (min(L) - k + 1)
    in NumPy float32."""
    import numpy as np

    codes, counts, offs = tables
    rows, cols = pair_rows(np.asarray(idx), lengths.size)
    out = np.empty(len(rows), np.float32)
    for n, (a, b) in enumerate(zip(rows.tolist(), cols.tolist())):
        _, ia, ib = np.intersect1d(codes[offs[a] : offs[a + 1]], codes[offs[b] : offs[b + 1]],
                                   assume_unique=True, return_indices=True)
        s = np.minimum(counts[offs[a] : offs[a + 1]][ia], counts[offs[b] : offs[b + 1]][ib]).sum()
        out[n] = np.float32(1.0) - np.float32(s) / np.float32(min(lengths[a], lengths[b]) - k + 1)
    return out


def same_tables(got, want) -> bool:
    import numpy as np

    return all(np.array_equal(g, w) for g, w in zip(got, want, strict=True))


def phase_union_path(dev, card: str, tmp: Path) -> dict:
    """(d): the union route on a read set at coverage. distance_sparse_packed
    with the union route on, off and under auto (each one's CSV
    byte-identical), the streamed run over panels of READ_PANEL_ROWS
    stopped after READ_STOP_PANELS and resumed (its CSV byte-identical to
    the one-shot one), and canonical k once; sampled pairs held against
    numpy.intersect1d of the reference tables. Returns the launch counts,
    the tables, and the host two-pointer's time."""
    import numpy as np

    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.utils import io

    records = read_set(READ_COUNT, READ_GENOME_BASES)
    stream, starts, lengths = records
    seqs = record_strings(*records)
    S, k = lengths.size, SPARSE_K
    n_pairs = S * (S - 1) // 2
    none = dict.fromkeys(read_launches(), 0)
    t = time.perf_counter()
    ref = reference_pair_tables(*records, k, False, dev)
    tables = sparse_engine.build_pair_tables(seqs, k, False, dev)
    if not same_tables(tables, ref):
        raise AssertionError("(d): build_pair_tables differs from the reference tables")
    idx = np.sort(sample_lines(n_pairs, PAIR_SAMPLE))
    want = reference_pair_distances(ref, lengths, k, idx)
    log(f"(d) {S} reads of {int(lengths.min())}-{int(lengths.max())} bases from a "
        f"{READ_GENOME_BASES}-base genome ({int(lengths.sum()) / READ_GENOME_BASES:.1f}x): "
        f"{ref[0].size} table entries, {sparse_engine.sorted_unique(ref[0]).size} distinct "
        "codes; reference "
        f"tables and {idx.size} pairs by numpy.intersect1d in {time.perf_counter() - t:.1f} s "
        f"[{card}]")
    launches, csvs, host_s = {}, {}, None
    # The union route with the threshold gate's choice, and with the
    # threshold route off (K3 over the union matrix); the host route; auto.
    for union, threshold in (("on", "auto"), ("on", "off"), ("off", "auto"), ("auto", "auto")):
        name = SPARSE_OFF if (union, threshold) == ("on", "off") else f"(d) union={union}"
        info = {}
        reset_launches()
        t = time.perf_counter()
        packed = sparse_engine.distance_sparse_packed(seqs, k, device=dev, union=union,
                                                      threshold=threshold, info=info)
        wall = time.perf_counter() - t
        unioned = info["route"].startswith("union/")
        if unioned != (union != "off") and union != "auto":
            raise AssertionError(f"{name}: route {info['route']}")
        if threshold == "off" and info["route"].endswith("threshold"):
            raise AssertionError(f"{name}: route {info['route']} with the threshold route off")
        launches[name] = expect_launches(
            name, {**none, **follow_route({"min_sum_tri": int(unioned)}, info["route"])})
        if not same_bits(packed[idx], want):
            raise AssertionError(f"{name}: distances differ from the reference")
        csvs[name] = tmp / f"union_{union}_{threshold}.csv"
        io.write_distances_csv(csvs[name], packed)
        if union == "off":
            host_s = info["phases"]["min_sum"]
        predicted = (f"predicted device {info['t_dev_total']:.4f} s, host "
                     f"{info['t_host_total']:.4f} s" if "t_dev_total" in info else "no prediction")
        if "t_threshold" in info:
            predicted += (f"; threshold gate: cmax {info['threshold_cmax']}, predicted "
                          f"{info['t_threshold']:.6f} s against K3's {info['t_minplus']:.6f} s")
        report_run(f"(d) distance_sparse_packed(k={k}, {S} reads, union={union}, "
                   f"threshold={threshold})", wall, n_pairs, info["phases"],
                   f"route {info['route']} (K3 routes {routes_taken()}); union of "
                   f"{info.get('union_bins')} codes, {info.get('union_bytes')} bytes planned; "
                   f"{predicted}; {idx.size} sampled pairs equal the reference", card)
        del packed
    first = csvs["(d) union=on"].read_bytes()
    for name, path in csvs.items():
        if path.read_bytes() != first:
            raise AssertionError(f"{name}: CSV differs from union=on")
    log(f"(d) CSVs of union=on (threshold auto and off), off and auto byte-identical "
        f"({len(first)} bytes) [{card}]")

    name = f"(d) stream union=on panel_rows={READ_PANEL_ROWS}"
    csv, ckpt = tmp / "union_stream.csv", tmp / "union_stream.json"
    kw = dict(panel_rows=READ_PANEL_ROWS, checkpoint_path=ckpt, device=dev, union="on")
    reset_launches()
    t = time.perf_counter()
    leg1 = sparse_engine.distance_sparse_stream_to_csv(seqs, k, csv, max_panels=READ_STOP_PANELS, **kw)
    leg2 = sparse_engine.distance_sparse_stream_to_csv(seqs, k, csv, **kw)
    wall = time.perf_counter() - t
    n_panels = len(panel_shapes(S, READ_PANEL_ROWS))
    launches[name] = expect_launches(
        name, {**none, **follow_route({"min_sum_rect": n_panels}, leg2["route"])})
    if leg1["completed"] or not (leg2["resumed"] and leg2["completed"]):
        raise AssertionError(f"{name}: legs {leg1['completed']}, {leg2['resumed']}")
    if csv.read_bytes() != first:
        raise AssertionError(f"{name}: the resumed CSV differs from the one-shot CSV")
    report_run(f"(d) distance_sparse_stream_to_csv(k={k}, panel_rows={READ_PANEL_ROWS}, "
               f"stopped after {READ_STOP_PANELS} panels, resumed)", wall, n_pairs,
               {f"leg{i}_{p}": v for i, leg in ((1, leg1), (2, leg2))
                for p, v in leg["phases"].items()},
               f"route {leg2['route']}, {n_panels} panels (K4 routes {routes_taken()}); "
               f"CSV byte-identical to the one-shot CSV", card)
    for path in (*csvs.values(), csv, ckpt):
        path.unlink()
    one_shot_csv = first

    name = "(d) canonical"
    info = {}
    reset_launches()
    t = time.perf_counter()
    packed = sparse_engine.distance_sparse_packed(seqs, k, True, device=dev, info=info)
    wall = time.perf_counter() - t
    unioned = info["route"].startswith("union/")
    launches[name] = expect_launches(
        name, {**none, **follow_route({"min_sum_tri": int(unioned)}, info["route"])})
    ref_c = reference_pair_tables(*records, k, True, dev)
    sub = idx[: max(1, idx.size // 5)]
    if not same_bits(packed[sub], reference_pair_distances(ref_c, lengths, k, sub)):
        raise AssertionError(f"{name}: distances differ from the reference")
    report_run(f"(d) distance_sparse_packed(k={k}, canonical, {S} reads)", wall, n_pairs,
               info["phases"], f"route {info['route']}; {sub.size} sampled pairs equal the "
               "reference", card)
    return {"launches": launches, "tables": tables, "host_min_sum_s": host_s, "n_pairs": n_pairs,
            "records": records, "sample": (idx, want), "csv": one_shot_csv}


#: a child that streams sparse distances with checkpoints and SIGKILLs
#: itself once its second checkpoint is published
_KILLED_DISTANCE_CHILD = r"""
import os, signal, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import sparse_engine
from dna_kmeres_parallel_tpu_torch.utils import checkpoint

root, fasta, csv, ckpt, dev, k, rows = sys.argv[1:8]
parsed = native.parse_fasta_native(fasta)
letters = np.frombuffer(b"ACGTN", np.uint8)
seqs = [letters[np.minimum(parsed.stream[o : o + n], 4)].tobytes().decode()
        for o, n in zip(parsed.offsets[:-1], parsed.lengths)]
save = checkpoint.save_json_atomic
published = []

def save_then_die(*a, **kw):
    save(*a, **kw)
    published.append(1)
    if len(published) == 2:
        os.kill(os.getpid(), signal.SIGKILL)

checkpoint.save_json_atomic = save_then_die
sparse_engine.distance_sparse_stream_to_csv(seqs, int(k), csv, panel_rows=int(rows),
                                            checkpoint_path=ckpt, device=dev)
"""


def phase_host_path(records, dev, card: str, tmp: Path) -> dict:
    """(e): the host route on the first HOST_RECORDS records of the distance
    FASTA at k=21, streamed to CSV: a child killed after its second
    checkpoint, then resumed here. The CSV's line count, a sample of
    PAIR_SAMPLE lines and every line of the first resumed panel against
    numpy.intersect1d of the reference tables. Returns the launch
    counts."""
    import numpy as np

    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.utils import checkpoint

    records = first_records(records, min(HOST_RECORDS, records[2].size))
    stream, starts, lengths = records
    S, k = lengths.size, SPARSE_K
    n_pairs = S * (S - 1) // 2
    seqs = record_strings(*records)
    fasta, csv, ckpt = tmp / "host.fasta", tmp / "host.csv", tmp / "host.json"
    write_fasta(fasta, *records)
    t = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", _KILLED_DISTANCE_CHILD, str(ROOT), str(fasta), str(csv), str(ckpt),
         str(dev), str(k), str(HOST_PANEL_ROWS)],
        capture_output=True, text=True, timeout=600,
    )
    child_s = time.perf_counter() - t
    if child.returncode != -9:
        raise AssertionError(f"(e): child exited {child.returncode}: {child.stderr[-2000:]}")
    durable = checkpoint.load_json(ckpt)
    name = "(e) resumed"
    info = {}
    reset_launches()
    t = time.perf_counter()
    out = sparse_engine.distance_sparse_stream_to_csv(
        seqs, k, csv, panel_rows=HOST_PANEL_ROWS, checkpoint_path=ckpt, device=dev, info=info)
    wall = time.perf_counter() - t
    launches = {name: expect_launches(name, dict.fromkeys(read_launches(), 0))}
    if info["route"] != "host/sparse" or not (out["resumed"] and out["completed"]):
        raise AssertionError(f"{name}: route {info['route']}, report {out}")
    t = time.perf_counter()
    ref = reference_pair_tables(*records, k, False, dev)
    resumed = np.arange(durable["n_pairs"], min(durable["n_pairs"] + 20_000, n_pairs))
    idx = np.unique(np.concatenate([sample_lines(n_pairs, PAIR_SAMPLE), resumed]))
    checked = check_csv_lines(csv, n_pairs, idx, reference_pair_distances(ref, lengths, k, idx))
    done = n_pairs - durable["n_pairs"]
    report_run(f"(e) distance_sparse_stream_to_csv(k={k}, {S} records, panel_rows="
               f"{HOST_PANEL_ROWS}) resumed at row {durable['next_r0']}", wall, done,
               out["phases"],
               f"route {info['route']}, union of {info.get('union_bins')} codes "
               f"({info.get('union_bytes')} bytes) declined; child killed after 2 checkpoints "
               f"({durable['n_pairs']} pairs durable) in {child_s:.1f} s; {n_pairs} lines, "
               f"{checked} sampled and resumed lines equal the reference "
               f"(checked in {time.perf_counter() - t:.1f} s)", card)
    for path in (fasta, csv, ckpt):
        path.unlink()
    return launches


def phase_long_path(dev, card: str) -> dict:
    """(f): LONG_RECORDS independent records of LONG_BASES at k=21, whose
    tables come from SparseKmerEngine (K1 on the card, one batch a record)
    and whose union the auto plan declines: the host route. The tables
    and all pairs against the plain reference. Returns the launch
    counts."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch.models import sparse_engine

    records = long_records(LONG_RECORDS, *LONG_BASES)
    stream, starts, lengths = records
    S, k = lengths.size, SPARSE_K
    seqs = record_strings(*records)
    name = "(f) long records"
    info = {}
    reset_launches()
    t = time.perf_counter()
    packed = sparse_engine.distance_sparse_packed(seqs, k, device=dev, info=info)
    wall = time.perf_counter() - t
    launches = {name: expect_launches(
        name, {**dict.fromkeys(read_launches(), 0), "encode_packed": S})}
    if info["route"] != "host/sparse":
        raise AssertionError(f"{name}: route {info['route']}, the union is over the budget")
    if dev.type == "cuda" and info["union_bytes"] <= sparse_engine.UNION_DIST_BUDGET:
        raise AssertionError(f"{name}: union of {info['union_bytes']} bytes within the budget")
    ref = reference_pair_tables(*records, k, False, dev)
    if not same_tables(sparse_engine.build_pair_tables(seqs, k, False, dev), ref):
        raise AssertionError(f"{name}: tables differ from the reference tables")
    # Each pair's min-sum: the codes of one table looked up in the other
    # (torch.searchsorted on the card; numpy.intersect1d would take a
    # second a pair of 5 Mbase tables).
    codes = torch.from_numpy(ref[0].view(np.int64)).to(dev)
    counts = torch.from_numpy(ref[1]).to(dev)
    offs = ref[2].tolist()
    want = np.empty(S * (S - 1) // 2, np.float32)
    w = 0
    for a in range(S - 1):
        ca, na = codes[offs[a] : offs[a + 1]], counts[offs[a] : offs[a + 1]]
        for b in range(a + 1, S):
            cb, nb = codes[offs[b] : offs[b + 1]], counts[offs[b] : offs[b + 1]]
            pos = torch.searchsorted(cb, ca).clamp(max=max(cb.numel() - 1, 0))
            hit = cb[pos] == ca if cb.numel() else torch.zeros_like(ca, dtype=torch.bool)
            s = int(torch.minimum(na[hit], nb[pos[hit]]).sum()) if cb.numel() else 0
            want[w] = np.float32(1.0) - np.float32(s) / np.float32(
                min(lengths[a], lengths[b]) - k + 1)
            w += 1
    if not same_bits(packed, want):
        raise AssertionError(f"{name}: distances differ from the reference")
    report_run(f"(f) distance_sparse_packed(k={k}, {S} records of {int(lengths.min())}-"
               f"{int(lengths.max())} bases)", wall, want.size, info["phases"],
               f"route {info['route']}: union of {info.get('union_bins')} codes, "
               f"{info.get('union_bytes')} bytes, declined; {S} K1 launches; tables and every "
               "pair equal the reference", card)
    return launches


def phase_midk_path(records, dev, card: str, tmp: Path) -> dict:
    """(g): dense mid k. KmerEngine(k=9).distance_sequences on the first
    MIDK_ROWS distance records (K2's global route, then K3 at 4^9 bins or
    the threshold route, as the gate decides) and distance_stream_to_csv
    at k=10 on the first MIDK_STREAM_ROWS (K2's global route, the gate's
    route), and again with the threshold route off (K4 at 4^10 bins; the
    two CSVs byte-identical), each against the plain reference. Returns
    the launch counts."""
    import torch

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

    stream, starts, lengths = records
    n = min(MIDK_ROWS, lengths.size)
    seqs = record_strings(*first_records(records, n))
    launches = {MIDK_MAIN: check_in_memory_run(
        f"{MIDK_MAIN}: KmerEngine(k=9).distance_sequences({n} records)", 9, n,
        lambda: KmerEngine(KmerConfig(k=9), device=dev).distance_sequences(seqs),
        records, dev, card, {"counts_matrix": 1, "counts_matrix_global": 1, "min_sum_tri": 1,
                             "finish_upper": 1})}

    n = min(MIDK_STREAM_ROWS, lengths.size)
    ref_counts = reference_counts(stream, starts[:n], lengths[:n], 10, False, dev)
    ref_sums = reference_min_sums(ref_counts, ref_counts)
    del ref_counts
    want = reference_packed(ref_sums.cpu().numpy(), lengths[:n], lengths[:n], 10)
    csvs = {}
    # the gate's route, then the threshold route off (K4): the CSVs
    # byte-identical
    for name, threshold in ((MIDK_STREAM, "auto"), (MIDK_STREAM_OFF, "off")):
        csvs[name] = csv = tmp / f"midk_{threshold}.csv"
        reset_launches()
        t = time.perf_counter()
        out = KmerEngine(KmerConfig(k=10), device=dev, threshold=threshold
                         ).distance_stream_to_csv(seqs[:n], csv)
        wall = time.perf_counter() - t
        if threshold == "off" and out["route"] != "minplus":
            raise AssertionError(f"{name}: route {out['route']} with the threshold route off")
        launches[name] = expect_launches(name, {
            **dict.fromkeys(read_launches(), 0), **follow_route(
                {"counts_matrix": 1, "counts_matrix_global": 1, "min_sum_rect": 1,
                 "finish_upper": 1}, out["route"])})
        taken = routes_taken()
        checked = check_csv(csv, want)
        report_run(f"{name}: KmerEngine(k=10, threshold={threshold}).distance_stream_to_csv("
                   f"{n} records)", wall, want.size, out["phases"],
                   f"(min,+) route {out['route']}, K4 routes {taken}; {checked} CSV lines equal "
                   "the reference", card)
    if csvs[MIDK_STREAM].read_bytes() != csvs[MIDK_STREAM_OFF].read_bytes():
        raise AssertionError(f"{MIDK_STREAM}: the CSVs with the threshold route on and off differ")
    log(f"{MIDK_STREAM}: CSVs with the threshold route on and off byte-identical "
        f"({csvs[MIDK_STREAM].stat().st_size} bytes) [{card}]")
    for csv in csvs.values():
        csv.unlink()
    del ref_sums
    torch.cuda.empty_cache()
    return launches


def wide_counts(rows: int, B: int, kind: str, seed: int):
    """Seeded int32 [rows, B] counts of the width of a union matrix or a
    mid-k counts matrix: about 2,000 counts of 1-3 a row at random bins.
    "small": every row sums below 2^16 (the u16x2 route); "wide": row 0
    holds 16,384 counts of 4, summing to 65,536 (the i32 route)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c = np.zeros((rows, B), np.int32)
    hot = rng.integers(0, B, (rows, 2000))
    c[np.arange(rows)[:, None], hot] = rng.integers(1, 4, (rows, 2000))
    if kind == "wide":
        c[0] = 0
        c[0, rng.choice(B, 16_384, replace=False)] = 4
    return c


def phase_wide_kernels(dev, card: str, records, union_tables) -> dict:
    """K2's global route, and K3/K4 at the widths of phases (d) and (g),
    against their plain versions on the card (max_abs_err 0), each timed
    at the path's shape beside its plain version, ``torch.cdist(p=1)`` and
    its bound: K2 at (g)'s grids (k=9 and 10), on an edge grid (N runs,
    rows shorter than k, canonical) and on 8 rows of 4 Mbase (split into
    parts); K3 and K4 on (d)'s [2048, 131,072] union matrix and (g)'s
    [1024, 4^9] counts (u16x2), and on slices of WIDE_ROWS rows whose row
    sums reach 2^16 (i32); K4 on (g) k=10's own [256, 4^10] panel.
    Returns the records by kernel."""
    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda, histogram_cuda

    worst = {"counts_matrix_global": 0, "min_sum_tri": 0, "min_sum_rect": 0}

    def check(name, got, ref, what):
        torch.cuda.synchronize()
        err = max_abs_err((got,), (ref,))
        log(f"kernel check {name} {what}: max_abs_err={err} [{card}]")
        worst[name] = max(worst[name], err)
        if err:
            raise AssertionError(f"{name} disagrees with plain at {what}")

    rng = np.random.default_rng(6)
    g = rng.integers(0, 4, (300, 2000)).astype(np.uint8)
    g[rng.random(g.shape) < 0.01] = INVALID
    g[:30, 100:400] = INVALID
    for r, n in enumerate(rng.integers(0, 2001, 300)):
        g[r, n if r % 7 else r % 11 :] = INVALID
    for k, rows in ((9, 300), (10, 300), (12, 16)):  # k=12: 64 MiB of counts a row
        grid = torch.from_numpy(g[:rows]).to(dev)
        for canonical in (False, True):
            check("counts_matrix_global",
                  histogram_cuda.counts_matrix_cuda(grid, k, 4**k, canonical),
                  histogram_cuda.counts_matrix_reference(grid, k, 4**k, canonical),
                  f"k={k} canonical={canonical} grid {tuple(grid.shape)}")
        del grid
        torch.cuda.empty_cache()
    g = rng.integers(0, 4, K2_LONG_ROWS, dtype=np.uint8)
    g[rng.random(K2_LONG_ROWS) < 0.001] = INVALID
    grid = torch.from_numpy(g).to(dev)
    check("counts_matrix_global", histogram_cuda.counts_matrix_cuda(grid, 9, 4**9),
          histogram_cuda.counts_matrix_reference(grid, 9, 4**9), f"k=9 long rows {K2_LONG_ROWS}")
    del grid, g
    stream, starts, lengths = records
    shapes = {"counts_matrix_global": [], "min_sum_tri": [], "min_sum_rect": []}
    mats = {}
    for run, k, n in ((MIDK_MAIN, 9, MIDK_ROWS), (MIDK_STREAM, 10, MIDK_STREAM_ROWS)):
        sub = first_records(records, min(n, lengths.size))
        grid = torch.from_numpy(record_grid(*sub)).to(dev)
        S, L = grid.shape
        got = histogram_cuda.counts_matrix_cuda(grid, k, 4**k)
        check("counts_matrix_global", got, histogram_cuda.counts_matrix_reference(grid, k, 4**k),
              f"{run} grid [{S}, {L}]")
        mats[run] = got
        bound = bound_ms(S * L + S * 4**k * 4, 0)
        shapes["counts_matrix_global"].append(dict(
            run=run, shape=f"k={k} grid [{S}, {L}]",
            ms=time_ms(lambda: histogram_cuda.counts_matrix_cuda(grid, k, 4**k), 10),
            plain_ms=time_ms(lambda: histogram_cuda.counts_matrix_reference(grid, k, 4**k), 2),
            library_ms=None, bound_ms=bound[0], bound_by=bound[1]))
        del grid, got
        torch.cuda.empty_cache()

    codes, cnts, offs = union_tables
    plan = sparse_engine.union_dense_plan(codes, cnts, offs, device=dev, union="on")
    mats[SPARSE_MAIN] = sparse_engine.union_on_device(codes, cnts, offs, plan, dev)
    rates, plain, kept = {}, {}, {}
    # K3's and K4's runs on a path: (d) with the threshold route off, and
    # (g)'s k=9 run (as its gate decides); (d)'s stream and (g)'s k=10
    # stream with the threshold route off, whose one panel is its whole
    # [256, 4^10] matrix; (g) k=10 has no K3 and no hold.
    tri_runs = {SPARSE_MAIN: SPARSE_OFF, MIDK_MAIN: MIDK_MAIN}
    panel_runs = {SPARSE_MAIN: "(d) stream", MIDK_STREAM: MIDK_STREAM_OFF}
    for run, mat in mats.items():
        S, B = mat.shape
        kinds = [("path", mat)]
        if run != MIDK_STREAM:
            kinds.append(("wide", torch.from_numpy(wide_counts(WIDE_ROWS, B, "wide", B)).to(dev)))
        for kind, a in kinds:
            rows = a.shape[0]
            if run != MIDK_STREAM:
                route = distance_cuda.product_route(*distance_cuda.check_counts(a))
                out = torch.empty(rows, rows, dtype=torch.int32, device=dev)
                distance_cuda.launch_min_sum_tri(a, out, route)
                plain_ms = time_once_ms(lambda: plain.__setitem__(0, distance.min_sum_matrix(a)))
                if kind == "path":
                    kept[run, "tri"] = plain[0]
                check("min_sum_tri", out, plain.pop(0), f"[{rows}, {B}] ({route})")
                ms = time_ms(lambda: distance_cuda.launch_min_sum_tri(a, out, route), 3)
                af = a.float()
                bound = min_sum_bound([(rows, rows)], B, symmetric=True)
                shapes["min_sum_tri"].append(dict(
                    run=tri_runs[run] if kind == "path" else None,
                    shape=f"[{rows}, {B}] ({route})",
                    split=distance_cuda.product_split(rows, rows, B, route, dev, True)[0],
                    ms=ms, plain_ms=plain_ms,
                    library_ms=time_once_ms(lambda: torch.cdist(af, af, p=1)),
                    bound_ms=bound[0], bound_by=bound[1]))
                if kind == "path":
                    # K3's rate in the gates' own terms: rows (rows - 1) / 2
                    # pairs of B bins in the measured time
                    rates[run] = rows * (rows - 1) / 2 * B / (ms / 1e3)
                del out, af
            # K4: the first panel of a stream over these rows.
            p = a[: min(READ_PANEL_ROWS, rows)]
            route = distance_cuda.product_route(*distance_cuda.check_counts(p, a))
            out = torch.empty(p.shape[0], rows, dtype=torch.int32, device=dev)
            distance_cuda.launch_min_sum_rect(p, a, out, route)
            plain_ms = time_once_ms(lambda: plain.__setitem__(0, distance.min_sum_matrix(p, a)))
            if kind == "path":
                kept[run, "rect"] = plain[0]
            check("min_sum_rect", out, plain.pop(0),
                  f"[{p.shape[0]}, {B}] x [{rows}, {B}] ({route})")
            pf, cf = p.float(), a.float()
            bound = min_sum_bound([(p.shape[0], rows)], B)
            shapes["min_sum_rect"].append(dict(
                run=panel_runs.get(run) if kind == "path" else None,
                shape=f"[{p.shape[0]}, {B}] x [{rows}, {B}] ({route})",
                split=distance_cuda.product_split(p.shape[0], rows, B, route, dev, False)[0],
                ms=time_ms(lambda: distance_cuda.launch_min_sum_rect(p, a, out, route), 3),
                plain_ms=plain_ms, library_ms=time_once_ms(lambda: torch.cdist(pf, cf, p=1)),
                bound_ms=bound[0], bound_by=bound[1]))
            del out, pf, cf, p, a
            torch.cuda.empty_cache()
    for name, recs in shapes.items():
        for r in recs:
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            split = f", {r['split']} bin slices" if "split" in r else ""
            log(f"kernel time {name} {r['shape']}{split}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.3f} ms, torch.cdist {lib}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}) [{card}]")
    torch.cuda.empty_cache()
    # the path's matrices and their plain products stay for the threshold
    # phase (phase_threshold)
    return {"shapes": shapes, "max_abs_err": worst, "tri_bin_pairs_per_sec": rates,
            "mats": mats, "plain": kept, "union_plan": plan}


def measure_gate_rates(dev, card: str, host_min_sum_s: float, union_tables, tri_rates: dict) -> dict:
    """The rates the distance gates read (sparse_engine.DistanceRates), on
    this card and host, measured by ``ops/calibrate`` (what ``kmer-gpu
    calibrate`` persists): pinned H2D and D2H of 256 MiB, a tiny K3 job's
    round trip, K3's bin-pairs a second at a dense [1024, 4^9] counts
    matrix and at a [2048, 131,072] union matrix, and the two-pointer's
    entry-pairs a second a thread. Printed beside the same rates read off
    this run's phases: K3 at (d)'s union matrix and (g)'s counts
    (``phase_wide_kernels``) and the two-pointer over (d)'s tables."""
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.ops import calibrate

    codes, cnts, offs = union_tables
    S = offs.size - 1
    threads = sparse_engine.DistanceRates().host_threads()
    t = time.perf_counter()
    measured = calibrate.calibrate(dev)
    log(f"gate rates measured by ops/calibrate in {time.perf_counter() - t:.1f} s: "
        + json.dumps(measured) + f"; defaults {json.dumps(sparse_engine.DistanceRates().__dict__)}"
        f" [{card}]")
    phase = {
        "K3 at (d)": tri_rates[SPARSE_MAIN],
        "K3 at (g)": tri_rates.get(MIDK_MAIN),
        "two-pointer at (d)": S * (S - 1) / 2 * (codes.size / S) / (host_min_sum_s * threads),
    }
    log("gate rates read off this run's phases: " + json.dumps(phase) + f" [{card}]")
    return measured


#: phase 9's threshold part: Hopper's dense int8 tensor-core peak (SXM,
#: 1,979 TOPS) in multiply-adds a second, for the route's bound; and how
#: far apart the route's and K3/K4's measured times must be before the
#: gate is held to the faster one
INT8_MACS_PER_S = 9.9e14
GATE_MARGIN = 1.5


def threshold_bound(rows: int, cols: int, B: int, cmax: int, symmetric: bool) -> tuple[float, str]:
    """The least time of the threshold route over [rows, B] x [cols, B]
    at ``cmax`` thresholds: the larger of its int8 multiply-adds (the
    whole rectangle, rows x cols x B x cmax) over the tensor cores' peak
    and its bytes (the int32 counts read, the int8 planes written and
    read, the int32 product written) over the memory rate."""
    sides = rows if symmetric else rows + cols
    n_bytes = sides * B * 4 + 2 * sides * B * cmax + rows * cols * 4
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = rows * cols * B * cmax / INT8_MACS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def host_ms(fn, iters: int) -> float:
    """Mean host-clock milliseconds per call after one warm-up (the CPU's
    stand-in for ``time_ms``)."""
    fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def threshold_case(name: str, a, other, minplus, choose, *, minplus_ms=None, cdist_ms=None,
                   plain=None) -> dict:
    """One shape of the threshold phase: counts ``a`` against ``other``
    (None: the symmetric product), ``minplus()`` the K3/K4 product the
    route displaces there, ``choose(rates)`` the gate's choice under
    ``rates`` (the bucket, or None for K3/K4), and what the run measured
    already: K3/K4's and ``torch.cdist(p=1)``'s milliseconds and the plain
    product (each measured or computed here when None)."""
    return dict(name=name, a=a, other=other, minplus=minplus, choose=choose,
                minplus_ms=minplus_ms, cdist_ms=cdist_ms, plain=plain)


def phase_threshold(dev, card: str, cases: list, rates, defaults, hold_gate: bool = True) -> list:
    """The threshold route at the distance path's shapes: for each case
    the route (``threshold_cuda.min_sum_matrix_threshold`` at the bucket
    of the largest count) held to K3/K4 and to the plain product
    (max_abs_err 0), timed whole and its planes alone (CUDA events; the
    host clock on the CPU) beside K3/K4, ``torch.cdist(p=1)`` and its
    bound, with the gate's choice under the calibrated ``rates`` and
    under the ``defaults``. On the card (and with ``hold_gate``) the
    calibrated gate must take the measured faster route wherever the two
    times differ by GATE_MARGIN or more. Returns each case's record."""
    import torch

    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.ops import distance, threshold_cuda

    on_card = dev.type == "cuda"
    timer = time_ms if on_card else host_ms
    once = time_once_ms if on_card else (lambda fn: host_ms(fn, 1))
    records = []
    t_phase = time.perf_counter()
    for case in cases:
        a, other, name = case["a"], case["other"], case["name"]
        cmax, _ = sparse_engine.counts_extent(a)
        if other is not None:
            cmax = max(cmax, sparse_engine.counts_extent(other)[0])
        bucket = 1 << max(cmax - 1, 0).bit_length()
        rows, B = a.shape
        cols = rows if other is None else other.shape[0]
        reset_launches()
        got = threshold_cuda.min_sum_matrix_threshold(a, bucket, other)
        launched = dict(read_launches())
        gemms = threshold_cuda.GEMM_LAUNCHES
        ref = case["minplus"]()
        plain = case["plain"]
        if plain is None:
            plain = distance.min_sum_matrix(a, other)
        err = max(max_abs_err((got,), (ref,)), max_abs_err((got,), (plain,)))
        if err:
            raise AssertionError(f"threshold {name}: max_abs_err {err} against K3/K4 and plain")
        if on_card and launched["min_sum_threshold"] != 1:
            raise AssertionError(f"threshold {name}: launches {launched}")
        del got, ref, plain
        budget = threshold_cuda.default_budget(a, other)
        chunks = threshold_cuda.plane_chunks(rows, None if other is None else cols, B, bucket,
                                             budget)

        def planes():
            for c in chunks:
                threshold_cuda.build_planes(a, *c)
                if other is not None:
                    threshold_cuda.build_planes(other, *c)

        route_ms = timer(lambda: threshold_cuda.min_sum_matrix_threshold(a, bucket, other), 5)
        planes_ms = timer(planes, 5)
        minplus_ms = case["minplus_ms"]
        if minplus_ms is None:
            minplus_ms = timer(case["minplus"], 3)
        cdist_ms = case["cdist_ms"]
        if cdist_ms is None:
            af = a.float()
            of = af if other is None else other.float()
            cdist_ms = once(lambda: torch.cdist(af, of, p=1))
            del af, of
        bound = threshold_bound(rows, cols, B, bucket, other is None)
        chosen = case["choose"](rates)
        default = case["choose"](defaults)
        faster = "threshold" if route_ms < minplus_ms else "minplus"
        pick = "minplus" if chosen is None else "threshold"
        apart = max(route_ms, minplus_ms) / max(min(route_ms, minplus_ms), 1e-9)
        rec = dict(shape=name, dims=[rows, cols, B], cmax=cmax, bucket=bucket, gemms=gemms,
                   ms=route_ms, planes_ms=planes_ms, minplus_ms=minplus_ms, cdist_ms=cdist_ms,
                   bound_ms=bound[0], bound_by=bound[1], gate=pick,
                   gate_defaults="minplus" if default is None else "threshold",
                   faster=faster, max_abs_err=err)
        records.append(rec)
        log(f"threshold {name} [{rows}, {B}] x [{cols}, {B}], cmax {cmax} (bucket {bucket}, "
            f"{gemms} GEMMs): route {route_ms:.4f} ms (planes {planes_ms:.4f} ms), K3/K4 "
            f"{minplus_ms:.4f} ms, torch.cdist {cdist_ms:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}); max_abs_err {err} against K3/K4 and plain; gate: {pick} "
            f"(calibrated), {rec['gate_defaults']} (defaults); measured faster: {faster} "
            f"[{card}]")
        if hold_gate and on_card and pick != faster and apart >= GATE_MARGIN:
            raise AssertionError(f"threshold {name}: the calibrated gate takes {pick}, but "
                                 f"{faster} measured {apart:.2f}x faster")
        if on_card:
            torch.cuda.empty_cache()
    log("threshold route records: " + json.dumps(records))
    log(f"phase 9 threshold route at {len(records)} shapes in "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return records


def threshold_cases(records, dist: dict, wide: dict, union_tables, dev) -> list:
    """The threshold phase's shapes, from the matrices the run built: (a)
    the first DIST_ROWS_A distance records' k=3 counts and (b) the first
    DIST_ROWS_B's k=8 counts (K2, built again here; K3's and cdist's time
    at (a) from phase 5), (d)'s union matrix (its real [S, D] part), (g)'s
    k=9 counts and (g) k=10's own panel (``phase_wide_kernels``' matrices,
    plain products and times). Each gate choice is the one the path's own
    entry makes: the dense engine's (symmetric one-shot, or a panel of
    distance_stream_to_csv's 2,048 rows) or the union plan's."""
    import torch

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda, histogram_cuda

    lengths = records[2]

    def counts(n: int, k: int):
        sub = first_records(records, min(n, lengths.size))
        grid = torch.from_numpy(record_grid(*sub)).to(dev)
        return histogram_cuda.counts_matrix_grid(grid, k, 4**k)

    def engine_choice(k: int, c, rows: int, symmetric: bool):
        return lambda rates: KmerEngine(KmerConfig(k=k), device=dev, rates=rates
                                        )._threshold_cmax(c, rows, symmetric)

    def union_choice(rates):
        plan = sparse_engine.union_dense_plan(*union_tables, device=dev, union="on", rates=rates)
        return plan["cmax"] if plan is not None and plan["impl"] == "threshold" else None

    def timed_at(kernel: str, run: str) -> dict:
        return next(r for r in wide["shapes"][kernel] if r["run"] == run)

    mats, kept, plan = wide["mats"], wide["plain"], wide["union_plan"]
    ca, cb = counts(DIST_ROWS_A, 3), counts(DIST_ROWS_B, 8)
    S = union_tables[2].size - 1
    cd = mats[SPARSE_MAIN][:S, : plan["D"]]
    c9, c10 = mats[MIDK_MAIN], mats[MIDK_STREAM]
    p10 = c10[: min(READ_PANEL_ROWS, c10.shape[0])]
    d_k3, g_k3 = timed_at("min_sum_tri", SPARSE_OFF), timed_at("min_sum_tri", MIDK_MAIN)
    g_k4 = timed_at("min_sum_rect", MIDK_STREAM_OFF)
    return [
        threshold_case("(a)", ca, None, lambda: distance_cuda.min_sum_matrix_tri(ca),
                       engine_choice(3, ca, ca.shape[0], True),
                       minplus_ms=dist["min_sum_tri"]["ms"],
                       cdist_ms=dist["min_sum_tri"]["library_ms"]),
        threshold_case("(b)", cb, None, lambda: distance_cuda.min_sum_matrix_tri(cb),
                       engine_choice(8, cb, cb.shape[0], True)),
        threshold_case("(d)", cd, None,
                       lambda: distance_cuda.min_sum_matrix_tri(mats[SPARSE_MAIN])[:S, :S],
                       union_choice, minplus_ms=d_k3["ms"], cdist_ms=d_k3["library_ms"],
                       plain=kept[SPARSE_MAIN, "tri"][:S, :S]),
        threshold_case("(g) k=9", c9, None, lambda: distance_cuda.min_sum_matrix_tri(c9),
                       engine_choice(9, c9, c9.shape[0], True), minplus_ms=g_k3["ms"],
                       cdist_ms=g_k3["library_ms"], plain=kept[MIDK_MAIN, "tri"]),
        threshold_case("(g) k=10 panel", p10, c10,
                       lambda: distance_cuda.min_sum_matrix_rect(p10, c10),
                       engine_choice(10, c10, min(PANEL_ROWS, c10.shape[0]), False),
                       minplus_ms=g_k4["ms"], cdist_ms=g_k4["library_ms"],
                       plain=kept[MIDK_STREAM, "rect"]),
    ]


#: phase 10: kmer-gpu on the card. Distance records of the k=3 run, rows a
#: streamed panel and panels before the stop, records of the selftest
#: file, records of the stream (about 36 Mbase: three 16 Mbase batches)
#: and bases between its checkpoints, the bench's bases and batch, and the
#: table lines held against the reference
CLI_DIST_ROWS = 2048
CLI_PANEL_ROWS = 256
CLI_STOP_PANELS = 2
CLI_SELFTEST_ROWS = 32
CLI_STREAM_ROWS = 24_000
CLI_STREAM_EVERY = "16M"
CLI_BENCH = ("256M", "16M")
CLI_TABLE_SAMPLE = 100_000
CLI_MAIN = "kmer-gpu count --k 21"


def run_cli(argv) -> tuple[dict, float]:
    """``kmer-gpu argv`` in this process (``cli.main``): its JSON report
    (the last line it prints) and its wall. A nonzero exit code fails."""
    import contextlib
    import io

    from dna_kmeres_parallel_tpu_torch import cli

    argv = [str(a) for a in argv]
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"kmer-gpu {' '.join(argv)}: exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), wall


def same_file(a: Path, b: Path) -> bool:
    """Whether two files hold the same bytes, read in 64 MiB blocks."""
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while block := fa.read(64 << 20):
            if block != fb.read(len(block)):
                return False
    return True


def kmer_of(code: int, k: int) -> str:
    return "".join("ACGT"[(code >> (2 * (k - 1 - t))) & 3] for t in range(k))


def check_table_csv(path: Path, k: int, codes, counts, n_sample: int) -> int:
    """A ``kmer,count`` CSV against a reference table: its size is the
    header plus every line's, and ``n_sample`` seeded lines, found by
    their offsets, equal the reference's k-mer and count. Returns the
    lines checked."""
    import numpy as np

    digits = np.ones(counts.size, np.int64)
    for p in range(1, len(str(int(counts.max(initial=1))))):
        digits += counts >= 10**p
    line = k + 2 + digits
    ends = 11 + np.cumsum(line)
    size = int(ends[-1]) if ends.size else 11
    if path.stat().st_size != size:
        raise AssertionError(f"{path.name}: {path.stat().st_size} bytes, the reference "
                             f"table's lines take {size}")
    data = np.memmap(path, dtype=np.uint8, mode="r")
    if data[:11].tobytes() != b"kmer,count\n":
        raise AssertionError(f"{path.name}: header {data[:11].tobytes()!r}")
    idx = np.sort(sample_lines(counts.size, n_sample))
    for i in idx.tolist():
        got = data[ends[i] - line[i] : ends[i]].tobytes()
        want = f"{kmer_of(int(codes[i]), k)},{int(counts[i])}\n".encode()
        if got != want:
            raise AssertionError(f"{path.name} line {i + 1}: {got!r} != {want!r}")
    del data
    return idx.size


def check_npz_table(path: Path, codes, counts, name: str) -> None:
    import numpy as np

    with np.load(path) as z:
        if not (np.array_equal(z["codes"], codes) and np.array_equal(z["counts"], counts)):
            raise AssertionError(f"{name}: the .npz table differs from the reference")


def phase_cli(main_fasta: Path, main_table, hists, n_batches: int, dist_fasta: Path,
              dist_records, union: dict, gate_rates: dict, dev, card: str, tmp: Path) -> dict:
    """Phase 10: ``kmer-gpu`` (``cli.main``) with ``--device`` the type of
    ``dev`` (cuda on the card), each output held against a plain
    reference or the native engine. Returns the launch counts of each
    run."""
    import os

    import numpy as np
    import torch

    import dna_kmeres_parallel_tpu_torch as port
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.models import distance_stream
    from dna_kmeres_parallel_tpu_torch.ops import calibrate

    none = dict.fromkeys(read_launches(), 0)
    on = ["--device", dev.type]  # cuda on the card, as the default
    launches = {}
    t_phase = time.perf_counter()

    # calibrate into a directory of this run; every later command reads it
    cal_dir = tmp / "cal"
    saved_cal_dir = os.environ.get("KMER_GPU_CAL_DIR")
    os.environ["KMER_GPU_CAL_DIR"] = str(cal_dir)
    try:
        report, wall = run_cli(["calibrate", *on])
        path = Path(report["calibration_file"])
        if path.parent != cal_dir or not path.exists():
            raise AssertionError(f"calibrate wrote {path}, not into {cal_dir}")
        rates = calibrate.load_rates(path)
        default = sparse_engine.DistanceRates()
        keys = ("bin_pairs_per_sec", "dense_bin_pairs_per_sec",
                "sparse_entry_pairs_per_sec_per_thread", "h2d_bytes_per_sec",
                "d2h_bytes_per_sec", "roundtrip_s", "threads")
        for key in keys:
            log(f"kmer-gpu calibrate {key}: file {getattr(rates, key)!r}, default "
                f"{getattr(default, key)!r}, phase 9 {gate_rates.get(key)!r} [{card}]")
        log(f"kmer-gpu calibrate: {path.name} in {wall:.2f} s; K3 dense at "
            f"{report['dense_shape']} {rates.dense_bin_pairs_per_sec:.4g} bin-pairs/s, at the "
            f"union shape {report['union_shape']} {rates.bin_pairs_per_sec:.4g}; two-pointer "
            f"{rates.sparse_entry_pairs_per_sec_per_thread:.4g} entry-pairs/s a thread at "
            f"{report['host_tables']} x {rates.host_threads()} threads [{card}]")
        # the router's decisions at (d) and (g), under the defaults and the file
        codes, cnts, offs = union["tables"]
        g_lengths = dist_records[2][:MIDK_ROWS]
        for label, r in (("defaults", default), ("calibrated", rates)):
            # union="on" plans past the cost gate and reports its two
            # predictions; "auto" on a card takes the cheaper
            info = {}
            sparse_engine.union_dense_plan(codes, cnts, offs, device=dev, union="on", rates=r,
                                           info=info)
            dense_g = sparse_engine.dense_distance_preferred(g_lengths.size, 9, g_lengths,
                                                             rates=r)
            union_d = ("declined by the budget" if "t_dev_total" not in info else
                       f"{'union' if info['t_dev_total'] < info['t_host_total'] else 'host'} "
                       f"(predicted card {info['t_dev_total']:.4f} s, host "
                       f"{info['t_host_total']:.4f} s)")
            log(f"router, {label}: (d) k={SPARSE_K} sparse tables, auto route {union_d}; "
                f"(g) k=9 {g_lengths.size} records "
                f"{'dense' if dense_g else 'sparse'} (dense {4**9 / r.dense_bin_pairs_per_sec:.3e}"
                f" s a pair) [{card}]")

        # count --k 21 on the main path's FASTA, beside count_file
        main_codes, main_counts = main_table
        t = time.perf_counter()
        res = port.count_file(str(main_fasta), k=21, device=dev)
        lib_wall = time.perf_counter() - t
        if not (np.array_equal(res.codes, main_codes) and np.array_equal(res.counts, main_counts)):
            raise AssertionError("count_file(k=21): table differs from the reference")
        lib_parse = res.phases["parse"]
        del res
        npz = tmp / "cli21.npz"
        reset_launches()
        report, wall = run_cli(["count", *on, "--k", 21, main_fasta, "-o", npz])
        launches[CLI_MAIN] = expect_launches(CLI_MAIN, {**none, "encode_packed": n_batches})
        check_npz_table(npz, main_codes, main_counts, CLI_MAIN)
        if report["distinct_kmers"] != main_codes.size or report["engine"] != "gpu/sparse":
            raise AssertionError(f"{CLI_MAIN}: report {report}")
        log(f"{CLI_MAIN} -o .npz: wall {wall:.3f} s (count {report['elapsed_s']:.3f} s, parse "
            f"and write {wall - report['elapsed_s']:.3f} s; {npz.stat().st_size} bytes) against "
            f"count_file(k=21) {lib_wall:.3f} s (parse {lib_parse:.3f} s); table equal to the "
            f"reference; {n_batches} K1 launches [{card}]")
        npz.unlink()
        csv = tmp / "cli21.csv"
        reset_launches()
        report, wall = run_cli(["count", *on, "--k", 21, main_fasta, "-o", csv])
        expect_launches(f"{CLI_MAIN} -o .csv", {**none, "encode_packed": n_batches})
        checked = check_table_csv(csv, 21, main_codes, main_counts, CLI_TABLE_SAMPLE)
        log(f"{CLI_MAIN} -o .csv: wall {wall:.3f} s (count {report['elapsed_s']:.3f} s); "
            f"{csv.stat().st_size} bytes, {checked} sampled lines and the size equal the "
            f"reference's [{card}]")
        native_csv = tmp / "cli21_native.csv"
        reset_launches()
        report, wall = run_cli(["count", "--k", 21, "--engine", "native", main_fasta, "-o",
                                native_csv])
        expect_launches("kmer-gpu count --engine native", none)
        if not same_file(csv, native_csv):
            raise AssertionError("count --engine native: CSV differs from the gpu engine's")
        csv.unlink()
        native_csv.unlink()
        log(f"kmer-gpu count --k 21 --engine native -o .csv: wall {wall:.3f} s (count "
            f"{report['elapsed_s']:.3f} s); byte-identical to the gpu engine's CSV [{card}]")
        del main_codes, main_counts

        # dense counts against phase 4's histograms
        for name, k, canonical, kernel in (("kmer-gpu count --k 3", 3, False, "hist_packed_small"),
                                           ("kmer-gpu count --k 8 --canonical", 8, True,
                                            "hist_planes")):
            out = tmp / f"dense{k}.npz"
            reset_launches()
            report, wall = run_cli(["count", *on, "--k", k, *(["--canonical"] if canonical else []),
                                    main_fasta, "-o", out])
            launches[name] = expect_launches(name, {**none, kernel: n_batches})
            with np.load(out) as z:
                if not np.array_equal(z["hist"], hists[k, canonical]):
                    raise AssertionError(f"{name}: histogram differs from the reference")
            out.unlink()
            log(f"{name} -o .npz: wall {wall:.3f} s (count {report['elapsed_s']:.3f} s); "
                f"histogram equal to the reference [{card}]")

        # distances: k=3 on the first records, k=21 on (d)'s reads, and a
        # streamed k=3 run stopped and resumed
        stream, starts, lengths = dist_records
        n = min(CLI_DIST_ROWS, lengths.size)
        ref_counts = reference_counts(stream, starts[:n], lengths[:n], 3, False, dev)
        want = reference_packed(reference_min_sums(ref_counts, ref_counts).cpu().numpy(),
                                lengths[:n], lengths[:n], 3)
        del ref_counts
        one_shot = tmp / "cli_d3.csv"
        name = "kmer-gpu distance --k 3"
        reset_launches()
        report, wall = run_cli(["distance", *on, "--k", 3, "--max-seqs", n, dist_fasta, "-o",
                                one_shot])
        launches[name] = expect_launches(
            name, {**none, **follow_route({"counts_matrix": 1, "min_sum_tri": 1,
                                           "finish_upper": 1})})
        checked = check_csv(one_shot, want)
        log(f"{name} ({n} records): wall {wall:.3f} s (distances {report['elapsed_s']:.3f} s), "
            f"engine {report['engine']}; {checked} CSV lines equal the reference [{card}]")
        name = f"kmer-gpu distance --k 3 --stream-panel {CLI_PANEL_ROWS} --checkpoint"
        csv, ckpt = tmp / "cli_d3s.csv", tmp / "cli_d3s.json"
        argv = ["distance", *on, "--k", 3, "--max-seqs", n, "--stream-panel", CLI_PANEL_ROWS,
                "--checkpoint", ckpt, dist_fasta, "-o", csv]
        writer = distance_stream.stream_panels_to_csv
        distance_stream.stream_panels_to_csv = (
            lambda *a, **kw: writer(*a, **{**kw, "max_panels": CLI_STOP_PANELS}))
        reset_launches()
        try:
            first, wall1 = run_cli(argv)
        finally:
            distance_stream.stream_panels_to_csv = writer
        second, wall2 = run_cli(argv)
        n_panels = len(panel_shapes(n, CLI_PANEL_ROWS))
        launches[name] = expect_launches(
            name, {**none, **follow_route({"counts_matrix": 2, "min_sum_rect": n_panels,
                                           "finish_upper": n_panels})})
        if first["completed"] or not (second["resumed"] and second["completed"]):
            raise AssertionError(f"{name}: legs {first}, {second}")
        if csv.read_bytes() != one_shot.read_bytes():
            raise AssertionError(f"{name}: the resumed CSV differs from the one-shot CSV")
        log(f"{name}: stopped after {CLI_STOP_PANELS} panels ({wall1:.3f} s) and resumed "
            f"({wall2:.3f} s); {n_panels} panels, launches "
            f"{ {k: c for k, c in launches[name].items() if c} }; CSV byte-identical to the "
            f"one-shot run's [{card}]")
        for p in (csv, ckpt, one_shot):
            p.unlink()
        reads = tmp / "reads.fasta"
        write_fasta(reads, *union["records"])
        idx, want = union["sample"]
        csv = tmp / "cli_d21.csv"
        name = f"kmer-gpu distance --k {SPARSE_K}"
        reset_launches()
        report, wall = run_cli(["distance", *on, "--k", SPARSE_K, reads, "-o", csv])
        unioned = report["engine"].startswith("union/")
        launches[name] = expect_launches(
            name, {**none, **follow_route({"min_sum_tri": int(unioned)}, report["engine"])})
        S = union["records"][2].size
        checked = check_csv_lines(csv, S * (S - 1) // 2, idx, want)
        log(f"{name} ((d)'s {S} reads): wall {wall:.3f} s (distances {report['elapsed_s']:.3f} "
            f"s), router: route {report['engine']}; {checked} sampled CSV lines equal the "
            f"reference [{card}]")
        csv.unlink()

        # selftest at k = 3, 8 and 21 on a small file
        small = tmp / "small.fasta"
        write_fasta(small, *first_records(dist_records, CLI_SELFTEST_ROWS))
        for k in (3, 8, SPARSE_K):
            verdict, wall = run_cli(["selftest", *on, "--k", k, small])
            log(f"kmer-gpu selftest --k {k}: rc 0, {json.dumps(verdict)} ({wall:.1f} s) [{card}]")

        # stream --k 21 with checkpoints, then merge, histo, query and info
        table = tmp / "stream21.npz"
        ckpt = tmp / "stream21.ckpt.npz"
        name = "kmer-gpu stream --k 21 --checkpoint"
        reset_launches()
        n = min(CLI_STREAM_ROWS, lengths.size)
        report, wall = run_cli(["stream", *on, "--k", 21, "--max-seqs", n, "--checkpoint", ckpt,
                                "--checkpoint-every", CLI_STREAM_EVERY, dist_fasta, "-o", table])
        launches[name] = read_launches()
        ref_codes, ref_counts = reference_table(first_records(dist_records, n)[0], 21, False, dev)
        torch.cuda.empty_cache()
        check_npz_table(table, ref_codes, ref_counts, name)
        counters = report["metrics"]["counters"]
        if counters.get("checkpoints", 0) < 1 or not ckpt.exists():
            raise AssertionError(f"{name}: {counters.get('checkpoints')} checkpoints")
        log(f"{name} ({n} records): wall {wall:.3f} s, {counters['checkpoints']} checkpoints, launches "
            f"{ {n: c for n, c in launches[name].items() if c} }; table equal to the reference "
            f"[{card}]")
        merged = tmp / "merged.npz"
        report, wall = run_cli(["merge", table, table, "-o", merged])
        check_npz_table(merged, ref_codes, 2 * ref_counts, "kmer-gpu merge")
        merged.unlink()
        log(f"kmer-gpu merge (the stream's table twice): wall {wall:.3f} s; counts doubled, "
            f"codes equal [{card}]")
        report, wall = run_cli(["histo", *on, table, "--max-count", 100])
        spectrum = np.bincount(np.minimum(ref_counts, 100), minlength=101)
        if report["spectrum_head"] != spectrum[1:11].tolist() or (
                report["distinct_kmers"], report["total_kmers"]) != (ref_codes.size,
                                                                     int(ref_counts.sum())):
            raise AssertionError(f"kmer-gpu histo: {report}")
        picks = sample_lines(ref_codes.size, 5)
        kmers = [kmer_of(int(ref_codes[i]), 21) for i in picks]
        report, _ = run_cli(["query", table, *kmers])
        if report["counts"] != {m: int(ref_counts[i]) for m, i in zip(kmers, picks)}:
            raise AssertionError(f"kmer-gpu query: {report}")
        report, _ = run_cli(["info", *on, dist_fasta])
        n_invalid = int((stream == INVALID).sum()) - lengths.size + 1
        if (report["n_seqs"], report["total_bases"], report["invalid_bases"]) != (
                lengths.size, int(lengths.sum()), n_invalid):
            raise AssertionError(f"kmer-gpu info: {report}")
        log(f"kmer-gpu histo, query ({len(kmers)} k-mers) and info: equal to the reference "
            f"[{card}]")
        for p in (table, ckpt, small, reads):
            p.unlink(missing_ok=True)
        del ref_codes, ref_counts

        # bench at k=8 and k=21
        for k in (8, 21):
            name = f"kmer-gpu bench --k {k}"
            report, wall = run_cli(["bench", *on, "--k", k, "--bases", CLI_BENCH[0], "--batch",
                                    CLI_BENCH[1]])
            if not (report["timing_valid"]
                    and report["windows_counted"] == report["windows_expected"]):
                raise AssertionError(f"{name}: {report}")
            log(f"{name}: {report['gbases_per_sec']} Gbase/s over {report['total_bases']} bases "
                f"({report.get('route', report.get('encoder'))}), windows "
                f"{report['windows_counted']} = expected [{card}]")
    finally:
        if saved_cal_dir is None:
            os.environ.pop("KMER_GPU_CAL_DIR", None)
        else:
            os.environ["KMER_GPU_CAL_DIR"] = saved_cal_dir
    log(f"phase 10 (kmer-gpu) in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


#: phase 11: the mesh and super-k-mer routes. Shards of the local mesh on
#: the card, and of the second mesh of the distance runs (not a divisor of
#: their row counts); records of the super-k-mer runs (the main path's
#: first records, about 64 Mbase) and the batch of their 'auto' run;
#: records of the command-line counts and distances
MESH_D = 4
MESH_D_ODD = 3
SUPER_RECORDS = 256
SUPER_AUTO_BATCH = 4 << 20
CLI_MESH_ROWS = 24_000
MESH_MAIN = f"StreamingCounter(k=21, mesh_shape=({MESH_D},))"


def phase_mesh_count(records, path: Path, dev, card: str, refs: dict) -> dict:
    """Phase 11, counting: ``StreamingCounter`` over a ``LocalMesh`` of
    MESH_D shards of the card on the main path's FASTA (k=21 through K1 and
    through K9, canonical k=11 with ``device_sort`` and ``pallas_sort``
    through K1 and K11, dense k=3 through K7 and canonical k=8 through K6),
    ``count_sharded`` at 3,000 bins (K8), dense k=8 with a checkpoint
    every STREAM_CKPT_BASES bases on the mesh, a child on the mesh killed
    after its second checkpoint and resumed on one device; then
    ``compact="device-super"`` at k=21 and canonical k=31 and ``auto``
    (K1 once a batch) on the first SUPER_RECORDS records. Each
    result against phase 4's cached reference, each run's launches against
    MESH_D per batch. Returns each run's launch counts."""
    import signal

    import numpy as np
    import torch

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
    from dna_kmeres_parallel_tpu_torch.parallel import bucketed, sharded_count
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh
    from dna_kmeres_parallel_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    stream, _, lengths = records
    D = MESH_D
    none = dict.fromkeys(read_launches(), 0)
    size = {} if STREAM_BATCH_BASES is None else {"batch_bases": STREAM_BATCH_BASES}
    launches = {}

    def n_batches(data, k, batch_bases=None):
        bb = batch_bases or KmerConfig(**size).batch_bases
        return math.ceil(data.size / batch_plan(data.size, k, bb)[0])

    def reference(data, key, k, canonical):
        if key[0] == "hist":
            return cached(refs, key, lambda: reference_hist(data, k, canonical, dev))
        table = cached(refs, key, lambda: reference_table(data, k, canonical, dev))
        torch.cuda.empty_cache()
        if k > 12:
            return table
        hist = np.zeros(4**k, np.int64)
        hist[table[0].astype(np.int64)] = table[1]
        return hist

    def run(name, k, canonical, kw, want, data=stream, fasta=path, key=None, **sc_kw):
        cfg = KmerConfig(k=k, canonical=canonical, **{**size, **kw})
        sc = StreamingCounter(cfg, device=dev, **sc_kw)
        reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        res = sc.run(str(fasta))
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        got = read_launches() if want is None else expect_launches(name, {**none, **want})
        launches[name] = got
        key = key or (("hist" if k <= 8 else "table"), k, canonical)
        ref = reference(data, key, k, canonical)
        ok = (np.array_equal(res.hist, ref) if hasattr(res, "hist") else
              np.array_equal(res.codes, ref[0]) and np.array_equal(res.counts, ref[1]))
        if not ok:
            raise AssertionError(f"{name}: result differs from the reference")
        phases = " ".join(f"{p}={s:.3f}" for p, s in sc.metrics.phase_seconds.items())
        fired = {n: c for n, c in got.items() if c}
        log(f"{name}: equal to the reference; wall {wall:.3f} s, "
            f"{res.total_bases / wall / 1e9:.4f} Gbase/s; phases s: {phases}; counters "
            f"{dict(sc.metrics.counters)}; launches {fired or 'none'}; peak device memory "
            f"{peak} bytes [{card}]")
        return res, sc.metrics, got, peak

    n21, n11, n8 = n_batches(stream, 21), n_batches(stream, 11), n_batches(stream, 8)
    mesh = {"mesh_shape": (D,)}
    run(MESH_MAIN, 21, False, mesh, {"encode_packed": D * n21})
    run(f"StreamingCounter(k=21, mesh_shape=({D},), pack_input=False)", 21, False,
        {**mesh, "pack_input": False}, {"encode_stream": D * n21})
    run(f"StreamingCounter(k=11, canonical, mesh_shape=({D},), device_sort, pallas_sort)", 11,
        True, {**mesh, "device_sort": True}, {"encode_packed": D * n11, "row_sort": D * n11},
        pallas_sort=True)
    run(f"StreamingCounter(k=3, mesh_shape=({D},))", 3, False, mesh,
        {"hist_u8_small": D * n_batches(stream, 3)})
    run(f"StreamingCounter(k=8, canonical, mesh_shape=({D},))", 8, True, mesh,
        {"hist_u8": D * n8})

    name, k, bins = ANY_RUN
    name = f"count_sharded(k={k}, bins={bins}, LocalMesh({D}))"
    lmesh = LocalMesh(D, dev)
    ref = reference_hist(stream, k, False, dev, bins)
    reset_launches()
    t = time.perf_counter()
    got = sharded_count.count_sharded(sharded_count.shard_stream(stream, lmesh), k, bins, False,
                                      lmesh).cpu().numpy()
    wall = time.perf_counter() - t
    launches[name] = expect_launches(name, {**none, "hist_u8_any": D})
    if got.shape != (bins,) or not np.array_equal(got, ref):
        raise AssertionError(f"{name}: histogram differs from the reference")
    log(f"{name} over {stream.size} bases: {int(got.sum())} windows, equal to the reference; "
        f"{D} hist_u8_any launches; wall {wall:.3f} s [{card}]")

    # Dense k=8 with checkpoints on the mesh; then a child on the mesh
    # SIGKILLs itself after its second checkpoint, and one device resumes.
    ckpt = path.with_name("mesh8.npz")
    name = f"StreamingCounter(k=8, mesh_shape=({D},), checkpoint_every_bases={STREAM_CKPT_BASES})"
    _, m, _, _ = run(name, 8, False, mesh, {"hist_u8": D * n8}, checkpoint_path=str(ckpt),
                     checkpoint_every_bases=STREAM_CKPT_BASES)
    if m.counters["checkpoints"] < 2:
        raise AssertionError(f"{name}: {m.counters['checkpoints']} checkpoints")
    ckpt.unlink()
    name = f"StreamingCounter(k=8) on the mesh killed after its second checkpoint, resumed on one device"
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _KILLED_CHILD, str(ROOT), str(path), str(ckpt), str(dev),
         str(STREAM_CKPT_BASES), str(STREAM_BATCH_BASES), "8", str(D)],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
    )
    child_s = time.perf_counter() - t
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"{name}: the child exited {proc.returncode}: {proc.stderr[-2000:]}")
    saved = checkpoint.load_checkpoint(ckpt)
    batch = batch_plan(stream.size, 8, KmerConfig(**size).batch_bases)[0]
    per_ckpt = -(-STREAM_CKPT_BASES // batch) * batch
    if not saved.dense or saved.cursor != 2 * per_ckpt:
        raise AssertionError(f"{name}: the child's checkpoint is at {saved.cursor}")
    left = math.ceil((stream.size - saved.cursor) / batch)
    _, m, _, _ = run(name, 8, False, {}, {"hist_planes": left}, checkpoint_path=str(ckpt),
                     checkpoint_every_bases=1 << 62)
    if m.counters.get("resumed_from_base") != saved.cursor:
        raise AssertionError(f"{name}: resumed from {m.counters.get('resumed_from_base')}")
    log(f"{name}: child killed by SIGKILL after {child_s:.1f} s with its checkpoint at base "
        f"{saved.cursor}; {left} batches resumed on one device [{card}]")
    ckpt.unlink()

    # The super-k-mer route on the first records: forced, then under auto.
    sub = first_records(records, min(SUPER_RECORDS, lengths.size))
    sub_path = path.with_name("super.fasta")
    write_fasta(sub_path, *sub)
    real = bucketed.table_from_superkmers
    d2h = {"bytes": 0, "records": 0}

    def counted(planes, meta, n_records, *a):
        # The bytes table_from_superkmers fetches: n_records, then its
        # power-of-two bucket (at least 128) of each record plane and meta.
        m_rec, n = int(n_records), int(meta.shape[0])
        mp = min(max(1 << (m_rec - 1).bit_length(), 128), n) if m_rec else 0
        d2h["bytes"] += 4 + mp * 4 * (len(planes) + 1)
        d2h["records"] += m_rec
        return real(planes, meta, n_records, *a)

    bucketed.table_from_superkmers = counted
    try:
        for k, canonical in ((21, False), (31, True)):
            d2h.update(bytes=0, records=0)
            name = (f"StreamingCounter(k={k}{', canonical' if canonical else ''}, "
                    "compact=device-super)")
            res, _, _, peak = run(name, k, canonical, {"compact": "device-super"}, {},
                                  data=sub[0], fasta=sub_path, key=("super", k, canonical))
            windows = int(res.total_kmers)
            words = windows * (6 if k <= 23 else 8)
            log(f"{name}: {d2h['records']} records for {windows} windows, D2H "
                f"{d2h['bytes']} bytes ({d2h['bytes'] / max(windows, 1):.3f} B a window; the "
                f"words route's planes {words} bytes), peak device memory {peak} bytes at "
                f"{KmerConfig(**size).batch_bases}-base batches [{card}]")
        name = "StreamingCounter(k=21, compact=auto)"
        nb = n_batches(sub[0], 21, SUPER_AUTO_BATCH)
        _, m, got, _ = run(name, 21, False, {"compact": "auto", "batch_bases": SUPER_AUTO_BATCH},
                           {"encode_packed": nb}, data=sub[0], fasta=sub_path,
                           key=("super", 21, False))
        if "host_count" in m.phase_seconds:
            raise AssertionError(f"{name}: a batch was counted on the host")
        log(f"{name} on {sub[0].size} bases in {nb} batches: route words (the device arm), "
            f"{got['encode_packed']} K1 batches [{card}]")
    finally:
        bucketed.table_from_superkmers = real
        sub_path.unlink()
    log(f"phase 11 (counting on the mesh, super-k-mer route) in "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


def phase_mesh_distance(dist_path: Path, dist_records, keep: dict, union: dict, dev, card: str,
                        tmp: Path) -> dict:
    """Phase 11, distances and the rest: on meshes of MESH_D and MESH_D_ODD
    shards of the card, (a) ``distance_file(k=3)`` bit for bit and (c)
    ``distance_stream_to_csv(k=3)``'s CSV byte for byte against phase 6's,
    and (d)'s union stream in panels of READ_PANEL_ROWS byte for byte
    against phase 9's one-shot CSV; ``count_sharded`` and
    ``min_sum_panel_sharded`` on a 1-rank NCCL process group against
    ``LocalMesh(1)``; ``kmer-gpu count --k 17``, ``stream --k 21`` and
    ``distance --k 3`` with ``--mesh MESH_D`` byte for byte against the
    same commands without it; ``graft_entry.dryrun_multichip(MESH_D)``.
    Each run's launches against its shards. Returns them."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import dna_kmeres_parallel_tpu_torch as port
    from dna_kmeres_parallel_tpu_torch import KmerConfig, graft_entry
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine, batch_plan
    from dna_kmeres_parallel_tpu_torch.parallel import sharded_count
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh, ProcessGroupMesh

    t_phase = time.perf_counter()
    none = dict.fromkeys(read_launches(), 0)
    launches = {}
    stream, starts, lengths = dist_records
    S = lengths.size
    seqs = record_strings(stream, starts, lengths)
    na = min(DIST_ROWS_A, S)
    reads = record_strings(*union["records"])
    n_read_panels = len(panel_shapes(len(reads), READ_PANEL_ROWS))

    def timed(name, want, fn):
        # K4 a shard, or the threshold route a shard where the gate takes it
        reset_launches()
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
        launches[name] = expect_launches(name, {**none, **follow_route(want)})
        return out, wall

    for D in (MESH_D, MESH_D_ODD):
        name = f"(a) distance_file(k=3, max_seqs={na}, mesh_shape=({D},))"
        want = {"counts_matrix": 1, "min_sum_rect": D, "finish_upper": 1}
        res, wall = timed(name, want, lambda: port.distance_file(
            str(dist_path), k=3, device=dev, max_seqs=na, mesh_shape=(D,)))
        if not same_bits(res.packed, keep["(a)"]):
            raise AssertionError(f"{name}: distances differ from phase 6's")
        report_run(name, wall, res.packed.size, res.phases,
                   f"(min,+) route {res.route}, K4 routes {routes_taken()}; distances "
                   "bit-identical to phase 6's", card)
        del res
        name = f"(c) distance_stream_to_csv(k=3, panel_rows={PANEL_ROWS}, max_panels=1, " \
               f"mesh_shape=({D},))"
        csv = tmp / f"mesh{D}_c.csv"
        eng = KmerEngine(KmerConfig(k=3, mesh_shape=(D,)), device=dev)
        out, wall = timed(name, want,
                          lambda: eng.distance_stream_to_csv(seqs, csv, panel_rows=PANEL_ROWS,
                                                             max_panels=1))
        if not same_file(csv, keep["(c)"]):
            raise AssertionError(f"{name}: CSV differs from phase 6's")
        report_run(name, wall, out["n_pairs"], out["phases"],
                   f"K4 routes {routes_taken()}; CSV byte-identical to phase 6's", card)
        csv.unlink()
        name = f"(d) distance_sparse_stream_to_csv(k={SPARSE_K}, union=on, panel_rows=" \
               f"{READ_PANEL_ROWS}, LocalMesh({D}))"
        csv = tmp / f"mesh{D}_d.csv"
        out, wall = timed(name, {"min_sum_rect": D * n_read_panels},
                          lambda: sparse_engine.distance_sparse_stream_to_csv(
                              reads, SPARSE_K, csv, panel_rows=READ_PANEL_ROWS, device=dev,
                              union="on", mesh=LocalMesh(D, dev)))
        if csv.read_bytes() != union["csv"]:
            raise AssertionError(f"{name}: CSV differs from phase 9's")
        report_run(name, wall, out["n_pairs"], out["phases"],
                   f"route {out['route']}, K4 routes {routes_taken()}; CSV byte-identical to "
                   "phase 9's one-shot CSV", card)
        csv.unlink()
        torch.cuda.empty_cache()

    # A 1-rank process group (NCCL on the card) against LocalMesh(1).
    flat = stream[: 1 << 20]
    counts = torch.from_numpy(np.random.default_rng(11).integers(0, 50, (96, 64), np.int32))
    with tempfile.TemporaryDirectory(prefix="kmer_pg_") as pg_tmp:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{pg_tmp}/pg", rank=0, world_size=1)
        try:
            got = {}
            for label, mesh in (("group", ProcessGroupMesh(dev)), ("local", LocalMesh(1, dev))):
                rows = sharded_count.shard_stream(flat, mesh)
                got[label] = (
                    sharded_count.count_sharded(rows, 3, 64, False, mesh, n_own=flat.size - 5)
                    .cpu().numpy(),
                    sharded_count.min_sum_panel_sharded(counts[:8].to(dev), counts.to(dev), mesh)
                    .cpu().numpy(),
                )
        finally:
            dist.destroy_process_group()
    if not all(np.array_equal(a, b) for a, b in zip(got["group"], got["local"])):
        raise AssertionError(f"a 1-rank {backend} group differs from LocalMesh(1)")
    log(f"count_sharded and min_sum_panel_sharded on a 1-rank {backend} process group: equal to "
        f"LocalMesh(1) ({int(got['group'][0].sum())} windows, a {got['group'][1].shape} panel) "
        f"[{card}]")

    # kmer-gpu with --mesh, against the same command without it
    on = ["--device", dev.type]
    n = min(CLI_MESH_ROWS, S)
    nd = min(CLI_DIST_ROWS, S)
    sub = first_records(dist_records, n)[0]
    per = math.ceil(sub.size / batch_plan(sub.size, 21, KmerConfig().batch_bases)[0])
    for argv, out, want in (
        (["count", "--k", 17, "--max-seqs", n], "c17.csv", {"encode_packed": MESH_D * per}),
        (["stream", "--k", 21, "--max-seqs", n], "s21.csv", {"encode_packed": MESH_D * per}),
        (["distance", "--k", 3, "--max-seqs", nd], "d3.csv",
         {"counts_matrix": 1, "min_sum_rect": MESH_D, "finish_upper": 1}),
    ):
        name = f"kmer-gpu {' '.join(map(str, argv))} --mesh {MESH_D}"
        plain, meshed = tmp / f"plain_{out}", tmp / f"mesh_{out}"
        _, wall = run_cli([argv[0], *on, *argv[1:], dist_path, "-o", plain])
        reset_launches()
        _, wall_mesh = run_cli([argv[0], *on, *argv[1:], "--mesh", MESH_D, dist_path, "-o",
                                meshed])
        launches[name] = expect_launches(name, {**none, **follow_route(want)})
        if not same_file(plain, meshed):
            raise AssertionError(f"{name}: output differs from the run without a mesh")
        log(f"{name}: wall {wall_mesh:.3f} s (without the mesh {wall:.3f} s); "
            f"{meshed.stat().st_size} bytes, byte-identical; launches "
            f"{ {k: c for k, c in launches[name].items() if c} } [{card}]")
        plain.unlink()
        meshed.unlink()

    reset_launches()
    t = time.perf_counter()
    graft_entry.dryrun_multichip(MESH_D, device=dev)
    log(f"graft_entry.dryrun_multichip({MESH_D}) in {time.perf_counter() - t:.2f} s; launches "
        f"{ {k: c for k, c in read_launches().items() if c} } [{card}]")
    log(f"phase 11 (distances on meshes of {MESH_D} and {MESH_D_ODD}, a process group, kmer-gpu "
        f"--mesh) in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches

#: phase 12: the 1-rank group's resumable counts run MULTIHOST_BATCH-base
#: steps (the dense one stopped after MULTIHOST_STOP_STEPS), its bucketed
#: runs over the main FASTA's first MULTIHOST_BUCKET_BASES bases; the two
#: children read its first MULTIHOST_CHILD_BASES (in MULTIHOST_CHILD_BATCH-
#: base steps) and the distance FASTA's first MULTIHOST_DIST_ROWS records
#: (in panels of MULTIHOST_CHILD_PANEL rows, stopped after
#: MULTIHOST_STOP_PANELS)
MULTIHOST_BATCH = 16 << 20
MULTIHOST_BUCKET_BASES = 64 << 20
MULTIHOST_CHILD_BASES = 32 << 20
MULTIHOST_CHILD_BATCH = 4 << 20
MULTIHOST_DIST_ROWS = 4096
MULTIHOST_CHILD_PANEL = 512
MULTIHOST_STOP_STEPS = 4
MULTIHOST_STOP_PANELS = 2
MULTIHOST_MAIN = "count_file_multihost(k=8, canonical), 1-rank group"

#: one rank of a two-rank gloo group on the card: runs the jobs, then
#: writes each one's results and launch counts
_MULTIHOST_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch.distributed as dist
import chip_smoke
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.parallel import multihost
from dna_kmeres_parallel_tpu_torch.parallel.mesh import ProcessGroupMesh

root, init, rank, device, out, jobs = sys.argv[1:7]
rank = int(rank)
dev = multihost.init_distributed(init, 2, rank, backend="gloo", device=device)
mesh = ProcessGroupMesh(dev)
arrays, info = {}, {}
try:
    for job in json.loads(jobs):
        name, cfg = job["name"], KmerConfig(k=job["k"], canonical=job.get("canonical", False))
        chip_smoke.reset_launches()
        t = time.perf_counter()
        if job["kind"] == "count":
            arrays[name], *_ = multihost.count_file_multihost(job["path"], cfg, mesh)
            extra = {}
        elif job["kind"] == "bucket":
            codes, counts, _, _, done, steps = multihost.count_file_bucketed_multihost_resumable(
                job["path"], cfg, mesh, job["ckpt"], job["batch"], job.get("max_steps"),
                owner_mode="minimizer")
            arrays[name + ".codes"], arrays[name + ".counts"] = codes, counts
            extra = {"steps": [done, steps]}
        else:
            report = multihost.distance_file_multihost_resumable(
                job["path"], cfg, job["csv"], job["ckpt"], panel_rows=job["panel_rows"],
                max_panels=job.get("max_panels"), device=dev)
            extra = {k: report[k] for k in ("rows", "completed", "all_complete", "regime")}
        info[name] = {"wall": time.perf_counter() - t, "launches": chip_smoke.read_launches(),
                      **extra}
finally:
    dist.destroy_process_group()
np.savez(out, info=np.array(json.dumps(info)), **arrays)
"""


def head_records(records, n_bases: int):
    """The first records of (stream, starts, lengths) whose stream holds
    at least ``n_bases`` bases (all of them if it is shorter)."""
    import numpy as np

    lengths = records[2]
    n = int(np.searchsorted(np.cumsum(lengths + 1), n_bases)) + 1
    return first_records(records, min(n, lengths.size))


def run_children(tag: str, jobs: list, dev, tmp: Path) -> list:
    """``jobs`` on two child processes, ranks of a gloo group on ``dev``
    (NCCL takes one rank a card); each child's arrays and info."""
    import numpy as np

    outs = [tmp / f"{tag}_rank{r}.npz" for r in range(2)]
    init = f"file://{tmp / f'mh_pg_{tag}'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MULTIHOST_CHILD, str(ROOT), init, str(r), str(dev), str(outs[r]),
         json.dumps(jobs)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT)) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"{tag}: rank {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    got = []
    for o in outs:
        with np.load(o) as z:
            arrays = {k: z[k] for k in z.files if k != "info"}
            got.append((arrays, json.loads(str(z["info"]))))
        o.unlink()
    return got


def phase_multihost(main_fasta: Path, hists: dict, head, dist_records, union: dict, dev,
                    card: str, tmp: Path) -> dict:
    """Phase 12, multi-host (``parallel/multihost``): a 1-rank process group
    (NCCL on the card) runs ``count_file_multihost`` at canonical k=8 over
    the main FASTA (K6 once), the resumable dense count at k=3 in
    MULTIHOST_BATCH-base steps stopped after MULTIHOST_STOP_STEPS
    and resumed (K7 a step), the bucketed resumable count at k=31 with
    minimizer owners (K1m a step) and prefix owners (K1 a step) over the
    first MULTIHOST_BUCKET_BASES bases, and the row-sharded distances at
    k=3 on the first MULTIHOST_DIST_ROWS distance records (K2 once, K4 a
    panel) and at k=21 on (d)'s reads (K4 a panel on the union route);
    then two child processes, the ranks of a gloo group on the card, run
    ``count_file_multihost`` at canonical k=8 and the bucketed count
    (killed after 2 steps by ``max_steps``, resumed) over the first
    MULTIHOST_CHILD_BASES bases and the k=3 distances (stopped after
    MULTIHOST_STOP_PANELS panels, resumed, stitched). Each result against
    phase 4's histograms, ``reference_table`` or the single-process CSV;
    each run's launches against its steps and shards. Returns them."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import merge_sparse_tables
    from dna_kmeres_parallel_tpu_torch.parallel import multihost
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import ProcessGroupMesh

    t_phase = time.perf_counter()
    none = dict.fromkeys(read_launches(), 0)
    launches = {}

    def timed(name, want, fn):
        reset_launches()
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
        launches[name] = expect_launches(name, {**none, **follow_route(want)})
        return out, wall

    def sub_fasta(records, n_bases, name):
        sub = head_records(records, n_bases)
        path = tmp / name
        write_fasta(path, *sub)
        return sub, path

    bucket_head, bucket_path = sub_fasta(head, MULTIHOST_BUCKET_BASES, "mh_bucket.fasta")
    child_head, child_path = sub_fasta(head, MULTIHOST_CHILD_BASES, "mh_child.fasta")
    n_dist = min(MULTIHOST_DIST_ROWS, dist_records[2].size)
    dist_sub = first_records(dist_records, n_dist)
    dist_path = tmp / "mh_dist.fasta"
    write_fasta(dist_path, *dist_sub)
    reads_path = tmp / "mh_reads.fasta"
    write_fasta(reads_path, *union["records"])

    # The single-process CSV the k=3 runs are held against.
    k3_csv = tmp / "mh_single3.csv"
    KmerEngine(KmerConfig(k=3), device=dev).distance_stream_to_csv(
        record_strings(*dist_sub), k3_csv, panel_rows=PANEL_ROWS)

    # A 1-rank process group: NCCL on the card.
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp / 'mh_pg_one'}", rank=0, world_size=1)
    try:
        mesh = ProcessGroupMesh(dev)
        group = f"1-rank {backend} group"
        (hist, bases, n_seqs), wall = timed(MULTIHOST_MAIN, {"hist_u8": 1}, lambda: (
            multihost.count_file_multihost(str(main_fasta), KmerConfig(k=8, canonical=True),
                                           mesh)))
        if not np.array_equal(hist, hists[(8, True)]):
            raise AssertionError(f"{MULTIHOST_MAIN}: histogram differs from phase 4's")
        log(f"{MULTIHOST_MAIN}: {n_seqs} records, {bases} bases, equal to phase 4's histogram; "
            f"wall {wall:.3f} s, {bases / wall / 1e9:.4f} Gbase/s [{card}]")

        batch = MULTIHOST_BATCH
        ckpt = str(tmp / "mh_dense")
        cfg = KmerConfig(k=3)
        name = f"count_file_multihost_resumable(k=3, batch_bases={batch}), {group}, stopped"
        first, wall1 = timed(name, {"hist_u8_small": MULTIHOST_STOP_STEPS}, lambda: (
            multihost.count_file_multihost_resumable(str(main_fasta), cfg, mesh, ckpt, batch,
                                                     MULTIHOST_STOP_STEPS)))
        n_steps = first[4]
        if first[3] != MULTIHOST_STOP_STEPS or n_steps <= MULTIHOST_STOP_STEPS:
            raise AssertionError(f"{name}: {first[3]} of {n_steps} steps")
        name = f"count_file_multihost_resumable(k=3, batch_bases={batch}), {group}, resumed"
        hist, wall2 = timed(name, {"hist_u8_small": n_steps - MULTIHOST_STOP_STEPS}, lambda: (
            multihost.count_file_multihost_resumable(str(main_fasta), cfg, mesh, ckpt,
                                                     batch))[0])
        if not np.array_equal(hist, hists[(3, False)]):
            raise AssertionError(f"{name}: histogram differs from phase 4's")
        log(f"count_file_multihost_resumable(k=3) on a {group}: {n_steps} steps of {batch} "
            f"bases, stopped after {MULTIHOST_STOP_STEPS} ({wall1:.3f} s) and resumed "
            f"({wall2:.3f} s); equal to phase 4's histogram [{card}]")
        for p in tmp.glob("mh_dense.p*"):
            p.unlink()

        ref = reference_table(bucket_head[0], BUCKET_K, False, dev)
        batch = MULTIHOST_BATCH
        n_steps = -(-bucket_head[0].size // batch)
        for owner, kernel in (("minimizer", "encode_packed_minimizer"), ("prefix", "encode_packed")):
            name = f"count_file_bucketed_multihost_resumable(k={BUCKET_K}, {owner}), {group}"
            out, wall = timed(name, {kernel: n_steps}, lambda: (
                multihost.count_file_bucketed_multihost_resumable(
                    str(bucket_path), KmerConfig(k=BUCKET_K), mesh, batch_bases=batch,
                    owner_mode=owner)))
            if not (np.array_equal(out[0], ref[0]) and np.array_equal(out[1], ref[1])):
                raise AssertionError(f"{name}: table differs from the reference")
            log(f"{name} over {bucket_head[0].size} bases in {out[5]} steps: {out[0].size} "
                f"distinct, equal to the reference; wall {wall:.3f} s, "
                f"{out[2] / wall / 1e9:.4f} Gbase/s [{card}]")
        del ref

        S = dist_sub[2].size
        name = f"distance_file_multihost_resumable(k=3, {S} records), {group}"
        csv = tmp / "mh_one3.csv"
        n_panels = -(-(S - 1) // PANEL_ROWS)
        report, wall = timed(name, {"counts_matrix": 1, "min_sum_rect": n_panels,
                                    "finish_upper": n_panels}, lambda: (
            multihost.distance_file_multihost_resumable(
                str(dist_path), KmerConfig(k=3), str(csv), panel_rows=PANEL_ROWS, device=dev)))
        if report["regime"] != "dense" or not same_file(csv, k3_csv):
            raise AssertionError(f"{name}: {report['regime']}, CSV differs from "
                                 "distance_stream_to_csv's")
        report_run(name, wall, report["n_pairs"], report["phases"],
                   "dense regime; CSV byte-identical to distance_stream_to_csv's", card)
        csv.unlink()
        S = union["records"][2].size
        name = f"distance_file_multihost_resumable(k={SPARSE_K}, {S} reads), {group}"
        csv = tmp / "mh_one21.csv"
        reset_launches()
        t = time.perf_counter()
        report = multihost.distance_file_multihost_resumable(
            str(reads_path), KmerConfig(k=SPARSE_K), str(csv), panel_rows=READ_PANEL_ROWS,
            device=dev)
        wall = time.perf_counter() - t
        unioned = report["route"].startswith("union/")
        want = {"min_sum_rect": len(panel_shapes(S, READ_PANEL_ROWS))} if unioned else {}
        launches[name] = expect_launches(name, {**none, **follow_route(want, report["route"])})
        if report["regime"] != "sparse" or csv.read_bytes() != union["csv"]:
            raise AssertionError(f"{name}: {report['regime']}, CSV differs from phase 9's")
        report_run(name, wall, report["n_pairs"], report["phases"],
                   f"sparse regime, route {report['route']}; CSV byte-identical to phase 9's",
                   card)
        csv.unlink()
    finally:
        dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # Two ranks of a gloo group on the card, each a child process.
    group = "2 gloo ranks on one device"
    batch = MULTIHOST_CHILD_BATCH
    ckpt = {"bucket": str(tmp / "mh2_bucket"), "dist": str(tmp / "mh2_dist")}
    csv = tmp / "mh2_3.csv"
    common = {"dist": {"kind": "dist", "k": 3, "path": str(dist_path), "csv": str(csv),
                       "ckpt": ckpt["dist"], "panel_rows": MULTIHOST_CHILD_PANEL},
              "bucket": {"kind": "bucket", "k": BUCKET_K, "path": str(child_path),
                         "ckpt": ckpt["bucket"], "batch": batch}}
    t = time.perf_counter()
    legs = [run_children("first", [
        {"name": "count", "kind": "count", "k": 8, "canonical": True, "path": str(child_path)},
        {"name": "bucket", **common["bucket"], "max_steps": 2},
        {"name": "dist", **common["dist"], "max_panels": MULTIHOST_STOP_PANELS},
    ], dev, tmp)]
    if csv.exists():
        raise AssertionError(f"{group}: the distances were stitched before every block was done")
    legs.append(run_children("second", [
        {"name": "bucket", **common["bucket"]}, {"name": "dist", **common["dist"]}], dev, tmp))
    wall = time.perf_counter() - t
    # On the CPU (a rehearsal) the children run the plain versions, which
    # count no launch.
    card_only = (lambda want: want) if dev.type == "cuda" else (lambda want: {})
    want_hist = reference_hist(child_head[0], 8, True, dev)
    ref = reference_table(child_head[0], BUCKET_K, False, dev)
    for r in range(2):
        arrays, info = legs[0][r]
        name = f"count_file_multihost(k=8, canonical), {group}, rank {r}"
        launches[name] = expect_launches(name, {**none, **card_only({"hist_u8": 1})},
                                         info["count"]["launches"])
        if not np.array_equal(arrays["count"], want_hist):
            raise AssertionError(f"{name}: histogram differs from the reference")
        n_steps = info["bucket"]["steps"][1]
        for leg, steps in ((0, 2), (1, n_steps - 2)):
            name = f"count_file_bucketed_multihost_resumable(k={BUCKET_K}, minimizer), " \
                   f"{group}, rank {r}, {('stopped', 'resumed')[leg]}"
            launches[name] = expect_launches(name, {
                **none, **card_only({"encode_packed_minimizer": steps})},
                legs[leg][r][1]["bucket"]["launches"])
        rows = info["dist"]["rows"]
        n_panels = -(-(rows[1] - rows[0]) // MULTIHOST_CHILD_PANEL)
        for leg, n in ((0, min(n_panels, MULTIHOST_STOP_PANELS)),
                       (1, max(n_panels - MULTIHOST_STOP_PANELS, 0))):
            name = f"distance_file_multihost_resumable(k=3, rows {rows}), {group}, rank {r}, " \
                   f"{('stopped', 'resumed')[leg]}"
            got = legs[leg][r][1]["dist"]["launches"]
            launches[name] = expect_launches(name, {
                **none, **card_only(follow_route(
                    {"counts_matrix": 1, "min_sum_rect": n, "finish_upper": n}, got=got))}, got)
        if not legs[1][r][1]["dist"]["all_complete"]:
            raise AssertionError(f"{group}: rank {r}'s distances are not complete")
    tables = [(legs[1][r][0]["bucket.codes"], legs[1][r][0]["bucket.counts"]) for r in range(2)]
    codes, counts = merge_sparse_tables(tables)
    if not (np.array_equal(codes, ref[0]) and np.array_equal(counts, ref[1])):
        raise AssertionError(f"{group}: the union of the ranks' tables differs from the reference")
    if not same_file(csv, k3_csv):
        raise AssertionError(f"{group}: the stitched CSV differs from distance_stream_to_csv's")
    walls = {name: [round(legs[leg][r][1][name]["wall"], 3) for leg in range(2) for r in range(2)
                    if name in legs[leg][r][1]] for name in ("count", "bucket", "dist")}
    log(f"{group}: count_file_multihost(k=8, canonical) over {child_head[0].size} bases equal to "
        f"the reference; the bucketed count (k={BUCKET_K}, minimizer, {n_steps} steps of {batch} "
        f"bases) stopped after 2 and resumed, the union of the ranks' tables ({tables[0][0].size} "
        f"+ {tables[1][0].size}) equal to the reference; the k=3 distances stopped after "
        f"{MULTIHOST_STOP_PANELS} panels, resumed and stitched, byte-identical to "
        f"distance_stream_to_csv's; walls s by job (leg, rank) {walls}; both launches "
        f"{wall:.1f} s [{card}]")
    for p in tmp.glob("mh*"):  # the phase's files: FASTAs, CSVs, parts, checkpoints, stores
        p.unlink()
    log(f"phase 12 (multi-host: a 1-rank {backend} group, two gloo ranks on one device) in "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
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
    shard_bases = smoke_shard_bases(args.bases)
    timed = phase_kernels(dev, card, shard_bases)
    dense = phase_dense_kernels(dev, card)
    k9 = phase_stream_kernel(dev, card)

    # 4. the main path, the dense path and the streaming path, on one FASTA
    # (kept, with the references phase 10 reads, until the end)
    t = time.perf_counter()
    records = smoke_records(args.bases)
    main_tmp = tempfile.TemporaryDirectory(prefix="kmer_smoke_")
    tmp = main_tmp
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
        if shard_bases != -(-stream.size // BUCKET_D):
            raise AssertionError("smoke_shard_bases disagrees with the generated stream")
        bucket = phase_bucket_kernels(dev, card, shard_bases)
        bucket_launches = phase_bucket_path(records, path, dev, card, refs)
        row_sort = phase_sort_kernel(dev, card)
        sort_launches = phase_sort_path(records, path, dev, card, refs)
        # 11. the mesh and super-k-mer routes, counting (distances below)
        phase11 = phase_mesh_count(records, path, dev, card, refs)
    except BaseException:
        main_tmp.cleanup()
        raise
    main_fasta = path
    main_table = refs[("table", 21, False)]
    hists = {key[1:]: refs[key] for key in (("hist", 3, False), ("hist", 8, True))}
    n_batches = math.ceil(stream.size / batch_plan(stream.size, 21, KmerConfig().batch_bases)[0])
    head = head_records(records, MULTIHOST_BUCKET_BASES)  # phase 12's
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
        dist = phase_distance_kernels(dev, card, records, so)
        keep: dict = {}
        dist_launches = phase_distance_path(records, path, dev, card, keep)
        # (d)-(g): sparse tables and dense mid k, then K2's global route
        # and K3/K4 at their widths, and the gates' rates
        work = Path(tmp.name)
        union = phase_union_path(dev, card, work)
        dist_launches.update(union["launches"])
        dist_launches.update(phase_host_path(records, dev, card, work))
        dist_launches.update(phase_long_path(dev, card))
        dist_launches.update(phase_midk_path(records, dev, card, work))
        wide = phase_wide_kernels(dev, card, records, union["tables"])
        gate_rates = measure_gate_rates(dev, card, union["host_min_sum_s"], union["tables"],
                                        wide["tri_bin_pairs_per_sec"])
        # the threshold route at (a), (b), (d) and (g), on the matrices
        # built above
        from dna_kmeres_parallel_tpu_torch.models.sparse_engine import DistanceRates
        from dna_kmeres_parallel_tpu_torch.ops import calibrate

        phase_threshold(dev, card, threshold_cases(records, dist, wide, union["tables"], dev),
                        calibrate.rates_from(gate_rates), DistanceRates())
        for key in ("mats", "plain"):
            wide.pop(key)
        torch.cuda.empty_cache()

        # 10. the command line, kmer-gpu, on the card
        phase_cli(main_fasta, main_table, hists, n_batches, path, records, union, gate_rates,
                  dev, card, work)

        # 11. the mesh routes of the distances, a process group, kmer-gpu --mesh
        phase11.update(phase_mesh_distance(path, records, keep, union, dev, card, work))
        keep.clear()

        # 12. multi-host: a 1-rank group, then two ranks on the card
        phase12 = phase_multihost(main_fasta, hists, head, records, union, dev, card, work)
    finally:
        tmp.cleanup()
        main_tmp.cleanup()

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
        extra = {}
        if name == "counts_matrix":
            # every timed shape, with its run's launches (the long rows are
            # on no path)
            extra["shapes"] = with_launches(r["shapes"], name, dist_launches)
        else:
            # the widths of phases (d) and (g), each with its run's launches
            # (the i32 slices are on no path)
            extra["shapes"] = with_launches(wide["shapes"][name], name, dist_launches)
            r["max_abs_err"] = max(r["max_abs_err"], wide["max_abs_err"][name])
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
            **extra,
        })
    # the finish kernel at the triangle of all records (the launches of a
    # distance_file call) and at (c)'s first panel
    r = dist["finish_upper"]
    run_key = next(key for key in dist_launches if key.startswith("(a)"))
    kernels_json.append({
        "name": "finish_upper",
        "route": "cuda",
        "source": "dna_kmeres_parallel_tpu_torch/csrc/finish.cu",
        "replaces": "dna_kmeres_parallel_tpu/ops/distance.py:162 (the host finish, NumPy)",
        "launches": dist_launches[run_key]["finish_upper"],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
        "shapes": with_launches(r["shapes"], "finish_upper", dist_launches),
    })
    shapes = with_launches(wide["shapes"]["counts_matrix_global"], "counts_matrix_global",
                           dist_launches)
    kernels_json.append({
        "name": "counts_matrix_global",
        "route": "cuda",
        "source": "dna_kmeres_parallel_tpu_torch/csrc/counts_matrix.cu",
        "replaces": "dna_kmeres_parallel_tpu/ops/histogram_pallas.py:114",
        "launches": dist_launches[MIDK_MAIN]["counts_matrix_global"],
        "max_abs_err": wide["max_abs_err"]["counts_matrix_global"],
        "ms": shapes[0]["ms"],
        "plain_ms": shapes[0]["plain_ms"],
        "bound_ms": shapes[0]["bound_ms"],
        "bound_by": shapes[0]["bound_by"],
        "library_ms": None,
        "shapes": shapes,
    })
    for name, replaces in (
        ("hist_planes", "histogram_pallas.py:814"),
        ("hist_u8", "histogram_pallas.py:604"),
        ("hist_u8_small", "histogram_pallas.py:375"),
        ("hist_packed_small", "histogram_pallas.py:375"),
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
        launched = bucket_launches[BUCKET_MAIN][name]
        extra = {}
        if name == "row_roll":
            # the path launches P1 once, on the probe's [8, 256] tile
            extra["shapes"] = [{**sh, "launches": launched if sh["shape"] == "[8, 256]" else 0}
                               for sh in r["shapes"]]
        kernels_json.append({
            "name": name,
            "route": "cuda",
            "source": f"dna_kmeres_parallel_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launched,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
            **extra,
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
    for entry in kernels_json:
        # this kernel's launches in each phase-11 run (on a mesh, D a batch
        # or panel)
        entry["phase11_launches"] = {run: got[entry["name"]] for run, got in phase11.items()
                                     if got.get(entry["name"])}
        # and in each phase-12 run (a step or panel a shard: each rank's
        # own launches)
        entry["phase12_launches"] = {run: got[entry["name"]] for run, got in phase12.items()
                                     if got.get(entry["name"])}
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
