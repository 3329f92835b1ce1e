#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--bases N]

Phases, each printing its lines; the first failure raises and the script
exits nonzero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the native host library's build;
2. the kernels' build from ``dna_kmeres_parallel_tpu_torch/csrc`` (nvcc);
3. every kernel against its plain PyTorch version on the card, element
   for element, and both timed with CUDA events at the main path's batch;
4. the main path: exact k-mer counting of a seeded random FASTA of
   ``--bases`` bases (default 256 Mbase, about one large human
   chromosome) through ``count_file`` and ``SparseKmerEngine``. Each table
   is checked code for code and count for count against a plain reference
   that shares no code with the port: every window of the generated
   records encoded in int64 on the card, then ``torch.unique``. The
   kernel's launch count is checked against the batch count.

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


def reference_table(stream, k: int, canonical: bool, dev):
    """Sorted distinct codes (u64) and counts (i64) of every valid window
    of the stream, in plain int64 torch on the card: the code of a window
    rolled over its k bases (and its reverse complement, for canonical),
    then ``torch.unique``. Shares no code with the port."""
    import torch

    b = torch.from_numpy(stream).to(dev)
    n = b.numel() - k + 1
    parts = []
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
        parts.append(code[valid])
    codes, counts = torch.unique(torch.cat(parts), sorted=True, return_counts=True)
    return codes.cpu().numpy().view("u8"), counts.cpu().numpy()


def phase_main_path(bases: int, dev, card: str) -> int:
    import numpy as np
    import torch

    import dna_kmeres_parallel_tpu_torch as port
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
        SparseKmerEngine,
        batch_plan,
    )
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda

    t = time.perf_counter()
    stream, starts, lengths = smoke_records(bases)
    tmp = tempfile.TemporaryDirectory(prefix="kmer_smoke_")
    path = Path(tmp.name) / "smoke.fasta"
    write_fasta(path, stream, starts, lengths)
    log(f"fasta: {lengths.size} records, {int(lengths.sum())} bases, "
        f"{int((stream == INVALID).sum()) - lengths.size + 1} N, "
        f"{path.stat().st_size} bytes, written in {time.perf_counter() - t:.1f} s")

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
    try:
        for name, k, canonical, run in runs:
            t = time.perf_counter()
            ref_codes, ref_counts = reference_table(stream, k, canonical, dev)
            torch.cuda.empty_cache()
            ref_s = time.perf_counter() - t
            batch, _ = batch_plan(stream.size, k, KmerConfig().batch_bases)
            n_batches = math.ceil(stream.size / batch)
            encode_cuda.LAUNCHES = 0
            t = time.perf_counter()
            res = run()
            wall = time.perf_counter() - t
            launches = encode_cuda.LAUNCHES
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
    finally:
        tmp.cleanup()
    return main_launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bases", type=int, default=256_000_000,
                    help="size of the main path's FASTA (default 256 Mbase)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import dna_kmeres_parallel_tpu_torch

    if not Path(dna_kmeres_parallel_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError("the port must be imported from this checkout")
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import require_native
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

    # 4. the main path
    launches = phase_main_path(args.bases, dev, card)

    ms, plain_ms, err = timed[(21, False)]
    log(json.dumps({"kernels": [{
        "name": "encode_packed",
        "route": "cuda",
        "source": "dna_kmeres_parallel_tpu_torch/csrc/encode_packed.cu",
        "replaces": "dna_kmeres_parallel_tpu/ops/encode_pallas.py:779",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
