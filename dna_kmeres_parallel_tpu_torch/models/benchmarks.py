"""Throughput microbenchmarks of the port's device programs.

The port of ``dna_kmeres_parallel_tpu/models/benchmarks.py``, with its
report keys. Each bench makes seeded random bases on the device from an
explicit ``torch.Generator``, stages them once as the engine stages a
batch, and times the device program alone (CUDA events on the card, the
host clock on the CPU), with the launches queued behind a spin of the
card (``torch.cuda._sleep``) so that the host's launch rate is not what
is timed. Each report checks its work: ``windows_counted`` against
``windows_expected``, and ``timing_valid``.

- ``run_count_bench``: the dense counter's kernel over n batches into
  one int32 accumulator (K5 from planes at k = 4..8, K7 from the packed
  batch at k <= 3, or from u8 bases with ``pack_input=False``);
- ``run_sparse_bench``: the sparse counter's device program (K1 from
  planes, or K9 from u8 bases; with ``device_sort``, the sort too);
- ``run_distance_bench``: K3 or the threshold route over a counts matrix
  K2 built once;
- ``run_impl_matrix_bench``: the dense histogram routes side by side
  (K7 packed, K5, and K6 or K7 from u8 with ``pack_input=False``).
"""

from __future__ import annotations

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch.models.engine import FLUSH_WINDOWS, KmerEngine, host_to_device
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
    DistanceRates,
    counts_extent,
    encode_staged,
    stage_words,
    threshold_plan,
)
from dna_kmeres_parallel_tpu_torch.ops import distance as dist_ops
from dna_kmeres_parallel_tpu_torch.ops import distance_cuda, histogram_cuda, runtime, threshold_cuda
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops
from dna_kmeres_parallel_tpu_torch.utils import codec
from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig

#: clock cycles the card spins before a timed run, per launch queued
#: behind it (a launch takes the host about 0.03 ms; 100,000 cycles are
#: about 0.05 ms at the H100's clocks)
QUEUE_CYCLES_PER_LAUNCH = 100_000
_LANE = 128


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def gate(dev: torch.device, launches: int) -> None:
    """Hold the card's stream in a spin while the host queues ``launches``
    launches behind it (nothing on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(QUEUE_CYCLES_PER_LAUNCH * max(launches, 1))


def random_batch(dev: torch.device, n_bases: int, seed: int) -> np.ndarray:
    """``n_bases`` random bases (0..3) made on ``dev`` from a seeded
    generator, padded with the separator to a multiple of 128, on the
    host (the engines stage batches from host arrays)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bases = torch.randint(0, 4, (n_bases,), generator=g, device=dev, dtype=torch.uint8)
    padded = np.full(-(-n_bases // _LANE) * _LANE, codec.INVALID_BASE, dtype=np.uint8)
    padded[:n_bases] = bases.cpu().numpy()
    return padded


def _rates(measured: int, elapsed: float) -> dict:
    valid = elapsed > 0
    return {
        "elapsed_s": round(elapsed, 6),
        "gbases_per_sec": round(measured / elapsed / 1e9, 4) if valid else 0.0,
        "bases_per_sec": round(measured / elapsed, 1) if valid else 0.0,
        "timing_valid": valid,
    }


def run_count_bench(
    k: int = 8,
    canonical: bool = False,
    total_bases: int = 64 << 20,
    batch_bases: int = 8 << 20,
    seed: int = 0,
    device: str | torch.device = "cuda",
    pack_input: bool = True,
) -> dict:
    """Time the dense counter's kernel (k <= 8): n = total / batch launches
    over one staged batch of random bases, adding into one int32
    accumulator (moved into an int64 one before it could pass
    ``FLUSH_WINDOWS``)."""
    dev = runtime.resolve_device(device)
    bins = codec.num_bins(k)
    if bins > histogram_cuda.MAX_BINS:
        raise ValueError(f"the dense count kernels serve k <= 8, got k={k}; "
                         "run_sparse_bench times k >= 9")
    batch_bases = min(batch_bases, total_bases)
    n_batches = max(total_bases // batch_bases, 1)
    n_own = batch_bases - k + 1
    eng = KmerEngine(KmerConfig(k=k, canonical=canonical, pack_input=pack_input), device=dev)
    staged = tuple(host_to_device(a, dev) for a in eng._stage(random_batch(dev, batch_bases, seed)))
    acc = torch.zeros(bins, dtype=torch.int32, device=dev)
    total = torch.zeros(bins, dtype=torch.int64, device=dev)
    eng.count_staged(staged, n_own, acc)  # warm-up, not counted
    acc.zero_()
    gate(dev, n_batches)
    m0 = runtime.mark(dev)
    in_acc = 0
    for _ in range(n_batches):
        if in_acc + n_own > FLUSH_WINDOWS:
            total += acc
            acc.zero_()
            in_acc = 0
        eng.count_staged(staged, n_own, acc)
        in_acc += n_own
    elapsed = runtime.span_s(m0, runtime.mark(dev))
    total += acc
    measured = n_batches * batch_bases
    route = ("hist_planes" if pack_input and k >= 4 else
             "hist_packed_small" if pack_input else
             {"small": "hist_u8_small", "u8": "hist_u8", "any": "hist_u8_any"}[
                 histogram_cuda.u8_route(bins)])
    return {
        "bench": "count",
        "k": k,
        "canonical": canonical,
        "bins": bins,
        "route": route,
        "total_bases": measured,
        "requested_total_bases": total_bases,
        "batch_bases": batch_bases,
        "n_batches": n_batches,
        **_rates(measured, elapsed),
        "windows_counted": int(total.sum()),
        "windows_expected": n_batches * n_own,
        "device": device_name(dev),
    }


def run_sparse_bench(
    k: int = 21,
    canonical: bool = False,
    total_bases: int = 64 << 20,
    batch_bases: int = 16 << 20,
    seed: int = 0,
    row_len: int = 0,
    device_sort: bool = False,
    device: str | torch.device = "cuda",
    pack_input: bool = True,
    pallas_sort: bool = False,
) -> dict:
    """Time the sparse counter's device program over n = total / batch
    batches of one staged batch of random bases: the encode (K1 from
    planes, K9 from u8 bases with ``pack_input=False``) and, with
    ``device_sort``, the sort of its words (``row_len`` rows, or one flat
    sort at 0). Each batch's span is timed alone; its valid words are then
    counted outside the span. Compaction and merge (host) are not timed
    here; the engines' ``phases`` split them."""
    dev = runtime.resolve_device(device)
    if not (1 <= k <= sparse_ops.MAX_SPARSE_K):
        raise ValueError(f"k must be in [1, {sparse_ops.MAX_SPARSE_K}], got {k}")
    batch_bases = min(batch_bases, total_bases)
    n_batches = max(total_bases // batch_bases, 1)
    n_own = batch_bases - k + 1
    host = stage_words(random_batch(dev, batch_bases, seed), pack_input)
    staged = tuple(host_to_device(a, dev) for a in host)

    def program():
        words = encode_staged(staged, n_own, k, canonical)
        if device_sort:
            words = sparse_ops.sort_encoded(words, n_own, row_len, pallas_sort)
        return words

    program()  # warm-up
    counted = torch.zeros((), dtype=torch.int64, device=dev)
    elapsed = 0.0
    for _ in range(n_batches):
        gate(dev, 4)
        m0 = runtime.mark(dev)
        words = program()
        m1 = runtime.mark(dev)
        counted += (words[0] != sparse_ops.word_sentinel(words[0].dtype)).sum()
        elapsed += runtime.span_s(m0, m1)
        del words
    measured = n_batches * batch_bases
    return {
        "bench": "sparse_count",
        "k": k,
        "canonical": canonical,
        "device_sort": device_sort,
        "row_len": row_len,
        "encoder": "encode_packed" if pack_input else "encode_stream",
        "total_bases": measured,
        "batch_bases": batch_bases,
        "n_batches": n_batches,
        **_rates(measured, elapsed),
        "windows_counted": int(counted),
        "windows_expected": n_batches * n_own,
        "device": device_name(dev),
    }


def run_distance_bench(
    n_seqs: int = 1024,
    seq_len: int = 1024,
    k: int = 3,
    seed: int = 0,
    impl: str = "auto",
    reps: int = 8,
    device: str | torch.device = "cuda",
    rates: DistanceRates = DistanceRates(),
) -> dict:
    """Time the (min,+) product of the distance path: K2 builds the
    [n_seqs, 4^k] counts matrix of random records once, then ``reps``
    launches over it are timed. impl: "tri" (K3 on the card, on the
    route ``distance_cuda.product_route`` picks, launched by
    ``distance_cuda.tri_launcher``; its plain version on the CPU),
    "threshold" (the threshold route at the bucket of the largest count,
    ``ops/threshold_cuda``; its plain version on the CPU), "auto" (the
    one of the two ``sparse_engine.threshold_plan`` takes under
    ``rates``, as the dense engine routes) or "plain" (K3's plain version
    on the same device, for A/B). The product's diagonal holds each row's
    window count, which is held against the windows of the records."""
    dev = runtime.resolve_device(device)
    if impl not in ("auto", "plain", "tri", "threshold"):
        raise ValueError(f"impl must be 'auto', 'plain', 'tri' or 'threshold', got {impl!r}")
    bins = codec.num_bins(k)
    g = torch.Generator(device=dev).manual_seed(seed)
    grid = torch.randint(0, 4, (n_seqs, seq_len), generator=g, device=dev, dtype=torch.uint8)
    counts = histogram_cuda.counts_matrix_grid(grid, k, bins)
    del grid
    cmax, row_max = counts_extent(counts)
    bucket = 1 << max(cmax - 1, 0).bit_length() if cmax else 0
    if impl == "auto":
        alt_s = dist_ops.minplus_time(
            n_seqs, n_seqs, bins, True, rate=rates.dense_bin_pairs_per_sec,
            rate_rows=dist_ops.DENSE_RATE_ROWS, peak=rates.peak_bin_pairs_per_sec)
        planned = threshold_plan(cmax, row_max, n_seqs, n_seqs, bins, alt_s=alt_s, device=dev,
                                 rates=rates)
        impl = "tri" if planned is None else "threshold"
    if impl == "plain":
        fn, use = (lambda: dist_ops.min_sum_matrix(counts)), "plain"
    elif impl == "threshold":
        fn, use = (lambda: threshold_cuda.min_sum_matrix_threshold(counts, bucket)), "threshold"
    else:
        fn, use = distance_cuda.tri_launcher(counts)
    out = fn()  # warm-up
    gate(dev, reps)
    m0 = runtime.mark(dev)
    for _ in range(reps):
        out = fn()
    elapsed = runtime.span_s(m0, runtime.mark(dev)) / reps
    n_pairs = n_seqs * (n_seqs - 1) // 2
    return {
        "bench": "distance",
        "k": k,
        "impl": use,
        "cmax": cmax,
        "n_seqs": n_seqs,
        "seq_len": seq_len,
        "n_pairs": n_pairs,
        "elapsed_s": round(elapsed, 6),
        "pairs_per_sec": round(n_pairs / elapsed, 1) if elapsed > 0 else 0.0,
        "timing_valid": elapsed > 0,
        "windows_counted": int(out.diagonal().sum()),
        "windows_expected": n_seqs * max(seq_len - k + 1, 0),
        "device": device_name(dev),
    }


def run_impl_matrix_bench(
    ks=(3, 4, 8),
    total_bases: int = 32 << 20,
    seed: int = 0,
    reps: int = 3,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """The dense histogram routes side by side at each k, over one batch
    of ``total_bases`` random bases: "packed" (K7 from the packed batch,
    k <= 3), "planes" (K5, k = 4..8) and "u8" (``pack_input=False``: K7
    from u8 at k <= 3, K6 above). One report per (k, route)."""
    reports = []
    for k in ks:
        impls = ("packed", "u8") if k <= 3 else ("planes", "u8")
        for impl in impls:
            r = run_count_bench(k=k, total_bases=reps * total_bases, batch_bases=total_bases,
                                seed=seed, device=device, pack_input=impl != "u8")
            reports.append({
                "k": k,
                "impl": impl,
                "kernel": r["route"],
                "gbases_per_sec": r["gbases_per_sec"],
                "exact": r["windows_counted"] == r["windows_expected"],
                "timing_valid": r["timing_valid"],
            })
    return reports
