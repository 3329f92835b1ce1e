"""Calibration of the distance gates: measure the card and host this runs
on, persist the rates per fingerprint, load them back as
``sparse_engine.DistanceRates``.

The port of ``dna_kmeres_parallel_tpu/ops/calibrate.py``. What it
measures, on a card (CUDA events for device work, the host clock for
host work):

- ``measure_link``: pinned H2D and D2H bytes a second, and the round trip
  of a tiny K3 job (copy in, launch, copy out, waited for);
- ``measure_compute``: K3's bin-pairs a second at three shapes, because
  its rate depends on the blocks it launches (output tiles times bin
  slices) and on the bins (at 64 it is bound by stores): a dense [S, 4^k]
  counts matrix built by K2 (``DENSE_SHAPE``, the rate
  ``dense_distance_preferred`` reads), a union matrix (``UNION_SHAPE``,
  the rate ``union_dense_plan`` reads) and a matrix of many tiles
  (``PEAK_SHAPE``, every SM busy: the most ``ops/distance.minplus_time``
  lets the rates grow to at bins too few to split); the threshold
  route's int8 multiply-adds a second (``THRESHOLD_SHAPE``: the JAX
  package's method, the difference between cmax 8 and cmax 2 over
  S * S * B * 6); and the native two-pointer's entry-pairs a second a
  thread on tables near the size the union gate meets (``HOST_TABLES``),
  run with the thread count the two-pointer uses.

On the CPU the same probes run at small shapes (the kernels' plain
versions, a host memcpy for the link): tests, not rates to route by.

The file is JSON, ``calibration_<fingerprint>.json`` in ``cal_dir`` (by
default ``build/calibration/`` beside the package); the fingerprint holds
the card's name, SM count and driver, the device count and the host's CPU
count. Nothing here reads the environment: the command line passes a
directory or a file.
"""

from __future__ import annotations

import json
import os
import re
import time
from pathlib import Path

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import DistanceRates
from dna_kmeres_parallel_tpu_torch.ops import distance as dist_ops
from dna_kmeres_parallel_tpu_torch.ops import distance_cuda, histogram_cuda, runtime, threshold_cuda

#: where calibration files live unless a directory is given
CAL_DIR = Path(__file__).resolve().parents[2] / "build" / "calibration"

#: K3's dense probe on the card: rows, k and record length of the [rows,
#: 4^k] counts matrix K2 builds from random records (phase (g)'s shape)
DENSE_SHAPE = (dist_ops.DENSE_RATE_ROWS, 9, 2000)
#: K3's union probe on the card: rows, columns and nonzero entries a row
#: (phase (d)'s union matrix of reads at about 30x)
UNION_SHAPE = (dist_ops.UNION_RATE_ROWS, 131_072, 1500)
#: K3 with every SM busy: the [16,384, 64] counts matrix of records of
#: 1,500 bases at k=3 (phase (a)'s shape)
PEAK_SHAPE = (16384, 3, 1500)
#: the threshold route's probe: rows and columns of random counts 0-8
THRESHOLD_SHAPE = (2048, 65_536)
#: the two-pointer's probe: tables, entries a table, and the universe the
#: entries are drawn from (reads of a 100 kbase genome share their codes)
HOST_TABLES = (512, 1500, 100_000)
#: the same probes on the CPU
CPU_DENSE_SHAPE = (32, 5, 300)
CPU_UNION_SHAPE = (64, 4096, 100)
CPU_HOST_TABLES = (64, 200, 5000)
CPU_PEAK_SHAPE = (64, 3, 300)
CPU_THRESHOLD_SHAPE = (64, 512)

#: the DistanceRates field each calibration key fills
RATE_KEYS = (
    "bin_pairs_per_sec",
    "dense_bin_pairs_per_sec",
    "sparse_entry_pairs_per_sec_per_thread",
    "h2d_bytes_per_sec",
    "d2h_bytes_per_sec",
    "roundtrip_s",
    "threads",
    "peak_bin_pairs_per_sec",
    "threshold_macs_per_sec",
    "sms",
)


def cuda_driver_version() -> str:
    """The CUDA driver's version (as ``cuDriverGetVersion`` gives it, e.g.
    "12080"), or "?" where no driver library loads."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int()
        if lib.cuDriverGetVersion(ctypes.byref(v)) == 0:
            return str(v.value)
    except OSError:
        pass
    return "?"


def fingerprint(device: str | torch.device = "cuda") -> str:
    """Identity of what the rates were measured on: the card's name, SM
    count and driver, the device count and the host's CPU count (on the
    CPU, the CPU count alone)."""
    dev = runtime.resolve_device(device)
    cpus = os.cpu_count() or 1
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        raw = (f"{props.name}_{props.multi_processor_count}sm_drv{cuda_driver_version()}_"
               f"{torch.cuda.device_count()}dev_{cpus}cpu")
    else:
        raw = f"cpu_{cpus}cpu"
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", raw)


def calibration_path(device: str | torch.device = "cuda", cal_dir=None) -> Path:
    """The calibration file of this card and host under ``cal_dir``."""
    return Path(cal_dir or CAL_DIR) / f"calibration_{fingerprint(device)}.json"


def save_calibration(cal: dict, path) -> Path:
    """Write ``cal`` as JSON at ``path`` (atomically: a reader never sees
    half a file)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(cal, indent=1, sort_keys=True) + "\n", encoding="ascii")
    os.replace(tmp, path)
    return path


def load_calibration(path) -> dict:
    """The calibration dict at ``path``; {} where there is no file."""
    path = Path(path)
    if not path.exists():
        return {}
    return json.loads(path.read_text(encoding="ascii"))


def rates_from(cal: dict) -> DistanceRates:
    """A DistanceRates with the calibrated rates, the defaults for any key
    the calibration lacks."""
    return DistanceRates(**{k: cal[k] for k in RATE_KEYS if cal.get(k) is not None})


def load_rates(path=None, device: str | torch.device = "cuda", cal_dir=None) -> DistanceRates:
    """The gates' rates: from ``path``, or else from this card's file under
    ``cal_dir``; the defaults where there is none."""
    if path is None:
        path = calibration_path(device, cal_dir)
    return rates_from(load_calibration(path))


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------


def _time_s(fn, dev: torch.device, reps: int) -> float:
    """Mean seconds of ``fn()`` over ``reps`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    m0 = runtime.mark(dev)
    for _ in range(reps):
        fn()
    return runtime.span_s(m0, runtime.mark(dev)) / reps


def measure_link(device: str | torch.device = "cuda", size_bytes: int = 256 << 20,
                 reps: int = 5) -> dict:
    """Pinned H2D and D2H bytes a second (copies of ``size_bytes``), and
    the round trip of a tiny K3 job: a [2, 128] matrix copied in, K3
    launched, its output copied out and waited for (the median of 21, host
    clock). On the CPU the copies are a host memcpy."""
    dev = runtime.resolve_device(device)
    if dev.type != "cuda":
        size_bytes = min(size_bytes, 16 << 20)
    host = torch.empty(size_bytes, dtype=torch.uint8)
    if dev.type == "cuda":
        host = host.pin_memory()
    card = torch.empty(size_bytes, dtype=torch.uint8, device=dev)
    h2d = size_bytes / _time_s(lambda: card.copy_(host, non_blocking=True), dev, reps)
    d2h = size_bytes / _time_s(lambda: host.copy_(card, non_blocking=True), dev, reps)
    del host, card
    tiny = torch.ones(2, 128, dtype=torch.int32)
    trips = []
    for _ in range(21):
        t = time.perf_counter()
        distance_cuda.min_sum_matrix_tri(tiny.to(dev)).cpu()
        trips.append(time.perf_counter() - t)
    return {
        "h2d_bytes_per_sec": h2d,
        "d2h_bytes_per_sec": d2h,
        "roundtrip_s": float(np.median(trips)),
    }


def k3_rate(counts: torch.Tensor, reps: int = 3) -> float:
    """K3's bin-pairs a second over ``counts`` [S, B], in the gates' own
    terms: S (S - 1) / 2 pairs of B bins in the mean time of a launch."""
    S, B = counts.shape
    run, _ = distance_cuda.tri_launcher(counts)
    seconds = _time_s(run, counts.device, reps)
    return S * (S - 1) / 2 * B / seconds


def dense_counts(device, rows: int, k: int, row_len: int, seed: int = 0) -> torch.Tensor:
    """The int32 [rows, 4^k] counts matrix of random records of
    ``row_len`` bases, built by K2 on ``device`` (its plain version on the
    CPU)."""
    dev = runtime.resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    grid = torch.randint(0, 4, (rows, row_len), generator=g, device=dev, dtype=torch.uint8)
    return histogram_cuda.counts_matrix_grid(grid, k, 4**k)


def threshold_rate(counts: torch.Tensor, reps: int = 3) -> float:
    """The threshold route's int8 multiply-adds a second over ``counts``
    [S, B] (counts 0-8), the JAX package's way: the time at cmax 8 less
    the time at cmax 2, over the S * S * B * 6 multiply-adds the six
    extra thresholds add (the planes' build included, as the route
    spends it). ``threshold_cuda.min_sum_matrix_threshold`` on the card,
    its plain version on the CPU."""
    S, B = counts.shape
    hi = _time_s(lambda: threshold_cuda.min_sum_matrix_threshold(counts, 8), counts.device, reps)
    lo = _time_s(lambda: threshold_cuda.min_sum_matrix_threshold(counts, 2), counts.device, reps)
    return S * S * B * 6 / max(hi - lo, 1e-9)


def union_counts(device, rows: int, bins: int, entries: int, seed: int = 0) -> torch.Tensor:
    """An int32 [rows, bins] union matrix: ``entries`` random columns a row
    holding counts 1-3, zeros elsewhere, made on ``device``."""
    dev = runtime.resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.randint(0, bins, (rows, entries), generator=g, device=dev)
    vals = torch.randint(1, 4, (rows, entries), generator=g, device=dev, dtype=torch.int32)
    mat = torch.zeros(rows, bins, dtype=torch.int32, device=dev)
    mat.scatter_(1, cols, vals)
    return mat


def two_pointer_rate(tables: int, entries: int, universe: int, threads: int,
                     seed: int = 0) -> float:
    """The native two-pointer's entry-pairs a second a thread: ``tables``
    sorted tables of ``entries`` codes drawn from ``universe`` codes, all
    pairs, host clock, divided by the ``threads`` it runs on."""
    rng = np.random.default_rng(seed)
    words = rng.choice(1 << 42, size=universe, replace=False).astype(np.uint64)
    codes = np.concatenate(
        [np.sort(rng.choice(words, size=entries, replace=False)) for _ in range(tables)])
    counts = rng.integers(1, 4, size=codes.size).astype(np.int64)
    offs = np.arange(tables + 1, dtype=np.int64) * entries
    native.min_sum_pairs_native(codes, counts, offs)  # warm the threads and pages
    t = time.perf_counter()
    native.min_sum_pairs_native(codes, counts, offs)
    seconds = time.perf_counter() - t
    return tables * (tables - 1) / 2 * entries / (seconds * threads)


def measure_compute(device: str | torch.device = "cuda", threads: int | None = None) -> dict:
    """K3's dense, union and peak rates, the threshold route's and the
    two-pointer's, with the thread count the two-pointer will use
    (``DistanceRates(threads=threads).host_threads()``)."""
    dev = runtime.resolve_device(device)
    on_card = dev.type == "cuda"
    dense_shape = DENSE_SHAPE if on_card else CPU_DENSE_SHAPE
    union_shape = UNION_SHAPE if on_card else CPU_UNION_SHAPE
    peak_shape = PEAK_SHAPE if on_card else CPU_PEAK_SHAPE
    thr_shape = THRESHOLD_SHAPE if on_card else CPU_THRESHOLD_SHAPE
    host_tables = HOST_TABLES if on_card else CPU_HOST_TABLES
    n_threads = DistanceRates(threads=threads).host_threads()
    counts = dense_counts(dev, *dense_shape)
    dense = k3_rate(counts)
    del counts
    counts = union_counts(dev, *union_shape)
    union = k3_rate(counts)
    counts = dense_counts(dev, *peak_shape)
    peak = k3_rate(counts)
    g = torch.Generator(device=dev).manual_seed(0)
    counts = torch.randint(0, 9, thr_shape, generator=g, device=dev, dtype=torch.int32)
    thr = threshold_rate(counts)
    del counts
    if on_card:
        torch.cuda.empty_cache()
    return {
        "bin_pairs_per_sec": union,
        "dense_bin_pairs_per_sec": dense,
        "peak_bin_pairs_per_sec": peak,
        "threshold_macs_per_sec": thr,
        "sparse_entry_pairs_per_sec_per_thread": two_pointer_rate(*host_tables, n_threads),
        "threads": n_threads,
        "dense_shape": [dense_shape[0], 4 ** dense_shape[1]],
        "union_shape": list(union_shape[:2]),
        "peak_shape": [peak_shape[0], 4 ** peak_shape[1]],
        "threshold_shape": list(thr_shape),
        "host_tables": list(host_tables[:2]),
    }


def calibrate(device: str | torch.device = "cuda", link_only: bool = False,
              threads: int | None = None) -> dict:
    """One calibration of this card and host: the fingerprint, the card's
    SM count (``sms``), the link, and unless ``link_only`` the compute
    rates."""
    dev = runtime.resolve_device(device)
    cal = {"fingerprint": fingerprint(dev), "device": str(dev)}
    if dev.type == "cuda":
        cal["sms"] = torch.cuda.get_device_properties(dev).multi_processor_count
    cal.update(measure_link(dev))
    if not link_only:
        cal.update(measure_compute(dev, threads))
    return cal
