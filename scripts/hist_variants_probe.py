#!/usr/bin/env python3
"""K5 and K7, the dense histograms of the counting path, beside their
candidates on one NVIDIA card, timed in alternating order in one process.

    python3 scripts/hist_variants_probe.py

Builds ``scripts/hist_variants.cu`` (which includes
``dna_kmeres_parallel_tpu_torch/csrc/histogram.cu`` whole) with nvcc for
``sm_90a`` into a temporary directory, and times with CUDA events, on one
16 Mbase batch of the dense path (``engine.batch_plan``) of an N-rich
stream and of one half of whose windows lie in one-base runs
(``chip_smoke.check_stream``, ``runs_stream``):

- K5 at k=8 (65,536 bins) from the planes: 16-bit halves, one whole
  histogram a block (the port's kernel); the cluster histogram in clusters
  of 2 and 4 blocks; every window straight into the accumulator in device
  memory (red.global); and the first port's sliced kernel;
- K5 at k=6 (4,096 bins): one block's cluster histogram (the port's), and
  the first port's;
- K7 at k=3 (64 bins): from u8 and from the packed batch with 32-bit
  per-thread counters in blocks of 768 threads (the port's), of 896, 512
  and 256, and with 16-bit counters in pairs in blocks of 1,024; the first
  port's u8 kernel; and the packed route before this design:
  ``encode.unpack_stream`` followed by the first port's kernel, and by the
  port's u8 kernel.

Every candidate is first checked equal to the plain version. Each is timed
twice, in the order of the candidates and then in reverse, by two timers:
``chip_smoke.time_ms`` (20 calls queued by the host, as ``chip_smoke.py``
times every kernel), and the same calls queued behind a spin of the card
(``torch.cuda._sleep``), so that a kernel that runs faster than the host
launches it is timed by its own run. Prints one line per time tagged with
the card's name and power limit, then one JSON object. Imports nothing of
JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "hist_variants.cu"


#: K7's block in other sizes, made from histogram.cu by replacing its
#: line, beside the port's 768 threads (one block of 192 KB an SM): 896
#: (224 KB), 512 (one of 128 KB) and 256 (three of 64 KB)
K7_VARIANTS = {
    f"32-bit x {n}": (("kSmallThreads = 768;", f"kSmallThreads = {n};"),)
    for n in (896, 512, 256)
}
#: clock cycles the card spins before the gated timer's calls, while the
#: host queues them (about 10 ms at the H100's clocks)
QUEUE_CYCLES = 20_000_000


def build(tmp: Path) -> dict:
    """{"as built": the library of hist_variants.cu, and one per
    K7_VARIANTS entry}, compiled in parallel."""
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    src = (kernels.CSRC_DIR / "histogram.cu").read_text()
    procs = {}
    for i, name in enumerate(("as built", *K7_VARIANTS)):
        inc = tmp / f"v{i}"
        inc.mkdir()
        text = src
        for old, new in K7_VARIANTS.get(name, ()):
            if text.count(old) != 1:
                raise RuntimeError(f"histogram.cu no longer holds {old!r} once")
            text = text.replace(old, new)
        (inc / "histogram.cu").write_text(text)
        so = inc / "libhist_variants.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(inc), "-I",
               str(kernels.CSRC_DIR), "-shared", "-o", str(so), str(SOURCE)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, (so, proc) in procs.items():
        out = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SOURCE.name} ({name})\n{out[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.kp_hist_planes.argtypes = [vp, vp, ll, ll, ci, ci, vp, vp]
        lib.kp_hist_u8_small.argtypes = [vp, ll, ll, ci, ci, ci, vp, vp]
        lib.kp_hist_packed_small.argtypes = [vp, vp, ll, ll, ci, ci, ci, vp, vp]
        lib.kv_old_small.argtypes = [vp, ll, ll, ci, ci, ci, vp, vp]
        for fn in ("kv_old_planes", "kv_planes_global"):
            getattr(lib, fn).argtypes = [vp, vp, ll, ll, ci, ci, vp, vp]
        lib.kv_planes_cluster.argtypes = [vp, vp, ll, ll, ci, ci, ci, vp, vp]
        lib.kv_pair_small.argtypes = [vp, vp, ll, ll, ci, ci, ci, vp, vp]
        libs[name] = lib
    return libs


def gated_ms(fn, iters: int) -> float:
    """``chip_smoke.time_ms`` with the timed calls queued behind a spin of
    the card (QUEUE_CYCLES)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(dev, card: str, log=print) -> dict:
    """Check and time every candidate; returns {case: {candidate: {"ms":
    [...], "gated_ms": [...]}}} (two times each, from the two halves of
    the alternation)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dna_kmeres_parallel_tpu_torch import KmerConfig, native
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan, stage_batch_planes
    from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
    from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda as hc

    batch, T = batch_plan(1 << 40, 8, KmerConfig().batch_bases)
    rng = np.random.default_rng(9)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
    lib = libs["as built"]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn, *args):
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{fn.__name__} launch failed: cudaError_t {rc}")

    result: dict = {}
    for label, bases in (("random", cs.check_stream(rng, T)), ("runs", cs.runs_stream(rng, T))):
        wl, ib = stage_batch_planes(bases, dev)
        data, mask, _ = native.pack_2bit_native(bases)
        data = torch.from_numpy(data).to(dev)
        mask = torch.from_numpy(mask).to(dev)
        b = torch.from_numpy(bases).to(dev)
        nw = wl.numel()

        def planes(k):
            return lambda acc: call(lib.kp_hist_planes, wl.data_ptr(), ib.data_ptr(), nw, batch,
                                    k, 0, acc.data_ptr(), stream)

        def planes_cluster(cluster):
            return lambda acc: call(lib.kv_planes_cluster, wl.data_ptr(), ib.data_ptr(), nw,
                                    batch, 8, 0, cluster, acc.data_ptr(), stream)

        def planes_v(name, k):
            return lambda acc: call(getattr(lib, name), wl.data_ptr(), ib.data_ptr(), nw,
                                    batch, k, 0, acc.data_ptr(), stream)

        def small(name, src, lib=lib):
            def fn(acc):
                u8 = src()  # held until the launch is queued
                call(getattr(lib, name), u8.data_ptr(), T, batch, 3, 0, 64, acc.data_ptr(),
                     stream)
            return fn

        def packed_small(lib):
            return lambda acc: call(lib.kp_hist_packed_small, data.data_ptr(), mask.data_ptr(),
                                    T, batch, 3, 0, 64, acc.data_ptr(), stream)

        k7 = {"packed (kept)": packed_small(lib),
              "u8 (kept)": small("kp_hist_u8_small", lambda: b)}
        for name in K7_VARIANTS:
            k7[f"packed {name}"] = packed_small(libs[name])
            k7[f"u8 {name}"] = small("kp_hist_u8_small", lambda: b, libs[name])
        k7["packed 16-bit x 1024"] = lambda acc: call(
            lib.kv_pair_small, data.data_ptr(), mask.data_ptr(), T, batch, 3, 0, 64,
            acc.data_ptr(), stream)
        k7["u8 16-bit x 1024"] = lambda acc: call(
            lib.kv_pair_small, b.data_ptr(), None, T, batch, 3, 0, 64, acc.data_ptr(), stream)

        cases = {
            "K5 k=8": (8, {
                "halves (kept)": planes(8),
                "cluster C=2": planes_cluster(2),
                "cluster C=4": planes_cluster(4),
                "red.global": planes_v("kv_planes_global", 8),
                "first port": planes_v("kv_old_planes", 8),
            }, lambda: hc.hist_planes_reference(wl, ib, batch, 8)),
            "K5 k=6": (6, {
                "cluster C=1 (kept)": planes(6),
                "red.global": planes_v("kv_planes_global", 6),
                "first port": planes_v("kv_old_planes", 6),
            }, lambda: hc.hist_planes_reference(wl, ib, batch, 6)),
            "K7 k=3": (3, {
                **k7,
                "first port u8": small("kv_old_small", lambda: b),
                "unpack + first port u8": small("kv_old_small",
                                          lambda: encode_ops.unpack_stream(data, mask)),
                "unpack + u8 (kept)": small("kp_hist_u8_small",
                                            lambda: encode_ops.unpack_stream(data, mask)),
            }, lambda: hc.hist_u8_reference(b, batch, 3, 64)),
        }
        for case, (k, fns, plain) in cases.items():
            want = plain()
            accs = {}
            for name, fn in fns.items():
                acc = torch.zeros(4**k, dtype=torch.int32, device=dev)
                fn(acc)
                torch.cuda.synchronize()
                if not torch.equal(acc, want):
                    raise AssertionError(f"{case} {label} {name} differs from the plain version")
                accs[name] = acc
            order = list(fns) + list(fns)[::-1]
            times = result.setdefault(f"{case} {label}", {})
            for name in order:
                fn = lambda: fns[name](accs[name])  # noqa: E731
                ms, gated = cs.time_ms(fn, 20), gated_ms(fn, 20)
                t = times.setdefault(name, {"ms": [], "gated_ms": []})
                t["ms"].append(ms)
                t["gated_ms"].append(gated)
                log(f"probe {case} {label} {name}: {ms:.4f} ms, gated {gated:.4f} ms [{card}]")
        del wl, ib, data, mask, b
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hist_variants_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    result = run(torch.device("cuda", 0), card)
    print(card)
    print(json.dumps({"card": card, "ms": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
