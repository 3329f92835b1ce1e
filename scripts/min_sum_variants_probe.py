#!/usr/bin/env python3
"""Where K3's and K4's time goes on one NVIDIA card: the port's (min,+)
kernels (``dna_kmeres_parallel_tpu_torch/csrc/min_sum.cu``) beside three
variants built from the same source, and K4's bin split beside its other
reduction, timed in alternating order in one process.

    python3 scripts/min_sum_variants_probe.py

- ``as built``: the kernels as the port builds them;
- ``plain adds``: each add written as ``acc + min``, which ptxas folds,
  two bins at a time, into one three-input IADD3 on the ALU pipe, beside
  the minima (the kernels issue it as an IMAD by a runtime one instead);
- ``no stores``: the tiles computed and never written (each block folds its
  accumulators into one word and stores it only if it equals a constant
  that it never equals): the arithmetic and the staging alone;
- ``one tile``: every block stores its tile into the output's first
  128 x 128 (no mirror): the store phase's work without its traffic to
  device memory, since those 64 KB stay in the L2 cache.

Each variant is built by nvcc (``sm_90a``) into a temporary directory and
timed with CUDA events on the distance path's counts: 54,018 seeded
records of 1-2 kbase at k=3 (``chip_smoke.distance_records``), K4 at the
first [2048, 64] panel against all records and K3 over all records, on the
packed ``u16x2`` route, all unsplit (one bin slice, as the port runs
them there). The plain-add build is checked equal to the kernel as built.

The split, at two products of few output tiles: K4 over [256, 131,072]
counts against themselves on the ``i32`` route (row 0 sums to 2^16), and
(g) k=10's panel, [256, 4^10] against itself on ``u16x2``
(``chip_smoke.wide_counts``), each run

- ``unsplit``: the kernel as built with one bin slice (the design before
  the split);
- ``split, atomics``: as the port runs it, with the plan's P
  slices, each block adding its tile into the zeroed output;
- ``split, workspace``: the same slices, each stored into its own plane
  of an int32 [P, S, S2] workspace and summed by a second kernel
  (``scripts/min_sum_variants.cu``).

Each is checked equal to the plain version and timed twice over
(alternating order), by ``chip_smoke.time_ms`` and behind a spin of the
card (``torch.cuda._sleep``). Prints one line per measurement tagged with
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
#: the workspace build of the split (includes csrc/min_sum.cu)
WS_SOURCE = ROOT / "scripts" / "min_sum_variants.cu"
#: clock cycles the card spins before the gated timer's calls, while the
#: host queues them (about 10 ms at the H100's clocks)
QUEUE_CYCLES = 20_000_000
#: the split's shapes: (name, rows, bins, counts kind, route)
SPLIT_SHAPES = (
    ("K4 [256, 131072] x [256, 131072]", 256, 131_072, "wide", "i32"),
    ("K4 (g) k=10 panel [256, 4^10] x [256, 4^10]", 256, 4**10, "small", "u16x2"),
)

ADD = '  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(m), "r"(one), "r"(acc));'
PLAIN_ADD = "  d = acc + m + 0 * one;"
STORES = (
    "  store_tile<kPacked, kSplit>(acc, smem, out, S, r0, S, c0, S, false);\n"
    "  if (ti != tj) store_tile<kPacked, kSplit>(acc, smem, out, S, c0, S, r0, S, true);",
    "  store_tile<kPacked, kSplit>(acc, smem, out, S2, r0, S, c0, S2, false);",
)
SINK = """  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) x ^= acc[i][j] * (i * 8 + j + 1);
  if (x == 0x9e3779b9u) out[0] = 1;"""


def variants(src: str) -> dict:
    for text in (ADD, *STORES):
        if text not in src:
            raise RuntimeError(f"min_sum.cu no longer holds: {text.strip()[:60]}")
    no_stores, one_tile = src, src
    for text in STORES:
        no_stores = no_stores.replace(text, SINK)
        one_tile = one_tile.replace(
            text, "  store_tile<kPacked, kSplit>(acc, smem, out, 128, 0, 128, 0, 128, false);")
    return {"as built": src, "plain adds": src.replace(ADD, PLAIN_ADD), "no stores": no_stores,
            "one tile": one_tile}


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


def split_probe(unsplit, ws_lib, dev, card: str) -> dict:
    """The SPLIT_SHAPES runs: {shape: {"split": P, candidate: {"ms": [..],
    "gated_ms": [..]}}}; each candidate checked equal to the plain
    version."""
    import torch

    import chip_smoke as cs
    from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda

    stream = torch.cuda.current_stream().cuda_stream
    result: dict = {}
    for shape, rows, B, kind, route in SPLIT_SHAPES:
        a = torch.from_numpy(cs.wide_counts(rows, B, kind, B)).to(dev)
        c = torch.from_numpy(cs.wide_counts(rows, B, kind, B + 1)).to(dev)
        if distance_cuda.product_route(*distance_cuda.check_counts(a, c)) != route:
            raise AssertionError(f"{shape}: the counts do not take the {route} route")
        P, L = distance_cuda.product_split(rows, rows, B, route, dev, False)
        want = distance.min_sum_matrix(a, c)
        out = torch.empty(rows, rows, dtype=torch.int32, device=dev)
        ws = torch.empty(P, rows, rows, dtype=torch.int32, device=dev)
        suffix = "" if route == "i32" else "_u16x2"
        rect = getattr(unsplit, f"kp_min_sum_rect{suffix}")
        rect_ws = getattr(ws_lib, f"kv_min_sum_rect_ws{suffix}")
        args = (a.data_ptr(), rows, c.data_ptr(), rows, B)

        def run(fn, *tail):
            def call():
                rc = fn(*args, *tail, stream)
                if rc:
                    raise RuntimeError(f"{shape}: launch failed, cudaError_t {rc}")
            return call

        cands = {"unsplit": run(rect, B, out.data_ptr()),
                 "split, atomics": run(rect, L, out.data_ptr()),
                 "split, workspace": run(rect_ws, L, ws.data_ptr(), out.data_ptr())}
        rec = result.setdefault(shape, {"split": P, "route": route})
        for name in list(cands) + list(cands)[::-1]:
            out.fill_(-1)
            cands[name]()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} differs from the plain version at {shape}")
            iters = 3 if name == "unsplit" else 10
            ms, gated = cs.time_ms(cands[name], iters), gated_ms(cands[name], iters)
            times = rec.setdefault(name, {"ms": [], "gated_ms": []})
            times["ms"].append(ms)
            times["gated_ms"].append(gated)
            print(f"{shape} ({route}, P={P}) {name}: {ms:.4f} ms, gated {gated:.4f} ms "
                  f"[{card}]", flush=True)
        del a, c, want, out, ws
        torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("min_sum_variants_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda, kernels

    card = cs.card_line()
    src = (kernels.CSRC_DIR / "min_sum.cu").read_text()
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, text) in enumerate(variants(src).items()):
            cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"v{i}.so"
            cu.write_text(text)
            procs[name] = (so, subprocess.Popen(
                [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        ws_so = Path(tmp) / "ws.so"
        ws_proc = subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR), "-shared",
             "-o", str(ws_so), str(WS_SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (so, proc) in procs.items():
            out = proc.communicate(timeout=600)[0]
            if proc.returncode:
                raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
            lib = ctypes.CDLL(str(so))
            for fn in ("kp_min_sum_rect", "kp_min_sum_rect_u16x2"):
                getattr(lib, fn).argtypes = [vp, ll, vp, ll, ll, ll, vp, vp]
            lib.kp_min_sum_tri_u16x2.argtypes = [vp, ll, ll, ll, vp, vp]
            libs[name] = lib
        out = ws_proc.communicate(timeout=600)[0]
        if ws_proc.returncode:
            raise RuntimeError(f"{WS_SOURCE.name}: nvcc failed\n{out[-3000:]}")
        ws_lib = ctypes.CDLL(str(ws_so))
        for fn in ("kv_min_sum_rect_ws", "kv_min_sum_rect_ws_u16x2"):
            getattr(ws_lib, fn).argtypes = [vp, ll, vp, ll, ll, ll, vp, vp, vp]

    dev = torch.device("cuda", 0)
    stream, starts, lengths = cs.distance_records(54_018)
    grid = torch.from_numpy(cs.record_grid(stream, starts, lengths)).to(dev)
    counts = histogram_cuda.counts_matrix_cuda(grid, 3, 64)
    del grid
    S = counts.shape[0]
    panel = counts[:2048]
    cuda_stream = torch.cuda.current_stream().cuda_stream
    outs = {"K4 [2048, 64] x [54018, 64]": torch.empty(2048, S, dtype=torch.int32, device=dev),
            "K3 [54018, 64]": torch.empty(S, S, dtype=torch.int32, device=dev)}

    def launch(lib, shape):
        out = outs[shape]
        if shape.startswith("K4"):
            return lambda: lib.kp_min_sum_rect_u16x2(panel.data_ptr(), 2048, counts.data_ptr(), S,
                                                     64, 1, out.data_ptr(), cuda_stream)
        return lambda: lib.kp_min_sum_tri_u16x2(counts.data_ptr(), S, 64, 1, out.data_ptr(),
                                                cuda_stream)

    result: dict = {}
    order = list(libs) + list(libs)[::-1]
    for shape in outs:
        launch(libs["as built"], shape)()
        torch.cuda.synchronize()
        want = outs[shape].clone() if shape.startswith("K4") else outs[shape][:: 4096].clone()
        for name in order:
            fn = launch(libs[name], shape)
            ms = cs.time_ms(fn, 20 if shape.startswith("K4") else 5)
            if name in ("as built", "plain adds"):
                got = outs[shape] if shape.startswith("K4") else outs[shape][:: 4096]
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} differs from the kernel as built at {shape}")
            result.setdefault(shape, {}).setdefault(name, []).append(ms)
            print(f"{shape} {name}: {ms:.4f} ms [{card}]", flush=True)
    del outs, counts, panel
    torch.cuda.empty_cache()
    result["split"] = split_probe(libs["as built"], ws_lib, dev, card)
    print(card)
    print(json.dumps({"card": card, "ms": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
