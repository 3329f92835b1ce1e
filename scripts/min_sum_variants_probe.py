#!/usr/bin/env python3
"""Where K3's and K4's time goes on one NVIDIA card: the port's (min,+)
kernels (``dna_kmeres_parallel_tpu_torch/csrc/min_sum.cu``) beside three
variants built from the same source, timed in alternating order in one
process.

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
packed ``u16x2`` route. The plain-add build is checked equal to the
kernel as built. Prints one line per measurement tagged with the card's
name and power limit, then one JSON object. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ADD = '  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(m), "r"(one), "r"(acc));'
PLAIN_ADD = "  d = acc + m + 0 * one;"
STORES = (
    "  store_tile<kPacked>(acc, smem, out, S, r0, S, c0, S, false);\n"
    "  if (ti != tj) store_tile<kPacked>(acc, smem, out, S, c0, S, r0, S, true);",
    "  store_tile<kPacked>(acc, smem, out, S2, r0, S, c0, S2, false);",
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
            text, "  store_tile<kPacked>(acc, smem, out, 128, 0, 128, 0, 128, false);")
    return {"as built": src, "plain adds": src.replace(ADD, PLAIN_ADD), "no stores": no_stores,
            "one tile": one_tile}


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
        for name, (so, proc) in procs.items():
            out = proc.communicate(timeout=600)[0]
            if proc.returncode:
                raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
            lib = ctypes.CDLL(str(so))
            lib.kp_min_sum_rect_u16x2.argtypes = [vp, ll, vp, ll, ll, vp, vp]
            lib.kp_min_sum_tri_u16x2.argtypes = [vp, ll, ll, vp, vp]
            libs[name] = lib

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
                                                     64, out.data_ptr(), cuda_stream)
        return lambda: lib.kp_min_sum_tri_u16x2(counts.data_ptr(), S, 64, out.data_ptr(), cuda_stream)

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
    print(card)
    print(json.dumps({"card": card, "ms": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
