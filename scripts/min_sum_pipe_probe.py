#!/usr/bin/env python3
"""Issue rates of the integer and half-precision instructions that a (min,+)
product can be built from, on one NVIDIA card (the PyTorch/CUDA port's K3
and K4, ``dna_kmeres_parallel_tpu_torch/csrc/min_sum.cu``).

    python3 scripts/min_sum_pipe_probe.py

Builds one small CUDA file with nvcc (``sm_90a``) into a temporary
directory, then for each instruction mix runs 8 blocks of 256 threads on
every SM, each thread 16 independent chains of the mix, and reports the
results per clock per SM: the thread instructions of the mix over the SM
clocks that ``clock64()`` counts across the slowest block (all 8 of an
SM's blocks run at once), and the SM clock those clocks imply over the
kernel's CUDA-event time. Prints one line per mix, the card's name and power
limit, and one JSON object. Needs a card, nvcc and the port's kernel
build settings; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (name, PTX of one step on chain %0 with the operand %1 (another chain,
#: so that no step can be folded into the next), instructions a step)
MIXES = (
    ("min.u16x2 (VIMNMX.U16x2)", "min.u16x2 %0, %0, %1;", 1),
    ("min.s32 (VIMNMX)", "min.s32 %0, %0, %1;", 1),
    ("add.u32 (IADD3)", "add.u32 %0, %0, %1;", 1),
    ("mad.lo.u32 (IMAD)", "mad.lo.u32 %0, %1, %2, %0;", 1),
    ("min.f16x2 (HMNMX2)", "min.f16x2 %0, %0, %1;", 1),
    ("add.f16x2 (HADD2)", "add.rn.f16x2 %0, %0, %1;", 1),
    ("min.u16x2 + add.u32", "{.reg .b32 t; min.u16x2 t, %0, %1; add.u32 %0, %0, t;}", 2),
    ("min.u16x2 + mad.lo.u32", "{.reg .b32 t; min.u16x2 t, %0, %1; mad.lo.u32 %0, t, %2, %0;}", 2),
    ("min.u16x2 + add.f16x2", "{.reg .b32 t; min.u16x2 t, %0, %1; add.rn.f16x2 %0, %0, t;}", 2),
    # two bins' minima and their two adds, which ptxas folds into one
    # three-input IADD3 (counted as 3 instructions a step)
    ("2 min.u16x2 + IADD3 of 3", "{.reg .b32 t, u; min.u16x2 t, %0, %1; min.u16x2 u, %1, %2;"
     " add.u32 %0, %0, t; add.u32 %0, %0, u;}", 3),
    ("2 min.u16x2 + 2 mad.lo.u32", "{.reg .b32 t, u; min.u16x2 t, %0, %1; min.u16x2 u, %1, %0;"
     " mad.lo.u32 %0, t, %2, %0; mad.lo.u32 %0, u, %2, %0;}", 4),
)

KERNEL = r"""
#include <cstdint>
template <int M>
__device__ __forceinline__ void step(uint32_t& r, uint32_t b, uint32_t one);
%STEPS%
template <int M>
__global__ void __launch_bounds__(256) bench(int iters, uint32_t one,
                                             uint32_t* sink, long long* cycles) {
  uint32_t r[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) r[k] = threadIdx.x * 16 + k;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k) step<M>(r[k], r[(k + 7) & 15], one);
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t x = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) x ^= r[k];
  if (x == 0x9e3779b9u) sink[0] = x;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int run(int mix, int blocks, int iters, long long* cycles, uint32_t* sink) {
  switch (mix) {
%CASES%
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def source() -> str:
    steps, cases = [], []
    for m, (_, ptx, _) in enumerate(MIXES):
        steps.append(
            f"template <> __device__ __forceinline__ void step<{m}>(uint32_t& r, uint32_t b, "
            f"uint32_t one) {{ asm volatile(\"{ptx}\" : \"+r\"(r) : \"r\"(b), \"r\"(one)); }}"
        )
        cases.append(
            f"    case {m}: bench<{m}><<<blocks, 256>>>(iters, 1u, sink, cycles); break;"
        )
    return KERNEL.replace("%STEPS%", "\n".join(steps)).replace("%CASES%", "\n".join(cases))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("min_sum_pipe_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp) / "pipes.cu", Path(tmp) / "pipes.so"
        src.write_text(source())
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS[:6], "-shared",
                        "-o", str(so), str(src)], check=True, capture_output=True, timeout=600)
        lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 4096
    cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    rates, clocks = {}, {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for m, (name, _, per_step) in enumerate(MIXES):
        for _ in range(2):  # the first run warms the clocks
            start.record()
            if lib.run(m, blocks, iters, cycles.data_ptr(), sink.data_ptr()):
                raise RuntimeError(f"{name}: launch failed")
            end.record()
            torch.cuda.synchronize()
        per_sm = 8 * 256 * iters * 16 * per_step  # thread instructions an SM
        slowest = float(cycles.max())
        rates[name] = per_sm / slowest
        clocks[name] = slowest / (start.elapsed_time(end) * 1e6)
        print(f"{name}: {rates[name]:.1f} thread instructions a clock per SM "
              f"({per_step} a step; SM clock {clocks[name]:.3f} GHz) [{card}]", flush=True)
    print(card)
    print(json.dumps({"card": card, "per_clock_per_sm": rates, "sm_clock_ghz": clocks}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
