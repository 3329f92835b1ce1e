#!/usr/bin/env python3
"""K1 and K1m, the packed-plane window encoder and its minimizer plane,
beside the first port's kernel and candidates of the port's, on one NVIDIA
card, timed in alternating order in one process.

    python3 scripts/encode_variants_probe.py

Builds ``scripts/encode_variants.cu`` (which includes
``dna_kmeres_parallel_tpu_torch/csrc/encode_packed.cu`` whole, and holds
the first port's kernel as ``kv_encode_packed_before``) with nvcc for
``sm_90a`` into a temporary directory, once as the source stands and once
per entry of VARIANTS (the port's source with lines replaced), all
compiled in parallel. Times with CUDA events, on ``chip_smoke.check_stream``
planes:

- K1 at k=21 and at canonical k=11 on one 16 Mbase batch of the counting
  path (``batch_plan``);
- K1 at k=31 on one config-5 shard (``chip_smoke.shard_windows`` of the
  default 256 Mbase FASTA), as the prefix-owner route launches it;
- K1m at k=31, m=7 on the same shard.

Every candidate is first checked equal to the plain version
(``encode_cuda.encode_packed_reference``), plane by plane. Each is timed
twice, in the order of the candidates and then in reverse, by two timers:
``chip_smoke.time_ms`` (20 calls queued by the host), and the same calls
queued behind a spin of the card (``hist_variants_probe.gated_ms``). The
calls go straight to the C entries with outputs allocated once, so no
wrapper cost is timed. Prints one line per time tagged with the card's
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
SCRIPTS = Path(__file__).resolve().parent
SOURCE = SCRIPTS / "encode_variants.cu"

_STAGED = """  __syncwarp();  // the warp's reads of the previous plane are done
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) stage[swizzle(CHUNKS * lane + q)] = chunk[q];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = 32 * i + lane;
    if (c < n_chunks) __stcs(out + c, stage[swizzle(c)]);  // streaming: evict first
  }"""
_DIRECT = """#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int c = CHUNKS * lane + q;
    if (c < n_chunks) __stcs(out + c, chunk[q]);
  }"""
#: the port's kernel with lines replaced: each thread's 16-byte chunks
#: stored straight from its registers (no shared-memory stage), plain
#: stores in place of streaming (evict-first) ones, and blocks of 128 and
#: 512 threads
VARIANTS = {
    "direct stores": ((_STAGED, _DIRECT),),
    "plain stores": (("__stcs(out + c, stage[swizzle(c)]);", "out[c] = stage[swizzle(c)];"),),
    "128 threads": (("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),),
    "512 threads": (("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),),
}


def build(tmp: Path) -> dict:
    """{"as built": the library of encode_variants.cu, and one per VARIANTS
    entry}, compiled in parallel."""
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    src = (kernels.CSRC_DIR / "encode_packed.cu").read_text()
    procs = {}
    for i, name in enumerate(("as built", *VARIANTS)):
        inc = tmp / f"v{i}"
        inc.mkdir()
        text = src
        for old, new in VARIANTS.get(name, ()):
            if text.count(old) != 1:
                raise RuntimeError(f"encode_packed.cu no longer holds {old!r} once")
            text = text.replace(old, new)
        (inc / "encode_packed.cu").write_text(text)
        so = inc / "libencode_variants.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(inc), "-I",
               str(kernels.CSRC_DIR), "-shared", "-o", str(so), str(SOURCE)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, (so, proc) in procs.items():
        out = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SOURCE.name} ({name})\n{out[-3000:]}")
        if name == "as built":
            for line in out.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn in ("kp_encode_packed", "kv_encode_packed_before"):
            getattr(lib, fn).restype = ci
            getattr(lib, fn).argtypes = [vp, vp, ll, ll, ci, ci, vp, vp, ci, ci, vp, vp]
        libs[name] = lib
    return libs


def run(dev, card: str, log=print) -> dict:
    """Check and time every candidate; returns {case: {candidate: {"ms":
    [...], "gated_ms": [...]}}} (two times each, from the two halves of
    the alternation)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(SCRIPTS))
    import chip_smoke as cs
    from hist_variants_probe import gated_ms

    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.engine import batch_plan, stage_batch_planes
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda
    from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(10)
    shard = cs.smoke_shard_bases(256_000_000)
    cases = []
    for k, canonical in ((21, False), (11, True)):
        batch, T = batch_plan(1 << 40, k, KmerConfig().batch_bases)
        cases.append((f"K1 k={k}{' canonical' if canonical else ''} 16 Mbase", k, canonical,
                      None, batch, T))
    T = cs.shard_windows(shard)
    cases.append(("K1 k=31 shard", 31, False, None, shard, T))
    cases.append(("K1m k=31 m=7 shard", 31, False, 7, shard, T))

    result: dict = {}
    for case, k, canonical, m, n_own, T in cases:
        planes = stage_batch_planes(cs.check_stream(rng, T), dev)
        want = encode_cuda.encode_packed_reference(*planes, n_own, k, canonical, minimizer_m=m)
        hi_dt = sparse_ops.hi_dtype(k)
        outs = {}

        def entry(lib, fn_name):
            lo = torch.empty(T, dtype=torch.int32, device=dev)
            hi = None if hi_dt is None else torch.empty(T, dtype=hi_dt, device=dev)
            mins = None if m is None else torch.empty(T, dtype=torch.int32, device=dev)
            fn = getattr(lib, fn_name)
            args = (planes[0].data_ptr(), planes[1].data_ptr(), T // 16, n_own, k,
                    int(canonical), lo.data_ptr(), None if hi is None else hi.data_ptr(),
                    0 if hi_dt is None else hi_dt.itemsize, m or 0,
                    None if mins is None else mins.data_ptr(), stream)

            def call():
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"{fn_name} launch failed: cudaError_t {rc}")
            return call, (hi, lo) if m is None else (hi, lo, mins)

        fns = {"before (first port)": entry(libs["as built"], "kv_encode_packed_before"),
               "kept": entry(libs["as built"], "kp_encode_packed")}
        for name in VARIANTS:
            fns[name] = entry(libs[name], "kp_encode_packed")
        for name, (call, got) in fns.items():
            call()
            torch.cuda.synchronize()
            for g, r in zip(got, want, strict=True):
                if not ((g is None and r is None) or torch.equal(g, r)):
                    raise AssertionError(f"{case} {name} differs from the plain version")
            outs[name] = call
        del want
        order = list(outs) + list(outs)[::-1]
        times = result.setdefault(case, {})
        for name in order:
            ms, gated = cs.time_ms(outs[name], 20), gated_ms(outs[name], 20)
            t = times.setdefault(name, {"ms": [], "gated_ms": []})
            t["ms"].append(ms)
            t["gated_ms"].append(gated)
            log(f"probe {case} T={T} {name}: {ms:.4f} ms, gated {gated:.4f} ms [{card}]")
        del planes, fns, outs
        torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("encode_variants_probe: CUDA is not available", file=sys.stderr)
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
