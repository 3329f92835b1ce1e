#!/usr/bin/env python3
"""K2 (the per-sequence counts matrix) and P1 (the per-row roll) beside
their candidates on one NVIDIA card, timed in alternating order in one
process.

    python3 scripts/counts_matrix_variants_probe.py

Builds ``scripts/counts_matrix_variants.cu`` (which includes
``dna_kmeres_parallel_tpu_torch/csrc/counts_matrix.cu`` and
``owner_segments.cu`` whole) with nvcc for ``sm_90a`` into a temporary
directory, and times with CUDA events:

- K2 on the distance path's grids (``chip_smoke.distance_records``, 54,018
  records of 1,000-2,000 bases): (a) the first 16,384 rows at k=3, (c) all
  54,018 rows at k=3 (the reference workload's one launch), (b) the first
  2,048 rows at k=8 (65,536 bins); the first 16,384 rows at k=5 and k=6
  (1,024 and 4,096 bins, the middle range); and 8 rows of 4,000,000 bases
  at k=3 (a few long rows). Candidates: the port's kernel; the same source with
  the text changes of K2_VARIANTS, each built as its own library
  (per-lane counters in K7's layout in place of the warp's histogram; the
  halo shuffled as digits, so each chunk's bytes are converted once; two
  histograms a warp; the next chunk loaded before this one is counted;
  the warp route at 48 and 64 warps an SM; the block route above 64 bins
  in place of 4,096; and two diagnostic builds, not checked, that count no
  window or add none); and the first port's kernel.
- P1 at [32768, 2048] (the largest row-route shape of ``chip_smoke.py``)
  and at [8, 256] (the tile the row route's probe rolls): the port's
  kernel (one word a lane); whole quads of 4 words written as 16-byte
  stores, read by 4-byte loads, the same with streaming stores, and with
  two 16-byte loads and a word select; and the first port's kernel.

Every candidate but the diagnostic builds is first checked equal to the
plain version. Each is timed twice, in the order of the candidates and
then in reverse, by two timers:
``chip_smoke.time_ms`` (20 calls queued by the host) and the same calls
queued behind a spin of the card (``hist_variants_probe.gated_ms``). Prints
one line per time tagged with the card's name and power limit, each case's
bound, then one JSON object. Imports nothing of JAX.
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
SOURCE = SCRIPTS / "counts_matrix_variants.cu"

#: the long-row case: rows x bases
LONG_ROWS = (8, 4_000_000)
#: P1's shapes: [rows, W]
ROLL_SHAPES = ((32768, 2048), (8, 256))


BYTE_HALO = """// Count the windows that start in chunk c of an item (every lane of the
// warp calls it together, for the halo's shuffle).
template <bool kCanonical, typename Add>
__device__ __forceinline__ void count_chunk(const uint8_t* __restrict__ abase, int64_t c,
                                            const Item& it, int64_t mis, int64_t end,
                                            int64_t limit, int k, uint32_t bins, Add& add) {
  uint32_t w[8];
  u8_chunk_pair(abase, c, mis, end, w);
  if (c < it.c1 && (w[0] & w[1] & w[2] & w[3]) != 0xFFFFFFFFu) {
    count_u8<kCanonical>(w, 16 * c - it.row_lo, limit, k, bins, add);
  }
}"""

DIGIT_HALO = """// The 16 bytes of a chunk as 2-bit digits (byte i at bits 2i) and
// validity bits (bit i).
__device__ __forceinline__ void chunk_bits(const uint4& q, uint32_t& d, uint32_t& v) {
  d = digits4(q.x) | digits4(q.y) << 8 | digits4(q.z) << 16 | digits4(q.w) << 24;
  v = valid4(q.x) | valid4(q.y) << 4 | valid4(q.z) << 8 | valid4(q.w) << 12;
}

// Count the windows that start in chunk c of an item. The halo, chunk
// c + 1, comes as digits and validity bits from the next lane, which
// turned its own chunk into them (lane 31 turns chunk c + 1 itself); every
// lane of the warp calls it together.
template <bool kCanonical, typename Add>
__device__ __forceinline__ void count_chunk(const uint8_t* __restrict__ abase, int64_t c,
                                            const Item& it, int64_t mis, int64_t end,
                                            int64_t limit, int k, uint32_t bins, Add& add) {
  const uint4 cur = stream_chunk(abase, c, mis, end);
  uint32_t d, v;
  chunk_bits(cur, d, v);
  uint32_t dn = __shfl_down_sync(0xFFFFFFFFu, d, 1);
  uint32_t vn = __shfl_down_sync(0xFFFFFFFFu, v, 1);
  if ((threadIdx.x & 31) == 31) chunk_bits(stream_chunk(abase, c + 1, mis, end), dn, vn);
  if (c < it.c1 && (cur.x & cur.y & cur.z & cur.w) != 0xFFFFFFFFu) {
    count16<kCanonical>(d | static_cast<uint64_t>(dn) << 32, v | vn << 16, 16 * c - it.row_lo,
                        limit, k, bins, add);
  }
}"""

WARP_LOOP = """    // The loop bound is the warp's first chunk: all lanes shuffle together.
    for (int64_t c0 = it.c0; c0 < it.c1; c0 += 32) {
      count_chunk<kCanonical>(abase, c0 + lane, it, mis, end, limit, k,
                              static_cast<uint32_t>(bins), add);
    }"""

PREFETCH_LOOP = """    uint4 next = make_uint4(0, 0, 0, 0);
    if (it.c0 < it.c1) next = stream_chunk(abase, it.c0 + lane, mis, end);
    for (int64_t c0 = it.c0; c0 < it.c1; c0 += 32) {
      const uint4 cur = next;
      const bool more = c0 + 32 < it.c1;
      if (more) next = stream_chunk(abase, c0 + 32 + lane, mis, end);
      uint4 halo;
      halo.x = __shfl_down_sync(0xFFFFFFFFu, cur.x, 1);
      halo.y = __shfl_down_sync(0xFFFFFFFFu, cur.y, 1);
      halo.z = __shfl_down_sync(0xFFFFFFFFu, cur.z, 1);
      halo.w = __shfl_down_sync(0xFFFFFFFFu, cur.w, 1);
      if (more) {
        const uint4 first = make_uint4(__shfl_sync(0xFFFFFFFFu, next.x, 0),
                                       __shfl_sync(0xFFFFFFFFu, next.y, 0),
                                       __shfl_sync(0xFFFFFFFFu, next.z, 0),
                                       __shfl_sync(0xFFFFFFFFu, next.w, 0));
        if (lane == 31) halo = first;
      } else if (lane == 31) {
        halo = stream_chunk(abase, c0 + 32, mis, end);
      }
      const uint32_t w[8] = {cur.x, cur.y, cur.z, cur.w, halo.x, halo.y, halo.z, halo.w};
      const int64_t c = c0 + lane;
      if (c < it.c1 && (cur.x & cur.y & cur.z & cur.w) != 0xFFFFFFFFu) {
        count_u8<kCanonical>(w, 16 * c - it.row_lo, limit, k, static_cast<uint32_t>(bins), add);
      }
    }"""

#: K2 made from counts_matrix.cu by replacing its text, beside the port's
#: kernel: per-lane counters in K7's layout (bin b of lane l in word
#: b * 32 + l: a plain load, add and store a window, no conflict; the flush
#: sums 32 words a bin, reading lane t's word in bank (t + lane) % 32); the
#: halo taken from the next lane as digits and validity bits
#: (two words, so each chunk's bytes are converted once, not by both lanes
#: that read them); two histograms a warp (even and odd lanes, 65 words
#: apart); the warp route loading its next chunk before it counts this
#: one ("prefetch"); the warp route held to 48 or 64 warps an SM (at most 40 or 32
#: registers a thread); the block route taking every width above 64 bins
#: ("block route above 64 bins"); and two DIAGNOSTIC builds that give wrong counts
#: and say what bounds the kernel: every key computed but none added
#: ("no shared adds"), and the chunks loaded but no window counted
#: ("loads only")
K2_VARIANTS = {
    "digit halo": ((BYTE_HALO, DIGIT_HALO),),
    "per-lane counters": (
        ("static constexpr int words(int bins) { return bins; }",
         "static constexpr int words(int bins) { return bins * 32; }"),
        ("for (int b = lane; b < bins; b += 32) h[b] = 0;",
         "for (int b = lane; b < bins * 32; b += 32) h[b] = 0;"),
        ("atomicAdd(h + key, 1u); }", "h[key * 32 + lane] += 1u; }"),
        ("uint32_t total(int b) const { return h[b]; }",
         "uint32_t total(int b) const { uint32_t s = 0; for (int t = 0; t < 32; ++t) "
         "s += h[b * 32 + ((t + lane) & 31)]; return s; }"),
    ),
    "two histograms a warp": (
        ("static constexpr int words(int bins) { return bins; }",
         "static constexpr int words(int bins) { return bins + 65; }"),
        ("for (int b = lane; b < bins; b += 32) h[b] = 0;",
         "for (int b = lane; b < bins + 65; b += 32) h[b] = 0;"),
        ("atomicAdd(h + key, 1u); }", "atomicAdd(h + (lane & 1) * 65 + key, 1u); }"),
        ("uint32_t total(int b) const { return h[b]; }",
         "uint32_t total(int b) const { return h[b] + h[65 + b]; }"),
    ),
    **{f"{8 * n} warps an SM": ((
        "__launch_bounds__(kWarpThreads)\ncounts_warp_kernel",
        f"__launch_bounds__(kWarpThreads, {n})\ncounts_warp_kernel"),) for n in (6, 8)},
    "prefetch": ((WARP_LOOP, PREFETCH_LOOP),),
    "block route above 64 bins": ((
        "constexpr int kWarpMaxBins = 4096;", "constexpr int kWarpMaxBins = 64;"),),
    "no shared adds": (("atomicAdd(h + key, 1u); }", "if (key == 0xFFFFFFFFu) h[0] = 1; }"),),
    "loads only": ((
        "count_u8<kCanonical>(w, 16 * c - it.row_lo, limit, k, bins, add);",
        "if ((w[0] ^ w[5]) == 0x9E3779B9u) add(0u);"),),
}
#: the variants that are timed but not checked
DIAGNOSTIC = ("no shared adds", "loads only")
#: the k each K2 variant is timed at (the others at k <= 3 only): the
#: variants of both routes at every k, the block route where it takes
#: bins from the warp route
VARIANT_K = {"digit halo": range(1, 16), "loads only": range(1, 16),
             "block route above 64 bins": range(4, 7)}


def build(tmp: Path, log=print) -> dict:
    """{"as built": the library of counts_matrix_variants.cu, and one per
    K2_VARIANTS entry}, compiled in parallel; logs each warp-route kernel's
    registers."""
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    src = (kernels.CSRC_DIR / "counts_matrix.cu").read_text()
    procs = {}
    for i, name in enumerate(("as built", *K2_VARIANTS)):
        inc = tmp / f"v{i}"
        inc.mkdir()
        text = src
        for old, new in K2_VARIANTS.get(name, ()):
            if text.count(old) != 1:
                raise RuntimeError(f"counts_matrix.cu no longer holds {old!r} once")
            text = text.replace(old, new)
        (inc / "counts_matrix.cu").write_text(text)
        so = inc / "libcounts_matrix_variants.so"
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
        lines = out.splitlines()
        for i, line in enumerate(lines[:-1]):
            if "counts_warp_kernel" in line and "Compiling entry" in line:
                regs = next((x for x in lines[i + 1 : i + 4] if "registers" in x), "")
                kernel = line[line.index("counts_warp_kernel"):].split("'")[0][:44]
                log(f"build {name}: {kernel} {regs.split(':')[-1].strip()}")
        lib = ctypes.CDLL(str(so))
        for fn in ("kp_counts_matrix", "kv_old_counts_matrix"):
            getattr(lib, fn).argtypes = [vp, ll, ll, ci, ci, ci, vp, vp]
        for fn in ("kp_row_roll", "kv_old_row_roll", "kv_roll_quads", "kv_roll_quads_two",
                   "kv_roll_quads_stream"):
            getattr(lib, fn).argtypes = [vp, vp, ll, ci, vp, vp]
        libs[name] = lib
    return libs


def run(dev, card: str, log=print) -> dict:
    """Check and time every candidate; returns {case: {"bound_ms": b,
    candidate: {"ms": [...], "gated_ms": [...]}}} (two times each, from
    the two halves of the alternation)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(SCRIPTS))
    import chip_smoke as cs
    import hist_variants_probe as hv
    from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda as hc
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), log)
    lib = libs["as built"]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn, *args):
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{fn.__name__} launch failed: cudaError_t {rc}")

    stream_u8, starts, lengths = cs.distance_records(54018)
    grid_c = torch.from_numpy(cs.record_grid(stream_u8, starts, lengths)).to(dev)
    grid_a = grid_c[:16384].contiguous()
    grid_b = grid_c[:2048].contiguous()
    rng = np.random.default_rng(12)
    long_rows = rng.integers(0, 4, LONG_ROWS, dtype=np.uint8)
    long_rows[rng.random(LONG_ROWS) < 0.001] = cs.INVALID
    grid_long = torch.from_numpy(long_rows).to(dev)
    del stream_u8, starts, lengths, long_rows

    def k2(name, grid, k, lib=lib):
        S, L = grid.shape
        fn = getattr(lib, name)
        return lambda out: call(fn, grid.data_ptr(), S, L, k, 0, 4**k, out.data_ptr(), stream)

    cases = {}
    for case, grid, k in (("K2 (a) k=3", grid_a, 3), ("K2 (c) k=3", grid_c, 3),
                          ("K2 (b) k=8", grid_b, 8), ("K2 (a) k=5", grid_a, 5),
                          ("K2 (a) k=6", grid_a, 6), ("K2 long rows k=3", grid_long, 3)):
        S, L = grid.shape
        fns = {"kept": k2("kp_counts_matrix", grid, k)}
        for name in K2_VARIANTS:
            if k in VARIANT_K.get(name, range(1, 4)):
                fns[name] = k2("kp_counts_matrix", grid, k, libs[name])
        fns["first port"] = k2("kv_old_counts_matrix", grid, k)
        cases[f"{case} [{S}, {L}]"] = (
            fns, lambda g=grid, k=k: hc.counts_matrix_reference(g, k, 4**k),
            lambda g=grid, k=k: torch.empty(g.shape[0], 4**k, dtype=torch.int32, device=dev),
            cs.bound_ms(S * L + S * 4**k * 4, 0))
    g = torch.Generator().manual_seed(9)
    for R, W in ROLL_SHAPES:
        x = torch.randint(-(2**31), 2**31 - 1, (R, W), generator=g,
                          dtype=torch.int64).to(torch.int32).to(dev)
        s = torch.randint(-3 * W, 3 * W, (R,), generator=g).to(torch.int32).to(dev)

        def p1(name, x=x, s=s, R=R, W=W):
            fn = getattr(lib, name)
            return lambda out: call(fn, x.data_ptr(), s.data_ptr(), R, W, out.data_ptr(), stream)

        fns = {"kept": p1("kp_row_roll"), "quads": p1("kv_roll_quads"),
               "quads, streaming stores": p1("kv_roll_quads_stream"),
               "quads, two 16-byte loads": p1("kv_roll_quads_two"),
               "first port": p1("kv_old_row_roll")}
        cases[f"P1 [{R}, {W}]"] = (fns, lambda x=x, s=s: sort_cuda.row_roll_reference(x, s),
                                   lambda x=x: torch.empty_like(x),
                                   cs.bound_ms(2 * 4 * R * W + 4 * R, 0))

    result: dict = {}
    for case, (fns, plain, empty, bound) in cases.items():
        want = plain()
        outs = {}
        for name, fn in fns.items():
            out = empty()
            fn(out)
            torch.cuda.synchronize()
            if name not in DIAGNOSTIC and not torch.equal(out, want):
                raise AssertionError(f"{case} {name} differs from the plain version")
            outs[name] = out
        del want
        times = result.setdefault(case, {"bound_ms": bound[0]})
        log(f"probe {case}: bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")
        for name in list(fns) + list(fns)[::-1]:
            fn = lambda: fns[name](outs[name])  # noqa: E731
            ms, gated = cs.time_ms(fn, 20), hv.gated_ms(fn, 20)
            t = times.setdefault(name, {"ms": [], "gated_ms": []})
            t["ms"].append(ms)
            t["gated_ms"].append(gated)
            log(f"probe {case} {name}: {ms:.4f} ms, gated {gated:.4f} ms [{card}]")
        del outs
        torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("counts_matrix_variants_probe: CUDA is not available", file=sys.stderr)
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
