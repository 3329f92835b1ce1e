"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one process per source, all started together, and the objects are linked
into ONE shared library with a plain C interface, at first use, under
``build/torch_kernels/`` beside the package. The library's name carries a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. It is loaded with ``ctypes``: every pointer and
the stream are passed as ``c_void_p``, since ctypes would cut a Python
int passed without a declared type to 32 bits.

Nothing here runs at import time, and nothing falls back: a failed build
raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``
    (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built from csrc/ with the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkmer_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with the output of the first
    that fails, else return all their output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}"
            )
    return "".join(outs)


@functools.cache
def build() -> tuple[Path, str]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, compiler log); the log holds ptxas's register
    and spill report when this call compiled, and is empty otherwise."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        log = _run([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)
        ])
        # Link to a private name, then rename: a concurrent build never
        # sees a half-written library.
        lib = Path(tmp) / so.name
        log += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, so)
    return so, log


@functools.cache
def load() -> ctypes.CDLL:
    """The built library, with every entry point's C signature declared."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.kp_encode_packed.restype = ci
    lib.kp_encode_packed.argtypes = [
        vp, vp, ll, ll, ci, ci, vp, vp, ci, ci, vp, vp,
    ]
    lib.kp_owner_segments.restype = ci
    lib.kp_owner_segments.argtypes = [vp, vp, vp, ll, ci, ci, ci, vp, vp, vp]
    lib.kp_row_roll.restype = ci
    lib.kp_row_roll.argtypes = [vp, vp, ll, ci, vp, vp]
    lib.kp_row_sort.restype = ci
    lib.kp_row_sort.argtypes = [vp, ll, ci, vp, vp]
    lib.kp_encode_stream.restype = ci
    lib.kp_encode_stream.argtypes = [vp, ll, ll, ci, ci, vp, vp, ci, vp]
    lib.kp_counts_matrix.restype = ci
    lib.kp_counts_matrix.argtypes = [vp, ll, ll, ci, ci, ci, vp, vp]
    lib.kp_min_sum_tri.restype = ci
    lib.kp_min_sum_tri.argtypes = [vp, ll, ll, vp, vp]
    lib.kp_min_sum_rect.restype = ci
    lib.kp_min_sum_rect.argtypes = [vp, ll, vp, ll, ll, vp, vp]
    lib.kp_hist_planes.restype = ci
    lib.kp_hist_planes.argtypes = [vp, vp, ll, ll, ci, ci, vp, vp]
    for name in ("kp_hist_u8", "kp_hist_u8_small", "kp_hist_u8_any"):
        fn = getattr(lib, name)
        fn.restype = ci
        fn.argtypes = [vp, ll, ll, ci, ci, ci, vp, vp]
    return lib
