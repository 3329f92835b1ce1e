"""The kernel and host-library builds' CPU-visible behaviour: where each
library goes, what keys it, how nvcc is run, and that a missing compiler
raises (it never falls back)."""

import os

import pytest

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.ops import kernels


def test_library_path_is_keyed_by_the_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libkmer_kernels_") and path.suffix == ".so"
    assert path == kernels.library_path()
    assert (kernels.CSRC_DIR / "encode_packed.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_library_path_is_keyed_by_the_headers(tmp_path, monkeypatch):
    # A header the sources include (csrc/*.cuh) keys the library like a
    # source: an edited header never loads a stale library.
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in [*kernels.CSRC_DIR.glob("*.cu"), *kernels.CSRC_DIR.glob("*.cuh")]:
        (csrc / src.name).write_bytes(src.read_bytes())
    assert (csrc / "planes.cuh").exists()
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    path = kernels.library_path()
    assert path == kernels.library_path()
    (csrc / "planes.cuh").write_text((csrc / "planes.cuh").read_text() + "\n// edited\n")
    edited = kernels.library_path()
    assert edited != path
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert kernels.library_path() not in (path, edited)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()


def test_build_runs_one_nvcc_per_source_then_links(tmp_path, monkeypatch):
    # A stand-in nvcc that logs its arguments and writes its -o file.
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    fake = bindir / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ "$#" -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; shift; done\n'
    )
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    kernels.build.cache_clear()
    try:
        so, _ = kernels.build()
    finally:
        kernels.build.cache_clear()
    lines = log.read_text().splitlines()
    sources = sorted(p.name for p in kernels.CSRC_DIR.glob("*.cu"))
    compiles = [line for line in lines if " -c " in f" {line} "]
    assert sorted(line.split()[-1].rsplit("/", 1)[-1] for line in compiles) == sources
    assert all("arch=compute_90a,code=sm_90a" in line for line in lines)
    assert len(lines) == len(sources) + 1 and "-shared" in lines[-1]
    assert so.exists() and so.parent == tmp_path / "build"


def test_native_library_is_keyed_by_source_flags_and_cpu(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libkmer_host_")
    native.library_path.cache_clear()
    monkeypatch.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "-DKEY_TEST"))
    try:
        assert native.library_path() != path
    finally:
        native.library_path.cache_clear()
