"""The kernel build's CPU-visible behaviour: where the library goes, what
keys it, and that a missing compiler raises (it never falls back)."""

import pytest

from dna_kmeres_parallel_tpu_torch.ops import kernels


def test_library_path_is_keyed_by_the_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libkmer_kernels_") and path.suffix == ".so"
    assert path == kernels.library_path()
    assert (kernels.CSRC_DIR / "encode_packed.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()
