"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA card and skips without one.

The file imports no JAX, so it also runs where JAX is not installed (as on
the machine with the card), without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Integer codes: every comparison is exact (tolerance zero)."""

import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.utils import codec
from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.ops import encode_cuda
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

KS = [1, 11, 13, 15, 16, 21, 23, 24, 31]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def stream(n: int, seed: int) -> np.ndarray:
    """Seeded u8 stream of n bases (a multiple of 16): 3% N, one N run and
    an all-T stretch where the length allows."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, n).astype(np.uint8)
    b[rng.random(n) < 0.03] = codec.INVALID_BASE
    if n >= 2048:
        b[300:340] = codec.INVALID_BASE
        b[1000:1064] = 3
    return b


def kernel_and_plain(bases, n_own, k, canonical, dev):
    planes = engine.stage_batch_planes(bases, dev)
    launches = encode_cuda.LAUNCHES
    got = sparse_ops.encode_words_planes(*planes, n_own, k, canonical)
    assert encode_cuda.LAUNCHES == launches + 1
    ref = sparse_ops.narrow_words(
        *encode_cuda.encode_packed_reference(*planes, n_own, k, canonical), k
    )
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_kernel_matches_plain_on_card(cuda_device, k, canonical):
    bases = stream(4096, k)
    got, ref = kernel_and_plain(bases, 4096 - 200, k, canonical, cuda_device)
    for g, r in zip(got, ref, strict=True):
        assert g.device.type == "cuda" and g.dtype == r.dtype
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,n_own,k",
    [(16, 16, 1), (16, 16, 16), (16, 16, 31), (32, 5, 21), (48, 48, 31),
     (48, 0, 13), (4096, 10**9, 24)],
)
def test_kernel_edges_on_card(cuda_device, n, n_own, k):
    # One- to three-word planes (windows past the plane are invalid),
    # nothing owned, and n_own past the end.
    got, ref = kernel_and_plain(stream(n, n + k), n_own, k, True, cuda_device)
    for g, r in zip(got, ref, strict=True):
        assert torch.equal(g, r)
    valid = int((got[0] != -1).sum())
    assert valid <= max(0, min(n_own, n - k + 1))
