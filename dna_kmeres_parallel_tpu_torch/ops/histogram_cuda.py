"""K2, the per-sequence counts matrix: CUDA wrapper and plain PyTorch
version.

The kernel (``csrc/counts_matrix.cu``) replaces the TPU kernel
``dna_kmeres_parallel_tpu/ops/histogram_pallas.py::counts_matrix_pallas``
and serves every bin count up to 65,536 (k <= 8), where the TPU kernel
stops at 1,024 and the JAX engine scatters above it.

``counts_matrix_grid`` picks the route by the grid's device and nothing
else: the kernel on the card, the plain version on the CPU.
"""

from __future__ import annotations

import torch

from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
from dna_kmeres_parallel_tpu_torch.ops import histogram as hist_ops

#: widest bin range the kernel serves (4^8)
MAX_BINS = 1 << 16

#: Kernel launches since the count was last reset; the wrapper adds one
#: per launch and nothing else touches it except a caller's reset.
LAUNCHES = 0


def _check(grid: torch.Tensor, k: int, bins: int) -> None:
    if grid.dtype != torch.uint8 or grid.dim() != 2:
        raise ValueError(
            f"grid must be a 2-D uint8 tensor [S, L], got {grid.dtype} "
            f"{tuple(grid.shape)}"
        )
    if not (1 <= k <= encode_ops.MAX_DENSE_K):
        raise ValueError(f"k must be in [1, {encode_ops.MAX_DENSE_K}], got {k}")
    if not (1 <= bins <= MAX_BINS):
        raise ValueError(f"bins must be in [1, {MAX_BINS}], got {bins}")


def counts_matrix_cuda(
    grid: torch.Tensor, k: int, bins: int, canonical: bool = False
) -> torch.Tensor:
    """Launch the CUDA kernel: u8 grid [S, L] on the card -> int32
    [S, bins] on the card. Raises on anything the kernel does not take,
    and if the launch fails."""
    global LAUNCHES
    _check(grid, k, bins)
    if grid.device.type != "cuda":
        raise ValueError(f"counts_matrix_cuda needs a CUDA tensor, got {grid.device}")
    if not grid.is_contiguous():
        raise ValueError("counts_matrix_cuda needs a contiguous grid")
    S, L = grid.shape
    if S >= 1 << 31:
        raise ValueError(f"at most 2^31 - 1 rows, got {S}")
    out = torch.empty(S, bins, dtype=torch.int32, device=grid.device)
    if S == 0:
        return out
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    lib = kernels.load()
    with torch.cuda.device(grid.device):
        rc = lib.kp_counts_matrix(
            grid.data_ptr(), S, L, k, int(bool(canonical)), bins,
            out.data_ptr(), torch.cuda.current_stream(grid.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"kp_counts_matrix launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return out


def counts_matrix_reference(
    grid: torch.Tensor, k: int, bins: int, canonical: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of :func:`counts_matrix_cuda`, on whatever
    device the grid lies: rolling codes, the canonical fold, then a
    scatter-add (``ops/histogram.counts_matrix``)."""
    _check(grid, k, bins)
    S, L = grid.shape
    if L < k:
        return torch.zeros(S, bins, dtype=torch.int32, device=grid.device)
    codes, valid = encode_ops.rolling_codes(grid, k)
    if canonical:
        codes = encode_ops.canonicalize(codes, k)
    return hist_ops.counts_matrix(codes, valid, bins)


def counts_matrix_grid(
    grid: torch.Tensor, k: int, bins: int, canonical: bool = False
) -> torch.Tensor:
    """u8 grid [S, L] -> int32 counts [S, bins]: the kernel on the card,
    the plain version on the CPU."""
    if grid.device.type == "cuda":
        return counts_matrix_cuda(grid, k, bins, canonical)
    if grid.device.type == "cpu":
        return counts_matrix_reference(grid, k, bins, canonical)
    raise ValueError(f"no counts matrix for device {grid.device}")
