"""The histogram kernels' wrappers and their plain PyTorch versions.

- K2, the per-sequence counts matrix (``csrc/counts_matrix.cu``), replaces
  ``dna_kmeres_parallel_tpu/ops/histogram_pallas.py::counts_matrix_pallas``
  and serves every bin count up to 4^15 (k <= 15), where the TPU kernel
  stops at 1,024 and the JAX engine scatters above it: shared-memory
  histograms up to 65,536 bins, device-memory atomics into a zeroed
  output above.
- K5-K8, the dense histogram of one batch (``csrc/histogram.cu``), replace
  ``histogram_bp2_packed_pallas`` (K5, from the encoder's u32 planes),
  ``histogram_bp2_pallas`` (K6), ``histogram_bitplane_pallas`` (K7) and
  ``histogram_pallas`` (K8, the routing entry and its two-level body), each
  from a u8 base stream; K7 also reads the 2-bit packed batch itself (the
  JAX engine's ``_count_batch_acc_packed``: its unpack and the bit-plane
  kernel). Each adds its counts into a caller-given int32 accumulator, the
  port of the JAX engine's ``_count_batch_acc*``.

The entries (``counts_matrix_grid``, ``histogram_planes``,
``histogram_stream``, ``histogram_packed``) pick the route by the input's
device and nothing else: the kernel on the card, the plain version on the
CPU. A kernel that refuses its arguments raises; nothing falls back.
"""

from __future__ import annotations

import torch

from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
from dna_kmeres_parallel_tpu_torch.ops import encode_cuda
from dna_kmeres_parallel_tpu_torch.ops import histogram as hist_ops

#: widest bin range K5 and K6 serve (4^8), and K2 in shared memory
MAX_BINS = 1 << 16
#: widest bin range K2 serves (4^15); above MAX_BINS it counts with
#: device-memory atomics (its global route)
MAX_COUNTS_BINS = 1 << 30
#: widest bin range K7 serves, and the largest bins the routing sends it
SMALL_BINS = 64
#: widest bin range K8 serves (4^12)
MAX_ANY_BINS = 1 << 24
#: largest k K5 serves: a window then spans at most two plane words
MAX_PLANES_K = 8
#: most int32 bins K6 keeps in one block's shared memory (128 KB)
MAX_SLICE_BINS = 1 << 15
#: K6's cluster sizes, and the one taken above MAX_SLICE_BINS bins: at
#: 4^8 bins 2 blocks of 128 KB ran faster on the card than 4 of 64 KB
#: (chip_smoke.py times both, PERF.md)
CLUSTER_SIZES = (1, 2, 4)
WIDE_CLUSTER = 2

# Kernel launches since the counts were last reset; each wrapper adds one
# per launch of its kernel and nothing else touches them except a
# caller's reset.
#: K2 ``kp_counts_matrix``, every route
COUNTS_LAUNCHES = 0
#: K2's launches on its global route (bins above MAX_BINS), counted beside
#: COUNTS_LAUNCHES
COUNTS_GLOBAL_LAUNCHES = 0
#: K5 ``kp_hist_planes``
PLANES_LAUNCHES = 0
#: K6 ``kp_hist_u8``
U8_LAUNCHES = 0
#: K7 ``kp_hist_u8_small``
SMALL_LAUNCHES = 0
#: K7 ``kp_hist_packed_small``
PACKED_LAUNCHES = 0
#: K8 ``kp_hist_u8_any``
ANY_LAUNCHES = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K2: the per-sequence counts matrix
# ---------------------------------------------------------------------------


def _check(grid: torch.Tensor, k: int, bins: int) -> None:
    if grid.dtype != torch.uint8 or grid.dim() != 2:
        raise ValueError(
            f"grid must be a 2-D uint8 tensor [S, L], got {grid.dtype} "
            f"{tuple(grid.shape)}"
        )
    if not (1 <= k <= encode_ops.MAX_DENSE_K):
        raise ValueError(f"k must be in [1, {encode_ops.MAX_DENSE_K}], got {k}")
    if not (1 <= bins <= MAX_COUNTS_BINS):
        raise ValueError(f"bins must be in [1, {MAX_COUNTS_BINS}], got {bins}")


def counts_matrix_cuda(
    grid: torch.Tensor, k: int, bins: int, canonical: bool = False
) -> torch.Tensor:
    """Launch the CUDA kernel: u8 grid [S, L] on the card -> int32
    [S, bins] on the card. Raises on anything the kernel does not take,
    and if the launch fails."""
    global COUNTS_LAUNCHES, COUNTS_GLOBAL_LAUNCHES
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
            out.data_ptr(), _stream(grid),
        )
    if rc != 0:
        raise RuntimeError(f"kp_counts_matrix launch failed: cudaError_t {rc}")
    COUNTS_LAUNCHES += 1
    COUNTS_GLOBAL_LAUNCHES += int(bins > MAX_BINS)
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


# ---------------------------------------------------------------------------
# K5-K8: the dense histogram of one batch, added into an accumulator
# ---------------------------------------------------------------------------


def _accumulator(acc: torch.Tensor | None, bins: int, device: torch.device) -> torch.Tensor:
    """``acc`` checked (contiguous int32 [bins] on ``device``), or a new
    zero one."""
    if acc is None:
        return torch.zeros(bins, dtype=torch.int32, device=device)
    if acc.dtype != torch.int32 or acc.shape != (bins,) or acc.device != device:
        raise ValueError(
            f"acc must be int32 [{bins}] on {device}, got {acc.dtype} "
            f"{tuple(acc.shape)} on {acc.device}"
        )
    if not acc.is_contiguous():
        raise ValueError("acc must be contiguous")
    return acc


def _check_u8(bases: torch.Tensor, k: int, bins: int, max_bins: int) -> None:
    if bases.dtype != torch.uint8 or bases.dim() != 1:
        raise ValueError(
            f"bases must be a 1-D uint8 tensor, got {bases.dtype} {tuple(bases.shape)}"
        )
    if not (1 <= k <= encode_ops.MAX_DENSE_K):
        raise ValueError(f"k must be in [1, {encode_ops.MAX_DENSE_K}], got {k}")
    if not (1 <= bins <= max_bins):
        raise ValueError(f"bins must be in [1, {max_bins}], got {bins}")


def _check_planes(words_le: torch.Tensor, inval_be: torch.Tensor, k: int) -> None:
    if not (1 <= k <= MAX_PLANES_K):
        raise ValueError(f"k must be in [1, {MAX_PLANES_K}], got {k}")
    encode_cuda.check_planes(words_le, inval_be, k)


def u8_plan(bins: int, cluster: int | None = None) -> tuple[int, int]:
    """K6's launch plan for ``bins`` (<= 65,536): (C, S), C blocks to a
    cluster, each holding S bins in its shared memory (S = ceil(bins / C)
    rounded up to 4 bins, for the 16-byte bulk flush). C is 1 up to
    MAX_SLICE_BINS bins and WIDE_CLUSTER above, unless ``cluster`` is
    given; a plan whose slice exceeds MAX_SLICE_BINS raises."""
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"bins must be in [1, {MAX_BINS}], got {bins}")
    if cluster is None:
        cluster = 1 if bins <= MAX_SLICE_BINS else WIDE_CLUSTER
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got {cluster}")
    slice_bins = -(-bins // cluster) + 3 & ~3
    if slice_bins > MAX_SLICE_BINS:
        raise ValueError(
            f"{bins} bins in clusters of {cluster} need {slice_bins} bins a block, "
            f"above {MAX_SLICE_BINS}"
        )
    return cluster, slice_bins


def _launch_u8(name: str, bases, n_own, k, bins, canonical, acc, max_bins, plan=None):
    """Launch one of K6-K8 on a CUDA stream of bases; returns acc. ``plan``
    is the (C, S) that K6's and K8's entries take (None for K7's)."""
    _check_u8(bases, k, bins, max_bins)
    if bases.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {bases.device}")
    if not bases.is_contiguous():
        raise ValueError(f"{name} needs a contiguous stream")
    acc = _accumulator(acc, bins, bases.device)
    if plan and plan[0] and acc.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned accumulator")
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    fn = getattr(kernels.load(), name)
    with torch.cuda.device(bases.device):
        rc = fn(
            bases.data_ptr(), bases.numel(), int(n_own), k, int(bool(canonical)),
            bins, *(plan or ()), acc.data_ptr(), _stream(bases),
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
    return acc


def hist_u8_cuda(bases, n_own: int, k: int, bins: int, canonical: bool = False,
                 acc: torch.Tensor | None = None, cluster: int | None = None) -> torch.Tensor:
    """K6: u8 stream [T] on the card -> acc (int32 [bins], 16-byte
    aligned) += its histogram; bins a power of two <= 65,536, held in
    clusters of ``u8_plan(bins, cluster)``."""
    global U8_LAUNCHES
    if bins & (bins - 1):
        raise ValueError(f"hist_u8_cuda needs power-of-two bins, got {bins}")
    acc = _launch_u8("kp_hist_u8", bases, n_own, k, bins, canonical, acc, MAX_BINS,
                     u8_plan(bins, cluster))
    U8_LAUNCHES += 1
    return acc


def hist_u8_small_cuda(bases, n_own: int, k: int, bins: int, canonical: bool = False,
                       acc: torch.Tensor | None = None) -> torch.Tensor:
    """K7: u8 stream [T] on the card -> acc += its histogram; bins <= 64."""
    global SMALL_LAUNCHES
    acc = _launch_u8("kp_hist_u8_small", bases, n_own, k, bins, canonical, acc, SMALL_BINS)
    SMALL_LAUNCHES += 1
    return acc


def hist_u8_any_cuda(bases, n_own: int, k: int, bins: int, canonical: bool = False,
                     acc: torch.Tensor | None = None) -> torch.Tensor:
    """K8: u8 stream [T] on the card -> acc += its histogram; any bins
    from 1 to 4^12. Up to 65,536 bins it runs K6's kernel (the plan of
    ``u8_plan``; acc 16-byte aligned), above them device-memory atomics."""
    global ANY_LAUNCHES
    plan = u8_plan(bins) if bins <= MAX_BINS else (0, 0)
    acc = _launch_u8("kp_hist_u8_any", bases, n_own, k, bins, canonical, acc, MAX_ANY_BINS,
                     plan)
    ANY_LAUNCHES += 1
    return acc


def hist_u8_reference(bases, n_own: int, k: int, bins: int, canonical: bool = False,
                      acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K6, K7 and K8 (one function), on whatever
    device the stream lies: rolling codes of the windows that start below
    n_own, the canonical fold, then ``ops/histogram.histogram``."""
    _check_u8(bases, k, bins, MAX_ANY_BINS)
    acc = _accumulator(acc, bins, bases.device)
    n = min(int(n_own), bases.shape[0] - k + 1)
    if n > 0:
        codes, valid = encode_ops.rolling_codes(bases[: n + k - 1], k)
        if canonical:
            codes = encode_ops.canonicalize(codes, k)
        acc += hist_ops.histogram(codes, valid, bins)
    return acc


def u8_route(bins: int) -> str:
    """The kernel ``histogram_stream`` takes on the card for ``bins``, as
    ``histogram_pallas`` routes: "small" (K7) up to 64 bins, "u8" (K6) for
    a power of two up to 65,536, "any" (K8) otherwise."""
    if bins <= SMALL_BINS:
        return "small"
    if bins <= MAX_BINS and not bins & (bins - 1):
        return "u8"
    return "any"


def histogram_stream(bases: torch.Tensor, n_own: int, k: int, bins: int,
                     canonical: bool = False,
                     acc: torch.Tensor | None = None) -> torch.Tensor:
    """u8 base stream [T] -> acc (int32 [bins], zeros when None) += the
    histogram of its windows that start below n_own: on the card the
    kernel ``u8_route(bins)`` names, on the CPU the plain version."""
    if bases.device.type == "cuda":
        route = u8_route(bins)
        if route == "small":
            return hist_u8_small_cuda(bases, n_own, k, bins, canonical, acc)
        if route == "u8":
            return hist_u8_cuda(bases, n_own, k, bins, canonical, acc)
        return hist_u8_any_cuda(bases, n_own, k, bins, canonical, acc)
    if bases.device.type == "cpu":
        return hist_u8_reference(bases, n_own, k, bins, canonical, acc)
    raise ValueError(f"no histogram for device {bases.device}")


def hist_planes_cuda(words_le: torch.Tensor, inval_be: torch.Tensor, n_own: int,
                     k: int, canonical: bool = False,
                     acc: torch.Tensor | None = None) -> torch.Tensor:
    """K5: u32 planes [Tw] on the card -> acc (int32 [4^k], 16-byte
    aligned) += the histogram of the windows that start below n_own; k <=
    8."""
    global PLANES_LAUNCHES
    _check_planes(words_le, inval_be, k)
    if words_le.device.type != "cuda":
        raise ValueError(f"hist_planes_cuda needs CUDA tensors, got {words_le.device}")
    if not (words_le.is_contiguous() and inval_be.is_contiguous()):
        raise ValueError("hist_planes_cuda needs contiguous planes")
    acc = _accumulator(acc, 4**k, words_le.device)
    if acc.data_ptr() % 16:
        raise ValueError("hist_planes_cuda needs a 16-byte aligned accumulator")
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    lib = kernels.load()
    with torch.cuda.device(words_le.device):
        rc = lib.kp_hist_planes(
            words_le.data_ptr(), inval_be.data_ptr(), words_le.numel(), int(n_own),
            k, int(bool(canonical)), acc.data_ptr(), _stream(words_le),
        )
    if rc != 0:
        raise RuntimeError(f"kp_hist_planes launch failed: cudaError_t {rc}")
    PLANES_LAUNCHES += 1
    return acc


def hist_planes_reference(words_le: torch.Tensor, inval_be: torch.Tensor, n_own: int,
                          k: int, canonical: bool = False,
                          acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_planes_cuda`, on whatever device
    the planes lie: the planes unpacked into a u8 stream, then
    :func:`hist_u8_reference` at 4^k bins."""
    _check_planes(words_le, inval_be, k)
    return hist_u8_reference(
        encode_ops.planes_to_stream(words_le, inval_be), n_own, k, 4**k, canonical, acc
    )


def histogram_planes(words_le: torch.Tensor, inval_be: torch.Tensor, n_own: int,
                     k: int, canonical: bool = False,
                     acc: torch.Tensor | None = None) -> torch.Tensor:
    """u32 planes [Tw] -> acc (int32 [4^k], zeros when None) += the
    histogram of the windows that start below n_own: K5 on the card, its
    plain version on the CPU."""
    if words_le.device.type == "cuda":
        return hist_planes_cuda(words_le, inval_be, n_own, k, canonical, acc)
    if words_le.device.type == "cpu":
        return hist_planes_reference(words_le, inval_be, n_own, k, canonical, acc)
    raise ValueError(f"no histogram for device {words_le.device}")


# ---------------------------------------------------------------------------
# K7 from the 2-bit packed batch
# ---------------------------------------------------------------------------


def _check_packed(data: torch.Tensor, mask: torch.Tensor, k: int, bins: int) -> None:
    for name, t in (("data", data), ("mask", mask)):
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise ValueError(
                f"{name} must be a 1-D uint8 tensor, got {t.dtype} {tuple(t.shape)}"
            )
    if 4 * data.numel() != 8 * mask.numel():
        raise ValueError(
            f"{data.numel()} data bytes hold {4 * data.numel()} bases but "
            f"{mask.numel()} mask bytes hold {8 * mask.numel()}"
        )
    if data.device != mask.device:
        raise ValueError(f"data on {data.device}, mask on {mask.device}")
    if not (1 <= k <= encode_ops.MAX_DENSE_K):
        raise ValueError(f"k must be in [1, {encode_ops.MAX_DENSE_K}], got {k}")
    if not (1 <= bins <= SMALL_BINS):
        raise ValueError(f"bins must be in [1, {SMALL_BINS}], got {bins}")


def hist_packed_small_cuda(data: torch.Tensor, mask: torch.Tensor, n_own: int, k: int,
                           bins: int, canonical: bool = False,
                           acc: torch.Tensor | None = None) -> torch.Tensor:
    """K7 from the packed batch (``native.pack_2bit_native``'s format: data
    u8 [T/4], mask u8 [T/8]) on the card -> acc (int32 [bins]) += the
    histogram of its windows that start below n_own; bins <= 64. No
    unpacked stream is made."""
    global PACKED_LAUNCHES
    _check_packed(data, mask, k, bins)
    if data.device.type != "cuda":
        raise ValueError(f"hist_packed_small_cuda needs CUDA tensors, got {data.device}")
    if not (data.is_contiguous() and mask.is_contiguous()):
        raise ValueError("hist_packed_small_cuda needs contiguous data and mask")
    acc = _accumulator(acc, bins, data.device)
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    lib = kernels.load()
    with torch.cuda.device(data.device):
        rc = lib.kp_hist_packed_small(
            data.data_ptr(), mask.data_ptr(), 4 * data.numel(), int(n_own), k,
            int(bool(canonical)), bins, acc.data_ptr(), _stream(data),
        )
    if rc != 0:
        raise RuntimeError(f"kp_hist_packed_small launch failed: cudaError_t {rc}")
    PACKED_LAUNCHES += 1
    return acc


def hist_packed_small_reference(data: torch.Tensor, mask: torch.Tensor, n_own: int,
                                k: int, bins: int, canonical: bool = False,
                                acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_packed_small_cuda`, on whatever
    device the batch lies: ``encode.unpack_stream``, then
    :func:`hist_u8_reference`."""
    _check_packed(data, mask, k, bins)
    return hist_u8_reference(encode_ops.unpack_stream(data, mask), n_own, k, bins,
                             canonical, acc)


def histogram_packed(data: torch.Tensor, mask: torch.Tensor, n_own: int, k: int,
                     bins: int, canonical: bool = False,
                     acc: torch.Tensor | None = None) -> torch.Tensor:
    """The packed batch (data u8 [T/4], mask u8 [T/8]) -> acc (int32
    [bins], zeros when None) += the histogram of its windows that start
    below n_own, bins <= 64: K7 on the card, its plain version on the
    CPU."""
    if data.device.type == "cuda":
        return hist_packed_small_cuda(data, mask, n_own, k, bins, canonical, acc)
    if data.device.type == "cpu":
        return hist_packed_small_reference(data, mask, n_own, k, bins, canonical, acc)
    raise ValueError(f"no histogram for device {data.device}")
