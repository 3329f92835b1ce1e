"""K3 and K4, the tiled (min,+) products, and the float32 finish: CUDA
wrappers.

The kernels (``csrc/min_sum.cu``) replace the TPU kernels
``dna_kmeres_parallel_tpu/ops/distance_pallas.py::min_sum_matrix_pallas_tri``
(K3: the symmetric [S, S] matrix from upper-triangle tiles) and
``::min_sum_matrix_pallas`` (K4: a rectangular [S, S2] panel). Their plain
version is ``ops/distance.min_sum_matrix``.

``min_sum_matrix_tri`` and ``min_sum_matrix_rect`` pick the route by the
counts' device and nothing else: the kernel on the card, the plain version
on the CPU. Both refuse counts whose row sums reach 2^31: an int32
min-sum could not hold such a pair, and the kernels do not wrap.

On the card each kernel has two routes, both kernels (``product_route``):
``"u16x2"`` packs two outputs into one 32-bit word and takes their minima
with one ``min.u16x2``, exact where no count is negative and the smaller
side's largest row sum is below 2^16 (no min-sum can then reach 2^16);
``"i32"`` runs the same tiling on 32-bit lanes for everything else. The
route follows from the row sums that ``check_counts`` computes anyway.

Both kernels also split the bins across blocks where the output tiles are
too few to fill the card (``ops/distance.min_sum_split``, the one plan:
the wrapper passes its slice length to the kernels): a product of a few
hundred rows over 10^5 bins and more has 3-4 output tiles of 128 x 128.
Each block then computes one tile over one slice of the bins and adds it
into the zeroed output; the result is the same integers.

The finish kernel (``csrc/finish.cu``, no Pallas kernel: the JAX package
finishes on the host) turns the min-sums where the product left them into
the packed float32 distances of their strict upper triangle, bit for bit
its plain version, ``ops/distance.finish_upper_plain``;
``finish_upper_packed`` picks the kernel or the host finish by the sums'
device.
"""

from __future__ import annotations

import functools

import torch

from dna_kmeres_parallel_tpu_torch.ops import distance as dist_ops

#: Kernel launches since the counts were last reset; each wrapper adds one
#: per launch of its kernel and nothing else touches them except a
#: caller's reset.
TRI_LAUNCHES = 0
RECT_LAUNCHES = 0
#: The kernels' routes: two 16-bit lanes a word, or one 32-bit lane.
PACKED, WIDE = "u16x2", "i32"
#: Launches of K3 and K4 together by route, counted beside the two above.
ROUTE_LAUNCHES = {PACKED: 0, WIDE: 0}
#: The packed route needs the smaller side's largest row sum below this.
PACKED_LIMIT = 1 << 16
#: Launches of the finish kernel since the count was last reset.
FINISH_LAUNCHES = 0


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def product_split(rows: int, cols: int, bins: int, route: str, device: torch.device,
                  symmetric: bool) -> tuple[int, int]:
    """``ops/distance.min_sum_split`` of K3 (``symmetric``, [rows, rows])
    or K4 ([rows, cols]) on ``route``, with the SM count read from
    ``device``: (bin slices, bins a slice)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    tiles = dist_ops.minplus_tiles(rows, cols, symmetric)
    return dist_ops.min_sum_split(tiles, bins, route, _sms(index))


def product_route(*bounds: int | None) -> str:
    """The kernels' route for operands whose largest row sums are
    ``bounds`` (one for K3, two for K4; ``None`` for a side holding a
    negative count): ``PACKED`` when no side is negative and the smallest
    bound is below 2^16, else ``WIDE``.

    A min-sum is at most the smaller side's row sum, so no packed lane can
    reach 2^16, and every value of that side is below 2^16: clamping both
    sides to 0xFFFF leaves every minimum as it was."""
    if not bounds or any(b is None for b in bounds):
        return WIDE
    return PACKED if min(bounds) < PACKED_LIMIT else WIDE


def check_counts(*mats: torch.Tensor) -> list[int | None]:
    """Raise unless every matrix is a 2-D int32 [rows, B] tensor with one B
    and one device, and every row's sum is below 2^31. Returns each
    matrix's largest row sum (0 for no rows), or ``None`` for a matrix that
    holds a negative count: the bounds ``product_route`` takes."""
    bounds = []
    for m in mats:
        if m.dtype != torch.int32 or m.dim() != 2:
            raise ValueError(
                f"counts must be 2-D int32 tensors, got {m.dtype} {tuple(m.shape)}"
            )
        if m.shape[1] != mats[0].shape[1] or m.device != mats[0].device:
            raise ValueError(
                f"counts must share bins and device, got {tuple(m.shape)} on "
                f"{m.device} and {tuple(mats[0].shape)} on {mats[0].device}"
            )
        if not m.numel():
            bounds.append(0)
            continue
        # One device-to-host read for both numbers.
        top, low = torch.stack(
            [m.sum(1, dtype=torch.int64).max(), m.min().to(torch.int64)]
        ).tolist()
        if top >= 1 << 31:
            raise ValueError(
                "a row of the counts sums to 2^31 or more: its min-sums could "
                "overflow int32"
            )
        bounds.append(None if low < 0 else top)
    return bounds


def _launch(fn, name: str, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _cuda_ready(*mats: torch.Tensor) -> None:
    for m in mats:
        if m.device.type != "cuda" or m.device != mats[0].device:
            raise ValueError(
                f"the min-sum kernels need tensors on one card, got {m.device}"
            )
        if m.dtype != torch.int32 or m.dim() != 2 or not m.is_contiguous():
            raise ValueError(
                "the min-sum kernels need contiguous 2-D int32 tensors, got "
                f"{m.dtype} {tuple(m.shape)}"
            )


def _entry(name: str, route: str):
    if route not in ROUTE_LAUNCHES:
        raise ValueError(f"route must be {PACKED!r} or {WIDE!r}, got {route!r}")
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    entry = name if route == WIDE else f"{name}_{PACKED}"
    return entry, getattr(kernels.load(), entry)


def launch_min_sum_tri(counts: torch.Tensor, out: torch.Tensor, route: str) -> None:
    """Launch K3 on ``route`` into ``out`` (int32 [S, S] on the card),
    over ``product_split``'s bin slices. Checks shapes and devices only:
    the caller has checked the row sums and chosen the route with
    ``product_route``."""
    global TRI_LAUNCHES
    _cuda_ready(counts, out)
    S, B = counts.shape
    if out.dtype != torch.int32 or out.shape != (S, S):
        raise ValueError(f"out must be int32 {(S, S)}, got {out.dtype} {tuple(out.shape)}")
    name, fn = _entry("kp_min_sum_tri", route)
    _, slice_bins = product_split(S, S, B, route, counts.device, True)
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream(counts.device).cuda_stream
        _launch(fn, name, counts.data_ptr(), S, B, slice_bins, out.data_ptr(), stream)
    TRI_LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1


def launch_min_sum_rect(
    counts: torch.Tensor, counts_other: torch.Tensor, out: torch.Tensor, route: str
) -> None:
    """Launch K4 on ``route`` into ``out`` (int32 [S, S2] on the card),
    over ``product_split``'s bin slices. Checks shapes and devices only:
    the caller has checked the row sums and chosen the route with
    ``product_route``."""
    global RECT_LAUNCHES
    _cuda_ready(counts, counts_other, out)
    S, B = counts.shape
    S2 = counts_other.shape[0]
    if counts_other.shape[1] != B:
        raise ValueError(f"bins differ: {B} and {counts_other.shape[1]}")
    if out.dtype != torch.int32 or out.shape != (S, S2):
        raise ValueError(f"out must be int32 {(S, S2)}, got {out.dtype} {tuple(out.shape)}")
    name, fn = _entry("kp_min_sum_rect", route)
    _, slice_bins = product_split(S, S2, B, route, counts.device, False)
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream(counts.device).cuda_stream
        _launch(fn, name, counts.data_ptr(), S, counts_other.data_ptr(), S2, B, slice_bins,
                out.data_ptr(), stream)
    RECT_LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1


def min_sum_tri_cuda(counts: torch.Tensor) -> torch.Tensor:
    """K3: int32 [S, B] on the card -> the full symmetric int32 [S, S]
    min-sum matrix on the card."""
    route = product_route(*check_counts(counts))
    _cuda_ready(counts)
    S = counts.shape[0]
    out = torch.empty(S, S, dtype=torch.int32, device=counts.device)
    if S:
        launch_min_sum_tri(counts, out, route)
    return out


def min_sum_rect_cuda(counts: torch.Tensor, counts_other: torch.Tensor) -> torch.Tensor:
    """K4: int32 [S, B] and [S2, B] on the card -> int32 [S, S2]."""
    route = product_route(*check_counts(counts, counts_other))
    _cuda_ready(counts, counts_other)
    S, S2 = counts.shape[0], counts_other.shape[0]
    out = torch.empty(S, S2, dtype=torch.int32, device=counts.device)
    if S and S2:
        launch_min_sum_rect(counts, counts_other, out, route)
    return out


def tri_launcher(counts: torch.Tensor):
    """(run, route): ``run()`` computes the symmetric product of ``counts``
    into one output allocated here and returns it, with the checks and
    the route decided once (K3 on the card, route ``PACKED`` or ``WIDE``;
    the plain version on the CPU, route "plain"). For timing the kernel
    alone: ``min_sum_matrix_tri`` reads the row sums back on every call."""
    route = product_route(*check_counts(counts))
    if counts.device.type == "cpu":
        return (lambda: dist_ops.min_sum_matrix(counts)), "plain"
    _cuda_ready(counts)  # raises off the card
    out = torch.empty(counts.shape[0], counts.shape[0], dtype=torch.int32, device=counts.device)

    def run() -> torch.Tensor:
        if counts.shape[0]:
            launch_min_sum_tri(counts, out, route)
        return out

    return run, route


def min_sum_matrix_tri(counts: torch.Tensor) -> torch.Tensor:
    """Symmetric int32 [S, S] min-sums: K3 on the card, the plain version
    on the CPU."""
    if counts.device.type == "cuda":
        return min_sum_tri_cuda(counts)
    if counts.device.type != "cpu":
        raise ValueError(f"no min-sum for device {counts.device}")
    check_counts(counts)
    return dist_ops.min_sum_matrix(counts)


def min_sum_matrix_rect(counts: torch.Tensor, counts_other: torch.Tensor) -> torch.Tensor:
    """int32 [S, S2] min-sums of a row panel against partner rows: K4 on
    the card, the plain version on the CPU."""
    if counts.device.type == "cuda":
        return min_sum_rect_cuda(counts, counts_other)
    if counts.device.type != "cpu":
        raise ValueError(f"no min-sum for device {counts.device}")
    check_counts(counts, counts_other)
    return dist_ops.min_sum_matrix(counts, counts_other)


def _check_finish(min_sums: torch.Tensor, lengths_rows: torch.Tensor,
                  lengths_cols: torch.Tensor) -> None:
    if min_sums.dtype != torch.int32 or min_sums.dim() != 2:
        raise ValueError(f"min-sums must be a 2-D int32 tensor, got {min_sums.dtype} "
                         f"{tuple(min_sums.shape)}")
    R, C = min_sums.shape
    for name, lens, n in (("lengths_rows", lengths_rows, R), ("lengths_cols", lengths_cols, C)):
        if lens.dtype != torch.int64 or tuple(lens.shape) != (n,):
            raise ValueError(f"{name} must be int64 [{n}], got {lens.dtype} {tuple(lens.shape)}")
        if lens.device != min_sums.device:
            raise ValueError(f"{name} is on {lens.device}, the min-sums on {min_sums.device}")


def finish_upper_cuda(
    min_sums: torch.Tensor, lengths_rows: torch.Tensor, lengths_cols: torch.Tensor,
    k: int, r0: int = 0, base: int = 0,
) -> torch.Tensor:
    """The finish kernel: int32 [R, C] min-sums on the card (columns
    contiguous, any row stride of at least C) and contiguous int64
    lengths there -> the float32 packed distances of ``finish_upper``'s
    layout, on the card, on the current stream."""
    global FINISH_LAUNCHES
    _check_finish(min_sums, lengths_rows, lengths_cols)
    if min_sums.device.type != "cuda":
        raise ValueError(f"the finish kernel needs tensors on the card, got {min_sums.device}")
    R, C = min_sums.shape
    if (C > 1 and min_sums.stride(1) != 1) or (R > 1 and min_sums.stride(0) < C):
        raise ValueError(f"the min-sums' rows must be contiguous and apart, got strides "
                         f"{min_sums.stride()} for {tuple(min_sums.shape)}")
    if not (lengths_rows.is_contiguous() and lengths_cols.is_contiguous()):
        raise ValueError("the finish kernel needs contiguous lengths")
    out = torch.empty(dist_ops.packed_upper_size(R, C, r0, base), dtype=torch.float32,
                      device=min_sums.device)
    if out.numel():
        from dna_kmeres_parallel_tpu_torch.ops import kernels

        ld = min_sums.stride(0) if R > 1 else C
        with torch.cuda.device(min_sums.device):
            stream = torch.cuda.current_stream(min_sums.device).cuda_stream
            _launch(kernels.load().kp_finish_upper, "kp_finish_upper", min_sums.data_ptr(),
                    R, C, ld, lengths_rows.data_ptr(), lengths_cols.data_ptr(), k, r0, base,
                    out.data_ptr(), stream)
        FINISH_LAUNCHES += 1
    return out


def finish_upper_packed(
    min_sums: torch.Tensor, lengths_rows: torch.Tensor, lengths_cols: torch.Tensor,
    k: int, r0: int = 0, base: int = 0,
) -> torch.Tensor:
    """Packed float32 distances of a panel's strict upper triangle (row i
    is sequence r0 + i, column j sequence base + j; ``finish_upper``'s
    layout) on the min-sums' device: the finish kernel on the card, the
    host finish on the CPU (``finish_packed`` for an all-pairs square, whose
    rows and columns share one lengths tensor, else ``finish_upper``). The
    lengths are int64 on the same device."""
    if min_sums.device.type == "cuda":
        return finish_upper_cuda(min_sums, lengths_rows, lengths_cols, k, r0, base)
    if min_sums.device.type != "cpu":
        raise ValueError(f"no finish for device {min_sums.device}")
    _check_finish(min_sums, lengths_rows, lengths_cols)
    sums, rows = min_sums.numpy(), lengths_rows.numpy()
    if r0 == base == 0 and lengths_rows is lengths_cols:
        return torch.from_numpy(dist_ops.finish_packed(sums, rows, k))
    return torch.from_numpy(
        dist_ops.finish_upper(sums, rows, lengths_cols.numpy(), k, r0, base))
