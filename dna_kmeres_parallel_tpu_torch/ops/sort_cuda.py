"""The row sort (K11), owner-segment extraction (K10) and its unit probe
(P1): CUDA wrappers, launch counters and plain PyTorch versions.

The counterparts of ``dna_kmeres_parallel_tpu/ops/sort_pallas.py``'s
``row_sort_pallas_u32`` (``csrc/row_sort.cu``) and
``extract_owner_segments``, and of the probe ``scripts/dynroll_probe.py``
(both in ``csrc/owner_segments.cu``).

Planes are int32 tensors holding u32 bits, with the all-ones sentinel -1.
A tensor on the card goes to the kernel, a tensor on the CPU to the plain
version; nothing falls back.
"""

from __future__ import annotations

import torch

#: Kernel launches since the count was last reset; each wrapper adds one
#: per launch of its kernel and nothing else touches it except a caller's
#: reset. K10:
OWNER_LAUNCHES = 0
#: P1:
ROLL_LAUNCHES = 0
#: K11:
ROW_SORT_LAUNCHES = 0

#: K11's row lengths: powers of two from 128 to 32,768 words (a row of
#: 32,768 words fills 128 KB of the block's shared memory)
MIN_ROW_SORT_M = 128
MAX_ROW_SORT_M = 32768
#: x ^ INT32_MIN maps unsigned order onto int32's signed order
INT32_MIN = -(1 << 31)

#: devices on which P1 has passed its probe in this process
_PROBED: set[str] = set()


def check_segments(planes, starts_full: torch.Tensor, row_cap: int, D: int) -> None:
    """The TPU kernel's argument checks (row_cap a multiple of 128), and the
    shapes and types the kernel takes: 1 or 2 int32 planes [n_rows, row_w]
    on one device, starts [n_rows, D+1] int32."""
    if row_cap <= 0 or row_cap % 128:
        raise ValueError(f"row_cap must be a positive 128-multiple, got {row_cap}")
    if D < 1:
        raise ValueError(f"D must be at least 1, got {D}")
    if not 1 <= len(planes) <= 2:
        raise ValueError(f"1 or 2 planes, got {len(planes)}")
    shape = planes[0].shape
    for p in planes:
        if p.dtype != torch.int32 or p.dim() != 2 or p.shape != shape:
            raise ValueError(
                f"planes must be int32 [n_rows, row_w] of one shape, got "
                f"{[(q.dtype, tuple(q.shape)) for q in planes]}"
            )
        if p.device != starts_full.device:
            raise ValueError("planes and starts must lie on one device")
    if starts_full.dtype != torch.int32 or starts_full.shape != (shape[0], D + 1):
        raise ValueError(
            f"starts_full must be int32 [{shape[0]}, {D + 1}], got "
            f"{starts_full.dtype} {tuple(starts_full.shape)}"
        )


def owner_segments_cuda(planes, starts_full: torch.Tensor, row_cap: int, D: int) -> tuple:
    """Launch K10 on the card: every plane in one launch."""
    global OWNER_LAUNCHES
    check_segments(planes, starts_full, row_cap, D)
    if starts_full.device.type != "cuda":
        raise ValueError(f"owner_segments_cuda needs CUDA tensors, got {starts_full.device}")
    if not all(p.is_contiguous() for p in (*planes, starts_full)):
        raise ValueError("owner_segments_cuda needs contiguous tensors")
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    lib = kernels.load()
    dev = starts_full.device
    n_rows, row_w = planes[0].shape
    outs = tuple(
        torch.empty(n_rows, D * row_cap, dtype=torch.int32, device=dev) for _ in planes
    )
    two = len(planes) == 2
    with torch.cuda.device(dev):
        rc = lib.kp_owner_segments(
            planes[0].data_ptr(),
            planes[1].data_ptr() if two else None,
            starts_full.data_ptr(),
            n_rows,
            row_w,
            D,
            row_cap,
            outs[0].data_ptr(),
            outs[1].data_ptr() if two else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"kp_owner_segments launch failed: cudaError_t {rc}")
    OWNER_LAUNCHES += 1
    return outs


def owner_segments_reference(planes, starts_full: torch.Tensor, row_cap: int, D: int) -> tuple:
    """Plain PyTorch version of K10: out[r, d*row_cap + c] = plane[r,
    (starts[r, d] + c) % row_w] for c < min(segment length, row_cap), -1
    elsewhere (the TPU kernel's roll, on whatever device the tensors lie)."""
    check_segments(planes, starts_full, row_cap, D)
    n_rows, row_w = planes[0].shape
    st = starts_full.long()
    col = torch.arange(row_cap, device=st.device)
    src = torch.remainder(st[:, :D, None] + col, row_w).reshape(n_rows, D * row_cap)
    keep = (col < (st[:, 1:] - st[:, :-1])[:, :, None]).reshape(n_rows, D * row_cap)
    return tuple(torch.where(keep, p.gather(1, src), -1) for p in planes)


def extract_owner_segments(planes, starts_full: torch.Tensor, row_cap: int, D: int) -> tuple:
    """Row-sorted planes -> per-owner fixed-capacity send slots, each plane
    [n_rows, D*row_cap] int32 (owner d's slots at columns [d*row_cap,
    (d+1)*row_cap)). Segments longer than row_cap are cut: the caller
    gates on its overflow flag. The tensors' device picks kernel or plain
    version."""
    dev = starts_full.device.type
    if dev == "cuda":
        return owner_segments_cuda(planes, starts_full, row_cap, D)
    if dev == "cpu":
        return owner_segments_reference(planes, starts_full, row_cap, D)
    raise ValueError(f"no owner-segment extraction for device {starts_full.device}")


def check_roll(x: torch.Tensor, shifts: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"x must be int32 [R, W], got {x.dtype} {tuple(x.shape)}")
    if shifts.dtype != torch.int32 or shifts.shape != (x.shape[0],):
        raise ValueError(
            f"shifts must be int32 [{x.shape[0]}], got {shifts.dtype} {tuple(shifts.shape)}"
        )
    if shifts.device != x.device:
        raise ValueError("x and shifts must lie on one device")


def row_roll_cuda(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Launch P1 on the card."""
    global ROLL_LAUNCHES
    check_roll(x, shifts)
    if x.device.type != "cuda":
        raise ValueError(f"row_roll_cuda needs CUDA tensors, got {x.device}")
    if not (x.is_contiguous() and shifts.is_contiguous()):
        raise ValueError("row_roll_cuda needs contiguous tensors")
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    lib = kernels.load()
    R, W = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.kp_row_roll(
            x.data_ptr(), shifts.data_ptr(), R, W, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"kp_row_roll launch failed: cudaError_t {rc}")
    ROLL_LAUNCHES += 1
    return out


def row_roll_reference(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P1: out[r, c] = x[r, (c + shifts[r]) mod W],
    each row rolled left by its shift (``np.roll(row, -shift)``)."""
    check_roll(x, shifts)
    W = x.shape[1]
    col = torch.arange(W, device=x.device)
    return x.gather(1, torch.remainder(col + shifts.long()[:, None], W))


def row_roll(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P1 on the card, its plain version on the CPU."""
    if x.device.type == "cuda":
        return row_roll_cuda(x, shifts)
    if x.device.type == "cpu":
        return row_roll_reference(x, shifts)
    raise ValueError(f"no row roll for device {x.device}")


def probe_row_roll(device: torch.device) -> None:
    """P1 as the JAX package ran it before it trusted the row route: roll
    the probe's [8, 256] tile (``arange``) left by 3r + 1 per row on
    ``device`` and check every row, once per device and process. Raises if
    a row comes back wrong; the row route calls it before its first K10
    launch on a device."""
    key = str(device)
    if key in _PROBED:
        return
    x = torch.arange(8 * 256, dtype=torch.int32, device=device).reshape(8, 256)
    shifts = torch.arange(8, dtype=torch.int32, device=device) * 3 + 1
    got = row_roll(x, shifts).cpu()
    want = torch.stack([torch.roll(x[r].cpu(), -(3 * r + 1)) for r in range(8)])
    if not torch.equal(got, want):
        raise RuntimeError(f"the row-roll probe failed on {device}: rows {got[:, :4].tolist()}")
    _PROBED.add(key)


def row_sort_fits(m: int) -> bool:
    """Whether K11 sorts rows of m words: a power of two from
    MIN_ROW_SORT_M to MAX_ROW_SORT_M (so a multiple of 128)."""
    return MIN_ROW_SORT_M <= m <= MAX_ROW_SORT_M and m & (m - 1) == 0


def check_row_sort(x: torch.Tensor) -> None:
    """The shapes and types K11 takes: int32 [R, m], R >= 1, m a power of
    two from 128 to 32,768."""
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"x must be int32 [R, m], got {x.dtype} {tuple(x.shape)}")
    R, m = x.shape
    if R < 1 or not row_sort_fits(m):
        raise ValueError(
            f"row sort needs R >= 1 rows of m words, m a power of two in "
            f"[{MIN_ROW_SORT_M}, {MAX_ROW_SORT_M}]; got [{R}, {m}]"
        )


def row_sort_digit_passes(x: torch.Tensor) -> torch.Tensor:
    """The 8-bit digit passes K11 runs on each row of x (int32 [R, m] of
    u32 bits): one per byte in which the row's words other than the
    all-ones sentinel differ (the bits set in the AND xor the OR of those
    words), none for a row of equal words or of sentinels only. A block of
    several rows (m <= 2048) runs the union of its rows' passes."""
    check_row_sort(x)
    real = x != -1
    a = torch.where(real, x, -1)
    o = torch.where(real, x, 0)
    while a.shape[1] > 1:  # m is a power of two: fold the halves
        a = a[:, 0::2] & a[:, 1::2]
        o = o[:, 0::2] | o[:, 1::2]
    differ = torch.where(real.any(dim=1), (a ^ o)[:, 0], 0).long() & 0xFFFFFFFF
    return sum(((differ >> (8 * i)) & 0xFF != 0).long() for i in range(4))


def row_sort_u32_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K11 on the card: each row of x sorted ascending as u32."""
    global ROW_SORT_LAUNCHES
    check_row_sort(x)
    if x.device.type != "cuda":
        raise ValueError(f"row_sort_u32_cuda needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("row_sort_u32_cuda needs a contiguous, 16-byte aligned tensor")
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    lib = kernels.load()
    R, m = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.kp_row_sort(
            x.data_ptr(), R, m, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"kp_row_sort launch failed: cudaError_t {rc}")
    ROW_SORT_LAUNCHES += 1
    return out


def row_sort_u32_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11: ``torch.sort`` of the biased keys
    (x ^ INT32_MIN orders u32 bits as int32), unbiased again."""
    check_row_sort(x)
    return torch.sort(x ^ INT32_MIN, dim=-1).values ^ INT32_MIN


def row_sort_u32(x: torch.Tensor) -> torch.Tensor:
    """K11 on the card, its plain version on the CPU."""
    if x.device.type == "cuda":
        return row_sort_u32_cuda(x)
    if x.device.type == "cpu":
        return row_sort_u32_reference(x)
    raise ValueError(f"no row sort for device {x.device}")
