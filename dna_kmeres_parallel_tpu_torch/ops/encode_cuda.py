"""The window encoders: CUDA wrappers, plain PyTorch versions, and the
host-side plane construction.

K1, the packed-plane encoder (``csrc/encode_packed.cu``), replaces the TPU
kernel
``dna_kmeres_parallel_tpu/ops/encode_pallas.py::rolling_codes_split_packed_pallas``
(``words_le=True``). It emits windows in natural stream order (slot p is
the window that starts at base p), where the TPU kernel emits a
residue-permuted order; the consumers only read the multiset of valid
codes, and natural order lets the kernel and its plain version be
compared slot by slot. With ``minimizer_m`` it also emits the TPU
kernel's minimizer plane (K1m): each window's smallest forward m-mer
code, in the same order, INT32_MAX at invalid windows.

K9, the u8-stream encoder (``csrc/encode_stream.cu``), replaces
``dna_kmeres_parallel_tpu/ops/encode_pallas.py::rolling_codes_split_pallas``:
the same split words from one byte per base, in stream order over the
stream's T slots (the TPU kernel pads its output to a tile span with
sentinels).

Planes are int32 tensors holding u32 bits (torch's uint32 arithmetic is
partial on the CPU); outputs are int32 ``lo`` and int16 or int32 ``hi``
holding u32/u16 bits, with all-ones sentinels. The host views them back
as unsigned with ``numpy .view``.
"""

from __future__ import annotations

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

#: Kernel launches since the count was last reset; each wrapper adds one
#: per launch of its kernel and nothing else touches it except a caller's
#: reset. K1:
LAUNCHES = 0
#: K9:
STREAM_LAUNCHES = 0
#: K1 with its minimizer plane (K1m), counted apart from K1:
MIN_LAUNCHES = 0

#: the minimizer plane's value at an invalid window
MIN_SENTINEL = 2**31 - 1


def check_planes(words_le: torch.Tensor, inval_be: torch.Tensor, k: int):
    if not (1 <= k <= sparse_ops.MAX_SPARSE_K):
        raise ValueError(f"k must be in [1, {sparse_ops.MAX_SPARSE_K}], got {k}")
    for name, t in (("words_le", words_le), ("inval_be", inval_be)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(
                f"{name} must be a 1-D int32 tensor of u32 plane words, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if words_le.shape != inval_be.shape or words_le.device != inval_be.device:
        raise ValueError(
            "words_le and inval_be must have one shape and one device, got "
            f"{tuple(words_le.shape)} on {words_le.device} and "
            f"{tuple(inval_be.shape)} on {inval_be.device}"
        )


def check_minimizer(k: int, minimizer_m: int | None) -> None:
    """The JAX kernel's check on m: 1 <= m < min(k, 16)."""
    if minimizer_m is not None and not (1 <= minimizer_m < min(k, 16)):
        raise ValueError(
            f"minimizer_m must satisfy 1 <= m < min(k, 16), got {minimizer_m} (k={k})"
        )


def encode_packed(
    words_le: torch.Tensor,
    inval_be: torch.Tensor,
    n_own: int,
    k: int,
    canonical: bool = False,
    minimizer_m: int | None = None,
):
    """Launch the CUDA kernel: planes [Tw] on the card -> (hi, lo) window
    planes [16*Tw] on the card (hi is None for k <= 15), or (hi, lo, mins)
    with ``minimizer_m``. Raises on anything the kernel does not take, and
    if the launch fails. Counts a launch in LAUNCHES, or in MIN_LAUNCHES
    with the minimizer plane."""
    global LAUNCHES, MIN_LAUNCHES
    check_planes(words_le, inval_be, k)
    check_minimizer(k, minimizer_m)
    if words_le.device.type != "cuda":
        raise ValueError(f"encode_packed needs CUDA tensors, got {words_le.device}")
    if not (words_le.is_contiguous() and inval_be.is_contiguous()):
        raise ValueError("encode_packed needs contiguous planes")
    n_words = words_le.shape[0]
    if n_words == 0:
        raise ValueError("encode_packed needs at least one plane word")
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    lib = kernels.load()
    dev = words_le.device
    T = 16 * n_words
    lo = torch.empty(T, dtype=torch.int32, device=dev)
    hi_dt = sparse_ops.hi_dtype(k)
    hi = None if hi_dt is None else torch.empty(T, dtype=hi_dt, device=dev)
    hi_bytes = 0 if hi_dt is None else hi_dt.itemsize
    mins = None if minimizer_m is None else torch.empty(T, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.kp_encode_packed(
            words_le.data_ptr(),
            inval_be.data_ptr(),
            n_words,
            int(n_own),
            k,
            int(bool(canonical)),
            lo.data_ptr(),
            None if hi is None else hi.data_ptr(),
            hi_bytes,
            minimizer_m or 0,
            None if mins is None else mins.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"kp_encode_packed launch failed: cudaError_t {rc}")
    if mins is None:
        LAUNCHES += 1
        return hi, lo
    MIN_LAUNCHES += 1
    return hi, lo, mins


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 bits (or -1) -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _encode_bases_reference(
    bases: torch.Tensor, n_own: int, k: int, canonical: bool
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The plain encode of a base-code stream [T] (0..3 valid) into the
    kernels' planes over its T window starts: rolls over the k window
    offsets (``sparse.rolling_codes_split``), masks the windows at or past
    n_own, then ``sparse.canonicalize_split``, in int64 ops."""
    dev = bases.device
    T = bases.shape[0]
    lo_full = torch.full((T,), -1, dtype=torch.int64, device=dev)
    hi_full = torch.full((T,), -1, dtype=torch.int64, device=dev)
    n = T - k + 1
    if n > 0:
        (hi, lo), valid = sparse_ops.rolling_codes_split(bases, k)
        valid &= torch.arange(n, device=dev) < int(n_own)
        if canonical:
            hi, lo = sparse_ops.canonicalize_split(hi, lo, k)
        lo_full[:n] = torch.where(valid, lo, -1)
        hi_full[:n] = torch.where(valid, hi, -1)
    hi_dt = sparse_ops.hi_dtype(k)
    hi_out = None if hi_dt is None else _to_i32(hi_full).to(hi_dt)
    return hi_out, _to_i32(lo_full)


def minimizers_reference(bases: torch.Tensor, hi, lo, k: int, m: int) -> torch.Tensor:
    """The minimizer plane of a base stream [T] whose window planes are
    (hi, lo): the min of the k-m+1 forward m-mer codes of each window
    (``encode.rolling_codes``), INT32_MAX where the window is invalid or
    unowned (its words are sentinels)."""
    T = bases.shape[0]
    mins = torch.full((T,), MIN_SENTINEL, dtype=torch.int32, device=bases.device)
    n = T - k + 1
    if n > 0:
        mcodes, _ = encode_ops.rolling_codes(bases, m)
        win = mcodes[:n].clone()
        for j in range(1, k - m + 1):
            win = torch.minimum(win, mcodes[j : j + n])
        valid = (lo if hi is None else hi)[:n] != -1
        mins[:n] = torch.where(valid, win, MIN_SENTINEL)
    return mins


def encode_packed_reference(
    words_le: torch.Tensor,
    inval_be: torch.Tensor,
    n_own: int,
    k: int,
    canonical: bool = False,
    minimizer_m: int | None = None,
):
    """Plain PyTorch version of :func:`encode_packed`: the same planes in
    the same order, on whatever device the planes lie, in int64 ops.

    Unpacks the planes (``encode.planes_to_stream``), then encodes the
    bases as :func:`encode_stream_reference` does; with ``minimizer_m``
    adds :func:`minimizers_reference`'s plane."""
    check_planes(words_le, inval_be, k)
    check_minimizer(k, minimizer_m)
    bases = encode_ops.planes_to_stream(words_le, inval_be)
    hi, lo = _encode_bases_reference(bases, n_own, k, canonical)
    if minimizer_m is None:
        return hi, lo
    return hi, lo, minimizers_reference(bases, hi, lo, k, minimizer_m)


def check_stream(bases: torch.Tensor, k: int) -> None:
    if not (1 <= k <= sparse_ops.MAX_SPARSE_K):
        raise ValueError(f"k must be in [1, {sparse_ops.MAX_SPARSE_K}], got {k}")
    if bases.dtype != torch.uint8 or bases.dim() != 1:
        raise ValueError(
            "bases must be a 1-D uint8 tensor of base codes, got "
            f"{bases.dtype} {tuple(bases.shape)}"
        )


def encode_stream(
    bases: torch.Tensor, n_own: int, k: int, canonical: bool = False
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Launch K9: a u8 base stream [T] on the card -> (hi, lo) window
    planes [T] on the card (hi is None for k <= 15). Raises on anything
    the kernel does not take, and if the launch fails."""
    global STREAM_LAUNCHES
    check_stream(bases, k)
    if bases.device.type != "cuda":
        raise ValueError(f"encode_stream needs a CUDA tensor, got {bases.device}")
    if not bases.is_contiguous():
        raise ValueError("encode_stream needs a contiguous stream")
    T = bases.shape[0]
    if T == 0:
        raise ValueError("encode_stream needs at least one base")
    from dna_kmeres_parallel_tpu_torch.ops import kernels

    lib = kernels.load()
    dev = bases.device
    lo = torch.empty(T, dtype=torch.int32, device=dev)
    hi_dt = sparse_ops.hi_dtype(k)
    hi = None if hi_dt is None else torch.empty(T, dtype=hi_dt, device=dev)
    hi_bytes = 0 if hi_dt is None else hi_dt.itemsize
    with torch.cuda.device(dev):
        rc = lib.kp_encode_stream(
            bases.data_ptr(),
            T,
            int(n_own),
            k,
            int(bool(canonical)),
            lo.data_ptr(),
            None if hi is None else hi.data_ptr(),
            hi_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"kp_encode_stream launch failed: cudaError_t {rc}")
    STREAM_LAUNCHES += 1
    return hi, lo


def encode_stream_reference(
    bases: torch.Tensor, n_own: int, k: int, canonical: bool = False
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Plain PyTorch version of :func:`encode_stream`: the same planes in
    the same order, on whatever device the stream lies, in int64 ops."""
    check_stream(bases, k)
    return _encode_bases_reference(bases, n_own, k, canonical)


def rev16_digits_np(x: np.ndarray) -> np.ndarray:
    """Reverse the 16 2-bit digits of each uint32 (butterfly swaps)."""
    x = x.astype(np.uint32)
    m2 = np.uint32(0x33333333)
    m4 = np.uint32(0x0F0F0F0F)
    m8 = np.uint32(0x00FF00FF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return ((x << 16) | (x >> 16)).astype(np.uint32)


def host_planes_from_packfmt(
    data_u8: np.ndarray, mask_u8: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The 2-bit packed format (data [T/4] u8, 4 bases per byte
    little-endian; validity bitmask [T/8] u8) -> the kernel's
    (words_le, inval_be) u32 planes [T/16].

    ``words_le`` is a zero-copy view of the data bytes; ``inval_be`` spreads
    each 16-bit validity field into big-endian 2-bit digits, 11 where a
    base is invalid."""
    data_u8 = np.ascontiguousarray(data_u8, dtype=np.uint8)
    mask_u8 = np.ascontiguousarray(mask_u8, dtype=np.uint8)
    w_le = data_u8.view(np.uint32)
    m16 = mask_u8.view(np.uint16).astype(np.uint32)
    s = (~m16) & np.uint32(0xFFFF)
    s = (s | (s << 8)) & np.uint32(0x00FF00FF)
    s = (s | (s << 4)) & np.uint32(0x0F0F0F0F)
    s = (s | (s << 2)) & np.uint32(0x33333333)
    s = (s | (s << 1)) & np.uint32(0x55555555)
    return w_le, rev16_digits_np(s | (s << 1))
