"""K1, the packed-plane window encoder: CUDA wrapper, plain PyTorch
version, and the host-side plane construction.

The kernel (``csrc/encode_packed.cu``) replaces the TPU kernel
``dna_kmeres_parallel_tpu/ops/encode_pallas.py::rolling_codes_split_packed_pallas``
(``words_le=True``). It emits windows in natural stream order (slot p is
the window that starts at base p), where the TPU kernel emits a
residue-permuted order; the consumers only read the multiset of valid
codes, and natural order lets the kernel and its plain version be
compared slot by slot.

Planes are int32 tensors holding u32 bits (torch's uint32 arithmetic is
partial on the CPU); outputs are int32 ``lo`` and int16 or int32 ``hi``
holding u32/u16 bits, with all-ones sentinels. The host views them back
as unsigned with ``numpy .view``.
"""

from __future__ import annotations

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

#: Kernel launches since the count was last reset; the wrapper adds one
#: per launch and nothing else touches it except a caller's reset.
LAUNCHES = 0


def _check_planes(words_le: torch.Tensor, inval_be: torch.Tensor, k: int):
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


def encode_packed(
    words_le: torch.Tensor,
    inval_be: torch.Tensor,
    n_own: int,
    k: int,
    canonical: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Launch the CUDA kernel: planes [Tw] on the card -> (hi, lo) window
    planes [16*Tw] on the card (hi is None for k <= 15). Raises on
    anything the kernel does not take, and if the launch fails."""
    global LAUNCHES
    _check_planes(words_le, inval_be, k)
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
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"kp_encode_packed launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return hi, lo


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 bits (or -1) -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def encode_packed_reference(
    words_le: torch.Tensor,
    inval_be: torch.Tensor,
    n_own: int,
    k: int,
    canonical: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Plain PyTorch version of :func:`encode_packed`: the same planes in
    the same order, on whatever device the planes lie, in int64 ops.

    Unpacks the digits, rolls over the k window offsets
    (``sparse.rolling_codes_split``), then ``sparse.canonicalize_split``."""
    _check_planes(words_le, inval_be, k)
    dev = words_le.device
    T = 16 * words_le.shape[0]
    sh = 2 * torch.arange(16, device=dev, dtype=torch.int64)
    w = words_le.to(torch.int64) & 0xFFFFFFFF
    iv = inval_be.to(torch.int64) & 0xFFFFFFFF
    digits = ((w[:, None] >> sh) & 3).reshape(-1)
    bad = (((iv[:, None] >> (30 - sh)) & 3) != 0).reshape(-1)
    bases = digits.masked_fill(bad, 0xFF)
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
