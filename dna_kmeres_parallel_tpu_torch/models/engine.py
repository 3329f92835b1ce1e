"""Host staging of a batch for the device encoder.

The port of ``dna_kmeres_parallel_tpu/models/engine.py``'s plane staging
(``pack_planes_np``, ``stage_batch_planes``). The dense engine will live
here too once it is ported (ROADMAP item 6).
"""

from __future__ import annotations

import numpy as np
import torch

from dna_kmeres_parallel_tpu import native
from dna_kmeres_parallel_tpu_torch.ops.encode_cuda import host_planes_from_packfmt


def pack_planes_np(flat_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack a padded u8 base stream (length a multiple of 16) with the
    native packer and build the encoder's u32 (words_le, inval_be) planes,
    NumPy in and NumPy out."""
    data, mask, _ = native.pack_2bit_native(flat_u8)
    return host_planes_from_packfmt(data, mask)


def planes_to_device(
    planes: tuple[np.ndarray, np.ndarray], device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """u32 NumPy planes -> int32 tensors on ``device`` with the same bits.
    To the card they go through pinned host memory."""
    out = []
    for plane in planes:
        t = torch.from_numpy(plane.view(np.int32))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out[0], out[1]


def stage_batch_planes(
    padded: np.ndarray, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Planes of a padded batch on ``device``: 0.5 B per base."""
    return planes_to_device(pack_planes_np(padded), device)
