"""Device resolution: where does a public entry run?

The JAX package resolves a backend and a Pallas mode (compiled, interpret
or plain jnp) and degrades once on a kernel build failure. The port has
no modes: a tensor on the card goes to the hand-written kernel, a tensor
on the CPU to the kernel's plain PyTorch version, and the caller picks
the device explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The ``torch.device`` a public entry runs on.

    Asking for ``"cuda"`` where CUDA is not available raises: the port
    never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for but CUDA is not available"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")

