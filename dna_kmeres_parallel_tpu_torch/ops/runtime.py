"""Device resolution (where does a public entry run?) and the event marks
the engines time their device phases with.

The JAX package resolves a backend and a Pallas mode (compiled, interpret
or plain jnp) and degrades once on a kernel build failure. The port has
no modes: a tensor on the card goes to the hand-written kernel, a tensor
on the CPU to the kernel's plain PyTorch version, and the caller picks
the device explicitly.
"""

from __future__ import annotations

import time

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


def mark(dev: torch.device):
    """A point on the device's timeline: a CUDA event recorded on the
    current stream on the card, the host clock on the CPU (where every op
    has finished when it returns). Reading the events adds no synchronize
    when they are read after a copy to the host has waited for the
    stream."""
    if dev.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(dev))
    return event


def wait(m) -> None:
    """Wait on the host until the device has reached ``mark`` point ``m``
    (on the CPU it has already)."""
    if not isinstance(m, float):
        m.synchronize()


def span_s(a, b) -> float:
    """Seconds between two ``mark`` points (on the card this waits for the
    later event, which has normally completed by the time it is read)."""
    if isinstance(a, float):
        return b - a
    b.synchronize()
    return a.elapsed_time(b) / 1e3
