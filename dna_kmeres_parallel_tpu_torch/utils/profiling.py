"""Profiler traces of a run, with ``torch.profiler``: the counterpart of
the JAX package's ``jax.profiler`` trace; and its device-synchronized
``wall_timer``."""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Trace the host and, where CUDA is available, the card into
    ``log_dir/trace.json`` (a Chrome trace); a no-op when log_dir is
    None or empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def wall_timer(out: dict, key: str):
    """Wall seconds of the block into ``out[key]``, read after the work on
    the tensors the block leaves in ``out[key + "_arrays"]`` (popped) has
    finished: each card that holds one is synchronized first."""
    t0 = time.perf_counter()
    yield
    arrays = out.pop(key + "_arrays", None)
    if arrays is not None:
        import torch

        items = arrays if isinstance(arrays, (list, tuple)) else [arrays]
        for dev in {a.device for a in items if isinstance(a, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    out[key] = time.perf_counter() - t0
