"""Profiler traces of a run, with ``torch.profiler``: the counterpart of
the JAX package's ``jax.profiler`` trace."""

from __future__ import annotations

import contextlib
import os


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
