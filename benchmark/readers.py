"""What the metric readers under ``metrics/`` share: sums of the window's
calls, the program's phases over the work, and the trace's idle and
roofline shares. A reader returns None where it finds nothing to read;
the harness then leaves its metric out of the line."""

from __future__ import annotations

import re

from benchmark import roofline


def total_work(run) -> float:
    return sum(c.work for c in run.calls)


def per_gbase(run, seconds) -> float | None:
    """Seconds (a function of a call) summed over the window's calls, over
    the calls' input Gbase."""
    gbase = total_work(run) / 1e9
    if not run.calls or gbase <= 0:
        return None
    return sum(seconds(c) for c in run.calls) / gbase


def phase_per_gbase(run, phase: str) -> float | None:
    if not any(phase in c.phases for c in run.calls):
        return None
    return per_gbase(run, lambda c: c.phases.get(phase, 0.0))


def phase_mean(run, phase: str) -> float | None:
    vals = [c.phases[phase] for c in run.calls if phase in c.phases]
    return sum(vals) / len(vals) if vals else None


def idle_pct(run) -> float | None:
    """The device's idle share of the traced window, in percent: 1 minus
    the merged intervals of its kernels, copies and memsets."""
    t = run.trace
    if t is None or t.window_s() <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())


def roofline_pct(run, pattern: str, work) -> float | None:
    """The least time of the window's work over the traced time of every
    kernel whose name matches ``pattern``, in percent. ``work`` gives a
    call's (bytes, operations) from its input sizes
    (``benchmark/roofline.py``); the trace holds every call of the window,
    so the two cover the same calls. A trace with no such kernel reads
    nothing."""
    t = run.trace
    if t is None or not run.calls:
        return None
    got = t.kernel_launches(pattern)
    if not got:
        return None
    spent = sum(float(e["dur"]) for e in got) / 1e6
    least = sum(roofline.least_s(*work(c)) for c in run.calls)
    return 100.0 * least / spent if spent > 0 else None


def k1_work(run):
    """A call's K1 work: its parsed stream's windows."""
    k = run.config["args"]["k"]
    return lambda c: roofline.k1_work(int(c.inp.records.stream.size), k)


def k3_work(run):
    """A call's (min,+) product: an int32 [S, 4^k] counts matrix against
    itself."""
    k = run.config["args"]["k"]
    return lambda c: roofline.k3_work(int(c.inp.records.lengths.size), 4**k)


K1_KERNEL = re.escape("encode_packed_kernel")
K3_KERNEL = r"min_sum_(tri|rect)_kernel"
