"""The traced run's profiler: ``torch.profiler`` over the window (CPU and
CUDA activities), reduced to the numbers the per-layer readers and the
result line take.

The trace is exported in Chrome's format to a file in the run's temporary
directory, read back and deleted; the reduction works on its list of
events. Device activity is every event of category ``kernel``,
``gpu_memcpy`` or ``gpu_memset``; host annotations are the ``bench.call``
ranges the harness opens around each call, and the Python functions the
profiler records where the workload file asks for ``trace_stack``.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime")
CALL_PREFIX = "bench.call"
PROGRAM = "dna_kmeres_parallel_tpu_torch/"


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, sorted and merged."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


@dataclass
class Trace:
    """A reduced trace: times in microseconds, as Chrome traces keep them."""

    device: list[dict] = field(default_factory=list)
    host: list[dict] = field(default_factory=list)
    calls: list[tuple[float, float]] = field(default_factory=list)

    @classmethod
    def from_events(cls, events: list[dict]) -> "Trace":
        t = cls()
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                t.device.append(e)
            elif cat in HOST_CATS:
                t.host.append(e)
                if e.get("name", "").startswith(CALL_PREFIX):
                    t.calls.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        return t

    def span(self) -> tuple[float, float] | None:
        """The traced window: from the start of the first call to the end
        of the last."""
        if not self.calls:
            return None
        return min(a for a, _ in self.calls), max(b for _, b in self.calls)

    def window_s(self) -> float:
        s = self.span()
        return 0.0 if s is None else (s[1] - s[0]) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        s = self.span()
        if s is None:
            return []
        iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device]
        return merge(clip(iv, *s))

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_launches(self, pattern: str) -> list[dict]:
        """The kernel events whose name matches ``pattern`` (a regex), in
        the traced window."""
        s = self.span()
        rx = re.compile(pattern)
        return [
            e for e in self.device
            if e.get("cat") == "kernel" and rx.search(e.get("name", ""))
            and s is not None and s[0] <= float(e["ts"]) <= s[1]
        ]

    def top_device_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        by: dict[str, float] = {}
        for e in self.device:
            name = short_name(e.get("name", ""))
            by[name] = by.get(name, 0.0) + float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The longest idle gaps of the device inside the window, each
        named by what the host was doing over it: the innermost host event
        over the gap's middle, and the device operation before it."""
        s = self.span()
        if s is None:
            return []
        busy = self.busy_intervals()
        edges = [s[0]] + [x for iv in busy for x in iv] + [s[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            out.append([self._label(a, b), (b - a) / 1e6])
        return out

    def _label(self, a: float, b: float) -> str:
        """The innermost function of the program (else any host event)
        running over the gap's middle, and the device operation before."""
        mid = (a + b) / 2
        over = [e for e in self.host
                if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])
                and not e.get("name", "").startswith(CALL_PREFIX)]
        ours = [e for e in over if PROGRAM in e.get("name", "")]
        inner = min(ours or over, key=lambda e: float(e["dur"]))["name"] if over else "host code"
        before = [e for e in self.device if float(e["ts"]) + float(e["dur"]) <= a + 1e-3]
        prev = short_name(max(before, key=lambda e: float(e["ts"]))["name"]) if before else "start"
        return f"host: {host_name(inner)}; after: {prev}"


def host_name(name: str) -> str:
    """A Python function event (``path/file.py(line): func``) as
    ``file.py:func``; any other host event by its short name."""
    m = re.match(r"^(.*?)\((\d+)\): (.+)$", name)
    if m:
        return f"{os.path.basename(m.group(1))}:{m.group(3)}"
    return short_name(name)


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without its return type, namespace tag,
    template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut].strip()[:width]


class Profiler:
    """``torch.profiler`` over the window, exported and reduced at stop."""

    def __init__(self, tmp_dir: str, with_stack: bool = False):
        self.tmp_dir = tmp_dir
        self.with_stack = with_stack
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # with_stack records the Python functions, which name what the host
        # did over each idle gap of the device; a cell whose host path makes
        # many Python calls (a finish row by row) leaves it off
        self._prof = profile(activities=acts, with_stack=self.with_stack)
        self._prof.__enter__()

    def stop(self) -> Trace:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        path = os.path.join(self.tmp_dir, "trace.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return Trace.from_events(events)
