"""The port's tracing: host-clock spans at the layers of a call, and
``torch.profiler`` traces of a run, the counterpart of the JAX package's
``jax.profiler`` trace.

``span(name, phases)`` times a block on the host clock and adds its
seconds to ``phases[name]`` (the engines' ``phases`` dicts are built from
these). While ``torch.profiler`` records on the calling thread, a span
also opens ``record_function("kmer.<name>")``, so the block sits on the
profiler's timeline beside the device's work, and appends one record to a
bounded in-memory log (``records()``):

- ``call``: an id shared by every span opened inside one outermost span
  (one public call);
- ``name``, and ``parent``, the name of the span it was opened in (None
  for the outermost);
- ``t0``, ``t1``: ``time.perf_counter`` at open and close;
- ``sys_s``: the process's system CPU seconds (``ru_stime``, every
  thread) over the span;
- ``counters``: what the block counted with the handle's ``count``;
- ``seq``: the record's number, in the order the spans closed.

With the profiler off a span costs its ``perf_counter`` pair and one flag
check, and its counters are dropped. ``trace(log_dir)`` writes the log
of the traced block as ``spans.jsonl`` beside ``trace.json``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import resource
import threading
import time

import torch

#: records the log keeps (the oldest go first): about 500 count calls of
#: 16 batches, or 9,000 distance calls
LOG_MAX = 1 << 16
#: the prefix of a span's range on the profiler's timeline
RANGE_PREFIX = "kmer."

_recording = torch._C._autograd._profiler_enabled
_log: collections.deque = collections.deque(maxlen=LOG_MAX)
_seq = itertools.count()  # numbers the records as they close
_call_ids = itertools.count()
_open = threading.local()  # .stack: the recording spans open on this thread


def _stack() -> list:
    s = getattr(_open, "stack", None)
    if s is None:
        s = _open.stack = []
    return s


def _sys_s() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_stime


class span:
    """``with span(name, phases) as s: ...; s.count("rows", n)``: see the
    module's docstring. Its seconds run from its construction."""

    __slots__ = ("name", "phases", "counters", "_t0", "_rec")

    def __init__(self, name: str, phases: dict | None = None):
        # the clock is read first, and the phase added last, so a phase
        # holds what its span costs (under the profiler too) and a call's
        # phases still cover its wall
        self._t0 = time.perf_counter()
        self.name = name
        self.phases = phases
        self.counters: dict[str, int] = {}
        self._rec = None

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + int(n)

    def __enter__(self) -> "span":
        if _recording():
            stack = _stack()
            parent = stack[-1] if stack else None
            rng = torch.autograd.profiler.record_function(RANGE_PREFIX + self.name)
            rng.__enter__()
            self._rec = {
                "call": parent._rec["call"] if parent is not None else next(_call_ids),
                "name": self.name,
                "parent": parent.name if parent is not None else None,
                "sys_s": _sys_s(),
                "_range": rng,
            }
            stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        rec, self._rec = self._rec, None
        if rec is not None:
            t1 = time.perf_counter()
            rec.pop("_range").__exit__(*exc)
            _stack().pop()
            rec.update(t0=self._t0, t1=t1, sys_s=_sys_s() - rec["sys_s"],
                       counters=self.counters, seq=next(_seq))
            _log.append(rec)
        if self.phases is not None:
            self.phases[self.name] = (self.phases.get(self.name, 0.0)
                                      + time.perf_counter() - self._t0)


def records() -> list[dict]:
    """The log's records, oldest first (each closed span one record, in
    the order they closed)."""
    return list(_log)


def clear() -> None:
    """Empty the log."""
    _log.clear()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Trace the host and, where CUDA is available, the card into
    ``log_dir/trace.json`` (a Chrome trace), and the spans closed in the
    block into ``log_dir/spans.jsonl`` (one record a line); a no-op when
    log_dir is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = next(_seq)  # every record of the block comes after it
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.jsonl"), "w") as f:
        for rec in records():
            if rec["seq"] > first:
                f.write(json.dumps(rec) + "\n")
