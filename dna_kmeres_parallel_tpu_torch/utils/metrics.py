"""Run metrics: named counters, phase wall-timers, derived rates, a JSON
report. The port's copy of the JAX package's ``utils/metrics.py``; the
names a run records are the JAX package's."""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Metrics:
    counters: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    phase_seconds: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    started_at: float = field(default_factory=time.time)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_seconds[name] += time.perf_counter() - t0

    def rate(self, counter: str, phase: str) -> float:
        dt = self.phase_seconds.get(phase, 0.0)
        return self.counters.get(counter, 0) / dt if dt > 0 else 0.0

    def report(self) -> dict:
        out = {
            "counters": dict(self.counters),
            "phase_seconds": {k: round(v, 6) for k, v in self.phase_seconds.items()},
            "wall_seconds": round(time.time() - self.started_at, 6),
        }
        if "bases" in self.counters and "device" in self.phase_seconds:
            out["bases_per_sec_device"] = round(self.rate("bases", "device"), 1)
        return out

    def json(self) -> str:
        return json.dumps(self.report(), sort_keys=True)
