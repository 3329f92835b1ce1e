"""Run metrics: named counters, phase wall-timers, derived rates, a JSON
report. The port's copy of the JAX package's ``utils/metrics.py``; the
names a run records are the JAX package's."""

from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass, field

from dna_kmeres_parallel_tpu_torch.utils.profiling import span


@dataclass
class Metrics:
    counters: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    phase_seconds: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    started_at: float = field(default_factory=time.time)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def phase(self, name: str) -> span:
        """A span (``utils/profiling``) that adds its seconds to
        ``phase_seconds[name]``: on the profiler's timeline as
        ``kmer.<name>`` while a trace records."""
        return span(name, self.phase_seconds)

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
