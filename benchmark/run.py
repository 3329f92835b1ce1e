"""The benchmark of ``dna_kmeres_parallel_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell, from the root of a checkout. Everything that belongs
to a cell is found by name, as data:

- ``benchmark/workloads/<cell>.json``: the configuration, the traffic's
  generator and parameters, the chips, and why the cell exists;
- ``benchmark/configs/<config>.json``: the entry point and its arguments,
  the source, what was reduced and assumed, and the limits of the checks;
- ``benchmark/entries/<entry>.py``: how to warm the entry up, call it,
  count its work, and hold its outputs to the plain reference
  (``benchmark/reference/``);
- ``benchmark/metrics/<metric>.py``: one reader a metric, listed for the
  cell in ``BENCHMARK.json``.

A run makes its inputs from ``--seed`` (``benchmark/gen/``), warms up the
entry on the cell's own shapes, then calls it in a closed loop of whole
calls until ``--seconds`` have passed (the call in flight is finished and
counted). With ``--trace 1`` ``torch.profiler`` records the window. After
the window it reads the peak device memory, checks that no JAX module was
loaded, holds a seeded sample of the window's outputs to the reference,
and prints one JSON line: the cell's end-to-end metrics (``--trace 0``) or
its per-layer metrics (``--trace 1``), the device, and the checks beside
their limits.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dna_kmeres_parallel_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file of the benchmark, loaded by its path (metric files
    have dots in their names)."""
    name = "bench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    name = name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's name only begins with the latter)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    entry: object
    bench_dir: Path

    @classmethod
    def load(cls, name: str, bench_dir: Path = BENCH_DIR) -> "Cell":
        w = load_json(bench_dir / "workloads" / f"{name}.json")
        c = load_json(bench_dir / "configs" / f"{w['config']}.json")
        entry = load_module(bench_dir / "entries" / f"{c['entry']}.py")
        return cls(name, w, c, entry, bench_dir)

    def generator(self):
        return load_module(self.bench_dir / "gen" / f"{self.workload['generator']}.py")


def cell_metrics(manifest: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics ``BENCHMARK.json`` lists for this cell: its end-to-end
    metrics, or with the trace its per-layer metrics."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@dataclass
class Call:
    """One whole call of the window."""

    inp: object
    start: float
    end: float
    work: float
    phases: dict

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """What the readers read: the cell, the window's calls, set-up, and the
    reduced trace (None without ``--trace 1``)."""

    cell: Cell
    calls: list[Call]
    window_s: float
    setup_s: float
    trace: object = None

    @property
    def config(self) -> dict:
        return self.cell.config


class Sample:
    """A seeded sample of the window's outputs: up to ``keep`` results an
    input (reservoir sampling, so every call has the same chance)."""

    def __init__(self, keep: int, rng: np.random.Generator):
        self.keep = keep
        self.rng = rng
        self.seen: dict[int, int] = {}
        self.kept: dict[int, list] = {}

    def offer(self, key: int, result) -> None:
        n = self.seen.get(key, 0)
        self.seen[key] = n + 1
        slots = self.kept.setdefault(key, [])
        if len(slots) < self.keep:
            slots.append(result)
        else:
            j = int(self.rng.integers(0, n + 1))
            if j < self.keep:
                slots[j] = result


def card() -> dict:
    """The card's name and power limit, from nvidia-smi where it runs."""
    import torch

    out = {"kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
        if line:
            out["power_limit"] = line[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def host_memory_peak_bytes() -> int:
    """The process's peak resident host memory (Linux reports KiB)."""
    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def finite(x: float) -> float:
    """A compared number as JSON can hold it: NaN and infinities read as
    1e30, beyond every limit."""
    x = float(x)
    return x if math.isfinite(x) else 1e30


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: str,
             manifest: dict, t_start: float | None = None) -> dict:
    """One run of the cell on ``device``; returns the result line's object.
    The caller has checked for the chips."""
    import torch

    from benchmark import trace as trace_mod

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, entry = cell.config, cell.entry
    tmp = tempfile.mkdtemp(prefix="kmer_bench_")
    try:
        # ---- set-up: inputs from the seed, the entry warmed on their shapes
        inputs = cell.generator().generate(cell.workload["params"], seed, tmp)
        entry.warm_up(cfg, inputs, device, tmp)
        profiler = (trace_mod.Profiler(tmp, bool(cell.workload.get("trace_stack")))
                    if traced else None)
        if profiler is not None:  # the profiler's own first start
            profiler.start()
            entry.warm_up(cfg, inputs[:1], device, tmp)
            profiler.stop()
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s: {len(inputs)} input(s) made, the entry warmed")

        # ---- the window: whole calls in a closed loop, in a seeded order
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(inputs))
        sample = Sample(int(cell.workload.get("keep_per_input", 1)), rng)
        calls: list[Call] = []
        failed = 0
        if profiler is not None:
            profiler.start()
        w0 = time.perf_counter()
        i = 0
        while True:
            inp = inputs[order[i % len(order)]]
            i += 1
            t0 = time.perf_counter()
            span = (torch.profiler.record_function(f"{trace_mod.CALL_PREFIX}.{inp.index}")
                    if traced else contextlib.nullcontext())
            try:
                with span:
                    res = entry.call(cfg, inp, device)
                    if device == "cuda":
                        torch.cuda.synchronize()
            except Exception:  # a failed call counts, and the window goes on
                failed += 1
                log(traceback.format_exc())
                res = None
            t1 = time.perf_counter()
            if res is not None:
                calls.append(Call(inp, t0, t1, entry.work(cfg, inp), entry.phases(res)))
                sample.offer(inp.index, res)
                del res
            if t1 - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
        reduced = profiler.stop() if profiler is not None else None
        attempted = i
        log(f"window {window_s:.3f} s: {attempted} call(s), {failed} failed")
        if calls:
            walls = sorted(c.wall for c in calls)
            log(f"call walls (s): first {calls[0].wall:.3f}, least {walls[0]:.3f}, "
                f"median {walls[len(walls) // 2]:.3f}, most {walls[-1]:.3f}")

        # ---- after the window: memory, JAX, then the check
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        found = forbidden_loaded()
        if found:
            raise SystemExit(f"JAX or the JAX package was loaded: {', '.join(found)}")
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        kept = sum(len(v) for v in sample.kept.values())
        checks = check_sample(cell, inputs, sample, device)
        log(f"check {time.perf_counter() - t_check:.3f} s: {kept} output(s) of "
            f"{len(sample.kept)} input(s) held to the reference")
        correct = failed == 0 and bool(calls) and all(
            c["value"] <= c["limit"] for c in checks.values())

        run = Run(cell, calls, window_s, setup_s, reduced)
        metrics = {}
        for m in cell_metrics(manifest, cell.name, traced):
            value = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py").read(run)
            if value is None:
                log(f"metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev = card()
        out = {
            "correct": correct,
            "attempted": attempted,
            "failed": failed,
            "metrics": metrics,
            "device": {
                "platform": "gpu" if device == "cuda" else "cpu",
                "kind": dev["kind"],
                "count": int(cell.workload["chips"]),
                "memory_peak_bytes": int(peak),
                "power_limit": dev.get("power_limit", "not read"),
            },
        }
        if reduced is not None:
            out["device"]["busy_s"] = reduced.busy_s()
            out["device"]["window_s"] = reduced.window_s()
            out["breakdown"] = {
                "device_ops": reduced.top_device_ops(),
                "idle_gaps": reduced.idle_gaps(),
            }
        host_peak = host_memory_peak_bytes()
        log(f"host memory peak {host_peak} bytes")
        out["host"] = {"memory_peak_bytes": host_peak}
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_sample(cell: Cell, inputs: list, sample: Sample, device: str) -> dict:
    """Hold every sampled output to the plain reference of its input; each
    compared number is the worst over the sample, beside its limit."""
    limits = cell.config["limits"]
    worst = {name: 0.0 for name in limits}
    for key in sorted(sample.kept):
        ref = cell.entry.reference(cell.config, inputs[key], device)
        for res in sample.kept[key]:
            got = cell.entry.compare(cell.config, inputs[key], cell.entry.outputs(res), ref)
            for name, value in got.items():
                worst[name] = max(worst[name], finite(value))
        del ref
        sample.kept[key] = []
        gc.collect()
    return {name: {"value": worst[name], "limit": limits[name]} for name in limits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = load_json(ROOT / "BENCHMARK.json")
    spec = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if spec is None:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        log(f"the cell needs {spec['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    cell = Cell.load(args.workload)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", manifest, T_START)
    found = forbidden_loaded()
    if found:
        log(f"JAX or the JAX package was loaded: {', '.join(found)}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
