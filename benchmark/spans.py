"""The program's span log as the per-layer readers take it.

The port records one span a layer of each public call while
``torch.profiler`` records (``dna_kmeres_parallel_tpu_torch.utils.profiling
.records()``: ``call``, ``name``, ``parent``, ``t0``/``t1`` on
``time.perf_counter``, ``sys_s``, ``counters``). A traced run's readers
take the records of the public calls whose outermost span (the root, no
parent) lies inside one of the window's calls, ``run.calls``' ``[start,
end]`` on the same clock: the warm-up's calls under the profiler's first
start are left out. A run with no trace, or whose trace holds no device
activity (the kernels' plain versions on the CPU), reads nothing, as the
trace's readers do; so does a program that keeps no span log.
"""

from __future__ import annotations


def log() -> list[dict]:
    """The program's span log; empty where the program keeps none."""
    from dna_kmeres_parallel_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    return list(records()) if records is not None else []


def window_calls(run, records: list[dict] | None = None) -> list[tuple[object, list[dict]]]:
    """(window call, the records of one public call inside it) pairs, in
    the window's order."""
    if run.trace is None or not run.trace.device or not run.calls:
        return []
    groups: dict[object, list[dict]] = {}
    for r in log() if records is None else records:
        groups.setdefault(r["call"], []).append(r)
    out = []
    for group in groups.values():
        root = next((r for r in group if r["parent"] is None), None)
        if root is None:
            continue
        call = next((c for c in run.calls if c.start <= root["t0"] and root["t1"] <= c.end),
                    None)
        if call is not None:
            out.append((call, group))
    out.sort(key=lambda cg: cg[0].start)
    return out


def roots(pairs) -> list[dict]:
    return [r for _, g in pairs for r in g if r["parent"] is None]


def named(pairs, name: str) -> list[dict]:
    return [r for _, g in pairs for r in g if r["name"] == name]


def counter(recs: list[dict], key: str) -> int:
    return sum(r["counters"].get(key, 0) for r in recs)


def seconds(recs: list[dict]) -> float:
    return sum(r["t1"] - r["t0"] for r in recs)


def copy_gbytes_per_s(run, records=None) -> float | None:
    """The bytes of every ``d2h.copy`` span over their host-clock seconds,
    in GB/s."""
    recs = named(window_calls(run, records), "d2h.copy")
    s = seconds(recs)
    return counter(recs, "bytes") / s / 1e9 if recs and s > 0 else None


def merge_passes(run, records=None) -> float | None:
    """The rows the ``merge.pair`` spans wrote over the final tables' rows
    (the roots' ``rows``): how many times the merge writes each row (0
    where each call's one batch table needs no merge)."""
    pairs = window_calls(run, records)
    rows = counter(roots(pairs), "rows")
    return counter(named(pairs, "merge.pair"), "rows_out") / rows if rows > 0 else None


def sys_s_per_gbase(run, records=None) -> float | None:
    """The roots' system CPU seconds over the input Gbase of the window
    calls that hold them."""
    pairs = window_calls(run, records)
    gbase = sum({id(c): c.work for c, _ in pairs}.values()) / 1e9
    return sum(r["sys_s"] for r in roots(pairs)) / gbase if pairs and gbase > 0 else None


def sys_s_mean(run, records=None) -> float | None:
    """The roots' system CPU seconds, mean a public call."""
    rs = roots(window_calls(run, records))
    return sum(r["sys_s"] for r in rs) / len(rs) if rs else None
