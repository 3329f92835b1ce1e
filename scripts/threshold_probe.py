#!/usr/bin/env python3
"""The threshold (min,+) route against K3/K4 on one NVIDIA card, at the
distance path's shapes, with the rates its gate reads.

    python3 scripts/threshold_probe.py [--records N]

Builds the kernels, then on ``chip_smoke.py``'s own seeded data: (a) the
k=3 counts of the first 16,384 distance records, (b) the k=8 counts of
the first 2,048, (d) the union matrix of 2,048 reads of a 100 kbase
genome at k=21, (g) the k=9 counts of the first 1,024 and the k=10 panel
of the first 256. At each shape ``chip_smoke.phase_threshold`` holds the
route to K3/K4 and the plain product and times the route, its planes,
K3/K4 and ``torch.cdist(p=1)`` with CUDA events, beside the gate's
choice under the rates ``ops/calibrate.measure_compute`` measures in the
same process and under ``DistanceRates``' defaults (the gate is not held
to the faster route here). Then, at every shape, the route with its
planes' bins padded to multiples of 8 and of 32
(``threshold_cuda.PLANE_ALIGN``), in alternating order, 8-32-32-8. Every
line carries the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=54_018)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("threshold_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.ops import calibrate, distance_cuda, histogram_cuda, kernels

    card = cs.card_line()
    kernels.build()
    kernels.load()
    dev = torch.device("cuda", 0)
    cal = calibrate.measure_compute(dev)
    cs.log(f"measure_compute: {json.dumps(cal)} [{card}]")
    rates = calibrate.rates_from(cal)
    records = cs.distance_records(args.records)

    def counts(n: int, k: int):
        sub = cs.first_records(records, min(n, records[2].size))
        grid = torch.from_numpy(cs.record_grid(*sub)).to(dev)
        return histogram_cuda.counts_matrix_grid(grid, k, 4**k)

    reads = cs.read_set(cs.READ_COUNT, cs.READ_GENOME_BASES)
    tables = sparse_engine.build_pair_tables(cs.record_strings(*reads), cs.SPARSE_K, False, dev)
    plan = sparse_engine.union_dense_plan(*tables, device=dev, union="on", threshold="off")
    mat = sparse_engine.union_on_device(*tables, plan, dev)
    S = tables[2].size - 1
    c9, c10 = counts(cs.MIDK_ROWS, 9), counts(cs.MIDK_STREAM_ROWS, 10)
    shapes = {
        "(a)": (counts(cs.DIST_ROWS_A, 3), 3, True),
        "(b)": (counts(cs.DIST_ROWS_B, 8), 8, True),
        "(g) k=9": (c9, 9, True),
    }

    def engine_choice(k, c, rows, symmetric):
        from dna_kmeres_parallel_tpu_torch import KmerConfig
        from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

        return lambda r: KmerEngine(KmerConfig(k=k), device=dev, rates=r)._threshold_cmax(
            c, rows, symmetric)

    def union_choice(r):
        p = sparse_engine.union_dense_plan(*tables, device=dev, union="on", rates=r)
        return p["cmax"] if p is not None and p["impl"] == "threshold" else None

    cases = [cs.threshold_case(name, c, None, (lambda c=c: distance_cuda.min_sum_matrix_tri(c)),
                               engine_choice(k, c, c.shape[0], True))
             for name, (c, k, _) in shapes.items()]
    cases.insert(2, cs.threshold_case(
        "(d)", mat[:S, : plan["D"]], None, lambda: distance_cuda.min_sum_matrix_tri(mat)[:S, :S],
        union_choice))
    cases.append(cs.threshold_case(
        "(g) k=10 panel", c10, c10, lambda: distance_cuda.min_sum_matrix_rect(c10, c10),
        engine_choice(10, c10, min(cs.PANEL_ROWS, c10.shape[0]), False)))
    cs.phase_threshold(dev, card, cases, rates, sparse_engine.DistanceRates(), hold_gate=False)
    from dna_kmeres_parallel_tpu_torch.ops import threshold_cuda

    kept = threshold_cuda.PLANE_ALIGN
    try:
        for case in cases:
            a, other = case["a"], case["other"]
            cmax = max(int(a.max()), 0 if other is None else int(other.max()))
            bucket = 1 << max(cmax - 1, 0).bit_length()
            times = {8: [], 32: []}
            for align in (8, 32, 32, 8):
                threshold_cuda.PLANE_ALIGN = align
                times[align].append(cs.time_ms(
                    lambda: threshold_cuda.min_sum_matrix_threshold(a, bucket, other), 5))
            cs.log(f"plane alignment {case['name']}: 8 -> {times[8]} ms, 32 -> {times[32]} ms "
                   f"[{card}]")
    finally:
        threshold_cuda.PLANE_ALIGN = kept
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
