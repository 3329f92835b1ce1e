"""The readings the limits of a cell's checks are set from, on the card, at
the cell's own size (not run by the benchmark's own runs).

    python3 benchmark/limits.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

For each seed of ``--seeds`` it makes the cell's inputs, calls the entry
once on every input (the same call the window makes; no warm-up, which
changes no output) and holds each output to the plain reference: the
lower readings. For each seed of
``--control-seeds`` it puts the control in the program's place (the
reference with one guarantee broken or one precision lowered, the entry's
``control``) and compares it the same way: the upper readings. Every
reading is printed as one JSON line; the last line holds each compared
number's largest sound reading and smallest control reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as bench  # noqa: E402


def readings(cell, seed: int, device: str, control: bool) -> dict:
    """The worst of each compared number over the cell's inputs of one
    seed, for the program or for the control."""
    entry, cfg = cell.entry, cell.config
    tmp = tempfile.mkdtemp(prefix="kmer_limits_")
    try:
        inputs = cell.generator().generate(cell.workload["params"], seed, tmp)
        worst: dict = {}
        for inp in inputs:
            if control:
                got = entry.control(cfg, inp, device)
            else:
                got = entry.outputs(entry.call(cfg, inp, device))
            ref = entry.reference(cfg, inp, device)
            for name, value in entry.compare(cfg, inp, got, ref).items():
                worst[name] = max(worst.get(name, 0.0), bench.finite(value))
            del got, ref
            gc.collect()
        return worst
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = bench.Cell.load(args.workload)
    sound: dict = {}
    ctrl: dict = {}
    for kind, seeds, into in (("program", args.seeds, sound),
                              ("control", args.control_seeds, ctrl)):
        for s in filter(None, seeds.split(",")):
            got = readings(cell, int(s), "cuda", kind == "control")
            print(json.dumps({"cell": cell.name, "kind": kind, "seed": int(s), **got}),
                  flush=True)
            for name, value in got.items():
                into.setdefault(name, []).append(value)
    print(json.dumps({
        "cell": cell.name,
        "lower": {n: max(v) for n, v in sound.items()},
        "upper": {n: min(v) for n, v in ctrl.items()},
        "limits": cell.config["limits"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
