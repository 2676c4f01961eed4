"""Read the compared numbers of many runs of one cell in one process, to set
and test its limits (``limits/<cell>.json``); the benchmark's own runs do
not run this.

    python3 -m port_bench.calibrate --workload <cell> --seeds 11,12,13 \\
        --seconds 3 --mode program|<control>|<fault>

``program`` runs the cell as the benchmark does (the lower readings); a
control of the cell's entry (its ``CONTROLS``, ``controls.py``) puts the
timed path in the nearest precision below the configuration's (the upper
readings); a fault of the entry (its ``FAULTS``, ``faults.py``) plants it.
A control that puts the reference in the program's place makes no warm-up
calls (it builds nothing).  Each run prints one JSON line of its numbers
and verdict; the last line holds the largest reading of each number over
the runs, and the smallest.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import spec
from .run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--mode", default="program")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: nothing read", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    entry = spec.module("entries", cell.traffic["entry"])
    modes = {"program": {}}
    modes.update({k: {"prepare": v, "warmup": 0 if k.startswith("reference") else None}
                  for k, v in entry.CONTROLS.items()})
    modes.update({k: {"plant": v} for k, v in entry.FAULTS.items()})
    if args.mode not in modes:
        print(f"no mode {args.mode!r}; {args.workload} has {', '.join(modes)}", file=sys.stderr)
        return 2
    hi, lo = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, "cuda", **modes[args.mode])
        nums = out["numbers"]
        for k, v in nums.items():
            hi[k] = max(hi.get(k, v), v)
            lo[k] = min(lo.get(k, v), v)
        print(json.dumps({"mode": args.mode, "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"], "numbers": nums,
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "s": time.perf_counter() - t}), flush=True)
    print(json.dumps({"mode": args.mode, "workload": args.workload, "largest": hi,
                      "smallest": lo}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
