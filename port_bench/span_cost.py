"""What the port's own spans cost while they are on, with no profiler: one
cell's entry called back to back in blocks of ``--calls`` calls, with the
spans off and on in the order off, on, on, off each round, in one process
on one card, on the inputs of one seed.  A call ends in its host read, as
in ``run.py``; the spans are collected between blocks, outside the timing.
Prints one JSON line a block (milliseconds a call), then the median of each
mode, the rate on over off (the inverse of their ratio), and the quartiles
of the rounds' own rate ratios.

    python3 -m port_bench.span_cost --workload floor2d-refit --rounds 12 --calls 20 --seed 7

from the root of a checkout, on a machine with a CUDA card.  Where the
program has no spans (an older tree) it exits with code 2."""
import argparse
import json
import statistics
import sys
import time

import torch

from . import generator, program, program_spans, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lu = program_spans._logging_utils()
    if lu is None:
        print("the program has no spans", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(args.device)
    inputs = generator.make_inputs(cfg, tr, args.seed, dev)
    caller = spec.module("entries", tr["entry"]).prepare(cfg, tr, inputs, dev, args.seed)
    pool = inputs.pool
    done = 0

    def block(n, on):
        """Milliseconds a call over ``n`` calls with the spans ``on``."""
        nonlocal done
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        lu.spans(on)
        t = time.perf_counter()
        for _ in range(n):
            host, _ = caller.call(pool[done % len(pool)])
            host.cpu()
            done += 1
        ms = (time.perf_counter() - t) * 1e3 / n
        lu.spans(False)
        lu.collect()
        return ms

    ms = {"off": [], "on": []}
    ratios = []
    with caller.installed():
        for on in (False, True):  # the warm-up, and the first spans' own set-up
            block(tr["warmup_calls"], on)
        for r in range(args.rounds):
            mine = {"off": [], "on": []}
            for mode in ("off", "on", "on", "off"):
                v = block(args.calls, mode == "on")
                ms[mode].append(v)
                mine[mode].append(v)
                print(json.dumps({"round": r, "spans": mode, "ms_per_call": v}), flush=True)
            ratios.append(sum(mine["off"]) / sum(mine["on"]))
    off, on = statistics.median(ms["off"]), statistics.median(ms["on"])
    q = statistics.quantiles(ratios, n=4) if len(ratios) > 1 else [ratios[0]] * 3
    print(json.dumps({
        "workload": args.workload, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "rounds": args.rounds,
        "calls": args.calls, "median_ms_per_call": {"off": off, "on": on},
        "rate_on_over_off": off / on, "round_rate_ratio_quartiles": q,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
