"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run loads the cell's files (``spec.py``),
makes its inputs on the card from the seed (``generator.py``), drives the
traffic's entry (``entries/<entry>.py``) of
``gaussian_process_transportation_tpu_torch`` for its warm-up calls (the
kernels are built or loaded from the package's ``_build/`` at the first),
then calls it back to back, one caller, for ``--seconds``.  After the
window the traffic's checks (``checks/<check>.py``) compare what the calls
returned with the plain float64 reference, and the run prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones: the layers' spans (``program.Span``) are recorded through
the whole window, and a ``torch.profiler`` session covers ``trace_calls``
calls after it.

Without a CUDA card, or with fewer than the cell asks for, the run exits
with code 2 and prints no result; where ``jax``, ``jaxlib``, ``flax``,
``optax`` or the JAX package is loaded once the window has closed, with
code 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Callable, Optional  # noqa: E402

import torch  # noqa: E402

from . import check, generator, program, readings, spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gaussian_process_transportation_tpu")
CUPTI_TRIES = 4  # profiled stretches tried before the device readings are given up


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _readers(kind, metrics):
    return {m["name"]: spec.module(kind, m["name"]) for m in metrics}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t0: Optional[float] = None, members: Optional[int] = None,
             pool: Optional[int] = None, prepare: Optional[Callable] = None,
             plant: Optional[Callable[[spec.Cell], contextlib.AbstractContextManager]] = None,
             warmup: Optional[int] = None) -> dict:
    """One run of ``cell``; returns the result line's object.  ``members``,
    ``pool`` and ``warmup`` override the traffic's sizes and warm-up calls
    (the tests' small runs on the CPU, the controls), ``prepare`` puts another
    factory of the same signature in the place of the entry's ``prepare``
    (a control), and ``plant`` wraps the window in a context that breaks the
    timed path (a fault)."""
    t0 = time.perf_counter() if t0 is None else t0
    cfg, tr = cell.config, cell.traffic
    inputs = generator.make_inputs(cfg, tr, seed, device, members, pool)
    prepare = prepare or spec.module("entries", tr["entry"]).prepare
    caller = prepare(cfg, tr, inputs, device, seed)
    P = len(inputs.pool)
    E = inputs.pool[0].shape[0]
    annotate = torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())

    kept, reads, call_s = {}, defaultdict(list), []
    calls = 0

    def step():
        """One call on the next batch of the pool; its seconds, from its start to the host read."""
        nonlocal calls
        b = calls % P
        calls += 1
        t = time.perf_counter()
        with annotate("call"):
            host, payload = caller.call(inputs.pool[b])
            with annotate("host_read"):
                host = host.cpu()
        dt = time.perf_counter() - t
        kept[b] = payload
        if caller.own_state:  # each call derives its own state: only the kept call's read compares
            reads[b].clear()
        reads[b].append(host)
        return dt

    for _ in range(tr["warmup_calls"] if warmup is None else warmup):
        step()
    sync(device)
    setup_s = time.perf_counter() - t0

    per_layer = _readers("layer_metrics", cell.per_layer) if traced else {}
    end_to_end = {} if traced else _readers("end_to_end", cell.end_to_end)
    spans = {}
    counters = {}
    for r in per_layer.values():
        for name in getattr(r, "SPANS", []):
            spans.setdefault(name, program.Span(name))
        for name in getattr(r, "COUNTERS", []):
            c = program.counter(name)
            if c is not None:
                counters[name] = c
    # the fault under the spans and the entry's captures; undone in the reverse order
    installed = contextlib.ExitStack()
    if plant is not None:
        installed.enter_context(plant(cell))
    for s in spans.values():
        s.install()
        installed.callback(s.remove)
    installed.enter_context(caller.installed())

    kept.clear()
    reads.clear()

    def profile_stretch():
        """Profile ``trace_calls`` calls; (session, calls, host seconds, counters)."""
        sync(device)
        for _, reset in counters.values():
            reset()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t = time.perf_counter()
            for _ in range(tr["trace_calls"]):
                step()
            sync(device)
            host_s = time.perf_counter() - t
            counts_now = {n: read() for n, (read, _) in counters.items()}
        return prof, tr["trace_calls"], host_s, counts_now

    w0 = time.perf_counter()
    with installed:
        while time.perf_counter() - w0 < seconds:
            call_s.append(step())
        sync(device)
        window_s = time.perf_counter() - w0
        window_spans = {name: len(s.events) for name, s in spans.items()}
        # a traced run profiles a stretch of calls after the window; an empty
        # session (CUPTI now and then hands one back) is tried again
        reduced = None
        for _ in range(CUPTI_TRIES if traced else 0):
            prof, n_prof, window_traced, counts_read = profile_stretch()
            reduced = trace.reduce_profile(prof, list(spans))
            if reduced is not None:
                break

    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    span_ms = {name: s.ms()[:window_spans[name]] for name, s in spans.items() if s.present}
    del caller, spans
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers, failed = check.run_checks(cell, inputs, kept, reads, seed)
    correct, checks = check.verdict(numbers, cell.limits)
    log(f"check: {time.perf_counter() - t_check:.2f} s, window {window_s:.2f} s, "
        f"set-up {setup_s:.2f} s, {len(call_s)} calls")

    if traced:
        view = readings.Traced(cfg, tr, E, call_s, span_ms, n_prof if reduced else 0,
                               window_traced if reduced else 0.0, reduced,
                               counts_read if reduced else {})
        metrics = {}
        for m in cell.per_layer:
            v = per_layer[m["name"]].read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        view = readings.Window(E, len(call_s), window_s, call_s, setup_s)
        metrics = {m["name"]: {"value": end_to_end[m["name"]].read(view), "unit": m["unit"]}
                   for m in cell.end_to_end}
        metrics = {k: v for k, v in metrics.items() if v["value"] is not None}

    dev = torch.device(device)
    out = {
        "correct": correct,
        "attempted": len(call_s),
        "failed": min(failed, len(call_s)),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name() if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if traced:
        out["device"]["busy_s"] = reduced.busy_s if reduced is not None else 0.0
        out["device"]["window_s"] = window_traced if reduced is not None else 0.0
        if reduced is not None:
            out["breakdown"] = {"device_ops": reduced.device_ops, "idle_gaps": reduced.idle_gaps}
    out["numbers"] = numbers  # every number the checks read, compared or not
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: nothing measured")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
