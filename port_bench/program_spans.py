"""The program's own spans and tallies, for the per-layer metrics that read
them: the port's ``utils.logging_utils`` (``span``, ``spans``,
``collect``).  Unlike ``program.Span``, which wraps a module attribute
from outside, these spans sit inside the program's functions: the
conditioning step, apply's stages, each L-BFGS phase of the ensemble fit.

A reader that reads them calls ``start()`` when it is loaded.  ``run.py``
loads a run's per-layer readers only in a traced run, after the warm-up
and just before the window, so the spans are on from the window's first
call through the profiled stretch after it (where their
``record_function`` ranges label device work and idle gaps), and off in
every untraced run, whose end-to-end metrics are compared.  The first
``reading(t)`` of a run turns them off, collects them once, and keeps the
records of the window's calls: the first ``len(t.call_s)`` entry calls,
each the records under one root span that an entry opens (``ENTRIES``).
Times come from those calls only, as ``readings.span_ms_per_call`` takes
them, never from the profiled stretch, whose host the profiler slows; the
tallies are counts, whole over every fit since ``start()``.

The reading belongs to the run whose ``t`` collected it: another run's
``t`` reads nothing from it.  A second traced run in one process loads no
reader again, so its spans stay off and it reads nothing; one run a
process is how ``run.py`` is driven.  (Turning the spans on and collecting
them are ``run.py``'s to do once a benchmark change moves them there.)

Where the program has no such spans (an older tree), ``start()`` does
nothing and every reading is None."""
from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

from . import program

# the root span of each entry call that a cell times
ENTRIES = ("gpt.transport_batched", "gpt.transport_batched_opt")

_started = False
_reading: Optional["Reading"] = None
_reading_of = None  # the run's Traced that collected _reading


@dataclass
class Reading:
    calls: List[list]  # each window call's span records (the program's SpanRecord)
    tallies: Dict[str, int]  # "<function>.<counter>": what the program tallied


def _logging_utils():
    """The program's ``utils.logging_utils`` where it has spans, else None."""
    try:
        mod = program.module("utils.logging_utils")
    except ImportError:
        return None
    return mod if all(hasattr(mod, a) for a in ("span", "spans", "collect")) else None


def start() -> bool:
    """Turn the program's spans on (once); False where it has none."""
    global _started
    lu = _logging_utils()
    if lu is None:
        return False
    if not _started:
        lu.collect()  # nothing recorded before the window counts
        lu.spans(True)
        _started = True
    return True


def reading(t) -> Optional[Reading]:
    """The window's spans and the run's tallies; collected at this run's
    first call after ``start()``.  None where nothing was recorded for this
    run, or the window holds fewer entry calls than the run made."""
    global _reading, _reading_of, _started
    if _started:
        lu = _logging_utils()
        lu.spans(False)
        _started = False
        got = lu.collect()
        by_call = defaultdict(list)
        for rec in got.records:
            by_call[rec.call].append(rec)
        entries = [recs for _, recs in sorted(by_call.items())
                   if recs[0].parent is None and recs[0].name in ENTRIES]
        _reading, _reading_of = Reading(entries[:len(t.call_s)], got.tallies), t
        _log(got, _reading)
    if _reading is None or _reading_of is not t or not t.call_s \
            or len(_reading.calls) < len(t.call_s):
        return None
    return _reading


def ms_per_call(t, span: str, host: bool = False) -> Optional[float]:
    """The span's milliseconds per window call: by its CUDA events, or with
    ``host`` on the host's clock.  None where it has no record, or no CUDA
    events (work on the CPU)."""
    r = reading(t)
    if r is None:
        return None
    ms = [(rec.host_ms if host else rec.device_ms) for call in r.calls for rec in call
          if rec.name == span]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(r.calls)


def share(t, part: str, whole: str) -> Optional[float]:
    """100 · tally ``part`` / tally ``whole``; None where either is missing or
    the whole is 0."""
    r = reading(t)
    if r is None or not r.tallies.get(whole) or part not in r.tallies:
        return None
    return 100.0 * r.tallies[part] / r.tallies[whole]


def _log(got, r: Reading):
    """Each span's count, host and device ms, and self ms (less its
    children) a window call, to standard error."""
    if not r.calls:
        return
    kept = {rec.call for call in r.calls for rec in call}
    rows = defaultdict(lambda: [0, 0.0, 0.0, 0.0, 0.0])
    for rec, own_h, own_d in zip(got.records, got.self_ms(), got.self_ms(device=True)):
        if rec.call in kept:
            row = rows[rec.name]
            for i, v in enumerate((1, rec.host_ms, rec.device_ms, own_h, own_d)):
                row[i] += v or 0.0
    n = len(r.calls)
    print(f"program spans over {n} window calls (a call: count, host ms, device ms, "
          "self host ms, self device ms):", file=sys.stderr)
    for name, (k, h, d, sh, sd) in rows.items():
        print(f"  {name} {k / n:g} {h / n:.4f} {d / n:.4f} {sh / n:.4f} {sd / n:.4f}",
              file=sys.stderr)
    print(f"program tallies: {r.tallies}", file=sys.stderr, flush=True)
