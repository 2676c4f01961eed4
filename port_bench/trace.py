"""The traced run's reading: a ``torch.profiler`` session over a stretch of
calls after the window, reduced from its Chrome trace to what the per-layer
metrics read.

* Device activity is every kernel, copy and fill on the card; ``busy_s`` is
  the length of their union.
* A kernel belongs to a span when the host call that launched it (the
  launch event of the same correlation id) lies inside the
  span's ``record_function`` range.
* An idle gap (between two stretches of device activity) is labelled with
  the innermost range the host was in when the gap began.
"""
from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160


@dataclass
class Reduced:
    busy_s: float
    kernels: int  # kernel launches (copies and fills not counted)
    span_device_s: Dict[str, float]  # device seconds of the kernels each span launched
    span_calls: Dict[str, int]  # the span's ranges in the trace
    device_ops: List[list]  # [[name, seconds]], the most time first
    idle_gaps: List[list]  # [[host range, seconds]], the most time first


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events: List[dict], spans: List[str]) -> Reduced:
    """Reduce a Chrome trace's ``traceEvents`` (times in µs)."""
    device, launches, ranges = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", "?"), corr, cat == "kernel"))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat == "user_annotation":
            ranges.append((ts, ts + dur, ev.get("name", "?")))

    merged = _union([(s, e) for s, e, *_ in device])
    busy = sum(e - s for s, e in merged)

    by_name = defaultdict(float)
    for s, e, name, _, _ in device:
        by_name[name[:NAME_CHARS]] += e - s

    span_s = {name: 0.0 for name in spans}
    span_calls = {name: 0 for name in spans}
    for name in spans:
        own = sorted((s, e) for s, e, n in ranges if n == name)
        span_calls[name] = len(own)
        starts = [s for s, _ in own]
        for s, e, _, corr, _ in device:
            t = launches.get(corr)
            if t is None:
                continue
            i = bisect_right(starts, t) - 1
            if i >= 0 and t <= own[i][1]:
                span_s[name] += e - s

    # one host thread: its ranges nest, so the latest-started range that
    # still holds the gap's start is the innermost
    ranges.sort()
    range_starts = [r[0] for r in ranges]
    idle = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        inner = "host"
        for k in range(bisect_right(range_starts, e0) - 1, -1, -1):
            if ranges[k][1] >= e0:
                inner = ranges[k][2]
                break
        idle[inner] += s1 - e0

    top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Reduced(
        busy_s=busy / 1e6,
        kernels=sum(1 for *_, is_kernel in device if is_kernel),
        span_device_s={k: v / 1e6 for k, v in span_s.items()},
        span_calls=span_calls,
        device_ops=top(by_name),
        idle_gaps=top(idle),
    )


def reduce_profile(prof, spans: List[str]) -> Optional[Reduced]:
    """The profiler session's reduction; None where it holds no device
    record (CUPTI now and then hands back an empty session)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    red = reduce_events(events, spans)
    return red if red.busy_s > 0 else None
