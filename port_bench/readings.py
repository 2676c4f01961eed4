"""What the metric readers read: one run's window (``Window``, for the
end-to-end metrics) and one traced run (``Traced``, for the per-layer
metrics), with the arithmetic that several readers share.  Every reader
returns None where it finds nothing to read; the harness then leaves its
metric out."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Window:
    members: int  # members a call transports
    calls: int  # calls completed in the window
    window_s: float
    call_s: List[float]  # each call's start to the host holding its min|det J_Φ|
    setup_s: float


@dataclass
class Traced:
    config: dict
    traffic: dict
    members: int
    call_s: List[float]  # every call of the traced run
    span_ms: Dict[str, List[float]]  # every call of each span in the run (CUDA events)
    profiled_calls: int  # calls under the profiler
    window_s: float  # the profiled stretch, host clock
    reduced: Optional[object] = None  # trace.Reduced of the profiled stretch
    counters: Dict[str, int] = field(default_factory=dict)  # over the profiled calls


def members_per_s(w: Window) -> Optional[float]:
    return w.members * w.calls / w.window_s if w.calls else None


def p95_ms(call_s: List[float]) -> Optional[float]:
    return float(np.percentile(np.asarray(call_s) * 1e3, 95)) if call_s else None


def span_ms_per_call(t: Traced, span: str) -> Optional[float]:
    """The span's milliseconds per entry call, by its CUDA events."""
    ms = t.span_ms.get(span)
    if not ms or not t.call_s:
        return None
    return sum(ms) / len(t.call_s)


def span_device_s_per_call(t: Traced, span: str) -> Optional[float]:
    """Device seconds of the kernels the span launched, per profiled call."""
    if t.reduced is None or not t.profiled_calls or not t.reduced.span_calls.get(span):
        return None
    s = t.reduced.span_device_s.get(span, 0.0)
    return s / t.profiled_calls if s > 0 else None


def roofline(t: Traced, span: str, least_s_per_call: float) -> Optional[float]:
    """Share (%) of the least time over the span's device time."""
    dev = span_device_s_per_call(t, span)
    return None if dev is None else 100.0 * least_s_per_call / dev


def idle_share(t: Traced) -> Optional[float]:
    if t.reduced is None or t.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.reduced.busy_s / t.window_s)


def launches_per_call(t: Traced) -> Optional[float]:
    if t.reduced is None or not t.profiled_calls:
        return None
    return t.reduced.kernels / t.profiled_calls


def counter_per_call(t: Traced, name: str) -> Optional[float]:
    if name not in t.counters or not t.profiled_calls:
        return None
    return t.counters[name] / t.profiled_calls


def shape(t: Traced):
    """(E, n, Q, D, P) of the cell."""
    c = t.config
    return t.members, c["dist_points"], c["demo_points"], c["dims"], c["dims"]

