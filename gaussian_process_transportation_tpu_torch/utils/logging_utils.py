"""Structured logging and lightweight profiling.

Port of ``gaussian_process_transportation_tpu/utils/logging_utils.py``: a
namespaced stdlib logger, a recorder that accumulates scalar series
(losses, timings, diagnostics) and dumps them as JSON, a wall-clock timer
for a block, and a ``torch.profiler`` trace of a block written to a
directory as a Chrome trace.  Beyond the port: the program's own spans
(``span``, ``spans``, ``collect``), off by default, and tallies of device
counts read once at ``collect()``.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import torch

logger = logging.getLogger("gpt_tpu")
if not logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s"))
    logger.addHandler(h)
    logger.setLevel(os.environ.get("GPT_TPU_LOGLEVEL", "WARNING"))


def get_logger(name: str = "gpt_tpu") -> logging.Logger:
    return logging.getLogger(name)


class MetricsRecorder:
    def __init__(self):
        self.series: Dict[str, List] = defaultdict(list)

    def record(self, name: str, value, step: Optional[int] = None) -> None:
        self.series[name].append(
            {"step": step if step is not None else len(self.series[name]), "value": float(value)}
        )

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(self.series), f)

    def last(self, name: str):
        return self.series[name][-1]["value"] if self.series[name] else None


@contextlib.contextmanager
def timed(name: str, recorder: Optional[MetricsRecorder] = None):
    """Wall-clock a block; logs (and optionally records) the duration.

    CUDA launches return before their kernels run, so where CUDA is in use
    (initialised in this process) the block's end waits for the current
    device to finish its work: without that wait an asynchronous block
    would read as the time to launch it.  Work on other devices is not
    waited for."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    logger.info("%s took %.3fs", name, dt)
    if recorder is not None:
        recorder.record(f"time/{name}", dt)


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's where CUDA is available), written to ``logdir`` as a Chrome
    trace (``trace.json``; open it in Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass(slots=True)
class SpanRecord:
    name: str
    call: int  # the entry call it belongs to
    parent: Optional[int]  # index of the enclosing record in the same collection
    start_ns: int  # host clock, time.perf_counter_ns
    end_ns: int
    device_ms: Optional[float] = None  # between its CUDA events; None for work on the CPU

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclass
class Collected:
    records: List[SpanRecord]  # in the order the spans were opened
    tallies: Dict[str, int]  # name: the sum of what was tallied under it

    def self_ms(self, device: bool = False) -> List[Optional[float]]:
        """Each record's time less what its children cover (host, or device
        where ``device`` and the record has events)."""
        def ms(r):
            return r.device_ms if device else r.host_ms
        out = [ms(r) for r in self.records]
        for r in self.records:
            if r.parent is not None and out[r.parent] is not None and ms(r) is not None:
                out[r.parent] -= ms(r)
        return out


_spans_on = False
_OFF = contextlib.nullcontext()
_records: List[SpanRecord] = []
_events: Dict[int, list] = {}  # record index -> [stream, start event, end event]
_open: List[int] = []  # indices of the spans open now, innermost last
_next_call = 0
_tallies: List[tuple] = []  # (name, int or integer tensor)


class _Span:
    __slots__ = ("name", "device", "index", "range")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        global _next_call
        parent = _open[-1] if _open else None
        if parent is None:
            call, _next_call = _next_call, _next_call + 1
        else:
            call = _records[parent].call
        self.index = len(_records)
        _open.append(self.index)
        # a range records only under a profiler, and costs ~10 µs a span without one
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        dev = self.device
        if dev is not None and dev.type == "cuda":
            stream, start = torch.cuda.current_stream(dev), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            _events[self.index] = [stream, start, None]
        _records.append(SpanRecord(self.name, call, parent, time.perf_counter_ns(), 0))
        return self

    def __exit__(self, *exc):
        _records[self.index].end_ns = time.perf_counter_ns()
        ev = _events.get(self.index)
        if ev is not None:
            ev[2] = torch.cuda.Event(enable_timing=True)
            ev[2].record(ev[0])
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.pop()
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A span named ``name`` around a block of work on ``device`` (a
    ``torch.device``; CUDA events only for a CUDA device, the host's clock
    alone where ``device`` is None); a shared no-op context while spans are
    off."""
    if not _spans_on:
        return _OFF
    return _Span(name, device)


def spans(on: bool) -> bool:
    """Turn the spans on or off; returns whether they were on."""
    global _spans_on
    was, _spans_on = _spans_on, bool(on)
    return was


def spans_on() -> bool:
    return _spans_on


def tally(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` (an int, or an integer tensor whose sum counts) to the
    tally ``name`` that ``collect()`` returns: device tallies are read on
    the host once, not inside the work.  A tensor is held until then, so
    tally a reduced one."""
    _tallies.append((name, value))


def collect() -> Collected:
    """The spans recorded and the tallies kept since the last collection;
    clears both.  Call it between entry calls, with no span open."""
    for dev in {ev[0].device for ev in _events.values()}:
        torch.cuda.synchronize(dev)
    records = list(_records)
    for i, (_, start, end) in _events.items():
        records[i].device_ms = start.elapsed_time(end)
    added: Dict[str, int] = defaultdict(int)
    for name, value in _tallies:
        added[name] += int(value.sum().item()) if isinstance(value, torch.Tensor) else int(value)
    _records.clear()
    _events.clear()
    _open.clear()
    _tallies.clear()
    return Collected(records, dict(added))
