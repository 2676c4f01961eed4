"""Structured logging and lightweight profiling.

Port of ``gaussian_process_transportation_tpu/utils/logging_utils.py``: a
namespaced stdlib logger, a recorder that accumulates scalar series
(losses, timings, diagnostics) and dumps them as JSON, a wall-clock timer
for a block, and a ``torch.profiler`` trace of a block written to a
directory as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

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
