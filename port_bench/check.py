"""The comparison that decides ``correct``: the checks a traffic mix names
(``checks/<check>.py``, each ``compare(worst, cell, inputs, kept, reads,
seed, bad)``), run once the window has closed, and the verdict.

``kept`` holds, for each batch of the pool, what the checks need of the
last call on it (the entry's result, and any state the entry captured);
``reads`` the host reads that ended the calls on it.  A check adds its
worst readings to ``worst`` and returns how many calls it found past a
limit (``bad(name, value)``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from . import spec


def finite_max(x: torch.Tensor) -> float:
    """The largest entry; infinite where any is NaN or infinite."""
    if not bool(torch.isfinite(x).all()):
        return math.inf
    return float(x.max()) if x.numel() else 0.0


class Worst:
    """Running worst cases of the compared numbers."""

    def __init__(self):
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float):
        self.values[name] = max(self.values.get(name, 0.0), value)


def run_checks(cell: spec.Cell, inputs, kept: dict, reads: dict, seed: int):
    """(every number read, calls failed) of the cell's checks."""
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    bad: Callable[[str, float], bool] = lambda name, value: name in limits and not value <= limits[name]
    worst = Worst()
    failed = 0
    for name in cell.traffic["checks"]:
        failed += spec.module("checks", name).compare(worst, cell, inputs, kept, reads, seed, bad)
    return worst.values, failed


def verdict(values: Dict[str, float], limits: dict):
    """(correct, checks): each number that the cell's limits name, beside its
    limit; a number the checks did not read, or above its limit, is not
    correct, and so is a cell without limits."""
    checks = {}
    correct = bool(limits)
    for name, lim in limits.items():
        value = values.get(name, math.inf)
        checks[name] = {"value": value, "limit": lim["limit"]}
        if not value <= lim["limit"]:
            correct = False
    return correct, checks
