"""Finding a cell's files by name.

``BENCHMARK.json`` (the checkout's root) names the cells, the
configurations and the metrics; a cell's configuration and traffic files
name the rest.  Everything is found under this folder by those names, so
that a later configuration, traffic mix, entry, check or metric is new
files and new entries only:

* ``configs/<config>.json``: the configuration.  Its ``scene`` names
  ``scenes/<scene>.py`` (the demo and the source point set), its kernel's
  ``family`` names ``kernels/<family>.py`` (the program's kernel object)
  and ``reference/cov_<family>.py`` (the reference's covariance);
* ``traffic/<traffic>.json``: the traffic mix, read by ``generator.py``.
  Its ``targets.family`` names ``targets/<family>.py`` (how each call's
  targets are drawn), its ``entry`` names ``entries/<entry>.py`` (how a
  call drives the program, and the controls and faults of that entry), and
  its ``checks`` name ``checks/<check>.py`` each (the comparisons that
  decide ``correct``);
* ``limits/<cell>.json``: the limit of each number the checks compare;
* ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: the reader
  of each metric (``read(run)`` and ``read(trace)``), which returns None
  where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files and the metrics
    it reports; KeyError where there is no such cell."""
    bench = benchmark() if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(work)})")
    w = work[name]
    limits_path = HERE / "limits" / f"{name}.json"
    return Cell(
        name=name,
        config=load_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        chips=w["chips"],
    )


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under this folder (its name may hold
    dots), loaded once; FileNotFoundError where there is no such file."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind}/{name}.py under {HERE.name}")
    key = f"port_bench.{kind}._{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        loader = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(loader)
        sys.modules[key] = mod
        try:
            loader.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]

