"""Each cell's files, and each metric's reader, are found by name, and so is
every module that a configuration or a traffic mix names."""
import pytest

from port_bench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found(cell):
    c = spec.cell(cell, BENCH)
    assert callable(spec.module("scenes", c.config["scene"]).make)
    family = c.config["kernel"]["family"]
    assert callable(spec.module("kernels", family).make)
    assert callable(spec.module("reference", "cov_" + family).k)
    assert callable(spec.module("targets", c.traffic["targets"]["family"]).draw)
    entry = spec.module("entries", c.traffic["entry"])
    assert callable(entry.prepare) and entry.CONTROLS and entry.FAULTS
    assert c.traffic["checks"]
    for name in c.traffic["checks"]:
        assert callable(spec.module("checks", name).compare)
    assert c.limits, f"limits/{cell}.json holds no limit"
    for name, lim in c.limits.items():
        assert lim["limit"] > 0 and lim["lower"] < lim["limit"] < lim["upper"], name


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]])
def test_end_to_end_reader_found(metric):
    assert callable(spec.module("end_to_end", metric).read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_reader_found(metric):
    r = spec.module("layer_metrics", metric)
    assert callable(r.read)
    for name in getattr(r, "SPANS", []) + getattr(r, "COUNTERS", []):
        assert name.count(".") >= 2, name  # "<module path>.<attribute>"


def test_no_reader_without_its_metric():
    named = {m["name"] for m in BENCH["per_layer"]} | {m["name"] for m in BENCH["end_to_end"]}
    for kind in ("layer_metrics", "end_to_end"):
        for path in (spec.HERE / kind).glob("*.py"):
            assert path.stem in named, path


def test_a_module_is_loaded_once():
    assert spec.module("checks", "transport") is spec.module("checks", "transport")


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell", BENCH)
    with pytest.raises(FileNotFoundError):
        spec.module("entries", "no_such_entry")
