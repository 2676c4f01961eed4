"""The run refuses to measure without a card; nothing the benchmark runs
loads JAX or the JAX package; the reference loads nothing of the port."""
import ast
import json
import os
import shutil
import subprocess
import sys

from port_bench import spec

ROOT = spec.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "gaussian_process_transportation_tpu"}
COMMAND = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
ARGS = ["--workload", "floor2d-ensemble", "--seed", "1", "--seconds", "1", "--trace", "0"]


def python(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600, env=env)


def cpu_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_refuses_without_a_card():
    proc = subprocess.run([sys.executable, *COMMAND[1:], *ARGS], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, env=cpu_env())
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, *COMMAND[1:], *ARGS], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600, env=cpu_env())
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = """
import sys
from port_bench import calibrate, controls, faults, run, spec
from port_bench.reference import fit, transport
for name in ("floor2d-ensemble", "floor2d-refit"):
    run.run_cell(spec.cell(name), 3, 0.1, False, "cpu", members=8, pool=1)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""
    proc = python(code)
    assert proc.returncode == 0, proc.stderr
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN
    assert "gaussian_process_transportation_tpu_torch" in tops  # the whole name passes


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from port_bench import run

    monkeypatch.setitem(sys.modules, "gaussian_process_transportation_tpu_torch_x", sys)
    assert "gaussian_process_transportation_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "port_bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN | {"gaussian_process_transportation_tpu_torch",
                                               "port_bench"}, (path.name, name)
    proc = python("import sys; import port_bench.reference.transport, port_bench.reference.fit,"
                  " port_bench.reference.cov_rbf;"
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert proc.returncode == 0, proc.stderr
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "gaussian_process_transportation_tpu_torch" not in tops and not tops & FORBIDDEN
