"""The torch port as a package: it never imports JAX, it pins float32
matmuls to full precision, and its resampling matches the JAX package."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_transportation_tpu_torch as port
from gaussian_process_transportation_tpu.utils.resample import resample as jresample

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "gaussian_process_transportation_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "gaussian_process_transportation_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_import_pins_full_float32_matmuls():
    assert port.kernels is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("num_points,planar", [(20, False), (57, False), (33, True)])
def test_resample_matches_jax(num_points, planar):
    rng = np.random.default_rng(num_points)
    curve = np.cumsum(rng.standard_normal((40, 3)), axis=0)
    curve[10] = curve[9]  # a zero-length segment
    want = jresample(jnp.asarray(curve), num_points=num_points, planar_metric=planar)
    got = port.resample(torch.as_tensor(curve), num_points=num_points, planar_metric=planar)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
