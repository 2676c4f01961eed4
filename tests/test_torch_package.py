"""The torch port as a package: it never imports JAX, it pins float32
matmuls to full precision, and its resampling matches the JAX package."""
import ast
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_transportation_tpu_torch as port
from gaussian_process_transportation_tpu.utils.resample import resample as jresample

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

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


# ---- the public surface against the JAX package's -------------------------

# Names the JAX package exports that the port does not have: none is left.
NOT_PORTED = {
    "": set(),
    "avoidance": set(),
    "benchmarks": set(),
    "models": set(),
    "ops": set(),
    "parallel": set(),
    "transport": set(),
    "utils": set(),
}
EXTRA = {"": {"gpt"}}  # the port's own: the functional transport module at the top


@pytest.mark.parametrize("sub", sorted(NOT_PORTED))
def test_public_names_are_the_jax_packages(sub):
    """Each subpackage's ``__all__`` is JAX's minus the names not ported yet
    (plus the port's listed extras), in JAX's order, and every name
    resolves."""
    import importlib

    jmod = importlib.import_module("gaussian_process_transportation_tpu"
                                   + (f".{sub}" if sub else ""))
    tmod = importlib.import_module(port.__name__ + (f".{sub}" if sub else ""))
    want = [n for n in jmod.__all__ if n not in NOT_PORTED[sub]]
    got = [n for n in tmod.__all__ if n not in EXTRA.get(sub, set())]
    assert got == want
    assert NOT_PORTED[sub] <= set(jmod.__all__)
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None


def test_top_level_exports_the_gp_and_the_affine_transform():
    from gaussian_process_transportation_tpu_torch.models.affine import AffineTransform
    from gaussian_process_transportation_tpu_torch.models.gp_regressor import GaussianProcess

    assert port.GaussianProcess is GaussianProcess and port.AffineTransform is AffineTransform


@pytest.mark.parametrize("do_scale", [False, True])
def test_affine_transform_matches_jax(do_scale):
    """The stateful interface over the same numpy points: rotation, scale,
    translation, predict and derivative to float64 rounding; numpy input
    goes to the requested device, tensors stay where they are."""
    from gaussian_process_transportation_tpu.models.affine import AffineTransform as JAffine

    rng = np.random.default_rng(3)
    src = rng.standard_normal((9, 2))
    R = np.array([[np.cos(0.7), -np.sin(0.7)], [np.sin(0.7), np.cos(0.7)]])
    tgt = 1.5 * src @ R.T + 0.3 + 0.01 * rng.standard_normal((9, 2))
    x = rng.standard_normal((5, 2))
    ja = JAffine(do_scale=do_scale).fit(src, tgt)
    ta = port.AffineTransform(do_scale=do_scale, device="cpu").fit(src, tgt)
    for got, want in ((ta.rotation_matrix, ja.rotation_matrix), (ta.scale, ja.scale),
                      (ta.translation, ja.translation), (ta.predict(x), ja.predict(x)),
                      (ta.derivative(x), ja.derivative(x))):
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert ta.predict(torch.as_tensor(x)).dtype == torch.float64
    with pytest.raises(ValueError, match="points"):
        ta.fit(src, tgt[:4])


def test_cholesky_with_jitter_and_the_rbf_aliases_match_jax():
    """cholesky_with_jitter adds the jitter and gives NaN, not an error, for
    a matrix that is not positive definite (as XLA's factor); the rbf_*
    aliases are the stationary functions of the RBF; rbf_family_params
    takes C·RBF(+White) only."""
    from gaussian_process_transportation_tpu import kernels as JK
    from gaussian_process_transportation_tpu.models.exact_gp import rbf_family_params as jrfp
    from gaussian_process_transportation_tpu.ops.linalg import cholesky_with_jitter as jchol
    from gaussian_process_transportation_tpu_torch import kernels as TK
    from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
    from gaussian_process_transportation_tpu_torch.models.exact_gp import rbf_family_params
    from gaussian_process_transportation_tpu_torch.ops import blocked_chol, linalg, pallas_gram

    rng = np.random.default_rng(4)
    A = rng.standard_normal((6, 6))
    K = A @ A.T
    np.testing.assert_allclose(linalg.cholesky_with_jitter(torch.as_tensor(K), 0.5).numpy(),
                               np.asarray(jchol(jnp.asarray(K), 0.5)), rtol=1e-12, atol=1e-12)
    assert torch.isnan(linalg.cholesky_with_jitter(-torch.eye(3, dtype=torch.float64))).all()
    X = torch.as_tensor(rng.standard_normal((40, 2)))
    ls = torch.tensor([0.7, 1.2], dtype=torch.float64)
    torch.testing.assert_close(pallas_gram.rbf_gram(X, X[:7], ls, 2.0),
                               pallas_gram.stationary_gram(X, X[:7], ls, 2.0, "rbf"))
    panels, n = blocked_chol.rbf_gram_panels(X, ls, 2.0, 0.1, 128)
    want, _ = blocked_chol.stationary_gram_panels(X, ls, 2.0, 0.1, 128, "rbf")
    assert n == 40 and all(torch.equal(a, b) for a, b in zip(panels, want))
    for jk in (JK.Constant(2.0) * JK.RBF(jnp.asarray([0.7, 1.2])) + JK.White(0.1),
               JK.RBF(0.5), JK.Constant(2.0) * JK.Matern(1.0, nu=1.5),
               JK.Constant(2.0) * JK.Matern(1.0, nu=math.inf)):
        got, want = rbf_family_params(kernel_from_tree(jk, device="cpu")), jrfp(jk)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(float(got[0]), float(want[0]))
            np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]))
    assert rbf_family_params(TK.RBF(1.0) + TK.RBF(2.0)) is None


# ---- quirks of the JAX package the port does not copy ---------------------


def _ranked_metrics():
    rng = np.random.RandomState(0)
    return {"Frechet Distance": {"GPT": np.abs(rng.randn(30)) * 0.1,
                                 "DMP": np.concatenate([np.abs(rng.randn(29)) * 5 + 1, [np.nan]]),
                                 "HMM": np.abs(rng.randn(30)) * 2 + 0.5}}


def test_ranked_boxplot_leaves_the_matplotlib_backend_alone(tmp_path):
    """The JAX package's ``ranked_boxplot`` switches the whole process to
    Agg; the port's draws on a ``Figure`` and leaves the backend, and
    pyplot's figures, as they were."""
    import matplotlib
    import matplotlib.pyplot as plt

    from gaussian_process_transportation_tpu_torch.benchmarks.statistics import ranked_boxplot

    before, figures = matplotlib.get_backend(), plt.get_fignums()
    fig, axes = ranked_boxplot(_ranked_metrics(), out_path=str(tmp_path / "box.png"))
    assert matplotlib.get_backend() == before and plt.get_fignums() == figures
    assert (tmp_path / "box.png").stat().st_size > 0
    assert [t.get_text() for t in axes[0].get_xticklabels()][0] == "GPT"


def test_nan_samples_never_reach_mann_whitney(monkeypatch):
    from gaussian_process_transportation_tpu_torch.benchmarks import statistics

    seen = []
    real = statistics.stats.mannwhitneyu

    def checked(x, y, **kw):
        seen.append(np.isnan(x).any() or np.isnan(y).any())
        return real(x, y, **kw)

    monkeypatch.setattr(statistics.stats, "mannwhitneyu", checked)
    statistics.ranking_report(_ranked_metrics())
    statistics.ranked_boxplot(_ranked_metrics())
    assert len(seen) == 12 and not any(seen)
