"""Port parity: ``viz.py`` against the JAX package's, float64 on the CPU,
at the same conditioned GP (carried across by ``convert``): the vector
field and the variance-descent field to 1e-12, the rollouts of the GP
dynamical system (plain, modulated, stabilized) to 1e-10 of max|x|; the
plot helpers draw, and do nothing where matplotlib is missing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu import viz as jviz
from gaussian_process_transportation_tpu.avoidance import modulation as jmod
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu_torch import convert
from gaussian_process_transportation_tpu_torch import viz as tviz
from gaussian_process_transportation_tpu_torch.avoidance import modulation as tmod

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _gps(D, n=60, seed=17, cache_k_inv=False):
    """The GP of ẋ = −0.1x + 0.05 sin(x) on n points, conditioned by JAX
    and carried into the port."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-4, 4, (n, D))
    dX = -0.1 * X + 0.05 * np.sin(X)
    k = JK.Constant(1.0) * JK.RBF(3.0 * jnp.ones(D)) + JK.White(1e-4)
    jgp_ = jgp.condition(k, jnp.asarray(X), jnp.asarray(dX), cache_k_inv=cache_k_inv)
    state = {key: getattr(jgp_, key) for key in ("X", "Y", "alpha", "L", "K_inv")}
    tgp_ = convert.exact_gp_from_numpy(state, convert.kernel_from_tree(k, device="cpu"),
                                       device="cpu")
    return jgp_, tgp_


def _rollout_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("cache_k_inv", [False, True])
def test_vector_field_matches_jax(cache_k_inv):
    jg, tg = _gps(2, cache_k_inv=cache_k_inv)
    xs, ys = np.linspace(-3, 3, 10), np.linspace(-3, 3, 12)
    got = tviz.vector_field(tg, xs, ys)
    want = jax.jit(jviz.vector_field)(jg, jnp.asarray(xs), jnp.asarray(ys))
    assert got[0].shape == (12, 10) and got[2].shape == (12, 10, 2)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the variance prior − k K⁻¹ kᵀ cancels: its rounding scales with the
    # unsigned sum Σ|k_i K⁻¹_ij k_j| (~1e4 here at noise 1e-4), whatever the
    # order of the sums, so the variances are held to 1e-12 of that
    gx, gy = np.meshgrid(xs, ys)
    k = np.asarray(jg.kernel(jnp.asarray(np.column_stack([gx.ravel(), gy.ravel()])), jg.X))
    K_inv = np.linalg.inv(np.asarray(jg.kernel(jg.X)) + 1e-10 * np.eye(len(jg.X)))
    scale = 1.0 + (np.abs(k) @ np.abs(K_inv) * np.abs(k)).sum(1).reshape(gx.shape)
    err = np.abs(got[2].numpy() ** 2 - np.asarray(want[2]) ** 2)[..., 0]
    assert (err <= 1e-12 * scale).all(), (err / scale).max()


def test_rollouts_match_jax():
    jg, tg = _gps(2)
    x0 = np.array([[4.0, -4.0], [-3.0, 2.5], [0.5, 3.9], [-1.0, -1.0]])
    _rollout_close(tviz.rollout_gp_ds(tg, torch.as_tensor(x0), 50),
                   jax.jit(jviz.rollout_gp_ds, static_argnums=2)(jg, jnp.asarray(x0), 50))
    c = np.array([1.5, 1.0])
    got = tviz.rollout_gp_ds(tg, torch.as_tensor(x0), 30, dt=0.5, modulation_fn=lambda x: (
        tmod.modulation_matrix_spherical(x, torch.as_tensor(c), 0.8)))
    want = jax.jit(lambda g, x0_: jviz.rollout_gp_ds(g, x0_, 30, dt=0.5, modulation_fn=lambda x: (
        jmod.modulation_matrix_spherical(x, jnp.asarray(c), 0.8))))(jg, jnp.asarray(x0))
    _rollout_close(got, want)


def test_stable_rollout_and_attractor_field_match_jax():
    jg, tg = _gps(3, n=50, seed=3)
    x0 = np.array([[6.0, -6.0, 6.0], [-2.0, 1.0, 0.5]])
    _rollout_close(tviz.rollout_stable_gp_ds(tg, torch.as_tensor(x0), 30),
                   jax.jit(jviz.rollout_stable_gp_ds, static_argnums=2)(jg, jnp.asarray(x0), 30))
    q = np.random.RandomState(5).uniform(-8, 8, (16, 3))
    np.testing.assert_allclose(tviz.min_variance_attractor_field(tg, q, step=0.5).numpy(),
                               np.asarray(jax.jit(jviz.min_variance_attractor_field)(
                                   jg, jnp.asarray(q), step=0.5)), **TOL)


def test_plot_helpers_draw_and_do_nothing_without_matplotlib(monkeypatch):
    import matplotlib.pyplot as plt

    _, tg2 = _gps(2)
    _, tg3 = _gps(3, n=50, seed=3)
    g = np.linspace(-4, 4, 5)
    gx, gy = np.meshgrid(g, g)
    surface = np.stack([gx, gy, 0.1 * gx * gy], -1)
    try:
        ax = tviz.plot_traj_evolution(tg3, g, g, g, demo=tg3.X, surface=surface, n_steps=5,
                                      generator=torch.Generator().manual_seed(1))
        assert ax is not None and ax.name == "3d"
        ax2 = tviz.plot_vector_field(tg2, g, g, demo=tg2.X)
        t = np.linspace(0, 1, 20)
        assert tviz.draw_error_band(ax2, t, np.sin(t), 0.1 * np.ones((20, 2)), alpha=0.3) is ax2
    finally:
        plt.close("all")
    monkeypatch.setattr(tviz, "_plt", lambda: None)
    assert tviz.plot_traj_evolution(tg3, g, g, g) is None
    assert tviz.plot_traj_3D(np.zeros((3, 3))) is None
    assert tviz.plot_vector_field(tg2, g, g) is None
    assert tviz.draw_error_band(object(), g, g, g) is None
