"""Port parity: ``avoidance/flow_field.py`` against the JAX package's,
float64 on the CPU.  The polygon geometry to 1e-12 (the PCA axes up to
their sign), the samplers exactly (the same numpy draws), the flow field
at JAX's fitted state (carried across by ``convert.flow_field_from_tree``)
to 1e-8, and the port's own fit: its LML at least JAX's minus
1e-6·|LML|.  A 24-vertex boundary and 40 interior samples."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.avoidance import flow_field as jff
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu_torch import convert
from gaussian_process_transportation_tpu_torch.avoidance import flow_field as tff
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
FIELD_TOL = dict(rtol=1e-8, atol=1e-8)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _boundary(n=24):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([5.0 + 2.0 * np.cos(th), 1.2 * np.sin(th) + 0.3 * np.sin(2 * th)], 1)


def _points(seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(2, 8, 30), rng.uniform(-2, 2, 30)])


@pytest.fixture(scope="module")
def fitted():
    """JAX's flow field fitted on 40 interior samples, and the port's own
    fit on the same samples."""
    boundary = _boundary()
    inside = jff.sample_in_polygon(boundary, 40, rng=np.random.RandomState(0))
    jfield = jff.ObstacleFlowField(boundary).learn_flow_field(inside)
    tfield = tff.ObstacleFlowField(boundary, device="cpu").learn_flow_field(inside)
    return boundary, inside, jfield, tfield


def test_polygon_geometry_matches_jax():
    b, p = _boundary(), _points()
    np.testing.assert_allclose(tff.signed_distance(_t(b), _t(p)).numpy(),
                               np.asarray(jff.signed_distance(jnp.asarray(b), jnp.asarray(p))),
                               **TOL)
    np.testing.assert_allclose(tff.sdf_gradient(_t(b), _t(p)).numpy(),
                               np.asarray(jff.sdf_gradient(jnp.asarray(b), jnp.asarray(p))),
                               rtol=1e-9, atol=1e-9)  # central differences of step 1e-6
    c = np.array([5.1, 0.1])
    p[0] = [20.0, 20.0]  # a ray that meets no segment stays put
    for got, want in zip(tff.radial_project(_t(b), _t(p), _t(c)),
                         jff.radial_project(jnp.asarray(b), jnp.asarray(p), jnp.asarray(c))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    (c1, V1, d1), (c2, V2, d2) = (tff.estimate_center_pca(_t(b)),
                                  jff.estimate_center_pca(jnp.asarray(b)))
    np.testing.assert_allclose(c1.numpy(), np.asarray(c2), **TOL)
    np.testing.assert_allclose(d1.numpy(), np.asarray(d2), **TOL)
    sign = np.sign((V1.numpy() * np.asarray(V2)).sum(1, keepdims=True))
    np.testing.assert_allclose(V1.numpy() * sign, np.asarray(V2), **TOL)


def test_samplers_and_synthetic_flows_match_jax():
    b = _boundary()
    for name in ("sample_in_polygon", "sample_in_polygon_convex"):
        got = getattr(tff, name)(b, 30, rng=np.random.RandomState(3))
        np.testing.assert_array_equal(got, getattr(jff, name)(b, 30, rng=np.random.RandomState(3)))
    inside = tff.sample_in_polygon(b, 30)
    for name in ("divergent_rotational_flow", "shaped_divergent_flow"):
        np.testing.assert_allclose(getattr(tff, name)(_t(b), _t(inside)).numpy(),
                                   np.asarray(getattr(jff, name)(jnp.asarray(b),
                                                                 jnp.asarray(inside))), **TOL)


def test_flow_field_at_jax_fitted_state_matches_jax(fitted):
    boundary, inside, jfield, _ = fitted
    tfield = convert.flow_field_from_tree(jfield, device="cpu")
    t = np.linspace(0, 1, 50)
    traj = np.stack([10 * t, 0.2 * np.ones_like(t)], 1)
    vel = np.gradient(traj, axis=0)
    for got, want in zip(tfield.transform_space(traj), jfield.transform_space(jnp.asarray(traj))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FIELD_TOL)
    np.testing.assert_allclose(tfield.transform_velocity(traj, vel).numpy(),
                               np.asarray(jfield.transform_velocity(jnp.asarray(traj),
                                                                    jnp.asarray(vel))),
                               **FIELD_TOL)
    np.testing.assert_allclose(tfield.radial_projection(inside).numpy(),
                               np.asarray(jfield.projected_boundary_points), **FIELD_TOL)
    proj = tfield.project_using_sdf(inside[:20])
    np.testing.assert_allclose(proj.numpy(), np.asarray(jfield.project_using_sdf(inside[:20])),
                               **FIELD_TOL)
    assert 0 < tfield.project_iterations <= 100


def test_own_fit_reaches_jax_lml(fitted):
    _, _, jfield, tfield = fitted
    js, ts = jfield.gp.state, tfield.gp.state
    np.testing.assert_array_equal(ts.X.numpy(), np.asarray(js.X))
    np.testing.assert_allclose(ts.Y.numpy(), np.asarray(js.Y), **TOL)
    lml_j = float(jgp.log_marginal_likelihood(js.kernel, js.X, js.Y, js.jitter))
    lml_t = tgp.log_marginal_likelihood(ts.kernel, ts.X, ts.Y, ts.jitter).item()
    assert lml_t >= lml_j - 1e-6 * abs(lml_j), (lml_t, lml_j)
    # the default kernel's lengthscale bounds follow the obstacle's size
    r = float(np.linalg.norm(_boundary() - _boundary().mean(0), axis=1).max())
    ell = ts.kernel.k1.k2
    assert ell.bounds == pytest.approx((r / 4.0, 10.0 * r), rel=1e-12)
