"""Port parity: ``models/exact_gp.py::fit_jit`` (the restarts of one dataset
as lanes of optax's L-BFGS and zoom line search, ``models/_lbfgs.py``) and
``GaussianProcess(jit_fit=True)`` against the JAX package's ``fit_jit``
(optax's L-BFGS under ``vmap``), float64 on the CPU: θ after the first
iterations and the fitted LML."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu_torch import kernels as TK
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp
from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)


def _problem(n=20, seed=0):
    """A well-posed n-point fit: a smooth field on [−3, 3]² with 5% noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, (n, 2))
    Y = np.sin(X[:, :1]) * np.cos(X[:, 1:2]) + 0.05 * rng.standard_normal((n, 2))
    return X, Y


def _jax_kernel():
    return JK.Constant(1.0) * JK.RBF(jnp.ones(2)) + JK.White(0.1)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _lml(kernel, X, Y):
    return tgp.log_marginal_likelihood(kernel, _t(X), _t(Y), 1e-10).item()


@pytest.fixture(scope="module")
def jax_lml():
    """The LML of JAX's fit_jit on the problem, from the kernel's own θ alone
    (its default maxiter, 100).  One call: JAX compiles its optax loop for
    35–50 s a call on the CPU, whatever maxiter.  On this well-posed problem
    JAX's fit with three restarts reaches the same optimum (−5.916043910640738
    against −5.916043910640681), so this one reading is the reference of the
    runs with restarts too."""
    X, Y = _problem()
    gp = jgp.fit_jit(_jax_kernel(), jnp.asarray(X), jnp.asarray(Y), n_restarts=0)
    return float(jgp.log_marginal_likelihood(gp.kernel, jnp.asarray(X), jnp.asarray(Y), 1e-10))


JIT_EARLY = 6


@pytest.fixture(scope="module")
def jax_theta_early():
    """θ of JAX's fit_jit from the kernel's own θ alone after JIT_EARLY
    iterations (another compile of its loop, ~55 s on the CPU)."""
    X, Y = _problem()
    gp = jgp.fit_jit(_jax_kernel(), jnp.asarray(X), jnp.asarray(Y), n_restarts=0,
                     maxiter=JIT_EARLY)
    return np.asarray(gp.kernel.theta)


def _autograd_lanes(monkeypatch):
    """fit_jit's autograd lanes for a kernel of the fused family: the layout
    lookup that selects the fused route reads None."""
    monkeypatch.setattr(tgp, "small_lml_theta_layout", lambda kernel: None)


@pytest.mark.parametrize("route", ["fused_twin", "autograd"])
def test_fit_jit_without_restarts_matches_jax(jax_lml, route, monkeypatch):
    """From the kernel's own θ alone, both routes end within 1e-6·|LML| of
    JAX's optimum."""
    X, Y = _problem()
    kern = kernel_from_tree(_jax_kernel(), device="cpu")
    if route == "autograd":
        _autograd_lanes(monkeypatch)
    gp = tgp.fit_jit(kern, _t(X), _t(Y), n_restarts=0)
    got = _lml(gp.kernel, X, Y)
    assert abs(got - jax_lml) <= 1e-6 * abs(jax_lml), (got, jax_lml)


@pytest.mark.parametrize("route", ["fused_twin", "autograd"])
def test_fit_jit_takes_jaxs_first_steps(jax_theta_early, route, monkeypatch):
    """After JIT_EARLY iterations both routes' θ is JAX's within 1e-8 in each
    log hyperparameter: the same algorithm in float64, where the LMLs agree
    to ~1e-14 (1.3e-14 and 2.1e-14 read on the CPU)."""
    X, Y = _problem()
    if route == "autograd":
        _autograd_lanes(monkeypatch)
    gp = tgp.fit_jit(kernel_from_tree(_jax_kernel(), device="cpu"), _t(X), _t(Y), n_restarts=0,
                     maxiter=JIT_EARLY)
    np.testing.assert_allclose(gp.kernel.theta.numpy(), jax_theta_early, rtol=0, atol=1e-8)


def test_fit_jit_with_restarts_reaches_jax(jax_lml):
    """With restarts (drawn from another generator than JAX's), the best lane
    is at least JAX's optimum less 1e-4·|LML|, and at least the start's."""
    X, Y = _problem()
    tk = kernel_from_tree(_jax_kernel(), device="cpu")
    gp = tgp.fit_jit(tk, _t(X), _t(Y), n_restarts=3, generator=torch.Generator().manual_seed(1))
    got = _lml(gp.kernel, X, Y)
    assert got >= jax_lml - 1e-4 * abs(jax_lml), (got, jax_lml)
    assert got >= _lml(tk, X, Y)


def test_fused_route_equals_autograd_route(monkeypatch):
    """On the CPU the fused route (kernel #2's plain twin, in X's dtype) and
    the autograd lanes (torch.func.vmap of the LML's gradient) give the same
    values and gradients at the same lanes to 1e-8, and the same fit."""
    X, Y = _problem(seed=2)
    tk = kernel_from_tree(JK.Matern(jnp.ones(2), nu=2.5) * JK.Constant(0.5) + JK.White(0.05),
                          device="cpu")
    family, n_ls, has_noise, perm = tgp.small_lml_theta_layout(tk)
    lanes = _t(np.random.default_rng(3).uniform(-1.0, 1.0, (5, tk.n_theta)))  # kernel.theta order
    val_f, grad_f = tfl.small_lml_value_grad(_t(X), _t(Y), lanes[:, perm].T.contiguous(), family,
                                             n_ls, has_noise, 1e-10)
    for e in range(lanes.shape[0]):
        th = lanes[e].clone().requires_grad_(True)
        v = tgp.log_marginal_likelihood(tk.with_theta(th), _t(X), _t(Y), 1e-10)
        v.backward()
        assert abs(v.item() - val_f[e].item()) <= 1e-8 * abs(v.item())
        torch.testing.assert_close(grad_f[:, e], th.grad[perm], rtol=1e-8, atol=1e-10)
    fused = tgp.fit_jit(tk, _t(X), _t(Y), n_restarts=2, maxiter=40)
    _autograd_lanes(monkeypatch)
    autograd = tgp.fit_jit(tk, _t(X), _t(Y), n_restarts=2, maxiter=40)
    lml = [_lml(gp.kernel, X, Y) for gp in (fused, autograd)]
    assert abs(lml[0] - lml[1]) <= 1e-8 * abs(lml[1]), lml


def test_fit_jit_outside_the_fused_family_takes_the_autograd_lanes(monkeypatch):
    """A kernel that is not C·stationary(+White) (a sum of two RBFs), or a
    dataset past the fused kernel's n, never calls kernel #2 or its twin,
    and still ends above its start."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused route was taken")

    monkeypatch.setattr(tfl, "small_lml_value_grad", refuse)
    X, Y = _problem(n=12, seed=4)
    tk = TK.RBF(1.0) + TK.Constant(0.5) * TK.RBF(2.0) + TK.White(0.1)
    gp = tgp.fit_jit(tk, _t(X), _t(Y), n_restarts=1, maxiter=30)
    assert _lml(gp.kernel, X, Y) >= _lml(tk, X, Y)
    X, Y = _problem(n=tfl.MAX_N + 1, seed=4)
    tk = kernel_from_tree(_jax_kernel(), device="cpu")
    gp = tgp.fit_jit(tk, _t(X), _t(Y), n_restarts=0, maxiter=10)
    assert _lml(gp.kernel, X, Y) >= _lml(tk, X, Y)


def test_fit_jit_drops_nan_rows_and_conditions_a_kernel_without_theta():
    """Rows with NaN targets are dropped, as JAX's fit_jit does; a kernel
    without hyperparameters is conditioned directly."""
    X, Y = _problem(n=10, seed=5)
    Yn = Y.copy()
    Yn[3, 1] = np.nan
    tk = kernel_from_tree(_jax_kernel(), device="cpu")
    gp = tgp.fit_jit(tk, _t(X), _t(Yn), n_restarts=0, maxiter=5)
    assert gp.X.shape == (9, 2) and torch.isfinite(gp.alpha).all()
    want = tgp.fit_jit(tk, _t(np.delete(X, 3, 0)), _t(np.delete(Y, 3, 0)), n_restarts=0, maxiter=5)
    torch.testing.assert_close(gp.alpha, want.alpha, rtol=0, atol=0)
    empty = tgp.fit_jit(_EmptyTheta(), _t(X), _t(Y))
    torch.testing.assert_close(empty.alpha, tgp.condition(_EmptyTheta(), _t(X), _t(Y)).alpha)


class _EmptyTheta(TK.RBF):
    """An RBF with no free hyperparameter (θ of size 0)."""

    def _leaves(self):
        return []


def test_fit_jit_conditions_the_next_lane_where_a_gram_does_not_factor(monkeypatch):
    """Where condition() refuses the best lane's Gram (a float32 fit at its
    noise floor), fit_jit conditions the next best lane."""
    X, Y = _problem(n=12, seed=6)
    tk = kernel_from_tree(_jax_kernel(), device="cpu")
    want = tgp.fit_jit(tk, _t(X), _t(Y), n_restarts=2, maxiter=10)
    real, seen = tgp.condition, []

    def refuse_first(kernel, *args, **kwargs):
        seen.append(kernel.theta)
        if len(seen) == 1:
            raise torch.linalg.LinAlgError("not positive definite")
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(tgp, "condition", refuse_first)
    got = tgp.fit_jit(tk, _t(X), _t(Y), n_restarts=2, maxiter=10)
    assert len(seen) == 2 and torch.equal(seen[0], want.kernel.theta)
    assert not torch.equal(got.kernel.theta, want.kernel.theta)
    assert _lml(got.kernel, X, Y) <= _lml(want.kernel, X, Y)


def test_lml_of_a_gram_that_is_not_definite_is_nan_past_64_points():
    """Past the analytic small-N form the LML takes cholesky_ex: a Gram that
    is not positive definite gives NaN, which a fit's lanes read as 1e25."""
    X = np.linspace(0, 1, 70)[:, None]
    bad = TK.Constant(1.0) * TK.RBF(1.0) + TK.White(-0.5)
    val = tgp.log_marginal_likelihood(bad, _t(X), _t(np.sin(X)), 1e-10)
    assert torch.isnan(val)
