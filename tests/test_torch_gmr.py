"""Port parity: ``models/gmr.py`` against the JAX package's, float64 on the
CPU to 1e-8: the EM fit and its log-likelihood trace from JAX's own
initial means (recomputed with ``jax.random`` as JAX's ``fit_gmm`` draws
them), the conditioning, the GMR mean, variance and Jacobian."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.models import gmr as jg
from gaussian_process_transportation_tpu_torch.convert import (
    conditional_from_numpy, gmm_params_from_numpy,
)
from gaussian_process_transportation_tpu_torch.models import gmr as tg

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)
K, N_ITER = 4, 12


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def problem():
    """A curve-like source mapped onto a bent target (a rank-deficient
    joint set, as the transport's), JAX's GMR fitted to it."""
    t = np.linspace(0, 1, 50)
    X = np.stack([10 * t, np.sin(3 * t)], 1)
    Y = X + np.stack([0.3 * t, np.cos(2 * t)], 1)
    model = jg.GMR(n_components=K, n_iter=N_ITER, seed=2).fit(X, Y)
    return dict(X=X, Y=Y, z=np.concatenate([X, Y], 1), model=model, xq=X[::7] + 0.1)


def test_em_from_jax_draws_is_jaxs_fit(problem):
    z = problem["z"]
    idx = jax.random.choice(jax.random.PRNGKey(2), z.shape[0], shape=(K,), replace=False)
    params0, reg = tg.init_gmm(_t(z), torch.as_tensor(np.array(idx)))
    got, trace = tg.run_em(_t(z), params0, N_ITER, reg)
    want = problem["model"]
    _close(trace, want.ll_trace)
    for name in ("log_weights", "means", "covs"):
        _close(getattr(got, name), getattr(want.params, name))


def test_conditioning_predict_and_derivative_match_jax(problem):
    """From JAX's fitted GMM: the conditional factors; from JAX's
    conditional: the mean, variance and analytic Jacobian."""
    want = problem["model"]
    cond = tg.condition_on_x(gmm_params_from_numpy(want.params, device="cpu"), 2)
    for name in ("log_weights", "mean_x", "mean_y", "chol_xx", "gain", "cond_cov"):
        _close(getattr(cond, name), getattr(want.conditional, name))
    cp = conditional_from_numpy(want.conditional, device="cpu")
    xq = problem["xq"]
    for g, w in zip(tg.gmr_predict(cp, _t(xq)), jg.gmr_predict(want.conditional, jnp.asarray(xq))):
        _close(g, w)
    _close(tg.gmr_derivative(cp, _t(xq)), jg.gmr_derivative(want.conditional, jnp.asarray(xq)))


def test_wrapper_matches_jax_and_samples_its_mixture(problem):
    """predict (std = √var) and derivative from JAX's state; samples have
    JAX's shape and, drawn from a one-component fit, follow its Gaussian."""
    want, xq = problem["model"], problem["xq"]
    got = tg.GMR(n_components=K, n_iter=N_ITER, device="cpu")
    got.dx = 2
    got.conditional = conditional_from_numpy(want.conditional, device="cpu")
    for g, w in zip(got.predict(xq, return_std=True), want.predict(xq, return_std=True)):
        _close(g, w)
    _close(got.derivative(xq), want.derivative(xq))
    draws = got.samples(xq, n_samples=6)
    assert draws.shape == want.samples(xq, n_samples=6).shape and torch.isfinite(draws).all()
    torch.testing.assert_close(draws, got.samples(xq, n_samples=6))  # seeded
    one = tg.GMR(n_components=1, n_iter=3, device="cpu").fit(problem["X"], problem["Y"])
    mean, std = one.predict(xq[:1], return_std=True)
    many = one.samples(xq[:1], n_samples=4000)
    assert torch.allclose(many.mean(0), mean, atol=4 * float(std.max()) / np.sqrt(4000))
