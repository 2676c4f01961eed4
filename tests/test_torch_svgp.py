"""Port parity: ``models/svgp.py`` against the JAX package's, float64 on the
CPU to 1e-8: the ELBO and its gradient, the Adam and natural-gradient fits
from JAX's own draws (the inducing points and schedule recomputed with
``jax.random`` exactly as JAX's fits draw them), a fit whose steps hit
non-finite losses, the collapse and the posteriors of f and ∂f/∂x."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import svgp as js
from gaussian_process_transportation_tpu_torch.convert import (
    collapsed_svgp_from_tree, kernel_from_tree, svgp_state_from_tree,
)
from gaussian_process_transportation_tpu_torch.models import svgp as ts

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)
N, D, M, EPOCHS, BATCH = 40, 2, 8, 4, 16
FIELDS = ("theta", "Z", "m_w", "L_w_raw", "raw_noise")


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _jkernel():
    return JK.Constant(1.3) * JK.RBF(jnp.asarray([0.8, 1.1]))


def jax_draws(key, T):
    """The inducing indices (T, M) and the schedule JAX's fits draw from
    ``key``."""
    k_init, k_perm = jax.random.split(key)
    idx = jax.vmap(lambda k: jax.random.choice(k, N, (M,), replace=False))(
        jax.random.split(k_init, T))
    per_epoch = N // BATCH
    sched = jax.vmap(lambda k: jax.random.permutation(k, N)[: per_epoch * BATCH].reshape(
        per_epoch, BATCH))(jax.random.split(k_perm, EPOCHS)).reshape(-1, BATCH)
    return torch.as_tensor(np.array(idx)), torch.as_tensor(np.array(sched))


@pytest.fixture(scope="module")
def problem():
    """Two-task data, JAX's Adam and natural-gradient fits from one key,
    and a fit on targets with a NaN at a point no inducing set holds."""
    rng = np.random.default_rng(0)
    X = 2.0 * rng.standard_normal((N, D))
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1]) * X[:, 0]], 1)
    key = jax.random.PRNGKey(3)
    kw = dict(num_inducing=M, num_epochs=EPOCHS, batch_size=BATCH, key=key)
    idx, sched = jax_draws(key, 2)
    Y_nan = Y.copy()
    Y_nan[int(np.setdiff1d(np.arange(N), idx.numpy())[0]), 1] = np.nan
    return dict(X=X, Y=Y, Y_nan=Y_nan, idx=idx, sched=sched,
                adam=js.fit(_jkernel(), X, Y, **kw),
                natgrad=js.fit_natgrad(_jkernel(), X, Y, **kw),
                adam_nan=js.fit(_jkernel(), X, Y_nan, **kw),
                xq=2.0 * rng.standard_normal((7, D)))


def _init(problem, Y):
    return ts.init_params(kernel_from_tree(_jkernel(), device="cpu"), _t(problem["X"]), _t(Y),
                          problem["idx"])


def test_elbo_and_gradient_match_jax(problem):
    """At a point away from the initial one, every parameter's gradient."""
    X, Y = problem["X"], problem["Y"]
    p0 = js.init_params(_jkernel(), jnp.asarray(X), jnp.asarray(Y), M,
                        jax.random.split(jax.random.PRNGKey(3))[0])
    shift = dict(theta=0.1, Z=0.05, m_w=-0.1, L_w_raw=0.01 * np.tril(np.ones((M, M))),
                 raw_noise=0.2)
    pj = js.SVGPParams(**{f: getattr(p0, f) + shift[f] for f in FIELDS})
    val, grad = jax.jit(jax.value_and_grad(
        lambda p: js.elbo(_jkernel(), p, X[:16], Y[:16], N, 1e-6)))(pj)
    pt = ts.SVGPParams(**{f: _t(getattr(pj, f)).requires_grad_() for f in FIELDS})
    got = ts.elbo(kernel_from_tree(_jkernel(), device="cpu"), pt, _t(X[:16]), _t(Y[:16]), N, 1e-6)
    got.backward()
    _close(got, val)
    for f in FIELDS:
        _close(getattr(pt, f).grad, getattr(grad, f))
    _close(_init(problem, Y).L_w_raw, p0.L_w_raw)


def test_a_failed_cholesky_gives_nan_as_jax_does():
    """A rank-one K_uu (lengthscales of 1e8, no jitter): NaN, not an error."""
    k = JK.Constant(1.0) * JK.RBF(jnp.asarray([1e8, 1e8]))
    Z = np.random.default_rng(2).standard_normal((M, D))
    m_w, L_raw, x, y = np.zeros(M), np.zeros((M, M)), Z[:4], np.zeros(4)
    want = js._task_elbo(k, k.theta, Z, m_w, L_raw, 0.1, x, y, N, 0.0)
    got = ts._task_elbo(kernel_from_tree(k, device="cpu"), _t(k.theta)[None], _t(Z)[None],
                        _t(m_w)[None], _t(L_raw)[None], _t(0.1), _t(x), _t(y)[None], N, 0.0)
    assert math.isnan(float(want)) and torch.isnan(got).all()


@pytest.mark.parametrize("which", ["adam", "adam_nan", "natgrad"])
def test_training_from_jax_draws_is_jaxs_fit(problem, which):
    """``train`` (Adam; with NaN targets each step that meets one zeroes
    its gradient and still takes the Adam step) and ``train_natgrad``
    equal JAX's fits from the same draws."""
    Y = problem["Y_nan" if which == "adam_nan" else "Y"]
    kernel = kernel_from_tree(_jkernel(), device="cpu")
    step = ts.train_natgrad if which == "natgrad" else ts.train
    got, losses = step(kernel, _init(problem, Y), _t(problem["X"]), _t(Y), problem["sched"])
    if which == "adam_nan":
        assert not torch.isfinite(losses).all() and torch.isfinite(losses).any()
    for f in FIELDS:
        _close(getattr(got, f), getattr(problem[which].params, f))


@pytest.mark.parametrize("which", ["adam", "natgrad"])
def test_collapse_and_posteriors_match_jax(problem, which):
    """The collapsed form of JAX's state carried across, and the mean and
    std of f and of ∂f/∂x from it and from JAX's collapsed form."""
    state = problem[which]
    want_c = jax.jit(js.collapse)(state)
    got_c = ts.collapse(svgp_state_from_tree(state, device="cpu"))
    for f in ("theta", "Z", "alpha", "Lk", "Lw"):
        _close(getattr(got_c, f), getattr(want_c, f))
    xq = problem["xq"]
    want_f = jax.jit(js.posterior_f)(want_c, jnp.asarray(xq))
    want_fp = jax.jit(js.posterior_f_prime)(want_c, jnp.asarray(xq))
    for c in (got_c, collapsed_svgp_from_tree(want_c, device="cpu")):
        for g, w in zip((*ts.posterior_f(c, _t(xq)), *ts.posterior_f_prime(c, _t(xq))),
                        (*want_f, *want_fp)):
            _close(g, w)
    draws = ts.sample_f(got_c, _t(xq), torch.Generator().manual_seed(0), n_samples=5)
    assert draws.shape == js.sample_f(want_c, jnp.asarray(xq), jax.random.PRNGKey(0), 5).shape
    assert torch.isfinite(draws).all()


def test_wrapper_matches_jax(problem):
    """predict, derivative (variance = std²) and samples of the wrapper
    from JAX's state; its own fit is seeded on the CPU generator."""
    X, Y, xq = problem["X"], problem["Y"], problem["xq"]
    want = js.StochasticVariationalGaussianProcess(X, Y, num_inducing=M, kernel=_jkernel())
    want.state = problem["adam"]
    want.collapsed = js.collapse(want.state)
    got = ts.StochasticVariationalGaussianProcess(X, Y, num_inducing=M, device="cpu")
    got.collapsed = ts.collapse(svgp_state_from_tree(want.state, device="cpu"))
    for g, w in zip((*got.predict(xq, return_std=True), *got.derivative(xq, return_var=True)),
                    (*want.predict(xq, return_std=True), *want.derivative(xq, return_var=True))):
        _close(g, w)
    assert got.samples(xq).shape == want.samples(xq).shape
    torch.testing.assert_close(got.samples(xq), got.samples(xq))
    fits = [ts.StochasticVariationalGaussianProcess(X, Y[:, 0], num_inducing=M, seed=1,
                                                    device="cpu").fit(num_epochs=2)
            for _ in range(2)]
    assert torch.equal(fits[0].predict(xq), fits[1].predict(xq))
    assert fits[0].predict(xq).shape == (7, 1)
