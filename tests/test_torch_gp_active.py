"""Port parity: ``models/gp_active.py`` (greedy max-variance selection by
partial pivoted Cholesky, and the active-learning GP) against the JAX
package's, float64 on the CPU unless said."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu.models import gp_active as jga
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp
from gaussian_process_transportation_tpu_torch.models import gp_active as tga

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _surface(N, seed):
    """Points on a smooth 2-D field with a nonlinear two-output target."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (N, 2))
    Y = np.stack([np.sin(1.5 * X[:, 0]), np.cos(0.7 * X[:, 1]) * X[:, 0]], 1)
    return X, Y + 0.05 * rng.standard_normal(Y.shape)


@pytest.mark.parametrize("N,m,m0", [(60, 5, 1), (500, 40, 4), (2000, 200, 20)])
def test_greedy_variance_select_matches_jax(N, m, m0):
    """The same indices as JAX's, in order, from the same explicit seed."""
    X, _ = _surface(N, N)
    jk = JK.Constant(1.0) * JK.RBF(0.5 * jnp.ones(2)) + JK.White(0.01)
    seed = np.random.default_rng(N + 1).choice(N, m0, replace=False)
    want = np.asarray(jga.greedy_variance_select(jk, jnp.asarray(X), m, jnp.asarray(seed),
                                                 noise=0.01))
    got = tga.greedy_variance_select(kernel_from_tree(jk, device="cpu"), _t(X), m,
                                     torch.as_tensor(seed), noise=0.01)
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_final_variances_are_the_schur_complement():
    """After the last step the loop's conditional variance of every point
    outside the selected set S is k(x, x) + σ² − k(x, S)(K_SS + σ²I)⁻¹k(S, x),
    to 1e-10; at the selected points it is 0 to 1e-12."""
    X, _ = _surface(300, 3)
    tk = kernel_from_tree(JK.Constant(1.5) * JK.RBF(0.7 * jnp.ones(2)) + JK.White(0.02),
                          device="cpu")
    idx, d = tga._greedy_variance_select(tk, _t(X), 40, torch.tensor([5, 17]),
                                         noise=float(tgp.white_noise_level(tk)))
    S = _t(X)[idx]
    K_SS = tk(S)  # the self-Gram carries the White term
    k_xS = tk(_t(X), S)
    want = tk.diag(_t(X)) - (k_xS * torch.linalg.solve(K_SS, k_xS.T).T).sum(1)
    free = torch.ones(300, dtype=torch.bool)
    free[idx] = False
    torch.testing.assert_close(d[free], want[free], rtol=0, atol=1e-10)
    assert d[idx].abs().max() <= 1e-12
    assert len(set(idx.tolist())) == 40 and idx[:2].tolist() == [5, 17]


def test_active_learning_takes_the_seeded_subset_then_the_greedy_one():
    """Past ``n_samples_max`` the GP keeps the seed (a 10% randperm prefix of
    a CPU generator seeded with ``seed``) and then the greedy points, and
    fits on that subset; below it, the whole set."""
    X, Y = _surface(300, 4)
    jk = JK.Constant(1.0) * JK.RBF(jnp.ones(2)) + JK.White(0.01)
    tk = kernel_from_tree(jk, device="cpu")
    m = tga.GaussianProcessActiveLearning(tk, n_samples_max=100, n_restarts_optimizer=0, seed=7,
                                          device="cpu").fit(X, Y)
    seed = torch.randperm(300, generator=torch.Generator().manual_seed(7))[:10]
    want = tga.greedy_variance_select(tk, _t(X), 100, seed, noise=0.01)
    torch.testing.assert_close(m.X, _t(X)[want], rtol=0, atol=0)
    assert m.state.L is not None and m.kernel_ is m.state.kernel
    small = tga.GaussianProcessActiveLearning(tk, n_samples_max=400, n_restarts_optimizer=0,
                                              device="cpu").fit(X, Y[:, 0])
    assert small.X.shape == (300, 2) and small.state.Y.shape == (300, 1)


def test_active_learning_dense_route_matches_jax():
    """Given the same subset and fitted kernel (JAX's), the port's predict
    (mean, epistemic std) and derivative ((Nq, D, P), (Nq, D, 1)) equal
    JAX's to 1e-8; the port's own scipy fit on that subset reaches JAX's
    LML to 1e-8 of its magnitude."""
    X, Y = _surface(300, 5)
    jk = JK.Constant(1.0) * JK.RBF(jnp.ones(2)) + JK.White(0.01)
    jm = jga.GaussianProcessActiveLearning(jk, n_samples_max=100, n_restarts_optimizer=0)
    jm.fit(X, Y)
    Xs, Ys = np.array(jm.state.X), np.array(jm.state.Y)
    tm = tga.GaussianProcessActiveLearning(kernel_from_tree(jk, device="cpu"), n_samples_max=100,
                                           n_restarts_optimizer=0, device="cpu")
    tm.state = tgp.condition(kernel_from_tree(jm.state.kernel, device="cpu"), _t(Xs), _t(Ys),
                             1e-10)
    q = np.random.default_rng(6).uniform(-2.0, 2.0, (25, 2))
    for got, want in zip((*tm.predict(q), *tm.derivative(q)), (*jm.predict(q), *jm.derivative(q))):
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)
    tm.fit(Xs, Ys)  # at n_samples_max: no selection, the scipy fit
    lml = [float(jgp.log_marginal_likelihood(jm.state.kernel, jnp.asarray(Xs), jnp.asarray(Ys),
                                             1e-10)),
           tgp.log_marginal_likelihood(tm.kernel_, _t(Xs), _t(Ys), 1e-10).item()]
    assert abs(lml[1] - lml[0]) <= 1e-8 * abs(lml[0]), lml


def test_active_learning_blocked_route_matches_jax():
    """``use_blocked=True`` in float32 (JAX's tests/test_active_diffeo.py
    case): the fit goes through ``fit_blocked`` and keeps the panel factor.
    On JAX's subset the port's fitted LML (read in f64) is within 1e-3 of
    its magnitude of JAX's, the tolerance of tests/test_torch_fit_blocked.py;
    given JAX's fitted kernel, predict and derivative in float32 agree with
    JAX's, and with the dense float64 predict at the port's float32 jitter
    floor (1e-6): the mean and dy/dx to the same 1e-3 of their scale (the
    port's blocked mean reads ~1.2e-4 of it against f64, JAX's ~2e-5), the
    std and dσ²/dx, which cancel in prior − k K⁻¹ kᵀ, to 1e-4 of the prior
    variance (both read ~5e-6)."""
    rng = np.random.RandomState(6)
    X = (rng.rand(500, 2) * 4 - 2).astype(np.float32)
    Y = (np.stack([np.sin(1.5 * X[:, 0]), np.cos(0.7 * X[:, 1])], 1)
         + 0.05 * rng.randn(500, 2)).astype(np.float32)
    jk = (JK.Constant(1.0, bounds=(1e-3, 1e3)) * JK.RBF(jnp.ones(2, jnp.float32), bounds=(1e-2, 1e2))
          + JK.White(0.1, bounds=(1e-6, 10.0)))
    jm = jga.GaussianProcessActiveLearning(jk, n_samples_max=256, use_blocked=True,
                                           blocked_kwargs=dict(block=128, interpret=True,
                                                               maxiter=10))
    jm.fit(X, Y)
    Xs, Ys = np.array(jm.state.X), np.array(jm.state.Y)
    tk = kernel_from_tree(jk, torch.float32, "cpu")
    tm = tga.GaussianProcessActiveLearning(tk, n_samples_max=256, use_blocked=True,
                                           blocked_kwargs=dict(block=128, maxiter=10),
                                           device="cpu").fit(Xs, Ys)
    assert tm.state.chol is not None and tm.state.L is None and tm.X.shape == (256, 2)

    def lml64(k):  # a port kernel's LML on JAX's subset, in float64
        return tgp.log_marginal_likelihood(k.with_theta(k.theta.double()), _t(Xs), _t(Ys)).item()

    lml_j, lml_t = lml64(kernel_from_tree(jm.state.kernel, device="cpu")), lml64(tm.kernel_)
    assert abs(lml_t - lml_j) <= 1e-3 * abs(lml_j), (lml_t, lml_j)
    kj = jm.state.kernel
    tm.state = tgp.condition_blocked(kernel_from_tree(kj, torch.float32, "cpu"),
                                     _t(Xs, torch.float32), _t(Ys, torch.float32), jitter=1e-10,
                                     block=128)
    ref = tga.GaussianProcessActiveLearning(kernel_from_tree(kj, device="cpu"), device="cpu")
    ref.state = tgp.condition(kernel_from_tree(kj, device="cpu"), _t(Xs), _t(Ys), 1e-6)
    q = X[:50]
    prior = float(ref.state.kernel.diag(_t(q[:1]))[0])  # amp + noise
    outs = zip((*tm.predict(q), *tm.derivative(q)), (*jm.predict(q), *jm.derivative(q)),
               (*ref.predict(q), *ref.derivative(q)))
    for name, (got, want, f64) in zip(("mean", "std", "dy/dx", "dvar/dx"), outs):
        want, f64 = np.asarray(want), f64.numpy()
        assert got.dtype == torch.float32 and got.shape == want.shape
        # the std and dσ²/dx come out of prior − k K⁻¹ kᵀ, rounded at the prior's scale
        tol = 1e-4 * prior if name in ("std", "dvar/dx") else 1e-3 * np.abs(f64).max()
        assert np.abs(got.numpy() - want).max() <= tol, name
        assert np.abs(got.numpy() - f64).max() <= tol, name
