"""Port parity: the log marginal likelihood with its analytic gradient, the
theta layout, scipy ``fit``, the per-lane L-BFGS and ``fit_ensemble_fused``
(``models/exact_gp.py``) against the JAX package, float64 unless said."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu_torch import kernels as TK
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp
from gaussian_process_transportation_tpu_torch.models.gp_regressor import GaussianProcess
from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

LML_KERNELS = {
    "c_rbf_ard_white": lambda: JK.Constant(2.0) * JK.RBF(jnp.asarray([1.0, 0.7])) + JK.White(0.05),
    "white_first_rbf_iso": lambda: JK.White(0.02) + JK.Constant(1.5) * JK.RBF(0.8),
    "c_matern52_white": lambda: JK.Constant(0.7) * JK.Matern(jnp.ones(2), nu=2.5) + JK.White(0.1),
    "matern12_no_noise": lambda: JK.Constant(1.2) * JK.Matern(1.3, nu=0.5),
}


def _data(n, D=2, p=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D))
    return X, np.sin(X[:, :1]) * np.cos(X[:, 1:2]) + 0.1 * rng.standard_normal((n, p))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("n", [15, 80], ids=["small_analytic", "large_autograd"])
@pytest.mark.parametrize("name", sorted(LML_KERNELS))
def test_log_marginal_likelihood_and_gradient_match_jax(name, n):
    jk = LML_KERNELS[name]()
    X, Y = _data(n, seed=n)
    theta0 = np.asarray(jk.theta) + 0.3
    f = lambda th: jgp.log_marginal_likelihood(jk.with_theta(th), jnp.asarray(X), jnp.asarray(Y),
                                               1e-8)
    v_j, g_j = jax.value_and_grad(f)(jnp.asarray(theta0))
    tk = kernel_from_tree(jk, device="cpu")
    th = torch.tensor(theta0, requires_grad=True)
    v = tgp.log_marginal_likelihood(tk.with_theta(th), _t(X), _t(Y), 1e-8)
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_j), rtol=1e-10)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(g_j), rtol=1e-8, atol=1e-10)


def test_log_marginal_likelihood_of_a_per_member_kernel_is_per_member():
    tk = kernel_from_tree(LML_KERNELS["c_rbf_ard_white"](), device="cpu")
    thetas = _t(np.random.default_rng(1).uniform(-1, 1, (3, 4)))
    Xs, Ys = zip(*(_data(10, seed=s) for s in range(3)))
    got = tgp.log_marginal_likelihood(tk.with_theta(thetas), _t(np.stack(Xs)), _t(np.stack(Ys)))
    for e in range(3):
        want = tgp.log_marginal_likelihood(tk.with_theta(thetas[e]), _t(Xs[e]), _t(Ys[e]))
        torch.testing.assert_close(got[e], want, rtol=1e-12, atol=1e-12)


LAYOUT_CASES = {  # tests/test_fused_lml.py:209-220, and a Matérn without noise
    "plain": lambda: JK.Constant(1.0) * JK.RBF(jnp.ones(2)) + JK.White(0.01),
    "swapped_sum": lambda: JK.White(0.01) + JK.Constant(1.0) * JK.RBF(0.5),
    "two_stationary": lambda: JK.RBF(1.0) + JK.RBF(2.0),
    "matern_no_noise": lambda: JK.Matern(jnp.ones(3), nu=1.5) * JK.Constant(2.0),
}


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_small_lml_theta_layout_matches_jax(name):
    jk = LAYOUT_CASES[name]()
    want = jgp.small_lml_theta_layout(jk)
    got = tgp.small_lml_theta_layout(kernel_from_tree(jk, device="cpu"))
    if want is None:
        assert got is None
        return
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])


def test_lbfgs_elast_matches_jax_on_a_per_lane_quadratic():
    """f_l(x) = ½ xᵀA_l x − b_lᵀx with SPD A_l, bounds active in some
    lanes: the same iterates as JAX's optimizer, float64."""
    rng = np.random.default_rng(2)
    T, L = 3, 6
    M = rng.standard_normal((L, T, T))
    A = np.einsum("lij,lkj->lik", M, M) + 0.5 * np.eye(T)
    b = 2.0 * rng.standard_normal((T, L))
    x0 = rng.standard_normal((T, L))
    lo, hi = -np.full((T, 1), 1.5), np.full((T, 1), 1.5)

    def vg_j(x):
        Ax = jnp.einsum("lij,jl->il", jnp.asarray(A), x)
        return 0.5 * jnp.sum(x * Ax, 0) - jnp.sum(jnp.asarray(b) * x, 0), Ax - jnp.asarray(b)

    def vg_t(x):
        Ax = torch.einsum("lij,jl->il", _t(A), x)
        return 0.5 * (x * Ax).sum(0) - (_t(b) * x).sum(0), Ax - _t(b)

    xj, vj = jgp._lbfgs_elast(vg_j, jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi), 10)
    xt, vt = tgp._lbfgs_elast(vg_t, _t(x0), _t(lo), _t(hi), 10)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10, atol=1e-10)


def test_fit_without_restarts_matches_jax():
    jk = LML_KERNELS["c_rbf_ard_white"]()
    X, Y = _data(14, seed=3)
    want = jgp.fit(jk, jnp.asarray(X), jnp.asarray(Y), n_restarts=0)
    got = tgp.fit(kernel_from_tree(jk, device="cpu"), _t(X), _t(Y), n_restarts=0)
    lml_j = float(jgp.log_marginal_likelihood(want.kernel, jnp.asarray(X), jnp.asarray(Y)))
    lml_t = tgp.log_marginal_likelihood(got.kernel, _t(X), _t(Y)).item()
    assert abs(lml_t - lml_j) <= 1e-6 * abs(lml_j)
    assert got.L is not None and got.alpha.shape == (14, 2)


def test_fit_drops_nan_rows_and_keeps_the_best_restart():
    jk = LML_KERNELS["c_matern52_white"]()
    X, Y = _data(12, seed=4)
    Y[3, 1] = np.nan
    Xf, Yf = tgp._filter_nan_rows(_t(X), _t(Y))
    Xj, Yj = jgp._filter_nan_rows(X, Y)
    np.testing.assert_array_equal(Xf.numpy(), Xj)
    np.testing.assert_array_equal(Yf.numpy(), Yj)
    tk = kernel_from_tree(jk, device="cpu")
    gp0 = tgp.fit(tk, _t(X), _t(Y), n_restarts=0)
    gp3 = tgp.fit(tk, _t(X), _t(Y), n_restarts=3, generator=torch.Generator().manual_seed(5))
    assert gp3.X.shape == (11, 2)
    lml = lambda gp: tgp.log_marginal_likelihood(gp.kernel, Xf, Yf).item()
    assert lml(gp3) >= lml(gp0) - 1e-9 and lml(gp0) >= tgp.log_marginal_likelihood(tk, Xf, Yf).item()


def _ensemble(E=4, n=10, seed=7):
    """Members with different datasets (tests/test_fused_lml.py:174-183)."""
    rng = np.random.default_rng(seed)
    Xe = rng.uniform(-2, 2, (E, n, 2))
    f = np.sin(1.3 * Xe[:, :, :1]) * np.cos(0.6 * Xe[:, :, 1:2])
    return Xe, f + 0.05 * rng.standard_normal((E, n, 1))


def _bounded_kernel():
    return (JK.Constant(1.0, bounds=(1e-2, 1e2)) * JK.RBF(jnp.ones(2), bounds=(1e-1, 1e1))
            + JK.White(0.2, bounds=(1e-4, 1.0)))


def test_fit_ensemble_fused_without_restarts_matches_jax():
    jk = _bounded_kernel()
    Xe, Ye = _ensemble()
    th_j, lml_j = jgp.fit_ensemble_fused(jk, jnp.asarray(Xe), jnp.asarray(Ye), n_restarts=0,
                                         maxiter=10)
    th_t, lml_t = tgp.fit_ensemble_fused(kernel_from_tree(jk, device="cpu"), _t(Xe), _t(Ye),
                                         n_restarts=0, maxiter=10)
    assert th_t.shape == (4, 4) and th_t.dtype == torch.float32
    lml_j = np.asarray(lml_j)
    np.testing.assert_array_less(np.abs(lml_t.numpy() - lml_j), 1e-3 * np.maximum(1, np.abs(lml_j)))


def test_fit_ensemble_fused_with_restarts_improves_every_member(monkeypatch):
    monkeypatch.setattr(tfl.small_lml_value_grad_md, "launches", 0)
    jk = _bounded_kernel()
    tk = kernel_from_tree(jk, device="cpu")
    Xe, Ye = _ensemble()
    calls, value_calls = [], []
    real, real_value = tfl.small_lml_value_grad_md, tfl._small_lml_value_md
    monkeypatch.setattr(tfl, "small_lml_value_grad_md",
                        lambda *a, **k: calls.append(a[2].shape) or real(*a, **k))
    monkeypatch.setattr(tfl, "_small_lml_value_md",
                        lambda *a, **k: value_calls.append(a[2].shape) or real_value(*a, **k))
    th, lml = tgp.fit_ensemble_fused(tk, _t(Xe), _t(Ye), n_restarts=4, maxiter=12,
                                     generator=torch.Generator().manual_seed(1))
    # one batched call a candidate: the Armijo candidates' values alone
    assert calls == [(4, 4 * 5)] * (1 + 12) and value_calls == [(4, 4 * 5)] * (12 * 6)
    assert real.launches == 0
    X64, Y64 = _t(Xe), _t(Ye)
    initial = tgp.log_marginal_likelihood(tk, X64, Y64, 1e-10)
    fitted = tgp.log_marginal_likelihood(tk.with_theta(th.double()), X64, Y64, 1e-10)
    assert (fitted >= initial - 1e-3).all(), (fitted, initial)
    # the reported LML is its theta's (the rule of tests/test_fused_lml.py:206)
    assert ((fitted - lml.double()).abs() < 2e-2 * torch.clamp(lml.double().abs(), min=1)).all()


@pytest.mark.parametrize("D,p", [(12, 2), (2, 12)])
def test_fit_ensemble_fused_wide_shapes_match_jax(D, p):
    """D and p past the card kernel's eight: JAX's fit, run as its CPU
    tests run it, and the port's agree as at D=2, p=1."""
    rng = np.random.default_rng(D + p)
    Xe = rng.standard_normal((3, 10, D))
    Ye = np.sin(Xe[..., :1]) + 0.05 * rng.standard_normal((3, 10, p))
    jk = (JK.Constant(1.0, bounds=(1e-2, 1e2)) * JK.RBF(jnp.ones(D), bounds=(1e-1, 1e1))
          + JK.White(0.2, bounds=(1e-4, 1.0)))
    th_j, lml_j = jgp.fit_ensemble_fused(jk, jnp.asarray(Xe), jnp.asarray(Ye), n_restarts=0,
                                         maxiter=6)
    th_t, lml_t = tgp.fit_ensemble_fused(kernel_from_tree(jk, device="cpu"), _t(Xe), _t(Ye),
                                         n_restarts=0, maxiter=6)
    assert th_t.shape == (3, D + 2) and torch.isfinite(lml_t).all()
    lml_j = np.asarray(lml_j)
    np.testing.assert_array_less(np.abs(lml_t.numpy() - lml_j), 1e-3 * np.maximum(1, np.abs(lml_j)))


def test_gaussian_process_refuses_the_jit_fit():
    """jit_fit is ported: GaussianProcess(jit_fit=True) fits through
    exact_gp.fit_jit, its restarts drawn from a CPU generator seeded with
    ``seed``, and conditions at the fitted kernel."""
    X, Y = _data(12, p=1, seed=5)
    kern = TK.Constant(1.0) * TK.RBF(torch.ones(2, dtype=torch.float64)) + TK.White(0.1)
    gp = GaussianProcess(kern, n_restarts_optimizer=2, seed=3, jit_fit=True).fit(_t(X), _t(Y))
    want = tgp.fit_jit(kern, _t(X), _t(Y), n_restarts=2, generator=torch.Generator().manual_seed(3),
                       maxiter=100)
    torch.testing.assert_close(gp.kernel_.theta, want.kernel.theta, rtol=0, atol=0)
    torch.testing.assert_close(gp.state.alpha, want.alpha, rtol=0, atol=0)
    assert gp.noise_var_ == pytest.approx(1e-10 + float(tgp.white_noise_level(want.kernel)))
