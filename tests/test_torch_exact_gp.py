"""Port parity: dense exact GP (``models/exact_gp.py``) against JAX, f64."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu_torch import kernels as TK
from gaussian_process_transportation_tpu_torch.convert import exact_gp_from_numpy, kernel_from_tree
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp

TOL = 1e-9  # a Cholesky of the same well-conditioned Gram, solved two ways

rng = np.random.default_rng(7)
X = rng.uniform(-3, 3, (18, 2))
Y = np.stack([np.sin(X[:, 0]) + 0.3 * X[:, 1], np.cos(X[:, 1])], 1)
XQ = rng.uniform(-3, 3, (11, 2))

JAX_KERNELS = {
    "c_rbf_white": lambda: JK.Constant(10.0) * JK.RBF(jnp.asarray([1.5, 2.0])) + JK.White(0.01),
    "c_matern52_white": lambda: JK.Constant(2.0) * JK.Matern(jnp.asarray([1.5, 2.0]), nu=2.5)
    + JK.White(1e-3),
}


@pytest.fixture(scope="module", params=[(k, c) for k in sorted(JAX_KERNELS) for c in (True, False)],
                ids=lambda p: f"{p[0]}-kinv{p[1]}")
def pair(request):
    name, cache = request.param
    jk = JAX_KERNELS[name]()
    jg = jgp.condition(jk, jnp.asarray(X), jnp.asarray(Y), jitter=1e-8, cache_k_inv=cache)
    tg = tgp.condition(kernel_from_tree(jk), torch.as_tensor(X), torch.as_tensor(Y),
                       jitter=1e-8, cache_k_inv=cache)
    return jg, tg


def test_condition_matches_jax(pair):
    jg, tg = pair
    for name in ("L", "alpha", "K_inv"):
        want = getattr(jg, name)
        if want is None:
            assert getattr(tg, name) is None
            continue
        np.testing.assert_allclose(getattr(tg, name).numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("epistemic_only", [False, True])
def test_predict_mean_and_std_match_jax(pair, epistemic_only):
    jg, tg = pair
    jm, js = jgp.predict(jg, jnp.asarray(XQ), return_std=True, epistemic_only=epistemic_only)
    tm, ts = tgp.predict(tg, torch.as_tensor(XQ), return_std=True, epistemic_only=epistemic_only)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tgp.predict(tg, torch.as_tensor(XQ)).numpy(), np.asarray(jm),
                               rtol=TOL, atol=TOL)


def test_jacobian_mean_and_var_match_jax(pair):
    jg, tg = pair
    jm, jv = jgp.jacobian(jg, jnp.asarray(XQ), return_var=True)
    tm, tv = tgp.jacobian(tg, torch.as_tensor(XQ), return_var=True)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def test_predict_cov_matches_jax(pair):
    jg, tg = pair
    jm, jc = jgp.predict_cov(jg, jnp.asarray(XQ))
    tm, tc = tgp.predict_cov(tg, torch.as_tensor(XQ))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)


def test_sample_y_is_mean_plus_cholesky_of_cov_times_normals(pair):
    """JAX and torch draw different normals from one seed, so the port is
    held to its own definition, on the covariance checked above."""
    _, tg = pair
    x = torch.as_tensor(XQ)
    got = tgp.sample_y(tg, x, generator=torch.Generator().manual_seed(3), n_samples=4)
    eps = torch.randn((4, 11, 2), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    mean, cov = tgp.predict_cov(tg, x)
    L = torch.linalg.cholesky(cov + 1e-8 * torch.eye(11, dtype=torch.float64))
    torch.testing.assert_close(got, mean[None] + L @ eps, rtol=1e-12, atol=1e-12)


def test_exact_gp_from_numpy_predicts_like_jax(pair):
    jg, _ = pair
    state = {k: None if getattr(jg, k) is None else np.asarray(getattr(jg, k))
             for k in ("X", "Y", "alpha", "L", "K_inv")}
    tg = exact_gp_from_numpy(state, kernel_from_tree(jg.kernel))
    jm, js = jgp.predict(jg, jnp.asarray(XQ), return_std=True)
    tm, ts = tgp.predict(tg, torch.as_tensor(XQ), return_std=True)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,jitter,want", [
    (torch.float32, 1e-10, 1e-6), (torch.float32, 1e-3, 1e-3), (torch.float64, 1e-10, 1e-10),
])
def test_eff_jitter(dtype, jitter, want):
    assert tgp._eff_jitter(dtype, jitter) == want
    assert jgp._eff_jitter(jnp.float32 if dtype == torch.float32 else jnp.float64, jitter) == want


def test_family_and_noise_helpers():
    k = TK.Constant(3.0) * TK.Matern(torch.tensor([1.0, 2.0]), nu=2.5) + TK.White(0.25)
    fam, amp, ls = tgp.stationary_family_params(k)
    assert (fam, amp) == ("matern52", 3.0) and ls.tolist() == [1.0, 2.0]
    assert tgp.stationary_family_params(TK.RBF(2.0))[0] == "rbf"
    assert tgp.stationary_family_params(TK.Matern(1.0, nu=math.inf))[0] == "rbf"
    assert tgp.stationary_family_params(TK.RBF(1.0) * TK.RBF(2.0)) is None
    assert tgp.white_noise_level(k) == 0.25
    assert tgp.white_noise_level(TK.White(0.5) * TK.RBF(1.0)) == 0.0
