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

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

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
    tg = tgp.condition(kernel_from_tree(jk, device="cpu"), torch.as_tensor(X), torch.as_tensor(Y),
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
    tg = exact_gp_from_numpy(state, kernel_from_tree(jg.kernel, device="cpu"), device="cpu")
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


def test_variance_gradient_matches_jax(pair):
    jg, tg = pair
    want = jgp.variance_gradient(jg, jnp.asarray(XQ))
    got = tgp.variance_gradient(tg, torch.as_tensor(XQ))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# ---- the blocked (panel-factor) GP ------------------------------------------

BLOCK_TOL = 2e-3  # the JAX package's blocked-vs-dense bound, float32
rng_b = np.random.default_rng(11)
XB = rng_b.standard_normal((300, 2))
YB = rng_b.standard_normal((300, 2))
XQB = rng_b.standard_normal((40, 2))


def _blocked_kernels(name):
    ls = jnp.asarray([1.5, 0.8], jnp.float32)
    base = JK.RBF(ls) if name == "rbf" else JK.Matern(ls, nu=2.5)
    return JK.Constant(2.0) * base + JK.White(0.1)


def _queries(mod, gp, x):
    """Every posterior query of a GP, by name."""
    jac_mean, jac_var = mod.jacobian(gp, x, return_var=True)
    return {
        "predict": mod.predict(gp, x, return_std=True),
        "predict_cov": mod.predict_cov(gp, x),
        "jacobian": (jac_mean, jac_var),
        "variance_gradient": (mod.variance_gradient(gp, x),),
    }


@pytest.fixture(scope="module", params=["rbf", "matern52"])
def blocked(request):
    jk = _blocked_kernels(request.param)
    jg = jgp.condition_blocked(jk, jnp.asarray(XB, jnp.float32), jnp.asarray(YB, jnp.float32),
                               block=128, interpret=True)
    f32 = dict(dtype=torch.float32)
    tg32 = tgp.condition_blocked(kernel_from_tree(jk, torch.float32, "cpu"),
                                 torch.as_tensor(XB, **f32), torch.as_tensor(YB, **f32), block=128)
    tk64 = kernel_from_tree(jk, device="cpu")
    tg64 = tgp.condition_blocked(tk64, torch.as_tensor(XB), torch.as_tensor(YB), block=128)
    dense64 = tgp.condition(tk64, torch.as_tensor(XB), torch.as_tensor(YB))
    return jg, tg32, tg64, dense64


def test_condition_blocked_matches_jax(blocked):
    jg, tg32, tg64, _ = blocked
    assert tg32.L is None and tg32.chol is not None and tg32.K_inv is None
    assert len(tg32.chol.panels) == 3 and tg32.chol.n == 300
    scale = np.abs(np.asarray(jg.alpha)).max()
    assert np.abs(tg32.alpha.numpy() - np.asarray(jg.alpha)).max() / scale < 2e-4
    np.testing.assert_allclose(tg32.chol.dense().numpy(), np.asarray(jg.chol.dense()),
                               atol=1e-5 * np.abs(np.asarray(jg.chol.dense())).max())
    assert tg64.alpha.dtype == torch.float64


@pytest.mark.parametrize("query", ["predict", "predict_cov", "jacobian", "variance_gradient"])
def test_blocked_gp_answers_like_the_dense_gp(blocked, query):
    """The panel factor reproduces every dense-path posterior query."""
    _, _, tg64, dense64 = blocked
    x = torch.as_tensor(XQB)
    for got, want in zip(_queries(tgp, tg64, x)[query], _queries(tgp, dense64, x)[query]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("query", ["predict", "predict_cov", "jacobian", "variance_gradient"])
def test_blocked_gp_queries_match_jax(blocked, query):
    jg, tg32, _, _ = blocked
    got = _queries(tgp, tg32, torch.as_tensor(XQB, dtype=torch.float32))[query]
    want = _queries(jgp, jg, jnp.asarray(XQB, jnp.float32))[query]
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() < BLOCK_TOL


def test_exact_gp_from_numpy_carries_a_blocked_factor(blocked):
    """A JAX condition_blocked state crosses over and predicts alike, f32:
    to 1e-6 of Σ_n |k α_n| (float32 sums of N terms, which JAX, with x64
    on, partly takes in float64)."""
    jg = blocked[0]
    state = {k: np.asarray(getattr(jg, k)) for k in ("X", "Y", "alpha")}
    state["chol"] = jg.chol
    tg = exact_gp_from_numpy(state, kernel_from_tree(jg.kernel, torch.float32, "cpu"), torch.float32,
                             "cpu")
    assert tg.L is None and tg.chol.n == jg.chol.n and len(tg.chol.panels) == 3
    jm, js = jgp.predict(jg, jnp.asarray(XQB, jnp.float32), return_std=True)
    xq = torch.as_tensor(XQB, dtype=torch.float32)
    tm, ts = tgp.predict(tg, xq, return_std=True)
    scale = (tg.kernel(xq, tg.X).abs() @ tg.alpha.abs()).max().item()
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6 * scale)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_condition_routes_on_the_tensors_device(monkeypatch):
    """Large N on a CPU tensor keeps the dense factor: the blocked route is
    for CUDA tensors, decided by X's device, not a process-wide default."""
    monkeypatch.setattr(tgp, "BLOCKED_CHOL_MIN_N", 64)
    k = TK.Constant(2.0) * TK.RBF(torch.ones(2)) + TK.White(0.1)
    X = torch.as_tensor(XB[:100], dtype=torch.float32)
    gp = tgp.condition(k, X, X)
    assert gp.L is not None and gp.chol is None


def test_predict_on_cpu_takes_the_dense_path(monkeypatch):
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as tpg

    monkeypatch.setattr(tgp, "FUSED_PREDICT_MIN_ELEMS", 1)
    monkeypatch.setattr(tgp, "FUSED_MEAN_VAR_MIN_ELEMS", 1)
    for fn in (tpg.fused_gp_predict_mean, tpg.fused_gp_predict_mean_var):
        monkeypatch.setattr(fn, "launches", 0)
    k = TK.Constant(2.0) * TK.RBF(torch.ones(2)) + TK.White(0.1)
    X = torch.as_tensor(XB[:50], dtype=torch.float32)
    gp = tgp.condition(k, X, X, cache_k_inv=True)
    xq = torch.as_tensor(XQB, dtype=torch.float32)
    assert tgp._fused_predict_params(gp, xq) is None
    mean, std = tgp.predict(gp, xq, return_std=True)
    assert torch.equal(mean, k(xq, X) @ gp.alpha)
    assert tpg.fused_gp_predict_mean.launches == tpg.fused_gp_predict_mean_var.launches == 0


def test_route_thresholds_are_the_measured_ones():
    """The routes' constants, as set from ``chip_smoke.py``'s and
    ``scripts/time_port_routes.py``'s readings on the card: the blocked
    Cholesky won in every reading from N=8192 (and not at N=4096 or 6144), the
    mean-and-variance kernel won up to N=2048 (from the JAX package's
    Nq·N = 2²¹), and the mean kernel won at every Nq·N timed, from 2¹¹."""
    assert tgp.BLOCKED_CHOL_MIN_N == 8192
    assert tgp.FUSED_MEAN_VAR_MAX_N == 2048
    assert tgp.FUSED_MEAN_VAR_MIN_ELEMS == 2**21
    assert tgp.FUSED_PREDICT_MIN_ELEMS == 2**11


F32, F64 = torch.float32, torch.float64
ROUTE_CASES = [
    # device, x dtype, alpha dtype, Nq, N, D, P, has K⁻¹, return_std -> route
    (("cuda", F32, F32, 10000, 2048, 2, 2, True, False), "mean"),
    (("cuda", F32, F32, 10000, 2048, 2, 2, False, False), "mean"),
    (("cuda", F32, F32, 10000, 2048, 2, 2, True, True), "mean_var"),
    (("cuda", F32, F32, 10000, 512, 3, 1, True, True), "mean_var"),
    (("cuda", F32, F32, 10000, 2048, 2, 2, False, True), None),  # no cached K⁻¹
    (("cuda", F32, F32, 10000, 2049, 2, 2, True, True), None),  # past the measured crossover
    (("cuda", F32, F32, 10000, 4096, 2, 2, True, False), "mean"),  # which binds the std only
    (("cuda", F32, F32, 1000, 2048, 2, 2, True, True), None),  # Nq·N under the threshold
    (("cuda", F32, F32, 1, 2047, 2, 2, True, False), None),  # under the mean's threshold
    (("cuda", F32, F32, 1024, 2048, 2, 2, True, True), "mean_var"),  # Nq·N at the threshold
    (("cuda", F64, F64, 10000, 2048, 2, 2, True, True), None),  # the kernels are float32
    (("cuda", F32, F64, 10000, 2048, 2, 2, True, False), None),
    (("cuda", F32, F32, 10000, 2048, 17, 2, True, True), None),  # D past the kernels' MAX_D
    (("cuda", F32, F32, 10000, 2048, 2, 9, True, False), None),  # P past the kernels' MAX_P
    (("cpu", F32, F32, 10000, 2048, 2, 2, True, True), None),  # the twins are the dense path
    (("cpu", F32, F32, 10000, 2048, 2, 2, True, False), None),
    (("cuda", F32, F32, 1000, 2048, 2, 2, True, False), "mean"),  # the mean from Nq·N = 2¹¹
    (("cuda", F32, F32, 1, 2048, 2, 2, True, False), "mean"),
]


@pytest.mark.parametrize("args,want", ROUTE_CASES)
def test_fused_predict_route(args, want):
    assert tgp.fused_predict_route(*args) == want


def test_epistemic_std_is_clamped_at_zero():
    """A float32 GP of 400 points with noise 1e-6: near the training points
    the variance's float32 cancellation takes it below the noise level, so
    sqrt(var) − sqrt(noise) is negative at some of them (as the JAX
    package returns it); the port's epistemic std is that difference
    clamped at 0, bit for bit, and no farther from float64 anywhere."""
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(-3, 3, (400, 2)), dtype=torch.float32)
    Y = torch.sin(X[:, :1]) * torch.cos(X[:, 1:])

    def gp_of(dtype):
        k = (TK.Constant(1.0) * TK.RBF(torch.tensor([0.7, 0.7], dtype=dtype))
             + TK.White(1e-6))
        return tgp.condition(k, X.to(dtype), Y.to(dtype),
                             jitter=tgp._eff_jitter(torch.float32, 1e-10))

    gp32, gp64 = gp_of(torch.float32), gp_of(torch.float64)
    _, total = tgp.predict(gp32, X[:200], return_std=True)
    raw = total - math.sqrt(1e-6)
    _, std = tgp.predict(gp32, X[:200], return_std=True, epistemic_only=True)
    _, std64 = tgp.predict(gp64, X[:200].double(), return_std=True, epistemic_only=True)
    assert bool((raw < 0).any()) and torch.equal(std, torch.clamp(raw, min=0.0))
    assert bool(((std.double() - std64).abs() <= (raw.double() - std64).abs()).all())
