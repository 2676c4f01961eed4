"""Port parity: torch kernels (``gaussian_process_transportation_tpu_torch.
kernels``) against the JAX kernels on the same numpy inputs, in float64."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu_torch import kernels as TK
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = 1e-12  # same float64 formulas, evaluated in a different order at most

rng = np.random.default_rng(11)
X = rng.standard_normal((7, 2)) * 3.0
Z = rng.standard_normal((5, 2)) * 3.0
LS = np.array([1.3, 0.7])

JAX_KERNELS = {
    "rbf": lambda: JK.RBF(jnp.asarray(LS)),
    "matern12": lambda: JK.Matern(jnp.asarray(LS), nu=0.5),
    "matern32": lambda: JK.Matern(jnp.asarray(LS), nu=1.5),
    "matern52": lambda: JK.Matern(jnp.asarray(LS), nu=2.5),
    "matern_inf": lambda: JK.Matern(jnp.asarray(LS), nu=math.inf),
    "c_rbf_white": lambda: JK.Constant(10.0) * JK.RBF(jnp.asarray(LS)) + JK.White(0.01),
    "c_matern52_white": lambda: JK.Constant(0.1) * JK.Matern(jnp.asarray(LS), nu=2.5)
    + JK.White(1e-4),
}

METHODS = {
    "gram": lambda k, x, z: k(x),
    "cross": lambda k, x, z: k(x, z),
    "diag": lambda k, x, z: k.diag(x),
    "dx": lambda k, x, z: k.dx(x, z),
    "dxT": lambda k, x, z: k.dxT(x, z),
    "dxdz_diag": lambda k, x, z: k.dxdz_diag(x),
}


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("name", sorted(JAX_KERNELS))
def test_kernel_method_matches_jax(name, method):
    jk = JAX_KERNELS[name]()
    tk = kernel_from_tree(jk, device="cpu")
    fn = METHODS[method]
    if name == "matern12" and method == "dxdz_diag":
        with pytest.raises(NotImplementedError):
            fn(jk, jnp.asarray(X), jnp.asarray(Z))
        with pytest.raises(NotImplementedError):
            fn(tk, _t(X), _t(Z))
        return
    want = np.asarray(fn(jk, jnp.asarray(X), jnp.asarray(Z)))
    got = fn(tk, _t(X), _t(Z))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_batched_gram_is_stack_of_grams():
    """Leading batch axes: one call builds each member's Gram."""
    k = TK.Constant(10.0) * TK.RBF(_t(LS)) + TK.White(0.01)
    Xb = _t(rng.standard_normal((4, 6, 2)))
    got = k(Xb)
    for e in range(4):
        torch.testing.assert_close(got[e], k(Xb[e]), rtol=0, atol=0)
    torch.testing.assert_close(k.dxT(_t(X), Xb)[1], k.dxT(_t(X), Xb[1]), rtol=0, atol=0)


def test_composition_and_white_cross_covariance():
    k = 2.0 * TK.RBF(1.0) + TK.White(0.5)
    assert isinstance(k, TK.Sum) and isinstance(k.k1, TK.Product)
    assert isinstance(k.k1.k1, TK.Constant)
    x = _t(X)
    assert torch.all(TK.White(0.5)(x, _t(Z)) == 0)
    torch.testing.assert_close(torch.diagonal(k(x)), torch.full((7,), 2.5, dtype=torch.float64))


def test_float32_inputs_stay_float32():
    k = TK.Constant(10.0) * TK.RBF(torch.tensor([4.0, 4.0], dtype=torch.float64)) + TK.White(0.01)
    x = torch.as_tensor(X, dtype=torch.float32)
    for out in (k(x), k.diag(x), k.dxT(x, x), k.dxdz_diag(x)):
        assert out.dtype == torch.float32


def test_product_of_two_stationary_kernels_has_no_dxdz_diag_yet():
    """The product of two non-constant kernels now has a dxdz_diag: the
    product rule on the factors' closed forms (the first derivatives vanish
    at a = b).  For RBF·RBF it is 1/ℓ₁² + 1/ℓ₂² and equals JAX's autodiff
    form; for RBF·Matérn 5/2, the case that used to raise, it is
    1/ℓ₁² + (5/3)/ℓ₂²."""
    k = TK.RBF(1.3) * TK.RBF(_t(LS))
    want = torch.ones(7, 2, dtype=torch.float64) * (1 / 1.3**2 + 1 / _t(LS) ** 2)
    torch.testing.assert_close(k.dxdz_diag(_t(X)), want, rtol=TOL, atol=TOL)
    jk = JK.RBF(1.3) * JK.RBF(jnp.asarray(LS))
    want = jax.jit(lambda k, x: k.dxdz_diag(x))(jk, jnp.asarray(X))
    np.testing.assert_allclose(k.dxdz_diag(_t(X)).numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    k = TK.RBF(1.0) * TK.Matern(1.2, nu=2.5)
    want = torch.full((7, 2), 1.0 + (5.0 / 3.0) / 1.2**2, dtype=torch.float64)
    torch.testing.assert_close(k.dxdz_diag(_t(X)), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("nu, scale", [(1.5, 3.0), (2.5, 5.0 / 3.0), (math.inf, 1.0)])
def test_matern_times_rbf_dxdz_diag_is_the_closed_form(nu, scale):
    """Matérn·RBF (either order, under a Constant and beside a White):
    c·(s_ν/ℓ_M² + 1/ℓ_R²), s_ν = 3, 5/3, 1 for ν = 3/2, 5/2, ∞; and against
    the mixed second derivative by central differences of ``pairwise``
    around a = b (float64, h = 1e-4; rounding about 1e-16/h², 1e-8; the
    truncation O(h²), about 1e-7, bound 1e-5, but O(h) for ν = 3/2, whose
    k has an |r|³ term: about 8h here, bound 10h).  The
    GP's Jacobian variance (prior − quadratic form) stays ≥ 0 with it
    (bound −1e-8, rounding)."""
    from gaussian_process_transportation_tpu_torch.models import exact_gp

    ls_m = 1.2
    for k in (TK.Constant(2.0) * (TK.Matern(ls_m, nu=nu) * TK.RBF(_t(LS))) + TK.White(0.01),
              TK.Constant(2.0) * (TK.RBF(_t(LS)) * TK.Matern(ls_m, nu=nu)) + TK.White(0.01)):
        got = k.dxdz_diag(_t(X))
        want = 2.0 * (scale / ls_m**2 + 1.0 / _t(LS) ** 2)
        torch.testing.assert_close(got, want.expand(7, 2), rtol=TOL, atol=TOL)
        h, x0 = 1e-4, _t(X[0])
        for d in range(2):
            e = torch.zeros(2, dtype=torch.float64)
            e[d] = h
            fd = (k.pairwise(x0 + e, x0 + e) - k.pairwise(x0 + e, x0 - e)
                  - k.pairwise(x0 - e, x0 + e) + k.pairwise(x0 - e, x0 - e)) / (4 * h * h)
            assert abs(fd.item() - got[0, d].item()) < (10 * h if nu == 1.5 else 1e-5)
        gp = exact_gp.condition(k, _t(X), _t(rng.standard_normal((7, 1))))
        _, var = exact_gp.jacobian(gp, _t(np.concatenate([X[:3], Z])), return_var=True)
        assert torch.isfinite(var).all() and (var > -1e-8).all()


@pytest.mark.parametrize("nu", [1.5, 2.5, math.inf])
def test_matern_generic_dxdz_diag_is_the_closed_form(nu):
    """The base class's autodiff second derivative of a Matérn leaf at a = b
    equals the closed form (s_ν/ℓ², s_ν = 3, 5/3, 1) to 1e-10: ``pairwise``
    takes the profile's series in d² near 0.  JAX's autodiff form is wrong
    there (Matérn 5/2 at ℓ = 1.2: −2.31 against the closed form 1.157), so
    the port is held to the closed form, not to JAX.  Away from a = b,
    ``pairwise`` is the closed-form profile to 1e-14, and the generic first
    derivative equals ``Matern.dx``."""
    from gaussian_process_transportation_tpu_torch.kernels.stationary import _matern_of_d

    for ls in (_t([1.2]), _t(LS)):
        k = TK.Matern(ls, nu=nu)
        torch.testing.assert_close(TK.Kernel.dxdz_diag(k, _t(X)), k.dxdz_diag(_t(X)),
                                   rtol=0, atol=1e-10)
    torch.testing.assert_close(TK.Kernel.dx(k, _t(X), _t(Z)), k.dx(_t(X), _t(Z)),
                               rtol=TOL, atol=TOL)
    for a, b in zip(_t(X), _t(Z)):
        d2 = (((a - b) / _t(LS)) ** 2).sum()
        want = torch.exp(-0.5 * d2) if nu == math.inf else _matern_of_d(torch.sqrt(d2), nu)
        assert abs(k.pairwise(a, b).item() - want.item()) <= 1e-14
    for eps in (1e-7, 1e-5):  # either side of the series' edge at d² = 1e-12
        b = _t(X[0]) + eps
        d2 = (((_t(X[0]) - b) / _t(LS)) ** 2).sum()
        want = torch.exp(-0.5 * d2) if nu == math.inf else _matern_of_d(torch.sqrt(d2), nu)
        assert abs(k.pairwise(_t(X[0]), b).item() - want.item()) <= 1e-14


def test_matern12_generic_dxdz_diag_raises():
    """ν = 1/2 has no second derivative at a = b: the base class refuses it,
    as ``Matern.dxdz_diag`` does."""
    k = TK.Matern(_t(LS), nu=0.5)
    for f in (TK.Kernel.dxdz_diag, TK.Matern.dxdz_diag):
        with pytest.raises(NotImplementedError, match="nu=0.5"):
            f(k, _t(X))


# The generic derivatives (Kernel.dx, dxT, dxdz_diag on ``pairwise`` through
# torch.func) against JAX's (jax.jacfwd / jacrev on its ``pairwise``).  RBF
# factors only for dxdz_diag: at a = b JAX's autodiff second derivative of a
# Matérn is wrong (its d = sqrt(d² + 1e-36) guard); the port's is held to
# the closed form above.
GENERIC = {
    "sum": (lambda K, ls: K.Constant(2.0) * K.RBF(ls) + K.Matern(0.9, nu=2.5) + K.White(0.1),
            ("pairwise", "dx", "dxT")),
    "product": (lambda K, ls: K.RBF(ls) * K.Matern(1.7, nu=1.5), ("pairwise", "dx", "dxT")),
    "rbf_sum": (lambda K, ls: K.Constant(2.0) * K.RBF(ls) + K.RBF(0.8), ("dxdz_diag",)),
    "rbf_product": (lambda K, ls: K.RBF(ls) * K.RBF(0.8), ("dxdz_diag",)),
}


def _generic(k, method, x, z):
    """The base class's form of ``method`` (JAX's jitted: eager, its
    autodiff dispatches op by op)."""
    on_jax = isinstance(x, jax.Array)
    vmap = jax.vmap if on_jax else torch.func.vmap
    if method == "pairwise":
        fn = lambda k, x, z: vmap(lambda a: vmap(lambda b: k.pairwise(a, b))(z))(x)
    elif method == "dxdz_diag":
        fn = lambda k, x, z: type(k).__mro__[-2].dxdz_diag(k, x)
    else:
        fn = lambda k, x, z: getattr(type(k).__mro__[-2], method)(k, x, z)
    return np.asarray((jax.jit(fn) if on_jax else fn)(k, x, z))


@pytest.mark.parametrize("name", sorted(GENERIC))
def test_generic_derivatives_match_jax(name):
    build, methods = GENERIC[name]
    jk, tk = build(JK, jnp.asarray(LS)), build(TK, _t(LS))
    for method in methods:
        want = _generic(jk, method, jnp.asarray(X), jnp.asarray(Z))
        got = _generic(tk, method, _t(X), _t(Z))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        if method in ("dx", "dxT"):  # the composite's closed form, the same values
            np.testing.assert_allclose(got, getattr(tk, method)(_t(X), _t(Z)).numpy(),
                                       rtol=1e-10, atol=1e-12)


# ---- the hyperparameter vector -------------------------------------------

THETA_KERNELS = {
    "plain": lambda: JK.Constant(10.0) * JK.RBF(jnp.asarray(LS)) + JK.White(0.01),
    "swapped_sum": lambda: JK.White(0.02, bounds=(1e-3, 1.0))
    + JK.Constant(0.5, bounds=(1e-2, 1e2)) * JK.RBF(0.8),
    "ard_matern_bounds": lambda: JK.Matern(jnp.asarray([1.0, 2.0, 0.5]), nu=2.5,
                                           bounds=(1e-1, 1e1)) * JK.Constant(2.0),
}


@pytest.mark.parametrize("name", sorted(THETA_KERNELS))
def test_theta_and_bounds_match_jax(name):
    jk = THETA_KERNELS[name]()
    tk = kernel_from_tree(jk, device="cpu")
    np.testing.assert_allclose(tk.theta.numpy(), np.asarray(jk.theta), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tk.theta_bounds.numpy(), np.asarray(jk.theta_bounds), rtol=TOL)
    assert tk.n_theta == jk.n_theta
    theta = np.asarray(jk.theta) + np.linspace(-0.5, 0.5, jk.n_theta)
    want, got = jk.with_theta(jnp.asarray(theta)), tk.with_theta(_t(theta))
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), rtol=TOL, atol=TOL)
    x = rng.standard_normal((6, 3 if name == "ard_matern_bounds" else 2))
    np.testing.assert_allclose(got(_t(x)).numpy(), np.asarray(want(jnp.asarray(x))), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("method", ["gram", "cross", "diag", "dx", "dxT", "dxdz_diag"])
@pytest.mark.parametrize("name", ["c_rbf_white", "c_matern52_white", "rbf_iso_white"])
def test_per_member_kernel_equals_member_kernels(name, method):
    """with_theta((E, T)) gives one kernel whose hyperparameters carry the
    E axis; it evaluates per-member points as E kernels would, and points
    without the E axis as shared by every member."""
    base = {"c_rbf_white": lambda: TK.Constant(10.0) * TK.RBF(_t(LS)) + TK.White(0.01),
            "c_matern52_white": lambda: TK.Constant(0.1) * TK.Matern(_t(LS), nu=2.5)
            + TK.White(1e-4),
            "rbf_iso_white": lambda: TK.RBF(0.7) + TK.White(0.3)}[name]()
    E = 3
    thetas = _t(rng.uniform(-1.0, 1.0, (E, base.n_theta)))
    kb = base.with_theta(thetas)
    Xb, Zb = _t(rng.standard_normal((E, 5, 2))), _t(rng.standard_normal((E, 4, 2)))
    fn = METHODS[method]
    got = fn(kb, Xb, Zb)
    shared = fn(kb, Xb[0], Zb[0])
    for e in range(E):
        one = base.with_theta(thetas[e])
        torch.testing.assert_close(got[e], fn(one, Xb[e], Zb[e]), rtol=TOL, atol=TOL)
        torch.testing.assert_close(shared[e], fn(one, Xb[0], Zb[0]), rtol=TOL, atol=TOL)


def test_with_theta_keeps_a_tensor_leaf_dtype_and_follows_theta_device():
    k = TK.Constant(2.0) * TK.RBF(torch.ones(2, dtype=torch.float32)) + TK.White(0.1)
    assert k.theta.dtype == torch.float32
    k2 = k.with_theta(torch.zeros(4, dtype=torch.float64))
    assert k2.k1.k2.lengthscale.dtype == torch.float32
    assert k2.k1.k1.constant_value.dtype == torch.float64
    with pytest.raises(ValueError, match="entries"):
        k.with_theta(torch.zeros(5))
