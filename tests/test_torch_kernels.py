"""Port parity: torch kernels (``gaussian_process_transportation_tpu_torch.
kernels``) against the JAX kernels on the same numpy inputs, in float64."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu_torch import kernels as TK
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree

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
    tk = kernel_from_tree(jk)
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
    k = TK.RBF(1.0) * TK.Matern(1.0, nu=2.5)
    with pytest.raises(NotImplementedError):
        k.dxdz_diag(_t(X))
