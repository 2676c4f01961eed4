"""Port parity: the large-N hyperparameter fit ``exact_gp.fit_blocked``
against the JAX package's (both optax's L-BFGS and zoom line search, over
the port's blocked LML and JAX's with its Pallas ``factor_panel`` in
interpret mode): θ after the first iterations, and the fitted LML read in
float64 by the dense formula, also against the port's dense scipy fit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu_torch import kernels as TK
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

N, D, B, MAXITER, EARLY = 200, 2, 128, 20, 3  # two panels, the last one padded


def _case():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))).astype(np.float32)
    jk = (JK.Constant(1.0, bounds=(1e-2, 1e2)) * JK.RBF(jnp.ones(D), bounds=(1e-1, 1e1))
          + JK.White(0.1, bounds=(1e-4, 1.0)))
    return X, Y, jk


def _lml64(kernel, X, Y):
    """A port kernel's LML by the dense formula in float64."""
    return tgp.log_marginal_likelihood(
        kernel.with_theta(kernel.theta.double().cpu()), torch.as_tensor(X, dtype=torch.float64),
        torch.as_tensor(Y, dtype=torch.float64)).item()


@pytest.fixture(scope="module")
def fits():
    X, Y, jk = _case()
    tk = kernel_from_tree(jk, torch.float32, "cpu")
    port = tgp.fit_blocked(tk, torch.as_tensor(X), torch.as_tensor(Y), maxiter=MAXITER, block=B)
    ref = jgp.fit_blocked(jk, jnp.asarray(X), jnp.asarray(Y), maxiter=MAXITER, block=B,
                          interpret=True)
    dense = tgp.fit(kernel_from_tree(jk, torch.float64, "cpu"),
                    torch.as_tensor(X, dtype=torch.float64),
                    torch.as_tensor(Y, dtype=torch.float64), n_restarts=0)
    return dict(start=_lml64(tk, X, Y), port=_lml64(port.kernel, X, Y),
                jax=_lml64(kernel_from_tree(ref.kernel, device="cpu"), X, Y),
                dense=_lml64(dense.kernel, X, Y), gp=port)


def test_fit_blocked_takes_jaxs_first_steps():
    """After EARLY iterations (the second's line search zooms back from a
    unit step) θ is JAX's within 1e-3 in each log hyperparameter.  float32
    sets the tolerance: the two blocked LMLs differ by ~1e-5 relative, and
    the zoom's cubic through float32 values carries that to ~1e-4 in θ
    (read on the CPU)."""
    X, Y, jk = _case()
    port = tgp.fit_blocked(kernel_from_tree(jk, torch.float32, "cpu"), torch.as_tensor(X),
                           torch.as_tensor(Y), maxiter=EARLY, block=B)
    ref = jgp.fit_blocked(jk, jnp.asarray(X), jnp.asarray(Y), maxiter=EARLY, block=B,
                          interpret=True)
    want = kernel_from_tree(ref.kernel, device="cpu").theta.numpy()
    np.testing.assert_allclose(port.kernel.theta.double().numpy(), want, rtol=0, atol=1e-3)


def test_fit_blocked_raises_the_lml(fits):
    """The line search takes only steps that lower −LML enough: the fitted
    LML is at least the start's (here by hundreds)."""
    assert fits["port"] >= fits["start"] + 100.0


@pytest.mark.parametrize("other", ["jax", "dense"])
def test_fit_blocked_reaches_the_optimum_of_the_other_fits(fits, other):
    """Three fits (the port's and JAX's optax L-BFGS in float32, scipy's
    L-BFGS-B in float64) from the same start,
    read by the same f64 formula: within 1e-3 of the LML's magnitude."""
    assert abs(fits["port"] - fits[other]) <= 1e-3 * abs(fits[other]), fits


def test_fit_blocked_returns_the_canonical_kernel_conditioned_blocked(fits):
    """C·stationary + White rebuilt with the input nodes' bounds, every ℓ
    inside its bounds, conditioned through the blocked Cholesky."""
    gp = fits["gp"]
    assert gp.chol is not None and gp.L is None and gp.alpha.shape == (N, 1)
    k = gp.kernel
    assert isinstance(k, TK.Sum) and isinstance(k.k1, TK.Product) and isinstance(k.k2, TK.White)
    assert k.k1.k1.bounds == (1e-2, 1e2) and k.k1.k2.bounds == (1e-1, 1e1)
    assert k.k2.bounds == (1e-4, 1.0)
    ls = torch.as_tensor(k.k1.k2.lengthscale)
    assert ls.shape == (D,) and bool(((ls >= 1e-1 * (1 - 1e-6)) & (ls <= 1e1 * (1 + 1e-6))).all())


def test_fit_blocked_refuses_kernels_outside_the_family():
    X = torch.zeros(10, 2)
    with pytest.raises(ValueError, match="C\\*stationary"):
        tgp.fit_blocked(TK.RBF(1.0) + TK.RBF(2.0), X, X[:, :1])


def test_fit_blocked_matern_fit_raises_the_lml():
    """A Matérn 5/2 fit with an isotropic ℓ (broadcast to one ℓ per axis)
    from a poor start, with NaN-target rows dropped first."""
    X, Y, _ = _case()
    Y = Y.copy()
    Y[::50] = np.nan
    keep = ~np.isnan(Y[:, 0])
    tk = TK.Constant(0.3) * TK.Matern(torch.tensor(3.0), nu=2.5) + TK.White(0.5)
    gp = tgp.fit_blocked(tk, torch.as_tensor(X), torch.as_tensor(Y), maxiter=8, block=B)
    assert gp.X.shape == (int(keep.sum()), D)
    assert torch.as_tensor(gp.kernel.k1.k2.lengthscale).shape == (D,)
    start = _lml64(tk, X[keep], Y[keep])
    assert _lml64(gp.kernel, X[keep], Y[keep]) > start + 10.0


def test_fit_blocked_moves_from_the_large_n_start():
    """scripts/bench_blocked_lml.py's data and start at N = 1000: the
    gradient runs to hundreds, and a steepest-descent first step of −g
    would leave the definite region; optax's first step of norm
    min(1, 1/‖g‖)·‖g‖ ≤ 1 and its line search raise the LML by hundreds in
    ten iterations."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((1000, 3)).astype(np.float32)
    Y = (np.sin(2.0 * X[:, :1]) + 0.1 * rng.standard_normal((1000, 1))).astype(np.float32)
    tk = TK.Constant(2.0) * TK.RBF(torch.ones(3)) + TK.White(0.1)
    gp = tgp.fit_blocked(tk, torch.as_tensor(X), torch.as_tensor(Y), maxiter=10, block=B)
    assert _lml64(gp.kernel, X, Y) > _lml64(tk, X, Y) + 100.0


@pytest.mark.parametrize("precision", ["default", "high"])
def test_every_precision_fits_as_highest_on_the_cpu(precision):
    """precision None is "highest" (JAX's choice off a TPU); on CPU tensors
    every precision takes "highest"'s steps bit for bit, as JAX's CPU
    backend ignores it."""
    X, Y, jk = _case()
    fit = lambda p: tgp.fit_blocked(kernel_from_tree(jk, torch.float32, "cpu"),
                                    torch.as_tensor(X), torch.as_tensor(Y), maxiter=EARLY,
                                    block=B, precision=p)
    want = fit(None)
    got = fit(precision)
    assert torch.equal(got.kernel.theta, want.kernel.theta)
    assert torch.equal(got.kernel.theta, fit("highest").kernel.theta)
    assert torch.equal(got.alpha, want.alpha)


def test_jax_at_high_takes_the_ports_high_steps():
    """JAX's fit_blocked with Precision.HIGH against the port's "high", as
    test_fit_blocked_takes_jaxs_first_steps holds "highest"; an unknown
    name is refused."""
    import jax

    X, Y, jk = _case()
    port = tgp.fit_blocked(kernel_from_tree(jk, torch.float32, "cpu"), torch.as_tensor(X),
                           torch.as_tensor(Y), maxiter=EARLY, block=B, precision="high")
    ref = jgp.fit_blocked(jk, jnp.asarray(X), jnp.asarray(Y), maxiter=EARLY, block=B,
                          precision=jax.lax.Precision.HIGH, interpret=True)
    want = kernel_from_tree(ref.kernel, device="cpu").theta.numpy()
    np.testing.assert_allclose(port.kernel.theta.double().numpy(), want, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="precision"):
        tgp.fit_blocked(kernel_from_tree(jk, torch.float32, "cpu"), torch.as_tensor(X),
                        torch.as_tensor(Y), maxiter=1, block=B, precision="HIGH")
