"""Port parity: the generic (autograd) route of ``sample_gp_posterior``
and the single-chain samplers (``parallel/samplers.py``).  The route's
log-density against the JAX package's formula (``samplers.py:872-878``) on
a Sum kernel and at n = 40, past the fused route, and its vmapped gradient
against plain autograd of the port's LML (held against JAX's gradient in
tests/test_torch_fit.py); its chains against the fused route, which
tests/test_torch_samplers.py holds against JAX; one chain of HMC and NUTS
on a known Gaussian."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp
from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl
from gaussian_process_transportation_tpu_torch.parallel import samplers as ts

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

SUM = lambda: (JK.Constant(1.0) * JK.RBF(1.0) + JK.Constant(0.5) * JK.Matern(3.0, nu=2.5)
               + JK.White(0.01))
FAMILY = lambda: JK.Constant(1.0) * JK.RBF(jnp.ones(2)) + JK.White(0.01)


def _data(n, p=1, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 2))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, p))
    return X, Y


def _jax_logprob(jk, X, Y, theta):
    """JAX's generic log-density: LML − the softplus barrier (eager: XLA's
    compile of it takes minutes at n = 40)."""
    lo, hi = jk.theta_bounds[:, 0], jk.theta_bounds[:, 1]
    out = []
    for th in map(jnp.asarray, theta):
        lml = jgp.log_marginal_likelihood(jk.with_theta(th), jnp.asarray(X), jnp.asarray(Y),
                                          1e-10)
        barrier = jnp.sum(jax.nn.softplus(-(th - lo) * 20.0) + jax.nn.softplus((th - hi) * 20.0))
        out.append(float(lml - 100.0 * barrier))
    return np.array(out)


@pytest.mark.parametrize("case", ["sum_n12", "family_n40"])
def test_generic_lp_and_grad_matches_jax(case):
    """float64, both chains in one vmapped call, at a θ inside the bounds and
    one past them (the barrier's side): the value to 1e-9 of JAX's formula,
    the gradient to 1e-9 of its largest entry from plain autograd of the
    same log-density one chain at a time."""
    jk = SUM() if case == "sum_n12" else FAMILY()
    X, Y = _data(12 if case == "sum_n12" else 40)
    T = jk.theta.shape[0]
    theta = np.random.default_rng(1).uniform(-2.0, 2.0, (2, T))
    theta[1, 0] = np.log(1e5) + 0.2
    tk = kernel_from_tree(jk, torch.float64, "cpu")
    lo, hi = tk.theta_bounds[:, 0], tk.theta_bounds[:, 1]
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    lp, g = ts.generic_lp_and_grad(tk, Xt, Yt, lo, hi, 1e-10)(torch.as_tensor(theta.T))
    np.testing.assert_allclose(lp.numpy(), _jax_logprob(jk, X, Y, theta), rtol=1e-9, atol=1e-9)
    for c in range(2):
        th = torch.tensor(theta[c], requires_grad=True)
        v = tgp.log_marginal_likelihood(tk.with_theta(th), Xt, Yt, 1e-10) - ts._barrier(th, lo, hi)
        v.backward()
        torch.testing.assert_close(g[:, c], th.grad, rtol=0,
                                   atol=1e-9 * th.grad.abs().max().item())


def test_generic_route_takes_what_the_fused_route_refuses(monkeypatch):
    """A Sum kernel, n = 40 and p = 9 run the generic route: no call of the
    fused LML or its twin, finite samples of the kernel's θ, and chains
    independent of the number of chains (bit for bit)."""
    monkeypatch.setattr(tfl, "small_lml_value_grad_ref",
                        lambda *a, **k: pytest.fail("the fused route ran"))
    kw = dict(seed=2, num_warmup=6, num_samples=5, num_leapfrog=4)
    for jk, (n, p) in ((SUM(), (12, 1)), (FAMILY(), (40, 1)), (FAMILY(), (20, 9))):
        X, Y = (torch.as_tensor(a) for a in _data(n, p))
        tk = kernel_from_tree(jk, torch.float64, "cpu")
        s4, d4 = ts.sample_gp_posterior(tk, X, Y, num_chains=4, **kw)
        s2, _ = ts.sample_gp_posterior(tk, X, Y, num_chains=2, **kw)
        assert s4.shape == (4, 5, tk.n_theta) and torch.isfinite(s4).all()
        assert s4.dtype == torch.float64 and d4["mean_accept"].shape == (4,)
        assert torch.equal(s2, s4[:2])


@pytest.mark.parametrize("algorithm", ["hmc", "nuts"])
def test_generic_route_agrees_with_the_fused_route(algorithm):
    """On the fused route's own problem (C·RBF+White, n = 10), ``fused=False``
    samples the same posterior: means per θ within 0.8·sd + 0.3 of the
    fused route's (tests/test_fused_lml.py:248's rule)."""
    X, Y = _data(10)
    tk = kernel_from_tree(FAMILY(), torch.float32, "cpu")
    kw = dict(num_chains=8, num_warmup=25, num_samples=25, seed=0, algorithm=algorithm,
              **({"num_leapfrog": 8} if algorithm == "hmc" else {"max_depth": 3}))
    s_f, _ = ts.sample_gp_posterior(tk, torch.as_tensor(X, dtype=torch.float32),
                                    torch.as_tensor(Y, dtype=torch.float32), **kw)
    s_g, _ = ts.sample_gp_posterior(tk, torch.as_tensor(X), torch.as_tensor(Y), fused=False,
                                    **kw)
    assert s_g.dtype == torch.float64 and s_f.dtype == torch.float32
    flat_f = s_f.reshape(-1, 4).double()
    m_g = s_g.reshape(-1, 4).mean(0)
    assert ((m_g - flat_f.mean(0)).abs() < 0.8 * flat_f.std(0) + 0.3).all(), (m_g, flat_f.mean(0))


MU = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
SIGMA = torch.tensor([0.5, 2.0, 1.0], dtype=torch.float64)


def _logprob(q):
    return -0.5 * (((q - MU) / SIGMA) ** 2).sum()


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_single_chain_samplers_recover_a_gaussian(sampler):
    """One chain over an autograd log-density, JAX's returns: samples (S, T),
    a scalar step size and accept rate, a (T,) mass.  Means to 0.3 and sds
    to 0.45 (one chain of 400 correlated draws) of a known Gaussian."""
    fn = ts.hmc if sampler == "hmc" else ts.nuts
    kw = {"num_leapfrog": 8} if sampler == "hmc" else {}
    samples, info = fn(_logprob, torch.zeros(3, dtype=torch.float64), seed=1, num_warmup=150,
                       num_samples=400, **kw)
    assert samples.shape == (400, 3)
    assert info["step_size"].shape == () and info["inv_mass"].shape == (3,)
    assert info["mean_accept"].shape == () and info["mean_accept"] > 0.5
    torch.testing.assert_close(samples.mean(0), MU, rtol=0, atol=0.3)
    torch.testing.assert_close(samples.std(0), SIGMA, rtol=0, atol=0.45)


def test_single_chain_hmc_is_its_warmup_and_sample_ranges():
    """hmc = hmc_warmup + hmc_sample_range over any cut of the samples, bit
    for bit, and equals chain ``chain_id`` of a batched run."""
    q0 = torch.tensor([0.3, -0.1, 0.2], dtype=torch.float64)
    kw = dict(num_warmup=10, num_leapfrog=4)
    whole, _ = ts.hmc(_logprob, q0, seed=5, num_samples=9, chain_id=2, **kw)
    state, step, inv_mass = ts.hmc_warmup(_logprob, q0, seed=5, chain_id=2, **kw)
    parts = []
    for start, stop in ((0, 4), (4, 9)):
        state, s, _ = ts.hmc_sample_range(_logprob, state, 5, 9, start, stop, step, inv_mass,
                                          num_leapfrog=4, chain_id=2)
        parts.append(s)
    assert torch.equal(torch.cat(parts), whole)

    def batched(q):
        z = (q - MU[:, None]) / SIGMA[:, None]
        return -0.5 * (z * z).sum(0), -z / SIGMA[:, None]

    q0s = torch.stack([q0 + 1.0, q0 - 1.0, q0], 1)
    many, _ = ts.hmc_batched(batched, q0s, seed=5, num_samples=9, **kw)
    torch.testing.assert_close(many[2], whole, rtol=1e-12, atol=1e-12)
