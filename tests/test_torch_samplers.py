"""Port parity: the batched HMC sampler and the GP hyperposterior
(``parallel/samplers.py``) against the JAX package: the adaptation and
diagnostics to float64 rounding, the sampler on a known Gaussian, the
fused log-density against JAX's formula, and the posterior moments of
``sample_gp_posterior``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.ops import fused_lml as jfl
from gaussian_process_transportation_tpu.parallel import samplers as js
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl
from gaussian_process_transportation_tpu_torch.parallel import samplers as ts

TOL = 1e-12


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_dual_averaging_matches_jax():
    rng = np.random.default_rng(0)
    step0 = rng.uniform(0.05, 0.5, 7)
    sj, st = js._dual_averaging_init(jnp.asarray(step0)), ts._dual_averaging_init(_t(step0))
    for _ in range(5):
        acc = rng.uniform(0, 1, 7)
        sj = js._dual_averaging_update(sj, jnp.asarray(acc), target=0.7)
        st = ts._dual_averaging_update(st, _t(acc), target=0.7)
    for key in sj:
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(4, 400, 2), (3, 51, 3)])
def test_split_rhat_and_ess_match_jax(shape):
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.standard_normal(shape), axis=1) * 0.1 + rng.standard_normal(shape)
    np.testing.assert_allclose(ts.split_rhat(_t(x)).numpy(), np.asarray(js.split_rhat(x)),
                               rtol=TOL)
    np.testing.assert_allclose(ts.effective_sample_size(_t(x)).numpy(),
                               np.asarray(js.effective_sample_size(jnp.asarray(x))), rtol=TOL)


MU, SIGMA = np.array([1.0, -2.0, 0.5]), np.array([0.5, 2.0, 1.0])


def _gaussian(q):
    z = (q - _t(MU)[:, None]) / _t(SIGMA)[:, None]
    return -0.5 * (z * z).sum(0), -z / _t(SIGMA)[:, None]


def test_hmc_batched_recovers_a_gaussian():
    """The tolerances of tests/test_samplers.py:41-42."""
    samples, info = ts.hmc_batched(_gaussian, torch.zeros(3, 16, dtype=torch.float64), seed=0,
                                   num_warmup=200, num_samples=300)
    assert samples.shape == (16, 300, 3) and info["inv_mass"].shape == (16, 3)
    flat = samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), MU, atol=0.15)
    np.testing.assert_allclose(flat.std(0), SIGMA, atol=0.3)
    assert (ts.split_rhat(samples) < 1.1).all()
    assert info["mean_accept"].mean() > 0.5


def test_segmented_run_equals_the_monolithic_one_bitwise():
    q0 = _t(np.random.default_rng(2).standard_normal((3, 8)))
    whole, _ = ts.hmc_batched(_gaussian, q0, seed=5, num_warmup=10, num_samples=12,
                              num_leapfrog=4)
    state, step, inv_mass = ts.hmc_batched_warmup(_gaussian, q0, seed=5, num_warmup=10,
                                                  num_leapfrog=4)
    parts = []
    for start, stop in ((0, 5), (5, 12)):
        state, s, _ = ts.hmc_batched_sample_range(_gaussian, state, 5, start, stop, step,
                                                  inv_mass, num_leapfrog=4)
        parts.append(s)
    assert torch.equal(torch.cat(parts, 1), whole)
    other, _ = ts.hmc_batched(_gaussian, q0, seed=6, num_warmup=10, num_samples=12,
                              num_leapfrog=4)
    assert not torch.equal(other, whole)


def _gp_case(n=10, seed=0):
    """bench.py's hmc workload shape (bench.py:340-345) at a small n."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 2)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    return X, Y, JK.Constant(1.0) * JK.RBF(jnp.ones(2, jnp.float32)) + JK.White(0.01)


def test_fused_lp_and_grad_matches_the_jax_formula():
    """samplers.py:922-939 of the JAX package, at lanes inside and past the
    log-bounds (the barrier's both sides), float32."""
    X, Y, jk = _gp_case()
    lo, hi = np.log(1e-5), np.log(1e5)
    th = np.random.default_rng(3).uniform(lo - 0.3, hi + 0.3, (4, 9)).astype(np.float32)
    th[:, 0] = 0.0
    lo_c, hi_c = np.full((4, 1), lo, np.float32), np.full((4, 1), hi, np.float32)
    val, grad = jfl.small_lml_value_grad_ref(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(th),
                                             "rbf", 2, True, 1e-10)
    z_lo, z_hi = (th - lo_c) * 20.0, (th - hi_c) * 20.0
    lp = val - 100.0 * jnp.sum(jax.nn.softplus(-z_lo) + jax.nn.softplus(z_hi), axis=0)
    g = grad - 100.0 * 20.0 * (jax.nn.sigmoid(z_hi) - jax.nn.sigmoid(-z_lo))
    bad = ~jnp.isfinite(lp)
    lp = jnp.where(bad, -1e10, lp)
    g = jnp.where(jnp.isfinite(g) & ~bad[None, :], g, 0.0)
    f32 = lambda a: _t(a, torch.float32)
    lp_t, g_t = ts.fused_lp_and_grad(f32(X), f32(Y), f32(lo_c), f32(hi_c), "rbf", 2, True,
                                     1e-10)(f32(th))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g), rtol=2e-4, atol=2e-4)


def test_sample_gp_posterior_agrees_with_jax(monkeypatch):
    """Posterior means per θ within 0.8·sd + 0.3 of JAX's sampler (the rule
    of tests/test_fused_lml.py:248); every leapfrog step one twin call."""
    X, Y, jk = _gp_case()
    calls = []
    real = tfl.small_lml_value_grad_ref
    monkeypatch.setattr(tfl, "small_lml_value_grad_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    common = dict(num_chains=16, num_warmup=40, num_samples=40)
    s_t, d_t = ts.sample_gp_posterior(kernel_from_tree(jk, torch.float32, "cpu"), _t(X),
                                      _t(Y), seed=0, **common)
    assert len(calls) == 1 + 80 * 16 and tfl.small_lml_value_grad.launches == 0
    s_j, _ = js.sample_gp_posterior(jk, jnp.asarray(X), jnp.asarray(Y), jax.random.PRNGKey(0),
                                    **common)
    assert s_t.shape == (16, 40, 4) and torch.isfinite(s_t).all()
    assert d_t["rhat"].shape == (4,) and d_t["mean_accept"].shape == (16,)
    m_t = s_t.reshape(-1, 4).double().numpy().mean(0)
    flat_j = np.asarray(s_j).reshape(-1, 4)
    assert np.all(np.abs(m_t - flat_j.mean(0)) < 0.8 * flat_j.std(0) + 0.3), (m_t, flat_j.mean(0))


def test_routes_not_ported_yet_raise():
    X, Y, jk = _gp_case()
    tk = kernel_from_tree(jk, torch.float32, "cpu")
    for kw in (dict(algorithm="nuts"), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ts.sample_gp_posterior(tk, _t(X), _t(Y), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # not the C·stationary family
        ts.sample_gp_posterior(kernel_from_tree(JK.RBF(1.0) + JK.RBF(2.0), torch.float32, "cpu"),
                               _t(X), _t(Y))
    X40 = _t(np.random.default_rng(0).standard_normal((40, 2)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.sample_gp_posterior(tk, X40, torch.sin(X40[:, :1]))
    for fn in (ts.hmc, ts.nuts, ts.nuts_batched):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(None, None)
