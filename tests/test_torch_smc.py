"""Port parity: SMC particle ensembles (``parallel/smc.py``) against the
JAX package's on the same inputs: the resample's offset and the particles'
normals are JAX's own draws, handed to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.parallel import smc as jsmc
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.parallel import smc as tsmc

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = 1e-12  # float64, the same formulas
E, N, D = 64, 10, 2


def _particles(seed=14, spread=1.0):
    rng = np.random.default_rng(seed)
    trajs = rng.standard_normal((E, N, D))
    lw = spread * rng.standard_normal(E)
    lw = lw - np.log(np.exp(lw).sum())
    return (jsmc.ParticleEnsemble(jnp.asarray(trajs), jnp.asarray(lw)),
            tsmc.ParticleEnsemble(torch.as_tensor(trajs), torch.as_tensor(lw)))


def _same(pt, pj):
    np.testing.assert_allclose(pt.trajectories.numpy(), np.asarray(pj.trajectories), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(pt.log_weights.numpy(), np.asarray(pj.log_weights), rtol=TOL,
                               atol=TOL)


def test_reweight_and_effective_sample_size_match_jax():
    pj, pt = _particles()
    ll = np.random.default_rng(1).standard_normal(E) * 3.0
    qj, qt = jsmc.reweight(pj, jnp.asarray(ll)), tsmc.reweight(pt, torch.as_tensor(ll))
    _same(qt, qj)
    np.testing.assert_allclose(tsmc.effective_sample_size(qt).item(),
                               float(jsmc.effective_sample_size(qj)), rtol=TOL)


@pytest.mark.parametrize("key", [0, 5, 11])
def test_systematic_resample_matches_jax_on_jax_offsets(key):
    """The same offset (JAX's uniform of the key) picks the same particles:
    the port's searchsorted counts the cumulative weights below each point,
    as JAX's prefix count does."""
    pj, pt = _particles(spread=2.0)
    k = jax.random.PRNGKey(key)
    offset = torch.tensor(float(jax.random.uniform(k)), dtype=torch.float64)
    _same(tsmc.systematic_resample(pt, offset=offset), jsmc.systematic_resample(pj, k))


def test_systematic_resample_counts_follow_the_weights():
    """Low-variance resampling from a generator: each particle kept within
    one of E·w times (tests/test_smc.py's property)."""
    M = 1000
    w = np.random.default_rng(3).dirichlet(np.ones(M))
    p = tsmc.ParticleEnsemble(torch.arange(M, dtype=torch.float64)[:, None, None].expand(M, 2, 2),
                              torch.log(torch.as_tensor(w)))
    out = tsmc.systematic_resample(p, generator=torch.Generator().manual_seed(0))
    counts = np.bincount(out.trajectories[:, 0, 0].long().numpy(), minlength=M)
    assert np.all(np.abs(counts - M * w) <= 1.0 + 1e-9)
    assert torch.allclose(out.log_weights, torch.full((M,), -np.log(M), dtype=torch.float64))


@pytest.mark.parametrize("scale,resamples", [(0.3, True), (50.0, False)])
def test_smc_step_matches_jax(scale, resamples):
    """One reweight step with JAX's offset: the same particles and ESS, and
    the resample taken exactly when ESS < E/2, from uniform weights."""
    pj, pt = _particles(spread=0.0)
    goal = np.array([1.0, 1.0])
    k = jax.random.PRNGKey(7)
    qj, ess_j = jsmc.smc_step(pj, jsmc.goal_likelihood(jnp.asarray(goal), scale), k)
    qt, ess_t = tsmc.smc_step(pt, tsmc.goal_likelihood(torch.as_tensor(goal), scale),
                              offset=torch.tensor(float(jax.random.uniform(k)),
                                                  dtype=torch.float64))
    np.testing.assert_allclose(ess_t.item(), float(ess_j), rtol=1e-10)
    assert (ess_t.item() < E / 2) == resamples
    _same(qt, qj)


def test_smc_step_draws_its_offset_from_the_generator():
    """Without an offset the step draws one from the generator every step,
    resampling or not: two runs from one seed agree, and the weights stay
    normalised."""
    runs = []
    for _ in range(2):
        _, p = _particles()
        gen = torch.Generator().manual_seed(4)
        ll = tsmc.goal_likelihood(torch.tensor([1.0, 1.0], dtype=torch.float64), 0.5)
        for _ in range(3):
            p, ess = tsmc.smc_step(p, ll, gen)
            assert 0 < ess.item() <= E
        runs.append(p)
    assert torch.equal(runs[0].trajectories, runs[1].trajectories)
    torch.testing.assert_close(torch.exp(runs[0].log_weights).sum(),
                               torch.tensor(1.0, dtype=torch.float64))


def test_clearance_likelihood_matches_jax():
    centers = np.array([[0.5, 0.0], [-1.0, 1.0]])

    def gamma(centers_, norm):
        return lambda traj: norm(traj[None, :, :] - centers_[:, None, :], axis=-1) ** 2

    trajs = np.random.default_rng(5).standard_normal((E, N, D))
    want = jsmc.clearance_likelihood(gamma(jnp.asarray(centers), jnp.linalg.norm),
                                     margin=0.05)(jnp.asarray(trajs))
    got = tsmc.clearance_likelihood(
        gamma(torch.as_tensor(centers), lambda x, axis: torch.linalg.vector_norm(x, dim=axis)),
        margin=0.05)(torch.as_tensor(trajs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert (got < 0).any() and (got == 0).any()


def _transport_case():
    rng = np.random.default_rng(8)
    S = rng.standard_normal((12, 2)) * 2.0
    R = np.array([[np.cos(0.4), -np.sin(0.4)], [np.sin(0.4), np.cos(0.4)]])
    S1 = S @ R.T + 0.5 + 0.05 * rng.standard_normal((12, 2))
    traj = np.cumsum(0.2 * rng.standard_normal((15, 2)), 0)
    jk = JK.Constant(2.0) * JK.RBF(jnp.asarray([1.5, 1.5])) + JK.White(0.01)
    return S, S1, traj, jk


def test_init_particles_matches_jax_on_jax_normals():
    """JAX's per-particle normals handed to the port: the same trajectories
    (float64, to 1e-9 of their size) and uniform weights."""
    S, S1, traj, jk = _transport_case()
    key = jax.random.PRNGKey(3)
    pj = jsmc.init_particles(jk, jnp.asarray(S), jnp.asarray(S1), jnp.asarray(traj), key, 32)
    eps = jax.vmap(lambda k: jax.random.normal(k, traj.shape, jnp.float64))(
        jax.random.split(key, 32))
    pt = tsmc.init_particles(kernel_from_tree(jk, device="cpu"), torch.as_tensor(S),
                             torch.as_tensor(S1), torch.as_tensor(traj), 32,
                             normals=torch.as_tensor(np.array(eps)))
    np.testing.assert_allclose(pt.trajectories.numpy(), np.asarray(pj.trajectories), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(pj.trajectories)).max())
    np.testing.assert_allclose(pt.log_weights.numpy(), np.asarray(pj.log_weights), rtol=TOL)


def test_init_particles_mean_and_covariance():
    """4096 draws from a generator: the sample mean of each point within
    4 standard errors of γ(traj) + the posterior mean, and the sample
    covariance of the first coordinate along the trajectory within 0.1 of
    the largest posterior variance of the analytic one (the port's
    posterior, whose draws the test above ties to JAX's)."""
    from gaussian_process_transportation_tpu_torch.models import affine, exact_gp
    from gaussian_process_transportation_tpu_torch.transport import gpt

    S, S1, traj, jk = _transport_case()
    tk = kernel_from_tree(jk, device="cpu")
    St, S1t, trajt = (torch.as_tensor(a) for a in (S, S1, traj))
    p = tsmc.init_particles(tk, St, S1t, trajt, 4096, torch.Generator().manual_seed(0))
    aff, gp = gpt.fit_pipeline(tk, St, S1t)
    pos = affine.predict(aff, trajt)
    mean, cov = exact_gp.predict_cov(gp, pos)
    x = p.trajectories
    se = torch.sqrt(torch.diagonal(cov))[:, None] / 64.0
    assert ((x.mean(0) - (pos + mean)).abs() <= 4 * se + 1e-12).all()
    x0 = x[:, :, 0] - x[:, :, 0].mean(0)
    emp = x0.T @ x0 / (x.shape[0] - 1)
    assert (emp - cov).abs().max() <= 0.1 * torch.diagonal(cov).max()
