"""Port parity: ``transport/heteroscedastic.py`` (the aleatoric GP and the
combined uncertainty field) and ``transport/diffeo.py`` (the
forward∘inverse residual and the sweep of the largest lengthscale bound)
against the JAX package's, float64 on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu.transport import diffeo as jdf
from gaussian_process_transportation_tpu.transport import heteroscedastic as jhs
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp
from gaussian_process_transportation_tpu_torch.transport import diffeo as tdf
from gaussian_process_transportation_tpu_torch.transport import heteroscedastic as ths

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _problem():
    """JAX's diffeo test problem (tests/test_active_diffeo.py): a 50-point
    demo over a 15-point floor lifted onto a curved one."""
    t = np.linspace(0, 1, 50)
    X = np.stack([10 * t, 3 + 2 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, 15)
    S = np.stack([10 * s, np.zeros_like(s)], 1)
    S1 = np.stack([10 * s, 1.5 + np.sin(2 * s)], 1)
    return X, S, S1


def test_default_uncertainty_kernel_is_jaxs():
    tk = ths.default_uncertainty_kernel(2, torch.float64, "cpu")
    jk = jhs.default_uncertainty_kernel(2)
    np.testing.assert_allclose(tk.theta.numpy(), np.asarray(jk.theta), rtol=1e-15)
    np.testing.assert_allclose(tk.theta_bounds.numpy(), np.asarray(jk.theta_bounds), rtol=1e-15)


def test_heteroscedastic_field_matches_jax():
    """The dynamics and aleatoric GPs conditioned at the same kernels: the
    velocity mean and both σ fields to 1e-8; the σ fields non-negative."""
    rng = np.random.default_rng(0)
    traj = np.cumsum(rng.standard_normal((40, 2)) * 0.3, 0)
    vel = np.gradient(traj, axis=0)
    var = 0.01 + 0.05 * rng.random((40, 2))
    q = traj[::3] + 0.1
    jk_dyn = JK.Constant(1.0) * JK.RBF(jnp.ones(2)) + JK.White(0.01)
    jk_alea = jhs.default_uncertainty_kernel(2)
    j_dyn = jgp.condition(jk_dyn, jnp.asarray(traj), jnp.asarray(vel))
    j_alea = jgp.condition(jk_alea, jnp.asarray(traj), jnp.sqrt(jnp.asarray(var)))
    t_dyn = tgp.condition(kernel_from_tree(jk_dyn, device="cpu"), _t(traj), _t(vel))
    t_alea = tgp.condition(kernel_from_tree(jk_alea, device="cpu"), _t(traj), _t(np.sqrt(var)))
    got = ths.heteroscedastic_field(t_dyn, t_alea, _t(q))
    want = jhs.heteroscedastic_field(j_dyn, j_alea, jnp.asarray(q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-10)
    assert (got[1] >= 0).all() and (got[2] >= 0).all() and (got[1] >= got[2]).all()


def test_fit_aleatoric_gp_matches_jax():
    """scipy's L-BFGS-B from the default kernel's θ (no restarts): the same
    fitted LML to 1e-8 of its magnitude."""
    rng = np.random.default_rng(1)
    traj = np.cumsum(rng.standard_normal((30, 2)) * 0.3, 0)
    var = 0.02 + 0.05 * np.sin(traj) ** 2
    gp_t = ths.fit_aleatoric_gp(_t(traj), _t(var), n_restarts=0)
    gp_j = jhs.fit_aleatoric_gp(jnp.asarray(traj), jnp.asarray(var), n_restarts=0)
    labels = np.sqrt(var)
    lml = [tgp.log_marginal_likelihood(gp_t.kernel, _t(traj), _t(labels)).item(),
           float(jgp.log_marginal_likelihood(gp_j.kernel, jnp.asarray(traj), jnp.asarray(labels)))]
    assert abs(lml[0] - lml[1]) <= 1e-8 * abs(lml[1]), lml


def _transports(kernel=None, **gp_kwargs):
    """The port's and JAX's diffeo transports of the problem, with the JAX
    ``kernel`` (converted for the port) or their defaults."""
    X, S, S1 = _problem()
    out = []
    for mod, kw in ((tdf, dict(device="cpu", kernel_transport=None if kernel is None else
                               kernel_from_tree(kernel, device="cpu"))),
                    (jdf, dict(kernel_transport=kernel))):
        tr = mod.GaussianProcessTransportationDiffeo(**kw, **gp_kwargs)
        tr.source_distribution, tr.target_distribution, tr.training_traj = S, S1, X
        out.append(tr)
    return out


def test_forward_inverse_residual_matches_jax():
    """With ``optimizer=None`` (the kernel as given): the residual to 1e-8,
    and the inverse-mapped trajectory too."""
    kj = JK.Constant(10.0) * JK.RBF(4.0 * jnp.ones(2)) + JK.White(0.0001)
    tt, tj = _transports(kj, optimizer=None)
    for tr in (tt, tj):
        tr.fit_transportation()
    got, want = tt.check_invertibility(), tj.check_invertibility()
    assert got == pytest.approx(want, rel=1e-8)
    np.testing.assert_allclose(tt.traj_rotated_inv.numpy(), np.asarray(tj.traj_rotated_inv),
                               rtol=1e-8, atol=1e-8)


def test_optimize_diffeomorphism_matches_jax():
    """Five candidates, each refit by scipy's L-BFGS-B without restarts: the
    same best bound, every candidate's residual to 1e-4 of its size (the two
    scipy runs part at rounding level on a flat optimum: 3.4e-6 at one
    candidate), and the transport refitted at the best one."""
    tt, tj = _transports(n_restarts_optimizer=0)
    best_t, best_j = tt.optimize_diffeomorphism(n_trials=5), tj.optimize_diffeomorphism(n_trials=5)
    assert best_t == best_j
    assert list(tt.diffeo_errors) == list(tj.diffeo_errors)
    np.testing.assert_allclose(list(tt.diffeo_errors.values()), list(tj.diffeo_errors.values()),
                               rtol=1e-4)
    assert tt.method.delta_map.kernel.k1.k2.bounds == (0.1, best_t)


def test_the_sweep_with_jit_fit_refits_through_fit_jit(monkeypatch):
    """``jit_fit=True`` in the GP's keywords: every refit is one fit_jit."""
    calls = []
    real = tgp.fit_jit
    monkeypatch.setattr(tgp, "fit_jit", lambda *a, **k: calls.append(1) or real(*a, **k))
    tt, _ = _transports(jit_fit=True, n_restarts_optimizer=1)
    tt.optimize_diffeomorphism(n_trials=3)
    assert len(calls) == 4 and tt.best_max_lengthscale in tt.diffeo_errors
    assert all(np.isfinite(list(tt.diffeo_errors.values())))


def test_save_and_load_distributions(tmp_path, capsys):
    X, S, S1 = _problem()
    tr = tdf.GaussianProcessTransportationDiffeo(optimizer=None, device="cpu")
    tr.source_distribution, tr.target_distribution = _t(S), S1
    tr.save_distributions(str(tmp_path))
    tr2 = tdf.GaussianProcessTransportationDiffeo(optimizer=None, device="cpu")
    tr2.load_distributions(str(tmp_path))
    np.testing.assert_array_equal(tr2.source_distribution, S)
    np.testing.assert_array_equal(tr2.target_distribution, S1)
    tr2.load_distributions(str(tmp_path / "none"))
    assert "No distributions saved" in capsys.readouterr().out
