"""The port's sharded transport ensemble, joint training step and
posterior ensemble (parallel/ensemble.py) on gloo ranks against the JAX
package's and against the port in one process.

Four ranks run every case once (a module fixture): ``ens`` has 2 or 4 of
them on (2, 2) and (4, 1) meshes; E = 64 targets, Q = 400, n = 20."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import affine as jaffine
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu.parallel.ensemble import make_ensemble_train_step
from gaussian_process_transportation_tpu.transport import gpt as jgpt
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.parallel import _launch, _programs
from gaussian_process_transportation_tpu_torch.parallel.ensemble import (
    posterior_transport_ensemble,
)
from gaussian_process_transportation_tpu_torch.transport import gpt as tgpt

torch.set_num_threads(1)

E, Q, N_DIST, WORLD, STEPS, MEMBERS, SEED = 64, 400, 20, 4, 3, 4096, 5
ENS = (2, 4)
FIELDS = ("traj", "std", "delta", "delta_var", "min_abs_det")
TOL = 1e-9  # the port's transport tolerance against JAX (tests/test_torch_transport.py)


def _problem():
    t = np.linspace(0, 1, Q)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    s = np.linspace(0, 1, N_DIST)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)
    targets = S1[None] + np.linspace(0.0, 1.0, E)[:, None, None]
    return X, dX, S, S1, targets


def _jax_kernel():
    return JK.Constant(10.0) * JK.RBF(4.0 * jnp.ones(2)) + JK.White(0.01)


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


@pytest.fixture(scope="module")
def jax_refs():
    X, dX, S, S1, targets = _problem()
    jk = _jax_kernel()
    res = jgpt.fit_and_transport_batched(jk, jnp.asarray(S), jnp.asarray(targets),
                                         jnp.asarray(X), jnp.asarray(dX))
    step, optimizer = make_ensemble_train_step(jk)
    theta, state = jk.theta, optimizer.init(jk.theta)
    sources = jnp.broadcast_to(jnp.asarray(S), targets.shape)
    thetas, losses = [], []
    for _ in range(STEPS):
        theta, state, loss = step(theta, state, sources, jnp.asarray(targets))
        thetas.append(np.asarray(theta))
        losses.append(float(loss))
    aff, gp = jgpt.fit_pipeline(jk, jnp.asarray(S), jnp.asarray(S1))
    pos = jaffine.predict(aff, jnp.asarray(X))
    mean, cov = jgp.predict_cov(gp, pos)
    return dict(transport={f: np.asarray(getattr(res, f)) for f in FIELDS},
                thetas=np.stack(thetas), losses=np.array(losses),
                post_mean=np.asarray(pos + mean), post_sd=np.sqrt(np.clip(np.diag(cov), 0, None)))


@pytest.fixture(scope="module")
def ranks():
    X, dX, S, S1, targets = _problem()
    kernel = kernel_from_tree(_jax_kernel(), device="cpu")
    return _launch.launch(_programs.ensemble_cases,
                          (kernel, _t(S), _t(S1), _t(targets), _t(X), _t(dX), ENS, STEPS,
                           MEMBERS, SEED), nprocs=WORLD)


@pytest.mark.parametrize("n_ens", ENS)
def test_transport_ensemble_matches_jax_and_the_unsharded_call(ranks, jax_refs, n_ens):
    """Every field within 1e-9 of JAX's ``fit_and_transport_batched`` and,
    on every rank, bit for bit the port's unsharded call."""
    X, dX, S, S1, targets = _problem()
    kernel = kernel_from_tree(_jax_kernel(), device="cpu")
    one = tgpt.fit_and_transport_batched(kernel, _t(S), _t(targets), _t(X), _t(dX))
    for out in ranks:
        res = out[n_ens]["transport"]
        for f in FIELDS:
            assert torch.equal(getattr(res, f), getattr(one, f)), f
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ranks[0][n_ens]["transport"], f).numpy(),
                                   jax_refs["transport"][f], rtol=TOL, atol=TOL, err_msg=f)


@pytest.mark.parametrize("n_ens", ENS)
def test_train_steps_match_optax(ranks, jax_refs, n_ens):
    """Three joint Adam steps: θ and the loss within 1e-9 (relative) of
    JAX's ``make_ensemble_train_step`` with ``optax.adam(1e-2)``, and θ the
    same bits on every rank."""
    for out in ranks[1:]:
        assert torch.equal(out[n_ens]["thetas"], ranks[0][n_ens]["thetas"])
    got = ranks[0][n_ens]
    np.testing.assert_allclose(got["thetas"].numpy(), jax_refs["thetas"], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got["losses"].numpy(), jax_refs["losses"], rtol=1e-9, atol=0)


@pytest.mark.parametrize("n_ens", ENS)
def test_posterior_ensemble_is_the_one_rank_draw(ranks, jax_refs, n_ens):
    """D ranks draw bit for bit what one process draws from the same seed,
    and the mean of 4,096 members lies within 4 standard errors of JAX's
    posterior mean along γ(X)."""
    X, dX, S, S1, targets = _problem()
    kernel = kernel_from_tree(_jax_kernel(), device="cpu")
    one = posterior_transport_ensemble(kernel, _t(S), _t(S1), _t(X), MEMBERS,
                                       torch.Generator().manual_seed(SEED))
    for out in ranks:
        assert torch.equal(out[n_ens]["posterior"], one)
    dev = np.abs(one.mean(0).numpy() - jax_refs["post_mean"])
    assert (dev <= 4 * jax_refs["post_sd"][:, None] / np.sqrt(MEMBERS) + 1e-9).all()
