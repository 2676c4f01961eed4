"""Port parity: ``models/mlp.py`` against the JAX package's, float64 on the
CPU to 1e-8.  The training runs from JAX's own draws: the test recomputes
the initial parameters and minibatch schedules with ``jax.random`` exactly
as JAX's fits draw them, and the port's deterministic ``train`` runs on
them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.models import mlp as jm
from gaussian_process_transportation_tpu_torch.convert import mlp_params_from_tree
from gaussian_process_transportation_tpu_torch.models import mlp as tm

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)
HIDDEN, E, EPOCHS, BATCH = (16, 16), 3, 3, 8


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _params(p):
    return mlp_params_from_tree(p, device="cpu")


def jax_schedule(key, N, epochs, batch_size):
    """The minibatch indices JAX's ``fit_params`` draws from ``key``."""
    B = min(batch_size, N)
    per_epoch = max(N // B, 1)
    return jax.vmap(lambda k: jax.random.permutation(k, N)[: per_epoch * B].reshape(per_epoch, B))(
        jax.random.split(key, epochs)).reshape(-1, B)


@pytest.fixture(scope="module")
def problem():
    """Data, JAX's fitted ensemble and single net, and the draws each fit
    made (initial parameters, schedules)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((40, 2))
    Y = np.stack([np.sin(X[:, 0]), X[:, 0] * X[:, 1]], 1)
    sizes = (2,) + HIDDEN + (2,)
    ens = jm.EnsembleMLP(n_estimators=E, hidden=HIDDEN, seed=5).fit(
        X, Y, num_epochs=EPOCHS, batch_size=BATCH)
    ens_p0 = jax.vmap(lambda k: jm.init_params(k, sizes))(
        jax.random.split(jax.random.PRNGKey(5), E))
    ens_sched = jax.vmap(lambda k: jax_schedule(k, 40, EPOCHS, BATCH))(
        jax.random.split(jax.random.PRNGKey(6), E))
    one = jm.MLP(hidden=HIDDEN, seed=2).fit(X, Y, num_epochs=EPOCHS, batch_size=BATCH)
    one_p0 = jm.init_params(jax.random.PRNGKey(2), sizes)
    one_sched = jax_schedule(jax.random.PRNGKey(3), 40, EPOCHS, BATCH)
    xq = rng.standard_normal((9, 2))
    return dict(X=X, Y=Y, xq=xq, ens=ens, ens_p0=ens_p0, ens_sched=ens_sched, one=one,
                one_p0=one_p0, one_sched=one_sched)


def test_train_from_jax_draws_is_jaxs_ensemble_fit(problem):
    """Three members trained together, each on its own schedule, equal
    JAX's vmapped AdamW fit entry by entry."""
    got, losses = tm.train(_params(problem["ens_p0"]), _t(problem["X"]), _t(problem["Y"]),
                           torch.as_tensor(np.array(problem["ens_sched"])))
    assert losses.shape == (EPOCHS * (40 // BATCH), E)
    for (W, b), (Wj, bj) in zip(got, problem["ens"].params):
        _close(W, Wj), _close(b, bj)


def test_train_from_jax_draws_is_jaxs_single_fit(problem):
    got, _ = tm.train(_params(problem["one_p0"]), _t(problem["X"]), _t(problem["Y"]),
                      torch.as_tensor(np.array(problem["one_sched"])))
    for (W, b), (Wj, bj) in zip(got, problem["one"].params):
        _close(W, Wj), _close(b, bj)


@pytest.mark.parametrize("which", ["one", "ens"])
def test_apply_and_jacobian_match_jax(problem, which):
    """The forward pass and the closed-form ReLU-chain Jacobian against
    JAX's apply and jacfwd, for one net and for stacked members."""
    jparams = problem[which].params
    params, xq = _params(jparams), problem["xq"]
    if which == "one":
        want_y, want_J = jm.apply(jparams, xq), jm.jacobian_fn(jparams, jnp.asarray(xq))
    else:
        want_y = jax.vmap(lambda p: jm.apply(p, xq))(jparams)
        want_J = jax.vmap(lambda p: jm.jacobian_fn(p, jnp.asarray(xq)))(jparams)
    _close(tm.apply(params, _t(xq)), want_y)
    _close(tm.jacobian_fn(params, _t(xq)), want_J)


def test_wrappers_match_jax_and_pin_ddof_zero(problem):
    """EnsembleMLP's std and Jacobian variance are over the members with
    ddof 0 (jnp's default, not torch's); its samples are the members'
    predictions; MLP's std and variance are zero and its samples repeat."""
    xq = problem["xq"]
    ens = tm.EnsembleMLP(n_estimators=E, hidden=HIDDEN, device="cpu")
    ens.params = _params(problem["ens"].params)
    mean, std = ens.predict(xq, return_std=True)
    Jm, Jv = ens.derivative(xq, return_var=True)
    for got, want in zip((mean, std, Jm, Jv),
                         (*problem["ens"].predict(xq, return_std=True),
                          *problem["ens"].derivative(xq, return_var=True))):
        _close(got, want)
    members = ens.samples(xq).numpy()
    assert members.shape == (E, 9, 2)
    np.testing.assert_allclose(std.numpy(), members.std(0, ddof=0), rtol=1e-12)
    assert not np.allclose(std.numpy(), members.std(0, ddof=1))
    Js = tm.jacobian_fn(ens.params, _t(xq)).numpy()
    np.testing.assert_allclose(Jv.numpy(), Js.var(0, ddof=0), rtol=1e-12, atol=1e-15)
    one = tm.MLP(hidden=HIDDEN, device="cpu")
    one.params = _params(problem["one"].params)
    y, s = one.predict(xq, return_std=True)
    _close(y, problem["one"].predict(xq))
    assert not s.any() and not one.derivative(xq, return_var=True)[1].any()
    draws = one.samples(xq, n_samples=4)
    assert draws.shape == (4, 9, 2) and all(torch.equal(d, y) for d in draws)


def test_fits_are_seeded_on_the_cpu_generator(problem):
    """The port's own fits: the same seed gives the same parameters, the
    ensemble's members differ, and a 1-D target is a column."""
    X, Y = problem["X"], problem["Y"]
    fits = [tm.EnsembleMLP(n_estimators=2, hidden=(8,), seed=1, device="cpu").fit(
        X, Y, num_epochs=2) for _ in range(2)]
    for (a, _), (b, _) in zip(fits[0].params, fits[1].params):
        assert torch.equal(a, b)
    assert not torch.equal(fits[0].params[0][0][0], fits[0].params[0][0][1])
    one = tm.MLP(hidden=(8,), device="cpu").fit(X, Y[:, 0], num_epochs=2)
    assert one.predict(X).shape == (40, 1) and one.derivative(X).shape == (40, 1, 2)
