"""Port parity: ``models/flows.py`` against the JAX package's, float64 on
the CPU to 1e-8, for both coupling-net kinds: the flow's forward map,
inverse and Jacobian, and the ensemble's training from JAX's own draws
(the initial layers and schedules recomputed with ``jax.random`` exactly as
JAX's fits draw them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.models import flows as jf
from gaussian_process_transportation_tpu_torch.convert import flow_layers_from_tree
from gaussian_process_transportation_tpu_torch.models import flows as tf

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)
E, BLOCKS, HIDDEN, EPOCHS, BATCH, SEED = 2, 2, 8, 3, 8, 4
KINDS = ("fcnn", "rffn")


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _layers(ls):
    return flow_layers_from_tree(ls, device="cpu")


def jax_schedule(key, N, epochs, batch_size):
    """The minibatch indices JAX's ``fit_flow`` draws from ``key``."""
    B = min(batch_size, N)
    per_epoch = max(N // B, 1)
    return jax.vmap(lambda k: jax.random.permutation(k, N)[: per_epoch * B].reshape(per_epoch, B))(
        jax.random.split(key, epochs)).reshape(-1, B)


@pytest.fixture(scope="module")
def fits():
    """For each kind: JAX's fitted two-member ensemble on a bent point set,
    the layers and schedules its fit drew, and queries."""
    rng = np.random.default_rng(1)
    X = 3.0 * rng.standard_normal((30, 2))
    Y = X + np.stack([np.sin(X[:, 1]), 0.3 * X[:, 0]], 1)
    out = {}
    for kind in KINDS:
        ens = jf.EnsembleBijectiveNetwork(X, Y, n_estimators=E, num_blocks=BLOCKS,
                                          num_hidden=HIDDEN, seed=SEED, kind=kind)
        init = ens.layers
        ens.fit(num_epochs=EPOCHS, batch_size=BATCH)
        sched = jax.vmap(lambda k: jax_schedule(k, 30, EPOCHS, BATCH))(
            jax.random.split(jax.random.PRNGKey(SEED + 1), E))
        out[kind] = dict(ens=ens, init=init, sched=sched)
    return dict(X=X, Y=Y, xq=3.0 * rng.standard_normal((7, 2)), **out)


@pytest.mark.parametrize("kind", KINDS)
def test_train_from_jax_draws_is_jaxs_ensemble_fit(fits, kind):
    """Adam on the Huber loss, both members at once, equals JAX's vmapped
    fit; an rffn's coefficients and offsets stay where they started."""
    ens = fits[kind]["ens"]
    got, losses = tf.train_flow(_layers(fits[kind]["init"]), _t(ens._norm(fits["X"])),
                                _t(ens._norm(fits["Y"])),
                                torch.as_tensor(np.array(fits[kind]["sched"])))
    assert losses.shape == (EPOCHS * (30 // BATCH), E)
    for p, pj, p0 in zip(got, ens.layers, _layers(fits[kind]["init"])):
        for net, netj, net0 in zip(p, pj, p0):
            for (W, b), (Wj, bj) in zip(net.layers, netj.layers):
                _close(W, Wj), _close(b, bj)
            if kind == "rffn":
                assert all(torch.equal(a, c) for a, c in zip(net.layers[0], net0.layers[0]))


@pytest.mark.parametrize("kind", KINDS)
def test_forward_inverse_and_jacobian_match_jax(fits, kind):
    """One trained member's Φ, Φ⁻¹ and exact Jacobian, and the stacked
    members' at once."""
    jl = fits[kind]["ens"].layers
    xq = fits["xq"] / 3.0
    one_j = jax.tree_util.tree_map(lambda a: a[0], jl)
    for tl, jlayers, lead in ((_layers(one_j), one_j, False), (_layers(jl), jl, True)):
        fwd, inv, jac = (jax.jit(jax.vmap(f) if lead else f) for f in (
            lambda ls: jf.flow_forward(ls, jnp.asarray(xq)),
            lambda ls: jf.flow_inverse(ls, jnp.asarray(xq)),
            lambda ls: jf.flow_jacobian(ls, jnp.asarray(xq))))
        _close(tf.flow_forward(tl, _t(xq)), fwd(jlayers))
        _close(tf.flow_inverse(tl, _t(xq)), inv(jlayers))
        _close(tf.flow_jacobian(tl, _t(xq)), jac(jlayers))
        _close(tf.flow_inverse(tl, tf.flow_forward(tl, _t(xq))),
               np.broadcast_to(xq, fwd(jlayers).shape))


@pytest.mark.parametrize("kind", KINDS)
def test_ensemble_wrapper_matches_jax_with_ddof_zero(fits, kind):
    """The ensemble's standardiser, mean and std of Φ (ddof 0), mean and
    variance of J_Φ = diag(sd) J diag(1/sd) (ddof 0) and its samples."""
    ens = fits[kind]["ens"]
    got = tf.EnsembleBijectiveNetwork(fits["X"], fits["Y"], n_estimators=E, num_blocks=BLOCKS,
                                      num_hidden=HIDDEN, kind=kind, device="cpu")
    _close(got.mu, ens.mu), _close(got.sd, ens.sd)
    got.layers = _layers(ens.layers)
    xq = fits["xq"]
    for g, w in zip((*got.predict(xq, return_std=True), *got.derivative(xq, return_var=True),
                     got.samples(xq)),
                    (*ens.predict(xq, return_std=True), *ens.derivative(xq, return_var=True),
                     ens.samples(xq))):
        _close(g, w)
    members = got.samples(xq).numpy()
    np.testing.assert_allclose(got.predict(xq, return_std=True)[1].numpy(),
                               members.std(0, ddof=0), rtol=1e-12)


def test_single_flow_wrapper_matches_jax(fits):
    """BijectiveNetwork from JAX's layers: predict, inverse and derivative."""
    X, Y, xq = fits["X"], fits["Y"], fits["xq"]
    want = jf.BijectiveNetwork(X, Y, num_blocks=BLOCKS, num_hidden=HIDDEN)
    want.layers = jax.tree_util.tree_map(lambda a: a[1], fits["fcnn"]["ens"].layers)
    got = tf.BijectiveNetwork(X, Y, num_blocks=BLOCKS, num_hidden=HIDDEN, device="cpu")
    got.layers = _layers(want.layers)
    _close(got.predict(xq), want.predict(xq))
    _close(got.inverse(xq), want.inverse(xq))
    _close(got.derivative(xq), want.derivative(xq))


def test_fits_are_seeded_and_start_at_identity(fits):
    """The port's own fit: its flow is the identity before training, the
    same seed gives the same layers, and the fit moves the flow."""
    X, Y = fits["X"], fits["Y"]
    nets = [tf.EnsembleBijectiveNetwork(X, Y, n_estimators=2, num_blocks=2, num_hidden=8, seed=3,
                                        device="cpu") for _ in range(2)]
    torch.testing.assert_close(nets[0].samples(X), _t(X).expand(2, -1, -1), rtol=0, atol=1e-12)
    for net in nets:
        net.fit(num_epochs=2)
    a, b = nets[0].samples(X), nets[1].samples(X)
    assert torch.equal(a, b) and not torch.allclose(a, _t(X).expand(2, -1, -1))
