"""Port parity: ``ops/assignment.py``, ``models/kmp.py``,
``models/laplacian_editing.py`` and the first part of
``transport/variants.py`` (the finite-difference Jacobian, the affine,
KMP and Laplacian-editing transports) against the JAX package's, float64
on the CPU: the assignments exactly, the rest to 1e-8."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.models import kmp as jkmp
from gaussian_process_transportation_tpu.models import laplacian_editing as jle
from gaussian_process_transportation_tpu.ops import assignment as jas
from gaussian_process_transportation_tpu.transport import variants as jvar
from gaussian_process_transportation_tpu_torch import transport as tvar
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.models import KMP, LaplacianEditing
from gaussian_process_transportation_tpu_torch.models import laplacian_editing as tle
from gaussian_process_transportation_tpu_torch.ops import assignment as tas

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _problem(closed=False):
    """A 60-point demo with velocities over a 12-point source set lifted,
    turned and scaled onto a curved target; ``closed`` makes the demo a
    loop (a cycle graph)."""
    t = np.linspace(0, 1, 60)
    if closed:
        X = np.stack([3 * np.cos(2 * np.pi * t), 2 * np.sin(2 * np.pi * t)], 1)[:-1]
    else:
        X = np.stack([10 * t, 3 + 2 * np.sin(3 * t)], 1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    s = np.linspace(0, 1, 12)
    S = X[np.linspace(0, len(X) - 1, 12).astype(int)] + 0.05 * np.stack([np.sin(7 * s), s], 1)
    R = np.array([[np.cos(0.3), -np.sin(0.3)], [np.sin(0.3), np.cos(0.3)]])
    S1 = 1.2 * S @ R.T + np.stack([0 * s + 1.0, 0.5 * np.sin(2 * s)], 1)
    return X, dX, S, S1


@pytest.mark.parametrize("n_rows,n_cols,seed", [(20, 20, 0), (30, 12, 1), (45, 45, 2)])
def test_assignments_match_jax_exactly(n_rows, n_cols, seed):
    """The distance matrix to 1e-12; scipy's assignment and the auction
    (ε-scaled, on the device) give JAX's indices exactly, and the auction
    finds the optimum here."""
    rng = np.random.default_rng(seed)
    A, B = rng.standard_normal((n_rows, 2)), rng.standard_normal((n_cols, 2))
    C = tas.distance_matrix(_t(A), _t(B))
    Cj = jas.distance_matrix(jnp.asarray(A), jnp.asarray(B))
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=1e-12, atol=1e-12)
    for got, want in zip(tas.linear_sum_assignment(C), jas.linear_sum_assignment(Cj)):
        np.testing.assert_array_equal(got, want)
    auction = tas.auction_assignment(C)
    np.testing.assert_array_equal(auction.numpy(), np.asarray(jas.auction_assignment(Cj)))
    rows, cols = tas.linear_sum_assignment(C)
    np.testing.assert_array_equal(auction.numpy()[cols], rows)
    with pytest.raises(ValueError, match="n_rows >= n_cols"):
        tas.auction_assignment(C[:3, :5] if n_cols >= 5 else C.T)


def test_match_waypoints_matches_jax():
    X, _, S, _ = _problem()
    for got, want in zip(tas.match_waypoints(_t(X), _t(S)), jas.match_waypoints(X, S)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("closed", [False, True], ids=["path", "cycle"])
def test_laplacian_editing_matches_jax(closed):
    X, _, S, S1 = _problem(closed)
    assert tle.is_cycle(_t(X)) == jle.is_cycle(jnp.asarray(X)) == closed
    _close(tle.graph_laplacian(len(X), closed), jle.graph_laplacian(len(X), closed))
    _close(tle.edit(_t(X), _t(S), _t(S1)), jle.edit(X, S, S1))
    got = LaplacianEditing().fit(_t(S), _t(S1), _t(X))
    want = jle.LaplacianEditing().fit(S, S1, X)
    for g, w in zip(got.predict(None, return_std=True), want.predict(None, return_std=True)):
        _close(g, w)
    _close(got.samples(None, n_samples=3), want.samples(None, n_samples=3))


def _kmp_kernel():
    return jkmp.default_kmp_kernel()


def test_kmp_matches_jax():
    """No restarts, so no random draw differs: the matched waypoints, the
    conditioned trajectory, its transportation std and the refitted time
    GP's prediction."""
    X, _, S, S1 = _problem()
    got = KMP(kernel_from_tree(_kmp_kernel(), device="cpu"), n_restarts=0, device="cpu")
    got.fit(_t(S), _t(S1), _t(X))
    want = jkmp.KMP(_kmp_kernel(), n_restarts=0).fit(S, S1, X)
    np.testing.assert_array_equal(got.mask_traj, want.mask_traj)
    assert got.periodic == want.periodic
    _close(got.training_traj, want.training_traj)
    for g, w in zip(got.predict(None, return_std=True), want.predict(None, return_std=True)):
        _close(g, w)
    draws = got.samples(None, n_samples=4)
    assert draws.shape == (4, len(X), 2) and torch.isfinite(draws).all()
    torch.testing.assert_close(draws, got.samples(None, n_samples=4))  # seeded


def test_default_kmp_kernel_is_jaxs():
    tk = tvar.variants.KMP(device="cpu").kernel
    np.testing.assert_allclose(tk.theta.numpy(), np.asarray(_kmp_kernel().theta), rtol=1e-15)
    np.testing.assert_allclose(tk.theta_bounds.numpy(), np.asarray(_kmp_kernel().theta_bounds),
                               rtol=1e-15)


def test_finite_difference_jacobian_matches_jax():
    X, _, _, _ = _problem()
    Xn = X + 0.1 * np.sin(X[:, ::-1])
    _close(tvar.finite_difference_jacobian(_t(Xn), _t(X)),
           jvar.finite_difference_jacobian(jnp.asarray(Xn), jnp.asarray(X)))


def _drive(tr, X, dX, S, S1):
    tr.source_distribution, tr.target_distribution = S, S1
    tr.training_traj, tr.training_delta = X, dX
    tr.fit_transportation()
    tr.apply_transportation()
    return tr


@pytest.mark.parametrize("name", ["AffineTransportation", "KMPTransport",
                                  "LaplacianEditingTransport"])
def test_variant_transports_match_jax(name):
    """The protocol on numpy attributes: the transported trajectory, its
    std, the pushed-forward velocities and the samples."""
    X, dX, S, S1 = _problem()
    kw_t, kw_j = dict(device="cpu"), {}
    if name == "KMPTransport":
        kw_t["kernel"], kw_j["kernel"] = kernel_from_tree(_kmp_kernel(), device="cpu"), _kmp_kernel()
    got, want = getattr(tvar, name)(**kw_t), getattr(jvar, name)(**kw_j)
    if name == "KMPTransport":  # no restarts, so no random draw differs
        got.transportation.n_restarts = want.transportation.n_restarts = 0
    _drive(got, X, dX, S, S1), _drive(want, X, dX, S, S1)
    for attr in ("training_traj", "std", "training_delta"):
        assert getattr(got, attr).device.type == "cpu"
        _close(getattr(got, attr), getattr(want, attr))
    if name != "KMPTransport":
        _close(got.sample_transportation(), want.sample_transportation())


def test_affine_transportation_turns_orientations_as_jax():
    X, dX, S, S1 = _problem()
    q = np.tile([1.0, 0.0, 0.0, 0.0], (len(X), 1))
    X3, S3, S13 = (np.concatenate([a, 0.1 * a[:, :1]], 1) for a in (X, S, S1))
    outs = []
    for tr in (tvar.AffineTransportation(device="cpu"), jvar.AffineTransportation()):
        tr.source_distribution, tr.target_distribution = S3, S13
        tr.training_traj, tr.training_ori = X3, q
        tr.fit_transportation(do_scale=True)
        tr.apply_transportation()
        outs.append((tr.training_traj, tr.training_ori))
    for g, w in zip(*outs):
        _close(g, w)
