"""Port parity: ``ops/assignment.py``, ``models/kmp.py``,
``models/laplacian_editing.py`` and ``transport/variants.py`` (the
finite-difference Jacobian, the affine, KMP and Laplacian-editing
transports, and the eight transports on learned delta maps, their fitted
models carried across from JAX's through ``convert.py``) against the JAX
package's, float64 on the CPU: the assignments exactly, the rest to 1e-8."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.models import kmp as jkmp
from gaussian_process_transportation_tpu.models import laplacian_editing as jle
from gaussian_process_transportation_tpu.ops import assignment as jas
from gaussian_process_transportation_tpu.transport import variants as jvar
from gaussian_process_transportation_tpu_torch import transport as tvar
from gaussian_process_transportation_tpu_torch import convert
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


# The learned-map transports at narrow settings: (constructor keywords,
# fit_transportation keywords), the same for both packages.
LEARNED = {
    "MLPTransport": (dict(n_estimators=2, num_epochs=1), {}),
    "RandomForestTransport": (dict(n_estimators=5, max_depth=3), {}),
    "NeuralTransport": (dict(hidden=(16, 16)), dict(num_epochs=2)),
    "EnsembleNeuralTransport": (dict(n_estimators=2), dict(num_epochs=1)),
    "BijectiveTransport": (dict(num_blocks=2, num_hidden=8), dict(num_epochs=2)),
    "EnsembleBijectiveTransport": (dict(n_estimators=2, num_blocks=2, num_hidden=8),
                                   dict(num_epochs=2)),
    "GMRTransport": (dict(n_components=3, n_iter=5), {}),
    "SVGPTransport": ({}, dict(num_epochs=2, num_inducing=8)),
}


def _carry_model(name, got, want):
    """Put JAX's fitted model into the port's transport through convert.py."""
    cpu = dict(device="cpu")
    if name in ("MLPTransport", "NeuralTransport", "EnsembleNeuralTransport"):
        got.delta_map.params = convert.mlp_params_from_tree(want.delta_map.params, **cpu)
    elif name == "RandomForestTransport":
        # carried too: the fit on the same data is JAX's bit for bit
        # (test_torch_random_forest.py), but the aligned sources the two fit
        # differ in their last bits (the Kabsch SVD), which can flip a
        # near-tied split
        got.delta_map.params = convert.forest_params_from_numpy(want.delta_map.params, **cpu)
    elif name in ("BijectiveTransport", "EnsembleBijectiveTransport"):
        got.model.layers = convert.flow_layers_from_tree(want.model.layers, **cpu)
    elif name == "GMRTransport":
        got.gmr.conditional = convert.conditional_from_numpy(want.gmr.conditional, **cpu)
    else:
        got.gp_delta_map.collapsed = convert.collapsed_svgp_from_tree(
            want.gp_delta_map.collapsed, **cpu)


def _fit_both(name, X, dX, S, S1, extra=None):
    kw, fit_kw = LEARNED[name]
    got, want = getattr(tvar, name)(device="cpu", **kw), getattr(jvar, name)(**kw)
    for tr in (got, want):
        tr.source_distribution, tr.target_distribution = S, S1
        tr.training_traj, tr.training_delta = X, dX
        for attr, value in (extra or {}).items():
            setattr(tr, attr, value)
        tr.fit_transportation(**fit_kw)
    _carry_model(name, got, want)
    got.apply_transportation(), want.apply_transportation()
    return got, want


@pytest.mark.parametrize("name", list(LEARNED))
def test_learned_transports_match_jax(name):
    """The protocol on numpy attributes with JAX's fitted model carried
    across: the transported trajectory, its std, the velocities and their
    variance where the transport has one; the samples have JAX's shape.
    The SVGP transport runs in 3-D with orientations, which it turns by
    the closest rotation to I + J_Ψ after the affine rotation."""
    X, dX, S, S1 = _problem()
    extra = None
    if name == "SVGPTransport":
        X, dX, S, S1 = (np.concatenate([a, 0.2 * np.sin(a[:, :1])], 1) for a in (X, dX, S, S1))
        extra = dict(training_ori=np.tile([np.cos(0.2), 0.0, np.sin(0.2), 0.0], (len(X), 1)))
    got, want = _fit_both(name, X, dX, S, S1, extra)
    attrs = ["training_traj", "std", "training_delta"] + list(extra or ())
    assert hasattr(got, "var_vel_transported") == hasattr(want, "var_vel_transported")
    if hasattr(want, "var_vel_transported"):
        attrs.append("var_vel_transported")
    for attr in attrs:
        assert getattr(got, attr).device.type == "cpu"
        _close(getattr(got, attr), getattr(want, attr))
    if extra:
        np.testing.assert_allclose(torch.linalg.norm(got.training_ori, dim=1).numpy(), 1.0,
                                   atol=1e-12)
    draws = got.sample_transportation()
    assert draws.shape == want.sample_transportation().shape and torch.isfinite(draws).all()


def test_svgp_transport_converts_other_distributions_through_its_hook():
    """Distributions that are not arrays go through the sensor hook, and
    two of different types are refused."""
    X, dX, S, S1 = _problem()

    class Sensor(tvar.SVGPTransport):
        def convert_distribution_to_array(self):
            self.source_distribution = np.asarray(self.source_distribution)
            self.target_distribution = np.asarray(self.target_distribution)

    tr = Sensor(device="cpu")
    tr.source_distribution, tr.target_distribution = S.tolist(), S1.tolist()
    tr.fit_transportation(num_epochs=1, num_inducing=4)
    assert isinstance(tr.source_distribution, np.ndarray)
    tr.source_distribution = tuple(S.tolist())
    with pytest.raises(TypeError, match="arrays"):
        tr.fit_transportation(num_epochs=1)
