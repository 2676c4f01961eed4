"""Port parity: the transport pipeline (``transport/gpt.py``) against JAX
on the bench's synthetic 2-D workload and a 3-D workload with
orientations, float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.transport import gpt as jgpt
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.ops import batched_linalg as tbl
from gaussian_process_transportation_tpu_torch.transport import gpt as tgpt

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = 1e-9  # the JAX package's own batched-vs-vmapped tolerance
FIELDS = ("traj", "std", "delta", "delta_var", "min_abs_det", "ori")


def _workload_2d(n_traj=120, n_dist=20):
    """The synthetic branch of the bench workload, float64."""
    t = np.linspace(0, 1, n_traj)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, n_dist)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return X, dX, S, S1


def _workload_3d(n_traj=40, n_dist=20, E=3):
    rng = np.random.default_rng(2)
    t = np.linspace(0, 1, n_traj)
    X = np.stack([4 * t, np.sin(3 * t), 0.5 * np.cos(2 * t)], 1)
    s = np.linspace(0, 1, n_dist)
    S = np.stack([4 * s, np.sin(4 * s), np.cos(3 * s)], 1)  # not collinear
    targets = S[None] + 0.2 * rng.standard_normal((E, n_dist, 3)) + np.array([0.3, -0.2, 0.5])
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    ori = rng.standard_normal((n_traj, 4))
    ori /= np.linalg.norm(ori, axis=1, keepdims=True)
    return X, dX, S, targets, ori


def _jax_kernel(d, amp=10.0, ls=4.0, noise=0.01):
    return JK.Constant(amp) * JK.RBF(ls * jnp.ones(d)) + JK.White(noise)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _assert_result(got, want, fields=FIELDS, tol=TOL):
    for name in fields:
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == tuple(np.shape(w)), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def case_2d():
    X, dX, S, S1 = _workload_2d()
    E = 5
    targets = S1[None] + np.linspace(0.0, 1.0, E)[:, None, None]
    jk = _jax_kernel(2)
    want = jgpt.fit_and_transport_batched(jk, jnp.asarray(S), jnp.asarray(targets),
                                          jnp.asarray(X), jnp.asarray(dX))
    want_one = jgpt.fit_and_transport(jk, jnp.asarray(S), jnp.asarray(targets[1]),
                                      jnp.asarray(X), jnp.asarray(dX))
    args = (kernel_from_tree(jk, device="cpu"), _t(S), _t(targets), _t(X), _t(dX))
    return args, want, want_one


def test_fit_and_transport_matches_jax(case_2d):
    (kern, S, targets, X, dX), _, want_one = case_2d
    got = tgpt.fit_and_transport(kern, S, targets[1], X, dX)
    _assert_result(got, want_one)


def test_fit_and_transport_batched_matches_jax(case_2d, monkeypatch):
    monkeypatch.setattr(tbl.spd_inverse_elast_fused, "launches", 0)
    args, want, _ = case_2d
    got = tgpt.fit_and_transport_batched(*args)
    _assert_result(got, want)
    assert tbl.spd_inverse_elast_fused.launches == 0  # CPU tensors take the twin


def test_batched_matches_own_per_member_path(case_2d):
    kern, S, targets, X, dX = case_2d[0]
    got = tgpt.fit_and_transport_batched(kern, S, targets, X, dX)
    for e in range(targets.shape[0]):
        one = tgpt.fit_and_transport(kern, S, targets[e], X, dX)
        for name in FIELDS[:5]:
            torch.testing.assert_close(getattr(got, name)[e], getattr(one, name),
                                       rtol=TOL, atol=TOL, msg=name)


def test_batched_with_scale_matches_jax():
    X, dX, S, S1 = _workload_2d(n_traj=50, n_dist=12)
    targets = 1.2 * S1[None] + np.linspace(0.0, 1.0, 3)[:, None, None]
    jk = _jax_kernel(2, amp=1.0, ls=2.0)
    want = jgpt.fit_and_transport_batched(jk, jnp.asarray(S), jnp.asarray(targets),
                                          jnp.asarray(X), jnp.asarray(dX), do_scale=True)
    got = tgpt.fit_and_transport_batched(kernel_from_tree(jk, device="cpu"), _t(S), _t(targets),
                                         _t(X), _t(dX), do_scale=True)
    _assert_result(got, want)


def test_3d_with_orientation_matches_jax():
    X, dX, S, targets, ori = _workload_3d()
    jk = _jax_kernel(3, amp=1.0, ls=1.5, noise=1e-3)
    want = jgpt.fit_and_transport_batched(jk, jnp.asarray(S), jnp.asarray(targets),
                                          jnp.asarray(X), jnp.asarray(dX), ori=jnp.asarray(ori))
    got = tgpt.fit_and_transport_batched(kernel_from_tree(jk, device="cpu"), _t(S), _t(targets),
                                         _t(X), _t(dX), ori=_t(ori))
    assert got.ori.shape == (targets.shape[0], X.shape[0], 4)
    _assert_result(got, want)


def test_orientation_needs_a_3d_map(case_2d):
    kern, S, targets, X, dX = case_2d[0]
    with pytest.raises(ValueError, match="3-D"):
        tgpt.fit_and_transport(kern, S, targets[0], X, dX, ori=_t(np.ones((X.shape[0], 4))))


def test_n80_per_member_branch_matches_jax():
    t = np.linspace(0, 1, 80)
    S = np.stack([t * 10, np.sin(t)], axis=1)
    targets = S[None] + np.array([0.5, 1.0])[:, None, None]
    X = S + 0.1
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    jk = JK.Constant(1.0) * JK.RBF(2.0 * jnp.ones(2)) + JK.White(0.01)
    want = jgpt.fit_and_transport_batched(jk, jnp.asarray(S), jnp.asarray(targets),
                                          jnp.asarray(X), jnp.asarray(dX))
    got = tgpt.fit_and_transport_batched(kernel_from_tree(jk, device="cpu"), _t(S), _t(targets),
                                         _t(X), _t(dX))
    assert got.min_abs_det.shape == (2,)
    _assert_result(got, want)


def _members_case(n, Q=30):
    rng = np.random.default_rng(3)
    S = 2.0 * rng.standard_normal((n, 3))
    targets = S[None] + np.array([0.0, 1.0])[:, None, None] + 0.05 * rng.standard_normal((2, n, 3))
    X = 2.0 * rng.standard_normal((Q, 3))
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return S, targets, X, dX


def test_members_below_the_blocked_threshold_take_the_dense_path(monkeypatch):
    """64 < n < BLOCKED_MIN_N: one by one through the dense path (the
    faster one there on the card), no blocked factor."""
    S, targets, X, dX = _members_case(800)
    kern = kernel_from_tree(_jax_kernel(3, amp=2.0, ls=2.0), device="cpu")
    monkeypatch.setattr(tgpt.gp_core, "condition_blocked",
                        lambda *a, **k: pytest.fail("condition_blocked below BLOCKED_MIN_N"))
    got = tgpt.fit_and_transport_batched(kern, _t(S), _t(targets), _t(X), _t(dX))
    one = tgpt.fit_and_transport(kern, _t(S), _t(targets[1]), _t(X), _t(dX))
    for name in FIELDS[:5]:
        torch.testing.assert_close(getattr(got, name)[1], getattr(one, name), rtol=0, atol=0,
                                   msg=name)


def test_large_members_go_through_the_blocked_factor_like_the_dense_path(monkeypatch):
    """n >= BLOCKED_MIN_N with a stationary kernel: per member,
    condition_blocked and transport_apply without K⁻¹, equal to the dense
    per-member path."""
    from gaussian_process_transportation_tpu_torch.ops import blocked_chol as tbc

    S, targets, X, dX = _members_case(tgpt.BLOCKED_MIN_N)
    kern = kernel_from_tree(_jax_kernel(3, amp=2.0, ls=2.0), device="cpu")
    seen = []
    real = tgpt.gp_core.condition_blocked
    monkeypatch.setattr(tgpt.gp_core, "condition_blocked",
                        lambda *a, **k: seen.append(k["block"]) or real(*a, **k))
    got = tgpt.fit_and_transport_batched(kern, _t(S), _t(targets), _t(X), _t(dX))
    assert seen == [tgpt.BLOCKED_PANEL] * 2 and tbc.factor_panel.launches == 0
    for e in range(2):
        one = tgpt.fit_and_transport(kern, _t(S), _t(targets[e]), _t(X), _t(dX))
        for name in FIELDS[:5]:
            torch.testing.assert_close(getattr(got, name)[e], getattr(one, name),
                                       rtol=1e-8, atol=1e-8, msg=name)


def _blocked_case():
    """The JAX package's blocked transport case (test_blocked_chol.py:254)."""
    rng = np.random.default_rng(4)
    S = rng.standard_normal((200, 2))
    S1 = S + 0.3 * rng.standard_normal((200, 2))
    traj = rng.standard_normal((50, 2))
    delta = 0.1 * rng.standard_normal((50, 2))
    return S, S1, traj, delta, _jax_kernel(2, amp=2.0, ls=1.0, noise=0.05)


def test_transport_apply_with_blocked_gp_matches_dense():
    from gaussian_process_transportation_tpu_torch.models import affine as taff
    from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp

    S, S1, traj, delta, jk = _blocked_case()
    kern = kernel_from_tree(jk, device="cpu")
    aff = taff.fit(_t(S), _t(S1))
    src = taff.predict(aff, _t(S))
    gp_b = tgp.condition_blocked(kern, src, _t(S1) - src, block=128)
    gp_d = tgp.condition(kern, src, _t(S1) - src, cache_k_inv=True)
    got = tgpt.transport_apply(aff, gp_b, _t(traj), _t(delta))
    want = tgpt.transport_apply(aff, gp_d, _t(traj), _t(delta))
    for name in FIELDS[:5]:
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-8, atol=1e-8, msg=name)


def test_transport_apply_with_blocked_gp_matches_jax():
    """float32, the JAX package's blocked-vs-dense bound (2e-3)."""
    from gaussian_process_transportation_tpu.models import affine as jaff
    from gaussian_process_transportation_tpu.models import exact_gp as jgp
    from gaussian_process_transportation_tpu_torch.convert import affine_from_numpy
    from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp

    S, S1, traj, delta, jk = _blocked_case()
    f = lambda a: jnp.asarray(a, jnp.float32)
    aff = jaff.fit(f(S), f(S1))
    src = jaff.predict(aff, f(S))
    jg = jgp.condition_blocked(jk, src, f(S1) - src, block=128, interpret=True)
    want = jgpt.transport_apply(aff, jg, f(traj), f(delta))
    t32 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32)
    taff = affine_from_numpy({k: np.asarray(getattr(aff, k)) for k in (
        "rotation", "scale", "source_centroid", "target_centroid")}, torch.float32, "cpu")
    tg = tgp.condition_blocked(kernel_from_tree(jk, torch.float32, "cpu"), t32(src),
                               t32(np.asarray(f(S1) - src)), block=128)
    got = tgpt.transport_apply(taff, tg, t32(traj), t32(delta))
    for name in ("traj", "std", "delta", "delta_var"):
        assert np.abs(getattr(got, name).numpy() - np.asarray(getattr(want, name))).max() < 2e-3


def test_transport_apply_carried_blocked_state_matches_jax():
    """convert.exact_gp_from_numpy with a JAX condition_blocked factor: the
    same transport as the JAX GP, float32 on the CPU."""
    from gaussian_process_transportation_tpu.models import affine as jaff
    from gaussian_process_transportation_tpu.models import exact_gp as jgp
    from gaussian_process_transportation_tpu_torch.convert import (
        affine_from_numpy, exact_gp_from_numpy,
    )

    S, S1, traj, delta, jk = _blocked_case()
    f = lambda a: jnp.asarray(a, jnp.float32)
    aff = jaff.fit(f(S), f(S1))
    src = jaff.predict(aff, f(S))
    jg = jgp.condition_blocked(jk, src, f(S1) - src, block=128, interpret=True)
    want = jgpt.transport_apply(aff, jg, f(traj), f(delta))
    state = {k: np.asarray(getattr(jg, k)) for k in ("X", "Y", "alpha")}
    state["chol"] = jg.chol
    tg = exact_gp_from_numpy(state, kernel_from_tree(jk, torch.float32, "cpu"), torch.float32,
                             "cpu")
    taff = affine_from_numpy({k: np.asarray(getattr(aff, k)) for k in (
        "rotation", "scale", "source_centroid", "target_centroid")}, torch.float32, "cpu")
    t32 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32)
    got = tgpt.transport_apply(taff, tg, t32(traj), t32(delta))
    for name in ("traj", "std", "delta", "delta_var", "min_abs_det"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-4, err_msg=name)


def test_transport_apply_without_k_inv_uses_the_dense_factor(case_2d):
    """A batched GP that carries L but no K⁻¹ takes forward substitution."""
    from dataclasses import replace

    from gaussian_process_transportation_tpu_torch.models import affine as taff
    from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp

    kern, S, targets, X, dX = case_2d[0]
    aff = taff.fit_batched(S, targets)
    src = taff.predict(aff, S)
    K_b = kern(src) + 1e-10 * torch.eye(S.shape[0], dtype=S.dtype)
    L = torch.linalg.cholesky(K_b)
    K_inv = torch.cholesky_inverse(L)
    alpha = K_inv @ (targets - src)
    gp = tgp.ExactGP(kernel=kern, X=src, Y=targets - src, alpha=alpha, L=L, K_inv=K_inv)
    want = tgpt.transport_apply(aff, gp, X, dX)
    got = tgpt.transport_apply(aff, replace(gp, K_inv=None), X, dX)
    for name in FIELDS[:5]:
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-7, atol=1e-7, msg=name)


def test_default_transport_kernel_matches_jax():
    x = np.random.default_rng(0).standard_normal((6, 1))
    want = jgpt.default_transport_kernel()(jnp.asarray(x))
    got = tgpt.default_transport_kernel(dtype=torch.float64, device="cpu")(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_default_transport_kernel_lives_on_the_card_by_default():
    """Entry points run on the card unless the caller asks for the CPU:
    without a card the default refuses rather than falling back."""
    if torch.cuda.is_available():
        assert tgpt.default_transport_kernel().k1.k2.lengthscale.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tgpt.default_transport_kernel()


# ---- hyperparameter fits under the transport --------------------------------


def _opt_kernel():
    """C(10)·RBF(4)+White(0.01) with the fit's bounds of ``chip_smoke.py``
    phase 13: under the default (1e-5, 1e5) these smooth residuals drive
    ℓ to 1e5 and the noise to 1e-5, where float32 fits diverge."""
    return (JK.Constant(10.0, bounds=(1e-2, 1e2)) * JK.RBF(4.0 * jnp.ones(2), bounds=(1e-1, 1e1))
            + JK.White(0.01, bounds=(1e-2, 1e1)))


def _opt_case():
    X, dX, S, S1 = _workload_2d(n_traj=40, n_dist=12)
    E = 3
    s = np.linspace(0, 1, 12)
    targets = S1[None] + np.linspace(0.0, 2.0, E)[:, None, None] * np.stack(
        [0 * s, np.sin(np.pi * s)], 1)[None]
    return X, dX, S, targets


def test_fit_and_transport_batched_opt_matches_jax():
    X, dX, S, targets = _opt_case()
    jk = _opt_kernel()
    want = jgpt.fit_and_transport_batched_opt(jk, jnp.asarray(S), jnp.asarray(targets),
                                              jnp.asarray(X), jnp.asarray(dX), n_restarts=0,
                                              maxiter=8)
    got = tgpt.fit_and_transport_batched_opt(kernel_from_tree(jk, device="cpu"), _t(S),
                                             _t(targets), _t(X), _t(dX), n_restarts=0, maxiter=8)
    scale = np.abs(X).max()
    for name in FIELDS[:5]:
        err = np.abs(getattr(got, name).numpy() - np.asarray(getattr(want, name))).max()
        assert err / scale < 1e-3, (name, err)


def test_batched_opt_equals_per_member_transport_at_the_fitted_kernels(monkeypatch):
    X, dX, S, targets = _opt_case()
    kern = kernel_from_tree(_opt_kernel(), device="cpu")
    fitted = []
    real = tgpt.gp_core.fit_ensemble_fused
    monkeypatch.setattr(tgpt.gp_core, "fit_ensemble_fused",
                        lambda *a, **k: fitted.append(real(*a, **k)) or fitted[-1])
    got = tgpt.fit_and_transport_batched_opt(kern, _t(S), _t(targets), _t(X), _t(dX),
                                             n_restarts=2, maxiter=6)
    thetas = fitted[0][0]
    assert thetas.shape == (3, kern.n_theta)
    for e in range(3):
        one = tgpt.fit_and_transport(kern.with_theta(thetas[e]), _t(S), _t(targets[e]), _t(X),
                                     _t(dX))
        for name in FIELDS[:5]:
            torch.testing.assert_close(getattr(got, name)[e], getattr(one, name), rtol=1e-10,
                                       atol=1e-10, msg=name)


def _facade_pair(optimizer, ori=False, **kw):
    """The JAX and the port façade driven through the same attributes."""
    if ori:
        X, dX, S, targets, q = _workload_3d(E=1)
        S1, jk = targets[0], _jax_kernel(3, amp=1.0, ls=1.5, noise=1e-3)
    else:
        X, dX, S, S1 = _workload_2d(n_traj=60, n_dist=15)
        q, jk = None, _jax_kernel(2)
    j = jgpt.GaussianProcessTransportation(kernel_transport=jk, optimizer=optimizer, **kw)
    t = tgpt.GaussianProcessTransportation(kernel_transport=kernel_from_tree(jk, device="cpu"),
                                           device="cpu", optimizer=optimizer, **kw)
    for tr, conv in ((j, jnp.asarray), (t, np.asarray)):
        tr.source_distribution, tr.target_distribution = conv(S), conv(S1)
        tr.training_traj, tr.training_delta = conv(X), conv(dX)
        if ori:
            tr.training_ori = conv(q)
        tr.fit_transportation()
        tr.apply_transportation()
    return j, t, np.abs(X).max()


FACADE_FIELDS = ("training_traj", "std", "training_delta", "var_vel_transported")


@pytest.mark.parametrize("ori", [False, True], ids=["2d", "3d_orientation"])
def test_facade_without_optimizer_matches_jax(ori):
    j, t, _ = _facade_pair(None, ori=ori)
    for name in FACADE_FIELDS + (("training_ori",) if ori else ()):
        got = getattr(t, name)
        assert got.device.type == "cpu", name
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j, name)), rtol=1e-10,
                                   atol=1e-10, err_msg=name)
    assert t.method.is_diffeomorphic == j.method.is_diffeomorphic


def test_facade_with_lbfgs_matches_jax():
    j, t, scale = _facade_pair("lbfgs", n_restarts_optimizer=0)
    for name in FACADE_FIELDS:
        err = np.abs(getattr(t, name).numpy() - np.asarray(getattr(j, name))).max()
        assert err <= 1e-6 * scale, (name, err)
    assert t.method.delta_map.kernel_ is not t.method.delta_map.kernel


def test_facade_lives_on_the_card_by_default():
    """Without a card the default device refuses rather than falling back."""
    if torch.cuda.is_available():
        assert tgpt.GaussianProcessTransportation().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tgpt.GaussianProcessTransportation()
