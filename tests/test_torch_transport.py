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
    args = (kernel_from_tree(jk), _t(S), _t(targets), _t(X), _t(dX))
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
    got = tgpt.fit_and_transport_batched(kernel_from_tree(jk), _t(S), _t(targets), _t(X),
                                         _t(dX), do_scale=True)
    _assert_result(got, want)


def test_3d_with_orientation_matches_jax():
    X, dX, S, targets, ori = _workload_3d()
    jk = _jax_kernel(3, amp=1.0, ls=1.5, noise=1e-3)
    want = jgpt.fit_and_transport_batched(jk, jnp.asarray(S), jnp.asarray(targets),
                                          jnp.asarray(X), jnp.asarray(dX), ori=jnp.asarray(ori))
    got = tgpt.fit_and_transport_batched(kernel_from_tree(jk), _t(S), _t(targets), _t(X),
                                         _t(dX), ori=_t(ori))
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
    got = tgpt.fit_and_transport_batched(kernel_from_tree(jk), _t(S), _t(targets), _t(X), _t(dX))
    assert got.min_abs_det.shape == (2,)
    _assert_result(got, want)


def test_blocked_sizes_are_not_ported_yet():
    k = kernel_from_tree(_jax_kernel(2))
    S = torch.zeros(768, 2, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="blocked"):
        tgpt.fit_and_transport_batched(k, S, S[None], S, S)


def test_default_transport_kernel_matches_jax():
    x = np.random.default_rng(0).standard_normal((6, 1))
    want = jgpt.default_transport_kernel()(jnp.asarray(x))
    got = tgpt.default_transport_kernel(dtype=torch.float64)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
