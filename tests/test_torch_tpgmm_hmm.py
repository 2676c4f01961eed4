"""Port parity: ``models/tpgmm.py`` and ``models/hmm_lqr.py`` against the
JAX package's, float64 on the CPU to 1e-8: the fits, the reproductions in
a held-out frame configuration, the forward–backward recursions and the
state sequence."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.models import hmm_lqr as jh
from gaussian_process_transportation_tpu.models import tpgmm as jt
from gaussian_process_transportation_tpu_torch.convert import (
    hmm_params_from_numpy, tpgmm_params_from_numpy,
)
from gaussian_process_transportation_tpu_torch.models import hmm_lqr as th
from gaussian_process_transportation_tpu_torch.models import tpgmm as tt

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)


def synthetic_frames(n_demos=7, T=40, seed=0):
    """Demonstrations from frame 0's origin to frame 1's with a bulge and a
    dwell at the goal: perfectly frame-parameterised (the JAX package's
    baseline tests' data)."""
    r = np.random.RandomState(seed)
    demos_x, A, b = [], [], []
    for _ in range(n_demos):
        b0, b1 = r.uniform(-20, 20, 2), r.uniform(-20, 20, 2)
        th_ = r.uniform(-np.pi, np.pi)
        R1 = np.array([[np.cos(th_), -np.sin(th_)], [np.sin(th_), np.cos(th_)]])
        t = np.linspace(0, 1, T - 6)
        path = np.outer(1 - t, b0) + np.outer(t, b1) + np.outer(np.sin(np.pi * t) * 5.0, R1 @ [0, 1])
        demos_x.append(np.vstack([path, np.tile(path[-1], (6, 1))]))
        A.append(np.tile(np.stack([np.eye(2), R1])[None], (T, 1, 1, 1)))
        b.append(np.tile(np.stack([b0, b1])[None], (T, 1, 1)))
    return demos_x, A, b


@pytest.fixture(scope="module")
def frames():
    demos_x, A, b = synthetic_frames()
    demos_dx = [np.vstack([np.diff(x, axis=0), np.zeros((1, 2))]) for x in demos_x]
    A_new = [np.asarray(A[-1][0][0]), np.asarray(A[-1][0][1])]
    b_new = [np.asarray(b[-1][0][0]), np.asarray(b[-1][0][1])]
    fit = dict(demos_x=demos_x[:-1], A=A[:-1], b=b[:-1])
    return dict(fit=fit, demos_dx=demos_dx[:-1], A_new=A_new, b_new=b_new, x0=demos_x[-1][0],
                tpgmm=jt.TPGMM(n_states=3, n_iter=12).fit(**fit),
                hmm=jh.HMMLQR(n_states=4, n_iter=8).fit(demos_dx=demos_dx[:-1], **fit))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_tpgmm_fit_and_reproduction_match_jax(frames):
    want = frames["tpgmm"]
    got = tt.TPGMM(n_states=3, n_iter=12, device="cpu").fit(**frames["fit"])
    assert got.x_scale == want.x_scale
    for name in ("priors", "mu", "sigma"):
        _close(getattr(got.params, name), getattr(want.params, name))
    want_traj = want.reproduce(frames["A_new"], frames["b_new"], n_points=33)
    for g, w in zip(got.reproduce(frames["A_new"], frames["b_new"], n_points=33), want_traj):
        _close(g, w)
    got.params = tpgmm_params_from_numpy(want.params._asdict(), device="cpu")
    _close(got.reproduce(frames["A_new"], frames["b_new"], n_points=33)[0], want_traj[0])


def test_eigenvalue_floor_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 4, 4))
    S = A @ A.transpose(0, 2, 1)
    _close(tt.eigenvalue_floor(torch.as_tensor(S), 0.1), jt.eigenvalue_floor(jnp.asarray(S), 0.1))


def test_hmm_fit_and_reproduction_match_jax(frames):
    want = frames["hmm"]
    got = th.HMMLQR(n_states=4, n_iter=8, device="cpu").fit(demos_dx=frames["demos_dx"],
                                                            **frames["fit"])
    for name in ("init", "trans", "mu", "sigma"):
        _close(getattr(got.params, name), getattr(want.params, name))
    np.testing.assert_array_equal(got.state_sequence(40).numpy(),
                                  np.asarray(want.state_sequence(40)))
    _close(got.reproduce(frames["A_new"], frames["b_new"], x0=frames["x0"], T=40),
           want.reproduce(frames["A_new"], frames["b_new"], x0=frames["x0"], T=40))
    got.params = hmm_params_from_numpy(want.params, device="cpu")
    seq = torch.as_tensor(np.random.default_rng(1).standard_normal((5, 2, 4)))
    _close(th._emission_loglik(got.params, seq), jh._emission_loglik(want.params, jnp.asarray(seq)))


def test_forward_backward_matches_jax():
    rng = np.random.default_rng(2)
    log_b = 3.0 * rng.standard_normal((25, 3))
    init = np.array([0.6, 0.3, 0.1])
    trans = np.array([[0.8, 0.2, 0.0], [0.1, 0.8, 0.1], [0.0, 0.3, 0.7]])
    got = th._forward_backward(*(torch.as_tensor(a) for a in (log_b, init, trans)))
    want = jh._forward_backward(*(jnp.asarray(a) for a in (log_b, init, trans)))
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(got[0].sum(1).numpy(), 1.0, atol=1e-12)


def test_float32_demonstrations_fit_in_float32(frames):
    """The fits run in the demonstrations' dtype; float32 stays finite."""
    fit32 = dict(frames["fit"], demos_x=[x.astype(np.float32) for x in frames["fit"]["demos_x"]])
    tp = tt.TPGMM(n_states=3, n_iter=12, device="cpu").fit(**fit32)
    hmm = th.HMMLQR(n_states=4, n_iter=8, device="cpu").fit(demos_dx=frames["demos_dx"], **fit32)
    assert tp.params.mu.dtype == hmm.params.mu.dtype == torch.float32
    assert np.isfinite(tp.reproduce(frames["A_new"], frames["b_new"])[0]).all()
    assert np.isfinite(hmm.reproduce(frames["A_new"], frames["b_new"], x0=frames["x0"])).all()
