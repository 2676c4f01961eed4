"""Port parity: the fused small-LML twins (``ops/fused_lml.py``) against the
JAX package's plain references in float32 and against the port's own
autograd log marginal likelihood in float64, and the wrappers' CPU route
and limits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.ops import fused_lml as jfl
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp
from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

# the JAX package's kernel-vs-reference tolerances (tests/test_fused_lml.py:97-98)
VAL_RTOL, GRAD_RTOL = 2e-5, 2e-4
F64_TOL = 1e-8

CASES = [
    ("rbf-ard", lambda: JK.Constant(2.0) * JK.RBF(jnp.ones(2)) + JK.White(0.05), 2),
    ("rbf-iso", lambda: JK.Constant(2.0) * JK.RBF(0.7) + JK.White(0.05), 2),
    ("matern52", lambda: JK.Constant(1.5) * JK.Matern(jnp.ones(2), nu=2.5) + JK.White(0.02), 2),
    ("matern32-no-noise", lambda: JK.Constant(1.0) * JK.Matern(0.8, nu=1.5), 3),
    ("matern12", lambda: JK.Constant(1.2) * JK.Matern(jnp.ones(2), nu=0.5) + JK.White(0.03), 2),
]


def _data(n, D, p, E=None, seed=0):
    """X (n, D) or (E, n, D) standard normal, Y = sin(x₀) + 0.1·noise."""
    rng = np.random.default_rng(seed)
    lead = () if E is None else (E,)
    X = rng.standard_normal(lead + (n, D))
    Y = np.sin(X[..., :1]) + 0.1 * rng.standard_normal(lead + (n, p))
    return X, Y


def _thetas(T, E, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (T, E))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _layout(mk):
    return tgp.small_lml_theta_layout(kernel_from_tree(mk(), device="cpu"))


@pytest.mark.parametrize("name,mk,D", CASES, ids=[c[0] for c in CASES])
def test_twin_matches_jax_reference_f32(name, mk, D):
    family, n_ls, has_noise, _ = _layout(mk)
    X, Y = _data(10, D, 2)
    th = _thetas(1 + n_ls + has_noise, 11)
    want = jfl.small_lml_value_grad_ref(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
                                        jnp.asarray(th, jnp.float32), family, n_ls, has_noise, 1e-8)
    got = tfl.small_lml_value_grad(_t(X), _t(Y), _t(th), family, n_ls, has_noise, 1e-8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL, atol=VAL_RTOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=GRAD_RTOL, atol=GRAD_RTOL)


@pytest.mark.parametrize("name,mk,D", CASES, ids=[c[0] for c in CASES])
def test_md_twin_matches_jax_reference_f32(name, mk, D):
    family, n_ls, has_noise, _ = _layout(mk)
    Xe, Ye = _data(9, D, 1, E=6, seed=3)
    th = _thetas(1 + n_ls + has_noise, 6)
    want = jfl.small_lml_value_grad_md_ref(
        jnp.asarray(Xe, jnp.float32), jnp.asarray(Ye, jnp.float32), jnp.asarray(th, jnp.float32),
        family, n_ls, has_noise, 1e-8)
    got = tfl.small_lml_value_grad_md(_t(Xe), _t(Ye), _t(th), family, n_ls, has_noise, 1e-8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL, atol=VAL_RTOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=GRAD_RTOL, atol=GRAD_RTOL)


@pytest.mark.parametrize("name,mk,D", CASES, ids=[c[0] for c in CASES])
def test_twin_f64_matches_port_lml_and_autograd(name, mk, D):
    """The twins' closed-form gradient against autograd through the port's
    ``log_marginal_likelihood`` of ``kernel.with_theta``, per lane."""
    kern = kernel_from_tree(mk(), device="cpu")
    family, n_ls, has_noise, perm = tgp.small_lml_theta_layout(kern)
    Xe, Ye = _data(15, D, 2, E=5, seed=4)
    th = torch.tensor(_thetas(kern.n_theta, 5).T, dtype=torch.float64, requires_grad=True)
    want = tgp.log_marginal_likelihood(kern.with_theta(th), _t(Xe, torch.float64),
                                       _t(Ye, torch.float64), 1e-8)
    want.sum().backward()
    te = th.detach()[:, perm].T
    for val, grad in (
        tfl.small_lml_value_grad_md(_t(Xe, torch.float64), _t(Ye, torch.float64), te, family,
                                    n_ls, has_noise, 1e-8),
        # the shared-data twin, lane by lane
        [torch.cat(z, -1) for z in zip(*(
            tfl.small_lml_value_grad(_t(Xe[e], torch.float64), _t(Ye[e], torch.float64),
                                     te[:, e:e + 1], family, n_ls, has_noise, 1e-8)
            for e in range(5)))],
    ):
        torch.testing.assert_close(val, want.detach(), rtol=F64_TOL, atol=F64_TOL)
        torch.testing.assert_close(grad.T[:, np.argsort(perm)], th.grad, rtol=F64_TOL,
                                   atol=F64_TOL)


def test_cpu_route_takes_the_twin_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(tfl.small_lml_value_grad, "launches", 0)
    monkeypatch.setattr(tfl.small_lml_value_grad_md, "launches", 0)
    X, Y = _data(9, 2, 3)
    th = _t(_thetas(4, 7))
    a = tfl.small_lml_value_grad(_t(X), _t(Y), th, "rbf", 2, True)
    b = tfl.small_lml_value_grad_ref(_t(X), _t(Y), th, "rbf", 2, True)
    c = tfl.small_lml_value_grad_md(_t(X)[None].expand(7, 9, 2), _t(Y)[None].expand(7, 9, 3), th,
                                    "rbf", 2, True)
    for got in (a, c):
        torch.testing.assert_close(got[0], b[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], b[1], rtol=0, atol=0)
    assert tfl.small_lml_value_grad.launches == 0 and tfl.small_lml_value_grad_md.launches == 0


def test_wrappers_raise_beyond_the_limits():
    """n > 32 raises, as in JAX; p and D are not limited."""
    X, Y = _data(33, 2, 1)
    with pytest.raises(ValueError, match="n <= 32"):
        tfl.small_lml_value_grad(_t(X), _t(Y), _t(_thetas(3, 4)), "rbf", 1, True)
    X12, Y12 = _data(8, 12, 12)
    val, grad = tfl.small_lml_value_grad(_t(X12), _t(Y12), _t(_thetas(14, 4)), "rbf", 12, True)
    assert val.shape == (4,) and grad.shape == (14, 4) and torch.isfinite(grad).all()
    Xe, Ye = _data(8, 12, 9, E=4)
    val, grad = tfl.small_lml_value_grad_md(_t(Xe), _t(Ye), _t(_thetas(3, 4)), "rbf", 1, True)
    assert val.shape == (4,) and grad.shape == (3, 4) and torch.isfinite(val).all()
    X, Y = _data(8, 2, 9)
    with pytest.raises(ValueError, match="theta"):
        tfl.small_lml_value_grad(_t(X), _t(Y[:, :2]), _t(_thetas(4, 4)), "rbf", 1, True)
    Xe, Ye = _data(8, 2, 1, E=3)
    with pytest.raises(ValueError, match="lanes"):
        tfl.small_lml_value_grad_md(_t(Xe), _t(Ye), _t(_thetas(3, 4)), "rbf", 1, True)
    with pytest.raises(ValueError, match="family"):
        tfl.small_lml_value_grad_md(_t(Xe), _t(Ye), _t(_thetas(3, 3)), "cosine", 1, True)


def test_a_lane_that_is_not_positive_definite_is_nan_there_only():
    """Two equal points in lane 1 and a negative jitter: lane 1's Gram has
    an eigenvalue of −1e-4, the others stay positive definite."""
    Xe, Ye = _data(6, 2, 1, E=3)
    Xe[1, 1] = Xe[1, 0]
    th = _t(np.zeros((2, 3)))
    val, grad = tfl.small_lml_value_grad_md(_t(Xe), _t(Ye), th, "rbf", 1, False, jitter=-1e-4)
    assert torch.isnan(val[1]) and torch.isnan(grad[:, 1]).all()
    assert torch.isfinite(val[[0, 2]]).all() and torch.isfinite(grad[:, [0, 2]]).all()


# (D, p, n_ls) past the kernel's eight coordinates or columns
WIDE = [(12, 1, 12), (2, 12, 1), (12, 12, 1)]


@pytest.mark.parametrize("D,p,n_ls", WIDE, ids=[f"D{d}-p{q}-nls{k}" for d, q, k in WIDE])
def test_wide_shapes_match_jax_pallas_interpret(D, p, n_ls):
    """D and p past eight, as JAX takes them: both wrappers against the JAX
    package's Pallas kernels in interpret mode (eb=8, as its tests run
    them), to the JAX tests' kernel-vs-reference tolerances."""
    T = 2 + n_ls
    X, Y = _data(8, D, p, seed=D + p)
    Xe, Ye = _data(7, D, p, E=9, seed=D * p)
    th = _thetas(T, 9, seed=p).astype(np.float32)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    for got, want in (
        (tfl.small_lml_value_grad(_t(X), _t(Y), _t(th), "matern52", n_ls, True, 1e-8),
         jfl.small_lml_value_grad(f32(X), f32(Y), f32(th), "matern52", n_ls, True, 1e-8, eb=8,
                                  interpret=True)),
        (tfl.small_lml_value_grad_md(_t(Xe), _t(Ye), _t(th), "rbf", n_ls, True, 1e-8),
         jfl.small_lml_value_grad_md(f32(Xe), f32(Ye), f32(th), "rbf", n_ls, True, 1e-8, eb=8,
                                     interpret=True)),
    ):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL,
                                   atol=VAL_RTOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL)


@pytest.mark.parametrize("p", [9, 12, 17])
def test_column_chunks_add_up_to_the_whole(p):
    """What the card's wrappers do for p > 8: one launch per chunk of
    ``KERNEL_P`` columns, values and gradients summed.  The twin over the
    chunks, summed, is the twin over all of Y, in float64."""
    Xe, Ye = _data(10, 3, p, E=5, seed=p)
    th = _t(_thetas(5, 5), torch.float64)
    Xe, Ye = _t(Xe, torch.float64), _t(Ye, torch.float64)
    whole = tfl.small_lml_value_grad_md(Xe, Ye, th, "matern32", 3, True, 1e-8)
    parts = [tfl.small_lml_value_grad_md(Xe, Ye[..., c:c + tfl.KERNEL_P].contiguous(), th,
                                         "matern32", 3, True, 1e-8)
             for c in range(0, p, tfl.KERNEL_P)]
    assert len(parts) == -(-p // tfl.KERNEL_P)
    torch.testing.assert_close(sum(v for v, _ in parts), whole[0], rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(sum(g for _, g in parts), whole[1], rtol=1e-12, atol=1e-10)
