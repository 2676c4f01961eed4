"""The fused transport apply (``ops/transport_apply.py``) on the CPU: its
plain twin against the JAX package's ``transport_apply`` in float64 on the
same GP states, shared and per-member hyperparameters; the route that
``transport.gpt.transport_apply`` takes, fused for the benchmark cells'
inputs and plain for every input outside the kernel; the kernel's
hyperparameter arguments.  The CUDA kernel itself is tested on the card
(``tests/test_torch_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import affine as jaffine
from gaussian_process_transportation_tpu.models import exact_gp as jexact
from gaussian_process_transportation_tpu.transport import gpt as jgpt
from gaussian_process_transportation_tpu_torch import kernels as K
from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core
from gaussian_process_transportation_tpu_torch.ops import transport_apply as fa
from gaussian_process_transportation_tpu_torch.transport import gpt

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool spins against them.
torch.set_num_threads(1)

TOL = 1e-9  # the JAX package's own batched-vs-vmapped tolerance
E, Q = 3, 16
FIELDS = ("traj", "std", "delta", "delta_var", "min_abs_det")


def _points(D, n, Q_, dtype=torch.float64, seed=0):
    """The bench's floor curves (2-D) or a 3-D curve, E targets around the
    source, the demo and its velocities."""
    rng = np.random.default_rng(seed + 10 * n + D)
    t, s = np.linspace(0, 1, Q_), np.linspace(0, 1, n)
    if D == 2:
        X, S = np.stack([10 * t, 5 * np.sin(3 * t)], 1), np.stack([10 * s, -2 + 0 * s], 1)
    else:
        X = np.stack([4 * t, np.sin(3 * t), 0.5 * np.cos(2 * t)], 1)
        S = np.stack([4 * s, np.sin(4 * s), np.cos(3 * s)], 1)
    T = S[None] + 0.3 * rng.standard_normal((E, n, D)) + 0.2
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (S, T, X, dX))


THETAS = ("shared", "per_member", "isotropic", "per_member_isotropic")


def _kernel(D, dtype=torch.float64, theta="shared", seed=0):
    """C(10)·RBF(4)+White(0.01) with an ARD or one isotropic lengthscale,
    shared by the E members or moved per member."""
    ls = 4.0 if "isotropic" in theta else 4.0 * torch.ones(D, dtype=dtype)
    kern = K.Constant(10.0) * K.RBF(ls) + K.White(0.01)
    if theta.startswith("per_member"):
        g = torch.Generator().manual_seed(seed)
        t0 = kern.theta.to(dtype)
        kern = kern.with_theta(t0[None] + 0.2 * torch.randn(E, t0.numel(), generator=g,
                                                            dtype=dtype))
    return kern


def _batched_state(kern, S, T):
    """The batched route's state (γ and the E GPs with L and K⁻¹), its factor
    from torch.linalg: the unrolled CPU twin of the Cholesky kernel takes
    seconds at n = 64."""
    aff, src_al, y = gpt._affine_batched(S, T, False, True)
    n = src_al.shape[-2]
    K_b = kern(src_al) + gp_core._eff_jitter(src_al.dtype, 1e-10) * torch.eye(n)
    L = torch.linalg.cholesky(K_b)
    K_inv = torch.cholesky_inverse(L)
    return aff, gp_core.ExactGP(kernel=kern, X=src_al, Y=y, alpha=K_inv @ y, L=L,
                                K_inv=K_inv)


def _twin(aff, gp, X, dX):
    return fa.transport_apply_rbf_plain(gp.X, gp.alpha, gp.L, aff.rotation, aff.scale,
                                        aff.source_centroid, aff.target_centroid, X, dX,
                                        *gp_core.rbf_hyperparameters(gp.kernel))


_JAX = {}


def _jax_apply(D, n):
    """JAX's transport_apply, vmapped over the members of every θ case of
    one shape (E each, in ``THETAS``' order) on the port's own GP states
    (JAX's variances through K⁻¹, the twin's through L: in float64 the two
    differ by ~1e-10 at n = 64): one compile a shape, shared by its cases."""
    if (D, n) in _JAX:
        return _JAX[(D, n)]
    S, T, X, dX = _points(D, n, Q)
    states = [_batched_state(_kernel(D, theta=th), S, T) for th in THETAS]
    hyper = [gp_core.rbf_hyperparameters(gp.kernel) for _, gp in states]

    def cat(f):
        return jnp.asarray(torch.cat([f(aff, gp, h) for (aff, gp), h in zip(states, hyper)])
                           .numpy())

    jk = (JK.Constant(cat(lambda a, g, h: torch.as_tensor(h[0]).expand(E)))
          * JK.RBF(cat(lambda a, g, h: torch.as_tensor(h[1]).expand(E, D)))
          + JK.White(cat(lambda a, g, h: torch.as_tensor(h[2]).expand(E))))
    aff = jaffine.AffineParams(rotation=cat(lambda a, g, h: a.rotation),
                               scale=cat(lambda a, g, h: a.scale),
                               source_centroid=cat(lambda a, g, h: a.source_centroid),
                               target_centroid=cat(lambda a, g, h: a.target_centroid))
    gp = jexact.ExactGP(kernel=jk, X=cat(lambda a, g, h: g.X), Y=cat(lambda a, g, h: g.Y),
                        alpha=cat(lambda a, g, h: g.alpha), L=cat(lambda a, g, h: g.L),
                        K_inv=cat(lambda a, g, h: g.K_inv))
    res = jax.jit(jax.vmap(jgpt.transport_apply, in_axes=(0, 0, None, None)))(
        aff, gp, jnp.asarray(X.numpy()), jnp.asarray(dX.numpy()))
    _JAX[(D, n)] = (states, X, dX, [np.asarray(getattr(res, f)) for f in FIELDS])
    return _JAX[(D, n)]


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("D,n", [(2, 1), (2, 20), (2, 64), (3, 1), (3, 20), (3, 64)])
def test_twin_matches_jax_transport_apply(D, n, theta):
    states, X, dX, want = _jax_apply(D, n)
    i = THETAS.index(theta)
    member = slice(i * E, (i + 1) * E)
    aff, gp = states[i]
    got = _twin(aff, gp, X, dX)
    for name, g, w in zip(FIELDS, got, want):
        w = w[member]
        if name in ("std", "delta_var"):
            w = w[..., 0]  # the same for every output coordinate
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL, err_msg=name)


def _cell_inputs(entry, monkeypatch):
    """The arguments that the floor cells' entries hand ``transport_apply``
    (float32, the cells' kernel and sizes, E = 3 members)."""
    S, T, X, dX = _points(2, 20, 40, dtype=torch.float32)
    kern = K.Constant(10.0) * K.RBF(4.0 * torch.ones(2)) + K.White(0.01)
    seen = []
    monkeypatch.setattr(gpt, "transport_apply", lambda *a, **kw: seen.append((a, kw)))
    if entry == "ensemble":
        gpt.fit_and_transport_batched(kern, S, T, X, dX, jitter=1e-10)
    else:
        gpt.fit_and_transport_batched_opt(kern, S, T, X, dX, n_restarts=1, maxiter=1,
                                          generator=torch.Generator().manual_seed(0))
    (args, kw), = seen
    return args, kw


@pytest.mark.parametrize("entry", ["ensemble", "refit"])
def test_the_cells_inputs_take_the_fused_route(entry, monkeypatch):
    args, kw = _cell_inputs(entry, monkeypatch)
    assert gpt.fused_apply_inputs(*args, **kw)
    amp, ls, noise = gp_core.rbf_hyperparameters(args[1].kernel)
    if entry == "refit":  # per member, E-strided
        assert amp.shape == (E,) and ls.shape == (E, 2) and noise.shape == (E,)
    else:
        assert amp == 10.0 and noise == 0.01 and ls.shape == (2,)


def _bypass(case):
    """Floor-like inputs, each changed in one way the kernel does not take."""
    n = 65 if case == "n65" else 20
    dtype = torch.float64 if case == "float64" else torch.float32
    S, T, X, dX = _points(2, n, 8, dtype=dtype)
    kern = _kernel(2, dtype)
    if case == "sum_of_rbfs":
        kern = K.RBF(4.0 * torch.ones(2)) + K.RBF(2.0 * torch.ones(2))
    aff, gp = _batched_state(kern, S, T)
    ori = None
    if case == "ori":
        ori = torch.zeros(8, 4)
    if case == "no_k_inv":
        gp = gp_core.ExactGP(kernel=gp.kernel, X=gp.X, Y=gp.Y, alpha=gp.alpha, L=gp.L)
    return aff, gp, X, dX, ori


@pytest.mark.parametrize("case", ["n65", "ori", "no_k_inv", "float64", "sum_of_rbfs"])
def test_inputs_outside_the_kernel_take_the_plain_route(case):
    aff, gp, X, dX, ori = _bypass(case)
    assert not gpt.fused_apply_inputs(aff, gp, X, dX, ori)


def test_one_member_without_an_axis_takes_the_fused_inputs():
    S, T, X, dX = _points(2, 20, 8, dtype=torch.float32)
    aff, gp = gpt.fit_pipeline(_kernel(2, torch.float32), S, T[0])
    assert gp.X.dim() == 2 and gpt.fused_apply_inputs(aff, gp, X, dX)


def test_cpu_transport_apply_launches_nothing_and_tallies_no_fused_member(monkeypatch):
    from gaussian_process_transportation_tpu_torch.utils import logging_utils as lu

    monkeypatch.setattr(fa.transport_apply_rbf, "launches", 0)
    S, T, X, dX = _points(2, 20, 8, dtype=torch.float32)
    aff, gp = _batched_state(_kernel(2, torch.float32), S, T)
    lu.collect()
    was = lu.spans(True)
    try:
        gpt.transport_apply(aff, gp, X, dX)
    finally:
        lu.spans(was)
    got = lu.collect()
    assert fa.transport_apply_rbf.launches == 0
    assert got.tallies == {"gpt.apply.members": E, "gpt.apply.fused_members": 0}
    assert "gpt.apply.fused" not in {r.name for r in got.records}


def test_rbf_hyperparameters_read_every_c_rbf_white_form():
    ls = torch.tensor([1.0, 2.0])
    assert gp_core.rbf_hyperparameters(K.RBF(ls)) == (1.0, ls, 0.0)
    assert gp_core.rbf_hyperparameters(K.White(0.5) + K.RBF(ls) * K.Constant(3.0)) == (3.0, ls,
                                                                                       0.5)
    assert gp_core.rbf_hyperparameters(K.Constant(2.0) * K.Matern(ls, nu=1.5)) is None
    assert gp_core.rbf_hyperparameters(K.Constant(2.0) * K.RBF(ls) * K.RBF(ls)) is None


def test_kernel_arguments_carry_member_strides():
    """A number and a CPU tensor of shared values go by value; values off
    the host by a device pointer and a member stride (0 shared, 1 or D per
    member; here on the meta device, which has strides and no data).
    Per-member values on the host are not taken: the launch would copy them."""
    assert fa._scalar_arg(2.5, E)[1:] == (None, 0, 2.5)
    assert fa._scalar_arg(torch.tensor(2.5), E)[1:] == (None, 0, 2.5)
    assert fa._scalar_arg(torch.ones(E, device="meta"), E)[2] == 1
    assert fa._scalar_arg(torch.ones((), device="meta"), E)[2] == 0
    assert fa._lengthscale_arg(torch.tensor([1.0, 2.0]), E, 2)[1:] == (None, 0, 0,
                                                                     (1.0, 2.0, 0.0))
    assert fa._lengthscale_arg(3.0, E, 3)[4] == (3.0, 3.0, 3.0)
    assert fa._lengthscale_arg(torch.ones(E, 2, device="meta"), E, 2)[2:4] == (2, 1)
    assert fa._lengthscale_arg(torch.ones(E, 1, device="meta"), E, 2)[2:4] == (1, 0)
    assert fa._lengthscale_arg(torch.ones(2, device="meta"), E, 2)[2:4] == (0, 1)
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert fa.hyperparameters_fit(1.0, torch.ones(E, 2), torch.ones(E), E, 2, cpu)
    assert not fa.hyperparameters_fit(1.0, torch.ones(E + 1, 2), 0.1, E, 2, cpu)
    assert fa.hyperparameters_fit(torch.tensor(2.0), torch.ones(2), 0.1, E, 2, card)
    assert not fa.hyperparameters_fit(1.0, torch.ones(E, 2), 0.1, E, 2, card)
    assert not fa.hyperparameters_fit(torch.ones(E), torch.ones(2), 0.1, E, 2, card)
