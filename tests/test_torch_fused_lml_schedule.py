"""The schedule of the card's fused small-LML kernel (``csrc/fused_lml.cu``,
TPU kernels #2 and #3), stepped through in plain torch ops on the CPU.

Each lane is a warp: thread t's register row is ``A[:, t, :]`` and a
shuffle of lane k's register j is the read ``A[:, k, j]``.  The rows past n
up to the instance's capacity (24 or 32 rows) are an identity block.  The
factor is K = C D Cᵀ (C unit lower), right-looking (the 32-row instance
updates only the groups of four columns that start below n, the 24-row
one runs its identity tail), with Y's columns eliminated
alongside (u = C⁻¹y: the value from Σu²/d and the pivots); thread t keeps
the Schur complement right of its diagonal (column t of C, rescaled at the
end).  The inverse is column t of C⁻¹ by one forward substitution and row
t of K⁻¹ = C⁻ᵀD⁻¹C⁻¹ from the columns, and the gradient is W = ½(ααᵀ −
p·K⁻¹) against the recomputed Gram row.  Coordinates past eight are walked
in chunks, and columns of Y past eight are separate launches whose results
add up, as the wrapper does.  The schedule is held to the f64 formula
(``chip_smoke.lml_f64``'s bound, the on-card check) and to the JAX
package: its Pallas kernels in interpret mode at n ≤ 2 and its plain
references at n = 20 and 32 (one interpret-mode call takes about a minute
at n = 20 on a CPU)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_process_transportation_tpu.ops import fused_lml as jfl
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp
from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl
from gaussian_process_transportation_tpu_torch.ops.pallas_gram import stationary_from_sqdist

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

# the JAX kernel-vs-reference tolerances (tests/test_fused_lml.py:97-98)
VAL_RTOL, GRAD_RTOL = 2e-5, 2e-4
FAMILIES = ("rbf", "matern12", "matern32", "matern52")
SHAPES = [(2, 1), (2, 2), (12, 1), (2, 12)]  # (D, p): a wide X and a wide Y past eight
NS = (1, 2, 20, 32)
CASES = [(fam, n, D, p, n_ls) for fam in FAMILIES for n in NS for D, p in SHAPES
         for n_ls in (1, D)]
CHUNK = 8  # kMaxD and kMaxP of the kernel
JITTER = 1e-8


def capacity(n, D, p):
    """The register rows of the instance the host picks for one launch."""
    return 24 if n <= 24 and D <= 2 and p <= 2 else 32


def _schedule_launch(Xe, Ye, theta, family, n_ls, has_noise, jitter, with_grad):
    """One launch (p ≤ 8) of the kernel's schedule over E lanes: Xe (E, n,
    D), Ye (E, n, p), theta (T, E), all float32 → (val (E,), grad (T, E) or
    None)."""
    E, n, D = Xe.shape
    p = Ye.shape[-1]
    C = capacity(n, D, p)
    f = dict(dtype=Xe.dtype)
    t = torch.arange(C)
    row = t < n
    amp = torch.exp(theta[0])
    noise = torch.exp(theta[1 + n_ls]) if has_noise else torch.zeros(E, **f)
    ls_row = lambda d: 1 + (d if n_ls > 1 else 0)
    il = torch.stack([torch.exp(-2.0 * theta[ls_row(d)]) for d in range(D)], 1)  # (E, D)
    xt = torch.zeros(E, C, D, **f)
    xt[:, :n] = Xe

    # Gram rows, chunk by chunk of coordinates, then the identity padding
    s = torch.zeros(E, C, C, **f)
    for c0 in range(0, D, CHUNK):
        for d in range(c0, min(c0 + CHUNK, D)):
            diff = xt[:, :, None, d] - xt[:, None, :, d]  # thread t, shuffled lane j
            s = s + diff * diff * il[:, d, None, None]
    inside = row[:, None] & row[None, :]
    eye = torch.eye(C, **f)
    A = torch.where(inside, amp[:, None, None] * stationary_from_sqdist(s, family)
                    + eye * (noise + jitter)[:, None, None], eye)

    # right-looking K = C D C^T with Y's columns alongside (u = C^-1 y);
    # thread t keeps S_tk right of its diagonal
    u = torch.zeros(E, C, p, **f)
    u[:, :n] = Ye
    logdet = torch.zeros(E, **f)
    dinv = torch.ones(E, C, **f)
    bad = torch.zeros(E, dtype=torch.bool)
    for j in range(n):
        piv = A[:, j, j].clone()  # lane j's register j
        bad |= ~(piv > 0)
        inv = 1.0 / piv
        logdet = logdet + torch.log(piv)
        ctj = torch.where(t > j, A[:, :, j] * inv[:, None], torch.zeros_like(A[:, :, j]))
        u = u - ctj[:, :, None] * u[:, j, None, :]
        ks = [k for k0 in range(0, C, 4) if k0 + 3 > j and (C == 24 or k0 < n)
              for k in range(k0, k0 + 4) if k > j]
        A[:, :, ks] = A[:, :, ks] - ctj[:, :, None] * A[:, ks, j][:, None, :]  # unscaled S_kj
        dinv[:, j] = inv
        A[:, :, j] = torch.where(t > j, ctj, A[:, :, j])
    quad = (u * u * dinv[:, :, None]).sum((1, 2))
    nan = torch.full((), math.nan, **f)
    val = torch.where(bad, nan, -0.5 * quad - p * (0.5 * logdet + 0.5 * n * math.log(2 * math.pi)))
    if not with_grad:
        return val, None

    # column t of C right of the diagonal, then alpha = C^-T D^-1 u
    upper = t[None, :] > t[:, None]  # (thread, k)
    A = torch.where(upper, A * dinv[:, :, None], A)
    z = u * dinv[:, :, None]
    for k in reversed(range(n)):
        l = torch.where(t < k, A[:, :, k], torch.zeros_like(A[:, :, k]))
        z = z - l[:, :, None] * z[:, k, None, :]
    # column t of C^-1 (lane i broadcasts row i of C), then row t of K^-1
    xc = torch.zeros(E, C, C, **f)  # xc[:, t, i] = (C^-1)_{i t}
    for i in range(n):
        xc[:, :, i] = (t == i).to(Xe.dtype) - (A[:, i, None, :i] * xc[:, :, :i]).sum(-1)
    ki = torch.zeros(E, C, C, **f)
    for k in range(n):
        w = xc[:, :, k] * dinv[:, k, None]
        ki[:, :, :k + 1] += w[:, :, None] * xc[:, None, :k + 1, k]

    # W row t against dK/dtheta, the Gram row recomputed; rows past n masked
    d2 = (xt[:, :, None, :] - xt[:, None, :, :]) ** 2  # (E, C, C, D)
    sg = (d2 * il[:, None, None, :]).sum(-1)
    aa = z @ z.transpose(1, 2)
    W = 0.5 * (aa - p * ki)
    W = torch.where(inside, W, torch.zeros_like(W))
    g_amp = (W * amp[:, None, None] * stationary_from_sqdist(sg, family)).sum((1, 2))
    wdk = W * amp[:, None, None] * tfl._dphi(sg, family)
    g_ls = (wdk[..., None] * d2).sum((1, 2)) * (-2.0 * il)  # (E, D)
    if n_ls == 1:
        g_ls = g_ls.sum(1, keepdim=True)
    rows = [g_amp[:, None], g_ls]
    if has_noise:
        rows.append((noise * torch.diagonal(W, dim1=1, dim2=2).sum(1))[:, None])
    grad = torch.cat(rows, 1).T
    return val, torch.where(bad[None, :], nan, grad)


def schedule_twin(Xe, Ye, theta, family, n_ls, has_noise=True, jitter=JITTER, with_grad=True):
    """The wrapper's launches of the schedule: one per eight columns of Y,
    values and gradients summed."""
    p = Ye.shape[-1]
    parts = [_schedule_launch(Xe, Ye[..., c0:c0 + CHUNK], theta, family, n_ls, has_noise, jitter,
                              with_grad) for c0 in range(0, p, CHUNK)]
    val = sum(v for v, _ in parts)
    return val, (sum(g for _, g in parts) if with_grad else None)


def _inputs(n, D, p, n_ls, E=5, seed=0):
    X, Y, th = chip_smoke.lml_inputs("cpu", E, n, D, p, n_ls, True, True, seed)
    return X, Y, th


def _close(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL, atol=VAL_RTOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=GRAD_RTOL, atol=GRAD_RTOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-n{c[1]}-D{c[2]}-p{c[3]}-nls{c[4]}")
def test_schedule_within_the_f64_bound(case):
    """Per lane and entry, the float32 schedule against the f64 formula
    within the on-card check's conditioning-aware bound (error/bound < 1)."""
    fam, n, D, p, n_ls = case
    X, Y, th = _inputs(n, D, p, n_ls, seed=n + D + p)
    val, grad = schedule_twin(X, Y, th, fam, n_ls)
    ex = chip_smoke.lml_excess(val, grad, chip_smoke.lml_f64(X, Y, th, fam, n_ls, True, JITTER))
    assert max(ex) < 1, ex


@pytest.mark.parametrize("case", [c for c in CASES if c[1] <= 2],
                         ids=lambda c: f"{c[0]}-n{c[1]}-D{c[2]}-p{c[3]}-nls{c[4]}")
def test_schedule_matches_jax_pallas_interpret(case):
    """n ≤ 2: both JAX Pallas kernels in interpret mode (eb=8, as the JAX
    tests run them), the shared-data one against lane 0's dataset."""
    fam, n, D, p, n_ls = case
    X, Y, th = _inputs(n, D, p, n_ls, E=9, seed=7)
    j32 = lambda a: jnp.asarray(a.numpy())
    _close(schedule_twin(X, Y, th, fam, n_ls),
           jfl.small_lml_value_grad_md(j32(X), j32(Y), j32(th), fam, n_ls, True, JITTER, eb=8,
                                       interpret=True))
    shared = [a[0:1].expand(9, *a.shape[1:]) for a in (X, Y)]
    _close(schedule_twin(*shared, th, fam, n_ls),
           jfl.small_lml_value_grad(j32(X[0]), j32(Y[0]), j32(th), fam, n_ls, True, JITTER, eb=8,
                                    interpret=True))


# n = 20 and 32: every family at (D, p) = (2, 2), every (D, p) with rbf and
# matern52, both lengthscale forms
LARGE = [c for c in CASES if c[1] >= 20 and (c[2:4] == (2, 2) or c[0] in ("rbf", "matern52"))
         and (c[4] > 1) == ((c[1] + c[3]) % 2 == 0)]


@pytest.mark.parametrize("case", LARGE, ids=lambda c: f"{c[0]}-n{c[1]}-D{c[2]}-p{c[3]}-nls{c[4]}")
def test_schedule_matches_jax_reference(case):
    """n = 20 and 32 against the JAX package's plain reference of the shared
    data kernel (lane 0's dataset for every lane)."""
    fam, n, D, p, n_ls = case
    X, Y, th = _inputs(n, D, p, n_ls, E=4, seed=11)
    j32 = lambda a: jnp.asarray(a.numpy())
    shared = [a[0:1].expand(4, *a.shape[1:]) for a in (X, Y)]
    _close(schedule_twin(*shared, th, fam, n_ls),
           jfl.small_lml_value_grad_ref(j32(X[0]), j32(Y[0]), j32(th), fam, n_ls, True, JITTER))


@pytest.mark.parametrize("n", [1, 20, 32])
def test_schedule_value_only_equals_the_full_value(n):
    """The value-only instance runs the same value code: the same bits."""
    X, Y, th = _inputs(n, 12, 12, 12, seed=n)
    full, _ = schedule_twin(X, Y, th, "matern32", 12)
    alone, none = schedule_twin(X, Y, th, "matern32", 12, with_grad=False)
    assert none is None and torch.equal(full, alone)


def test_schedule_nan_in_a_bad_lane_only():
    """A lane whose Gram is not positive definite is NaN there only."""
    X, Y, _ = _inputs(6, 2, 1, 1, E=3)
    X[1, 1] = X[1, 0]
    th = torch.zeros(2, 3)
    val, grad = schedule_twin(X, Y, th, "rbf", 1, has_noise=False, jitter=-1e-4)
    assert torch.isnan(val[1]) and torch.isnan(grad[:, 1]).all()
    assert torch.isfinite(val[[0, 2]]).all() and torch.isfinite(grad[:, [0, 2]]).all()


@pytest.mark.parametrize("D,p,n_ls", [(2, 2, 2), (12, 12, 1), (3, 1, 1)])
def test_value_only_wrapper_equals_the_full_wrapper_bit_for_bit(D, p, n_ls, monkeypatch):
    """``_small_lml_value_md`` on the CPU: the plain twin's values, bit for
    bit those of ``small_lml_value_grad_md``, no launch counted."""
    monkeypatch.setattr(tfl.small_lml_value_grad_md, "launches", 0)
    monkeypatch.setattr(tfl.small_lml_value_grad_md, "value_only_launches", 0)
    X, Y, th = _inputs(20, D, p, n_ls, E=7, seed=D * p)
    full, _ = tfl.small_lml_value_grad_md(X, Y, th, "matern52", n_ls, True, JITTER)
    alone = tfl._small_lml_value_md(X, Y, th, "matern52", n_ls, True, JITTER)
    assert torch.equal(full, alone)
    assert tfl.small_lml_value_grad_md.launches == 0
    assert tfl.small_lml_value_grad_md.value_only_launches == 0
    with pytest.raises(ValueError, match="lanes"):
        tfl._small_lml_value_md(X, Y, th[:, :3], "matern52", n_ls, True)


def test_fit_ensemble_fused_same_with_and_without_the_value_only_route(monkeypatch):
    """The line search's candidates through the value-only twin or through
    the full one: the same fitted theta and LML, bit for bit."""
    X, dX, S, S1 = chip_smoke.make_workload(n_traj=30)
    T = torch.as_tensor(chip_smoke.fit_targets(S1, 6))
    src = torch.as_tensor(S)[None].expand(6, -1, -1)
    kern = chip_smoke.fit_kernel(dtype=torch.float32, device="cpu")

    def run():
        return tgp.fit_ensemble_fused(kern, src, T - src, n_restarts=2, maxiter=5,
                                      generator=torch.Generator().manual_seed(3))

    th_a, lml_a = run()
    calls = []
    monkeypatch.setattr(tfl, "_small_lml_value_md",
                        lambda *a, **k: calls.append(1) or tfl.small_lml_value_grad_md(*a, **k)[0])
    th_b, lml_b = run()
    assert len(calls) == 5 * 6
    assert torch.equal(th_a, th_b) and torch.equal(lml_a, lml_b)
