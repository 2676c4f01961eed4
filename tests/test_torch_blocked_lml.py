"""Port parity: the blocked large-N LML and its closed-form gradient
(``ops/blocked_lml.py``) against the JAX package's, whose ``factor_panel``
runs in Pallas interpret mode (as tests/test_blocked_lml.py runs it), and
against dense float64 linear algebra and autograd."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.ops import blocked_lml as jbl
from gaussian_process_transportation_tpu_torch.ops import blocked_chol as tbc
from gaussian_process_transportation_tpu_torch.ops import blocked_lml as tbl
from gaussian_process_transportation_tpu_torch.ops.blocked_chol import (
    cholesky_panels,
    stationary_gram_panels,
)
from gaussian_process_transportation_tpu_torch.ops.pallas_gram import stationary_gram_plain

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

FAMILIES = ("rbf", "matern12", "matern32", "matern52")
N, D, P_OUT, B = 600, 3, 2, 128  # five panels, the last one padded
LOG_AMP, LOG_NOISE = 0.3, math.log(0.05)
LOG_LS = {"iso": np.float32(0.2), "ard": np.array([0.1, -0.2, 0.4], np.float32)}
JITTER = 1e-6


def _data(dtype=np.float32):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D))
    Y = np.sin(X[:, :P_OUT]) + 0.1 * rng.standard_normal((N, P_OUT))
    return X.astype(dtype), Y.astype(dtype)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's value and gradient for every family and lengthscale form, run
    once for the module (the interpret-mode compile is the cost)."""
    X, Y = _data()
    out = {}
    for fam in FAMILIES:
        for form, log_ls in LOG_LS.items():
            v, g = jbl.blocked_lml_value_and_grad(
                jnp.asarray(X), jnp.asarray(Y), fam, jnp.float32(LOG_AMP), jnp.asarray(log_ls),
                jnp.float32(LOG_NOISE), jitter=JITTER, block=B,
                precision=jax.lax.Precision.HIGHEST, interpret=True)
            out[fam, form] = float(v), [np.asarray(x, np.float64) for x in g]
    return out


@pytest.mark.parametrize("form", sorted(LOG_LS))
@pytest.mark.parametrize("family", FAMILIES)
def test_value_and_grad_match_jax(jax_runs, family, form):
    """float32 on both sides, the factorizations by different routines (the
    JAX Pallas panel factor, torch.linalg on the CPU): the value to 2e-6 of
    its magnitude plus the N·P terms it sums (it cancels to near 0 for
    some families), each gradient entry to 1e-3 of the largest."""
    X, Y = _data()
    v, g = tbl.blocked_lml_value_and_grad(torch.as_tensor(X), torch.as_tensor(Y), family,
                                          LOG_AMP, torch.as_tensor(LOG_LS[form]), LOG_NOISE,
                                          jitter=JITTER, block=B)
    v_j, g_j = jax_runs[family, form]
    assert v.dtype == torch.float32
    assert abs(v.item() - v_j) <= 2e-6 * (abs(v_j) + N * P_OUT)
    got = np.concatenate([np.ravel(x.double().numpy()) for x in g])
    want = np.concatenate([np.ravel(x) for x in g_j])
    assert got.shape == (D + 2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def _dense_f64(X, Y, family, log_amp, log_ls, log_noise):
    """The dense LML and its autograd gradient in float64."""
    th = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
          for x in (log_amp, log_ls, log_noise)]
    K = stationary_gram_plain(X, X, torch.exp(th[1]), torch.exp(th[0]), family)
    K = K + (torch.exp(th[2]) + JITTER) * torch.eye(N, dtype=torch.float64)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(Y, L)
    val = -0.5 * (Y * alpha).sum() - P_OUT * (torch.log(torch.diagonal(L)).sum()
                                              + 0.5 * N * math.log(2 * math.pi))
    val.backward()
    return val.item(), [t.grad for t in th]


@pytest.mark.parametrize("form", sorted(LOG_LS))
@pytest.mark.parametrize("family", FAMILIES)
def test_value_and_grad_match_dense_f64_autograd(family, form):
    """In float64 the blocked route is the dense formula reordered: value
    and gradient to 1e-9 of their magnitude.  An isotropic ℓ's gradient is
    the sum of the per-axis ones."""
    X, Y = (torch.as_tensor(a) for a in _data(np.float64))
    log_ls = np.asarray(LOG_LS[form], np.float64)
    v, (g_amp, g_ls, g_noise) = tbl.blocked_lml_value_and_grad(
        X, Y, family, LOG_AMP, torch.as_tensor(log_ls), LOG_NOISE, jitter=JITTER, block=B)
    v64, (ga, gl, gn) = _dense_f64(X, Y, family, LOG_AMP, log_ls, LOG_NOISE)
    assert abs(v.item() - v64) <= 1e-9 * abs(v64)
    g_ls = g_ls.sum() if form == "iso" else g_ls
    got = torch.cat([g_amp.reshape(1), g_ls.reshape(-1), g_noise.reshape(1)])
    want = torch.cat([ga.reshape(1), gl.reshape(-1), gn.reshape(1)])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-9 * want.abs().max().item())


def _chol_f64(n=300, block=B):
    X = torch.as_tensor(np.random.default_rng(1).standard_normal((n, D)))
    panels, _ = stationary_gram_panels(X, torch.ones(D, dtype=torch.float64), 1.5, 0.1, block)
    K = stationary_gram_plain(X, X, torch.ones(D, dtype=torch.float64), 1.5)
    return cholesky_panels(panels, n), K + 0.1 * torch.eye(n, dtype=torch.float64)


def _assemble(panels, n):
    return tbl._dense_lower(panels)[:n, :n]


def test_tri_inverse_panels_match_torch_linalg():
    """L⁻¹ in panel form (n = 300 padded to 384) against
    torch.linalg.solve_triangular in float64, to 1e-12 of its largest
    entry; exactly lower-triangular."""
    chol, K = _chol_f64()
    T = _assemble(tbl.tri_inverse_panels(chol), 300)
    L = torch.linalg.cholesky(K)
    want = torch.linalg.solve_triangular(L, torch.eye(300, dtype=torch.float64), upper=False)
    torch.testing.assert_close(T, want, rtol=0, atol=1e-12 * want.abs().max().item())
    assert torch.equal(torch.triu(T, 1), torch.zeros_like(T))


@pytest.mark.parametrize("chunks", [1, 6])
def test_kinv_panels_match_torch_linalg(chunks):
    """K⁻¹'s lower panels against torch.linalg.inv in float64, to 1e-11 of
    its largest entry, with and without the chunked products, from the
    panels of tri_inverse_panels or computed inside."""
    chol, K = _chol_f64()
    want = torch.tril(torch.linalg.inv(K))
    for tinv in (None, tbl.tri_inverse_panels(chol, chunks=chunks)):
        got = torch.tril(_assemble(tbl.kinv_panels(chol, tinv=tinv, chunks=chunks), 300))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-11 * want.abs().max().item())


@pytest.mark.parametrize("panels,want", [(31, 1), (32, 2)])
def test_auto_refine_iters_is_one_below_32_panels_and_two_from_32(monkeypatch, panels, want):
    """refine_iters=None refines like gram_cholesky_solve (1 step below 32
    panels, 2 from 32), not JAX's fixed 1: counted as residual products at
    B = 128, the smallest panel factor_panel takes, one a step and one of
    the unrefined α (the guard compares each step's residual with it); an
    explicit count holds."""
    calls = []
    real = tbc.symmetric_matvec_panels
    monkeypatch.setattr(tbc, "symmetric_matvec_panels",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    n = panels * B - 5
    X = torch.as_tensor(np.random.default_rng(2).standard_normal((n, 1)), dtype=torch.float32)
    for refine_iters, expected in ((None, want), (3, 3)):
        calls.clear()
        v = tbl.blocked_lml_value(X, torch.sin(X), "rbf", 0.0, 0.0, math.log(0.1), block=B,
                                  refine_iters=refine_iters)
        assert torch.isfinite(v) and len(calls) == expected + 1
    assert tbl.refine_steps(panels) == want


def test_make_blocked_lml_backward_is_the_closed_form():
    """autograd through make_blocked_lml gives blocked_lml_value_and_grad's
    gradient bit for bit (a shared ℓ gets the sum over axes), −α for Y
    and none for X; its value is the same bits too."""
    X, Y = (torch.as_tensor(a) for a in _data(np.float64))
    X, Y = X[:260], Y[:260]
    lml = tbl.make_blocked_lml("matern52", jitter=JITTER, block=B)
    theta = {"log_amp": torch.tensor(LOG_AMP, dtype=torch.float64, requires_grad=True),
             "log_ls": torch.tensor(0.2, dtype=torch.float64, requires_grad=True),
             "log_noise": torch.tensor(LOG_NOISE, dtype=torch.float64, requires_grad=True)}
    Yg = Y.clone().requires_grad_()
    val = lml(theta, X, Yg)
    val.backward()
    v, (g_amp, g_ls, g_noise) = tbl.blocked_lml_value_and_grad(
        X, Y, "matern52", LOG_AMP, 0.2, LOG_NOISE, jitter=JITTER, block=B)
    assert torch.equal(val.detach(), v)
    assert torch.equal(theta["log_amp"].grad, g_amp) and torch.equal(theta["log_noise"].grad,
                                                                      g_noise)
    assert theta["log_ls"].grad.shape == () and torch.equal(theta["log_ls"].grad, g_ls.sum())
    K = stationary_gram_plain(X, X, math.exp(0.2), math.exp(LOG_AMP), "matern52")
    K = K + (math.exp(LOG_NOISE) + JITTER) * torch.eye(260, dtype=torch.float64)
    torch.testing.assert_close(Yg.grad, -torch.linalg.solve(K, Y), rtol=1e-8, atol=1e-8)


# ---- precision= and the guarded refinement ----------------------------------

def _theta():
    return LOG_AMP, torch.as_tensor(LOG_LS["ard"]), LOG_NOISE


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("precision", ["default", "high"])
def test_every_precision_is_highest_bit_for_bit_on_the_cpu(precision, dtype):
    """As JAX's CPU backend: value, gradient and make_blocked_lml's backward
    at any precision are "highest"'s bits on CPU tensors."""
    X, Y = (torch.as_tensor(a) for a in _data(dtype))
    X, Y = X[:300], Y[:300]
    want = tbl.blocked_lml_value_and_grad(X, Y, "rbf", *_theta(), jitter=JITTER, block=B)
    got = tbl.blocked_lml_value_and_grad(X, Y, "rbf", *_theta(), jitter=JITTER, block=B,
                                         precision=precision)
    assert torch.equal(got[0], want[0]) and all(map(torch.equal, got[1], want[1]))
    theta = {"log_amp": torch.tensor(LOG_AMP, dtype=X.dtype, requires_grad=True),
             "log_ls": torch.as_tensor(LOG_LS["ard"], dtype=X.dtype).requires_grad_(),
             "log_noise": torch.tensor(LOG_NOISE, dtype=X.dtype, requires_grad=True)}
    val = tbl.make_blocked_lml("rbf", jitter=JITTER, block=B, precision=precision)(theta, X, Y)
    val.backward()
    assert torch.equal(val.detach(), want[0]) and torch.equal(theta["log_ls"].grad, want[1][1])
    chol, _ = _chol_f64()
    assert torch.equal(_assemble(tbl.kinv_panels(chol, precision), 300),
                       _assemble(tbl.kinv_panels(chol), 300))


def test_an_unknown_precision_is_refused():
    X, Y = (torch.as_tensor(a) for a in _data())
    with pytest.raises(ValueError, match="precision"):
        tbl.blocked_lml_value_and_grad(X, Y, "rbf", *_theta(), block=B, precision="HIGHEST")
    with pytest.raises(ValueError, match="precision"):
        tbl.make_blocked_lml("rbf", precision="bf16")
    with pytest.raises(ValueError, match="precision"):
        tbl.tri_inverse_panels(_chol_f64()[0], "fast")


@pytest.fixture(scope="module")
def jax_high():
    """JAX's rbf value and gradient at Precision.HIGH (interpret mode)."""
    X, Y = _data()
    v, g = jbl.blocked_lml_value_and_grad(
        jnp.asarray(X), jnp.asarray(Y), "rbf", jnp.float32(LOG_AMP), jnp.asarray(LOG_LS["ard"]),
        jnp.float32(LOG_NOISE), jitter=JITTER, block=B, precision=jax.lax.Precision.HIGH,
        interpret=True)
    return float(v), np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in g])


def _close_to(v, g, ref):
    """test_value_and_grad_match_jax's tolerances."""
    v_j, want = ref
    got = np.concatenate([np.ravel(x.double().numpy()) for x in g])
    assert abs(v.item() - v_j) <= 2e-6 * (abs(v_j) + N * P_OUT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_jax_at_high_on_the_cpu_is_the_ports_high(jax_high):
    X, Y = (torch.as_tensor(a) for a in _data())
    _close_to(*tbl.blocked_lml_value_and_grad(X, Y, "rbf", *_theta(), jitter=JITTER, block=B,
                                              precision="high"), jax_high)


def test_the_split_route_keeps_value_and_gradient(monkeypatch):
    """The card's split route (the factor, L and L⁻¹'s block rows split into
    bfloat16 parts once each, products of the parts widened to float32),
    emulated on the CPU, against the float64 blocked LML (the dense formula
    to 1e-9): the parts carry 16 bits of each operand where float32 carries
    24, so "high"'s tolerances are "highest"'s against JAX scaled 50x for
    the value, 1e-3 of the largest gradient entry (read 0.024 and 1.2e-4
    here; "highest" 0.0014 and 3.4e-6).  "default" loses definiteness on
    this Gram and reads NaN."""
    from gaussian_process_transportation_tpu_torch.ops import linalg as tlin

    X, Y = (torch.as_tensor(a) for a in _data())
    v64, g64 = tbl.blocked_lml_value_and_grad(X.double(), Y.double(), "rbf", *_theta(),
                                              jitter=JITTER, block=B)
    g64 = torch.cat([g.reshape(-1) for g in g64])
    v_highest = tbl.blocked_lml_value_and_grad(X, Y, "rbf", *_theta(), jitter=JITTER, block=B)[0]

    def reduced(a, precision):
        return tlin.check_precision(precision) != "highest" and a.dtype == torch.float32

    for m in (tlin, tbc, tbl):
        monkeypatch.setattr(m, "reduced", reduced)
    v, g = tbl.blocked_lml_value_and_grad(X, Y, "rbf", *_theta(), jitter=JITTER, block=B,
                                          precision="high")
    g = torch.cat([x.reshape(-1) for x in g]).double()
    assert v.item() != v_highest.item()
    assert abs(v.item() - v64.item()) <= 1e-4 * (abs(v64.item()) + N * P_OUT)
    assert (g - g64).abs().max() <= 1e-3 * g64.abs().max()
    v_d, _ = tbl.blocked_lml_value_and_grad(X, Y, "rbf", *_theta(), jitter=JITTER, block=B,
                                            precision="default")
    assert torch.isnan(v_d)


def _unguarded_forward(X, Y, steps):
    """_lml_forward with JAX's refinement: every step kept."""
    amp, ls, noise = tbl._hyper(*_theta(), X)
    n = X.shape[0]
    panels, _ = stationary_gram_panels(X, ls, amp, noise + JITTER, B, "rbf")
    chol = tbl.cholesky_panels(panels, n)
    alpha = chol.solve(Y)
    for _ in range(steps):
        alpha = alpha + chol.solve(Y - tbc.symmetric_matvec_panels(panels, alpha, n))
    val = -0.5 * (Y * alpha).sum() - Y.shape[1] * (0.5 * chol.logdet()
                                                   + 0.5 * n * math.log(2 * math.pi))
    return val, chol, alpha, panels


@pytest.mark.parametrize("factor", ["exact", "diverging"])
def test_refinement_keeps_a_step_only_where_it_lowers_the_residual(monkeypatch, jax_runs, factor):
    """float32, the module's 600 points.  With the Gram's own factor the one
    step lowers each column's residual: value and gradient are the unguarded
    loop's bit for bit and within test_value_and_grad_match_jax's tolerance
    of JAX's.  With a factor whose preconditioned Gram has eigenvalues past 2
    (the factor of K − 0.9·σ²·I), the unguarded residual grows at each of
    three steps; the guarded α's residual is no larger than the unrefined
    solve's."""
    X, Y = (torch.as_tensor(a) for a in _data())
    amp, ls, noise = tbl._hyper(*_theta(), X)
    if factor == "diverging":
        real = tbl.cholesky_panels

        def shifted(panels, n, precision="highest", group=None):
            moved = [p.clone() for p in panels]
            for p in moved:
                p[:B].diagonal().sub_(0.9 * noise.item())
            return real(moved, n, precision)

        monkeypatch.setattr(tbl, "cholesky_panels", shifted)
    steps = 1 if factor == "exact" else 3
    val, chol, alpha = tbl._lml_forward(X, Y, "rbf", amp, ls, noise, JITTER, B, steps, "highest")
    resid = lambda a: torch.linalg.vector_norm(Y - tbc.symmetric_matvec_panels(panels, a, N), dim=0)
    plain = [_unguarded_forward(X, Y, k) for k in range(steps + 1)]
    panels = plain[0][3]
    norms = torch.stack([resid(p[2]) for p in plain])
    if factor == "exact":
        assert bool((norms[1] < norms[0]).all())
        assert torch.equal(val, plain[1][0]) and torch.equal(alpha, plain[1][2])
        g = tbl._lml_gradient(X, "rbf", amp, ls, noise, chol, alpha, P_OUT, "highest")
        g_plain = tbl._lml_gradient(X, "rbf", amp, ls, noise, plain[1][1], plain[1][2], P_OUT,
                                    "highest")
        assert all(map(torch.equal, g, g_plain))
        _close_to(val, g, (jax_runs["rbf", "ard"][0],
                           np.concatenate([np.ravel(x) for x in jax_runs["rbf", "ard"][1]])))
    else:
        assert bool((norms[1:] > norms[:-1]).all())
        assert bool((resid(alpha) <= norms[0]).all())
