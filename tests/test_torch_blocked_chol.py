"""Port parity: the blocked Cholesky (``ops/blocked_chol.py``) against the
JAX package's, whose panel kernel runs in Pallas interpret mode here.

CPU tensors take ``factor_panel``'s plain twin.  Float32 cases hold the
port to the JAX tests' own tolerances against float64 (5e-6 relative for
one panel, 1e-5 for a whole factor, 2e-4 relative for a GP solve) and to
the JAX result; float64 cases hold the port's algebra to numpy tightly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.ops import blocked_chol as jbc
from gaussian_process_transportation_tpu_torch.ops import blocked_chol as tbc

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

FAMILIES = ("rbf", "matern12", "matern32", "matern52")


def _spd(n, seed=0):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _dense_gram(X, ls, amp, family):
    d2 = (((X[:, None, :] - X[None, :, :]) / ls) ** 2).sum(-1)
    return amp * np.asarray(jbc.stationary_from_sqdist(jnp.asarray(d2), family))


@pytest.mark.parametrize("B", [128, 256])
def test_factor_panel_matches_jax_kernel(B):
    K = _spd(B, seed=B).astype(np.float32)
    jL, jLinv = jbc.factor_panel(jnp.asarray(K), interpret=True)
    tL, tLinv = tbc.factor_panel(torch.as_tensor(K))
    L64 = np.linalg.cholesky(K.astype(np.float64))
    Linv64 = np.linalg.inv(L64)
    assert _rel(tL, L64) < 5e-6 and _rel(tLinv, Linv64) < 5e-6
    assert _rel(tL, jL) < 1e-5 and _rel(tLinv, jLinv) < 1e-5
    assert not np.triu(tL.numpy(), 1).any() and not np.triu(tLinv.numpy(), 1).any()


def _doubling(L, X, w0):
    """X = L⁻¹ from its diagonal tiles of width w0 by recursive doubling,
    in place: for pairs of width w, T = L₂₁X₁₁, then X₂₁ = −X₂₂T."""
    B = L.shape[0]
    w = w0
    while w < B:
        for st in range(0, B - w, 2 * w):
            first, second = slice(st, st + w), slice(st + w, min(st + 2 * w, B))
            T = L[second, first] @ X[first, first]
            X[second, first] = -X[second, second] @ T
        w *= 2


def _diag_twin(D, tile=32):
    """The diag step of the panel kernel on one sub-block: right-looking over
    32-wide panels (factor the 32 × 32 tile, solve the rows below against
    it, update the trailing block), then the tiles' inverses and X's
    off-diagonal tiles by doubling; reads the lower part of D only."""
    n = D.shape[0]
    M = torch.tril(D) + torch.tril(D, -1).T
    X = torch.zeros_like(D)
    for c in range(0, n, tile):
        t, below = slice(c, c + tile), slice(c + tile, n)
        Ltt = torch.linalg.cholesky(M[t, t])
        Xtt = torch.linalg.solve_triangular(Ltt, torch.eye(tile, dtype=D.dtype), upper=False)
        M[t, t], X[t, t] = Ltt, Xtt
        M[below, t] = M[below, t] @ Xtt.T
        M[below, below] -= M[below, t] @ M[below, t].T
    L = torch.tril(M)
    _doubling(L, X, tile)
    return L, X


def _panel_schedule_twin(A, sb=tbc.SUB_BLOCK):
    """The launch sequence of ``csrc/factor_panel.cu`` step for step in
    torch ops (tests only): init, then for each sub-block s diag (chol and
    inverse of the updated block, as ``_diag_twin``), col_solve (L_is =
    A'_is X_ssᵀ) and trail
    (A'_ij −= L_is L_jsᵀ over the lower blocks, j > s), then the recursive
    doubling of L⁻¹ (T = L₂₁X₁₁, X₂₁ = −X₂₂T) level by level."""
    B = A.shape[0]
    NB = B // sb
    blk = lambda s: slice(s * sb, (s + 1) * sb)
    L = A.clone()
    X = torch.zeros_like(A)
    for s in range(NB):
        Lss, Xss = _diag_twin(L[blk(s), blk(s)])
        L[blk(s), blk(s)] = Lss
        X[blk(s), blk(s)] = Xss
        below = slice((s + 1) * sb, B)
        L[below, blk(s)] = L[below, blk(s)] @ Xss.T
        for j in range(s + 1, NB):
            for i in range(j, NB):
                L[blk(i), blk(j)] -= L[blk(i), blk(s)] @ L[blk(j), blk(s)].T
    L = torch.tril(L)
    _doubling(L, X, sb)
    return L, X


@pytest.mark.parametrize("B", [128, 256, 384, 512])
def test_panel_schedule_matches_f64_and_jax(B):
    """The schedule of the card's kernels, in float32, against f64 to the
    JAX panel kernel's 5e-6 bound, against JAX's ``factor_panel`` in
    interpret mode, and exactly lower-triangular; in float64 against numpy
    tightly.  B = 384 is a ragged doubling (three sub-blocks)."""
    K = _spd(B, seed=B)
    L, Linv = _panel_schedule_twin(torch.as_tensor(K.astype(np.float32)))
    L64 = np.linalg.cholesky(K)
    Linv64 = np.linalg.inv(L64)
    assert _rel(L, L64) < 5e-6 and _rel(Linv, Linv64) < 5e-6
    assert not np.triu(L.numpy(), 1).any() and not np.triu(Linv.numpy(), 1).any()
    if B != 384:
        jL, jLinv = jbc.factor_panel(jnp.asarray(K, jnp.float32), interpret=True)
        assert _rel(L, jL) < 1e-5 and _rel(Linv, jLinv) < 1e-5
    L_d, Linv_d = _panel_schedule_twin(torch.as_tensor(K))
    np.testing.assert_allclose(L_d.numpy(), L64, rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(Linv_d.numpy(), Linv64, rtol=1e-10, atol=1e-12)


def test_factor_panel_keeps_float64_and_refuses_bad_blocks():
    K = _spd(128)
    L, Linv = tbc.factor_panel(torch.as_tensor(K))
    assert L.dtype == torch.float64
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((L @ Linv).numpy(), np.eye(128), atol=1e-12)
    for shape in ((100, 100), (128, 256), (0, 0)):
        with pytest.raises(ValueError):
            tbc.factor_panel(torch.zeros(shape))


@pytest.mark.parametrize("n,B", [(500, 128), (300, 256)])
def test_blocked_cholesky_matches_jax(n, B):
    K = _spd(n, seed=n).astype(np.float32)
    want = jbc.blocked_cholesky(jnp.asarray(K), block=B, interpret=True).dense()
    got = tbc.blocked_cholesky(torch.as_tensor(K), block=B).dense()
    L64 = np.linalg.cholesky(K.astype(np.float64))
    assert _rel(got, L64) < 1e-5
    assert _rel(got, want) < 1e-5


def test_blocked_solve_solve_lower_and_logdet_match_numpy():
    n, B = 500, 128
    K = _spd(n, seed=1)
    b = np.random.default_rng(2).standard_normal((n, 3))
    ch = tbc.blocked_cholesky(torch.as_tensor(K), block=B)
    assert ch.padded_n == 512 and ch.block == B and len(ch.panels) == 4
    np.testing.assert_allclose(ch.solve(torch.as_tensor(b)).numpy(), np.linalg.solve(K, b),
                               rtol=1e-10, atol=1e-12)
    x1 = ch.solve(torch.as_tensor(b[:, 0]))
    assert x1.shape == (n,)
    L = np.linalg.cholesky(K)
    np.testing.assert_allclose(ch.solve_lower(torch.as_tensor(b)).numpy(),
                               np.linalg.solve(L, b), rtol=1e-10, atol=1e-12)
    assert abs(ch.logdet().item() - np.linalg.slogdet(K)[1]) < 1e-8 * abs(np.linalg.slogdet(K)[1])


def test_blocked_solve_float32_matches_jax():
    n, B = 500, 128
    K = _spd(n, seed=3).astype(np.float32)
    b = np.random.default_rng(4).standard_normal((n, 3)).astype(np.float32)
    jch = jbc.blocked_cholesky(jnp.asarray(K), block=B, interpret=True)
    tch = tbc.blocked_cholesky(torch.as_tensor(K), block=B)
    x64 = np.linalg.solve(K.astype(np.float64), b)
    assert _rel(tch.solve(torch.as_tensor(b)), x64) < 1e-4
    assert _rel(tch.solve(torch.as_tensor(b)), jch.solve(jnp.asarray(b))) < 1e-4
    assert _rel(tch.solve_lower(torch.as_tensor(b)), jch.solve_lower(jnp.asarray(b))) < 1e-4
    assert abs(tch.logdet().item() - float(jch.logdet())) < 1e-5 * abs(float(jch.logdet()))


@pytest.mark.parametrize("family", FAMILIES)
def test_stationary_gram_panels_match_jax(family):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((200, 3)).astype(np.float32)
    ls = np.array([1.5, 0.8, 1.2], np.float32)
    jp, jn = jbc.stationary_gram_panels(jnp.asarray(X), jnp.asarray(ls), 2.0, 0.1, 128,
                                        family=family)
    tp, tn = tbc.stationary_gram_panels(torch.as_tensor(X), torch.as_tensor(ls), 2.0, 0.1, 128,
                                        family=family)
    assert tn == jn == 200 and len(tp) == len(jp) == 2
    for a, b in zip(tp, jp):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    # the padding rows are far pseudo-points: zero coupling, amp+noise diagonal
    assert not tp[1][72:, :72].any()
    np.testing.assert_allclose(torch.diagonal(tp[1])[72:].numpy(), 2.1, rtol=1e-6)


@pytest.mark.parametrize("noise_form", ["float", "0-d tensor"])
@pytest.mark.parametrize("D", [1, 2, 3, 5])
@pytest.mark.parametrize("family", FAMILIES)
def test_stationary_gram_panels_of_any_d_match_jax_in_one_buffer(family, D, noise_form):
    """A ragged n (150 in blocks of 64), the D of every kernel instance (5:
    the run-time one), the noise as a number and as a 0-d tensor: the twin's
    panels to JAX's within 2e-6 (f32 sums in another order), laid out in one
    buffer at ``panel_offsets`` with JAX's shapes."""
    n, B = 150, 64
    X = np.random.default_rng(D).standard_normal((n, D)).astype(np.float32)
    ls = np.linspace(0.8, 1.5, D).astype(np.float32)
    jp, _ = jbc.stationary_gram_panels(jnp.asarray(X), jnp.asarray(ls), 2.0, 0.1, B,
                                       family=family)
    noise = 0.1 if noise_form == "float" else torch.tensor(0.1)
    tp, tn = tbc.stationary_gram_panels(torch.as_tensor(X), torch.as_tensor(ls), 2.0, noise, B,
                                        family=family)
    assert tn == n and [tuple(p.shape) for p in tp] == [tuple(p.shape) for p in jp]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    base = tp[0].data_ptr()
    assert [(p.data_ptr() - base) // 4 for p in tp] == tbc.panel_offsets(n, B)[:-1]
    assert tp[0].untyped_storage().nbytes() == 4 * tbc.panel_offsets(n, B)[-1]


def test_stationary_gram_panels_into_fills_a_given_cpu_buffer():
    X = torch.as_tensor(np.random.default_rng(13).standard_normal((200, 3)))
    want, _ = tbc.stationary_gram_panels_plain(X, 1.3, 2.0, 0.1, 128, "matern32")
    buf = torch.full((tbc.panel_offsets(200, 128)[-1],), float("nan"), dtype=torch.float64)
    got = tbc.stationary_gram_panels_into(buf, X, 1.3, 2.0, 0.1, 128, "matern32")
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and not buf.isnan().any()
    assert got[0].data_ptr() == buf.data_ptr()


@pytest.mark.parametrize("family", FAMILIES)
def test_stationary_from_sqdist_matches_jax(family):
    d2 = np.linspace(0.0, 9.0, 50)
    np.testing.assert_allclose(tbc.stationary_from_sqdist(torch.as_tensor(d2), family).numpy(),
                               np.asarray(jbc.stationary_from_sqdist(jnp.asarray(d2), family)),
                               rtol=1e-13, atol=1e-15)


def test_stationary_from_sqdist_refuses_unknown_family():
    with pytest.raises(ValueError):
        tbc.stationary_from_sqdist(torch.zeros(3), "cosine")


def test_symmetric_matvec_panels_is_k_times_x():
    K = _spd(300, seed=6)
    x = np.random.default_rng(7).standard_normal((300, 2))
    panels = tbc._split_panels(torch.as_tensor(K), 128, 300)
    np.testing.assert_allclose(tbc.symmetric_matvec_panels(panels, torch.as_tensor(x), 300).numpy(),
                               K @ x, rtol=1e-12, atol=1e-10)
    y1 = tbc.symmetric_matvec_panels(panels, torch.as_tensor(x[:, 0]), 300)
    assert y1.shape == (300,)


@pytest.mark.parametrize("family", ["rbf", "matern52"])
def test_gram_cholesky_solve_matches_jax(family):
    rng = np.random.default_rng(8)
    X = rng.standard_normal((300, 3))
    Y = rng.standard_normal((300, 2))
    ls = np.array([1.5, 0.8, 1.2])
    ja, _ = jbc.gram_cholesky_solve(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
                                    jnp.asarray(ls, jnp.float32), 2.0, 0.1, block=128,
                                    interpret=True, family=family)
    ta, tch = tbc.gram_cholesky_solve(torch.as_tensor(X, dtype=torch.float32),
                                      torch.as_tensor(Y, dtype=torch.float32),
                                      torch.as_tensor(ls, dtype=torch.float32), 2.0, 0.1,
                                      block=128, family=family)
    a64 = np.linalg.solve(_dense_gram(X, ls, 2.0, family) + 0.1 * np.eye(300), Y)
    assert ta.dtype == torch.float32 and tch.n == 300
    assert _rel(ta, a64) < 2e-4
    assert _rel(ta, ja) < 2e-4


def test_gram_cholesky_solve_float64_is_the_dense_solve():
    rng = np.random.default_rng(9)
    X, Y = rng.standard_normal((260, 2)), rng.standard_normal(260)
    alpha, _ = tbc.gram_cholesky_solve(torch.as_tensor(X), torch.as_tensor(Y), 1.3, 1.5, 0.05,
                                       block=128, family="matern32")
    assert alpha.shape == (260,)
    want = np.linalg.solve(_dense_gram(X, 1.3, 1.5, "matern32") + 0.05 * np.eye(260), Y)
    np.testing.assert_allclose(alpha.numpy(), want, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("panels,threshold,solves", [(3, 32, 2), (3, 3, 3)])
def test_refine_iters_auto_rule(monkeypatch, panels, threshold, solves):
    """1 refinement step below the threshold panel count, 2 from it up."""
    monkeypatch.setattr(tbc, "_TWO_REFINE_MIN_PANELS", threshold)
    calls = []
    real = tbc.BlockedCholesky.solve
    monkeypatch.setattr(tbc.BlockedCholesky, "solve",
                        lambda self, b, *args: calls.append(1) or real(self, b, *args))
    X = np.random.default_rng(10).standard_normal((128 * panels - 5, 2))
    tbc.gram_cholesky_solve(torch.as_tensor(X), torch.as_tensor(X), 1.0, 1.0, 0.1, block=128)
    assert len(calls) == solves


def _plain_refinement(panels, chol, Y, n, steps):
    """α = K⁻¹Y refined ``steps`` times with no test of the residual."""
    alpha = chol.solve(Y)
    for _ in range(steps):
        alpha = alpha + chol.solve(Y - tbc.symmetric_matvec_panels(panels, alpha, n))
    return alpha


@pytest.mark.parametrize("factor", ["exact", "diverging"])
def test_refinement_keeps_a_step_only_where_it_lowers_the_residual(monkeypatch, factor):
    """float32, 300 points.  With the Gram's own factor the one step lowers
    each column's residual and α is the plain refinement's bit for bit.
    With a factor whose preconditioned Gram has eigenvalues past 2 (the
    factor of K − 0.9·noise·I, as a float32 factor at κ·ε32 > 1 behaves),
    the plain refinement's residual grows at each of three steps; the solve
    keeps the unrefined α, nearer the float64 solution."""
    rng = np.random.default_rng(13)
    X = torch.as_tensor(rng.standard_normal((300, 2)), dtype=torch.float32)
    Y = torch.as_tensor(rng.standard_normal((300, 2)), dtype=torch.float32)
    noise = 0.05
    real = tbc.cholesky_panels
    if factor == "diverging":
        def shifted(panels, n, precision="highest", group=None):
            moved = [p.clone() for p in panels]
            for p in moved:
                p[:128].diagonal().sub_(0.9 * noise)
            return real(moved, n, precision)
        monkeypatch.setattr(tbc, "cholesky_panels", shifted)
    steps = 1 if factor == "exact" else 3
    alpha, chol = tbc.gram_cholesky_solve(X, Y, 1.0, 1.0, noise, block=128, refine_iters=steps)
    panels, n = tbc.stationary_gram_panels(X, 1.0, 1.0, noise, 128, "rbf")
    resid = torch.stack([
        torch.linalg.vector_norm(Y - tbc.symmetric_matvec_panels(panels, a, n), dim=0)
        for a in [_plain_refinement(panels, chol, Y, n, k) for k in range(steps + 1)]])
    plain = _plain_refinement(panels, chol, Y, n, steps)
    a64 = np.linalg.solve(_dense_gram(X.double().numpy(), 1.0, 1.0, "rbf")
                          + noise * np.eye(300), Y.double().numpy())
    if factor == "exact":
        assert bool((resid[1] < resid[0]).all()) and torch.equal(alpha, plain)
    else:
        assert bool((resid[1:] > resid[:-1]).all())
        assert torch.equal(alpha, chol.solve(Y))
        assert _rel(alpha, a64) < _rel(plain, a64)


def test_group_is_accepted_and_ignored():
    K = torch.as_tensor(_spd(384, seed=11))
    panels = tbc._split_panels(K, 128, 384)
    a = tbc.cholesky_panels(panels, 384).dense()
    b = tbc.cholesky_panels(panels, 384, group=2).dense()
    assert torch.equal(a, b)
    X = torch.as_tensor(np.random.default_rng(12).standard_normal((300, 2)))
    a1, _ = tbc.gram_cholesky_solve(X, X, 1.0, 1.0, 0.1, block=128)
    a2, _ = tbc.gram_cholesky_solve(X, X, 1.0, 1.0, 0.1, block=128, group=4)
    assert torch.equal(a1, a2)


def test_cpu_tensors_never_launch_the_kernel(monkeypatch):
    monkeypatch.setattr(tbc.factor_panel, "launches", 0)
    tbc.blocked_cholesky(torch.as_tensor(_spd(300)), block=128)
    assert tbc.factor_panel.launches == 0


# ---- precision= (ops.linalg's mapping) ---------------------------------------

PRECISIONS = ("default", "high")


def _solve_case(dtype, n=300):
    rng = np.random.default_rng(20)
    X = torch.as_tensor(rng.standard_normal((n, 3)), dtype=dtype)
    Y = torch.as_tensor(rng.standard_normal((n, 2)), dtype=dtype)
    return X, Y, torch.tensor([1.5, 0.8, 1.2], dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_every_precision_is_highest_bit_for_bit_on_the_cpu(precision, dtype):
    """As the JAX package's CPU backend ignores its precision: the solve,
    the factor, its solves and the panel matvec equal "highest"'s bits."""
    X, Y, ls = _solve_case(dtype)
    a_hi, ch_hi = tbc.gram_cholesky_solve(X, Y, ls, 2.0, 0.1, block=128)
    a_p, ch_p = tbc.gram_cholesky_solve(X, Y, ls, 2.0, 0.1, block=128, precision=precision)
    assert torch.equal(a_p, a_hi) and torch.equal(ch_p.dense(), ch_hi.dense())
    assert torch.equal(ch_hi.solve(Y, precision), ch_hi.solve(Y))
    assert torch.equal(ch_hi.solve_lower(Y, precision), ch_hi.solve_lower(Y))
    K = torch.as_tensor(_spd(300, seed=21), dtype=dtype)
    assert torch.equal(tbc.blocked_cholesky(K, 128, precision).dense(),
                       tbc.blocked_cholesky(K, 128).dense())
    panels = tbc._split_panels(K, 128, 300)
    assert torch.equal(tbc.symmetric_matvec_panels(panels, Y, 300, precision),
                       tbc.symmetric_matvec_panels(panels, Y, 300))


def test_an_unknown_precision_is_refused():
    X, Y, ls = _solve_case(torch.float32)
    with pytest.raises(ValueError, match="precision"):
        tbc.gram_cholesky_solve(X, Y, ls, 2.0, 0.1, block=128, precision="HIGH")
    ch = tbc.blocked_cholesky(torch.as_tensor(_spd(256, seed=22)), 128)
    for call in (lambda: ch.solve(torch.ones(256, 1, dtype=torch.float64), "fast"),
                 lambda: tbc.blocked_cholesky(torch.eye(256), 128, "fast"),
                 lambda: tbc.symmetric_matvec_panels(ch.panels, torch.ones(256, 1), 256, "x")):
        with pytest.raises(ValueError, match="precision"):
            call()


def test_the_hi_lo_split_is_16x_closer_than_one_pass():
    """The card's "high" arithmetic (bf16 parts, float32 products), run on
    CPU tensors through the helper: its relative error at 512² is at least
    16x below one bfloat16 pass's."""
    from gaussian_process_transportation_tpu_torch.ops import linalg as tlin

    g = torch.Generator().manual_seed(23)
    a, b = (torch.randn(512, 512, generator=g) for _ in range(2))
    c64 = a.double() @ b.double()
    err = {}
    for p in PRECISIONS:
        c = tlin.split_product(tlin.Split.of(a, p), tlin.Split.of(b, p))
        err[p] = ((c.double() - c64).abs().max() / c64.abs().max()).item()
    assert err["high"] * 16 <= err["default"]
    assert err["high"] < 2.0**-14


def test_jax_at_high_on_the_cpu_is_the_ports_high():
    """JAX's solve and factor called with Precision.HIGH (its panel kernel in
    interpret mode) against the port's "high", at the float32 tolerances of
    the "highest" comparisons above."""
    import jax

    X, Y, ls = _solve_case(torch.float32)
    HIGH = jax.lax.Precision.HIGH
    ja, _ = jbc.gram_cholesky_solve(jnp.asarray(X.numpy()), jnp.asarray(Y.numpy()),
                                    jnp.asarray(ls.numpy()), 2.0, 0.1, block=128,
                                    precision=HIGH, interpret=True)
    ta, _ = tbc.gram_cholesky_solve(X, Y, ls, 2.0, 0.1, block=128, precision="high")
    assert _rel(ta, ja) < 2e-4
    K = _spd(500, seed=24).astype(np.float32)
    want = jbc.blocked_cholesky(jnp.asarray(K), block=128, precision=HIGH, interpret=True)
    got = tbc.blocked_cholesky(torch.as_tensor(K), 128, "high")
    assert _rel(got.dense(), want.dense()) < 1e-5
    b = np.random.default_rng(25).standard_normal((500, 3)).astype(np.float32)
    assert _rel(got.solve(torch.as_tensor(b), "high"), want.solve(jnp.asarray(b), HIGH)) < 1e-4


def _emulate_reduced(monkeypatch, *modules):
    """Takes the card's reduced-precision route for float32 CPU tensors too:
    the factor split into bfloat16 parts as it goes, the products of the
    parts widened to float32 (exact, as the card's tensor cores)."""
    from gaussian_process_transportation_tpu_torch.ops import linalg as tlin

    def reduced(a, precision):
        return tlin.check_precision(precision) != "highest" and a.dtype == torch.float32

    for m in (tlin,) + modules:
        monkeypatch.setattr(m, "reduced", reduced)


def test_the_split_route_solves_to_the_working_precision(monkeypatch):
    """The split route of cholesky_panels and its solves, emulated on the
    CPU at 600 points (five panels): at "high" the refined α is as near the
    float64 solve as "highest"'s (2e-4) and its factor within 1e-4 of the
    float64 factor; "default" (one pass) is farther from it or, as here,
    loses definiteness (NaN, as on the card at phase 24's Gram), and a
    "high" factor solves at "default" too."""
    _emulate_reduced(monkeypatch, tbc)
    X, Y, ls = _solve_case(torch.float32, 600)
    a64 = np.linalg.solve(_dense_gram(X.double().numpy(), ls.double().numpy(), 2.0, "rbf")
                          + 0.1 * np.eye(600), Y.double().numpy())
    L64 = np.linalg.cholesky(_dense_gram(X.double().numpy(), ls.double().numpy(), 2.0, "rbf")
                             + 0.1 * np.eye(600))
    errs = {}
    for p in ("highest", "high", "default"):
        a, ch = tbc.gram_cholesky_solve(X, Y, ls, 2.0, 0.1, block=128, precision=p)
        errs[p] = (_rel(a, a64), _rel(ch.dense(), L64))
        assert (p == "highest") == (ch._operands == {})
    assert errs["high"][0] < 2e-4 and errs["high"][1] < 1e-4
    assert np.isnan(errs["default"][1]) or errs["default"][1] > 4 * errs["high"][1]
    _, ch = tbc.gram_cholesky_solve(X, Y, ls, 2.0, 0.1, block=128, precision="high")
    assert _rel(ch.solve(Y, "default"), a64) < 5e-2 and set(ch._operands) == {"high", "default"}
