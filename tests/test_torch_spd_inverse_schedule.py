"""The schedules of two card kernels, stepped through in plain torch ops on
the CPU: the small-SPD inverse (``csrc/spd_inverse_elast.cu``, TPU kernel
#1) and the fused predict mean (``csrc/stationary_gram.cu``, TPU kernel #5).

Kernel #1's warp instances: a block stages G members' (n, n) slabs into
shared memory, member g's row i at float g·M + i·P (P and M multiples of 4
whose quarter is odd); each member is H = rows / 2 lanes of a warp, two
rows a lane.  Row t's registers are ``A[:, t, :]`` and a shuffle of row
k's register j is the read ``A[:, k, j]``: which lane holds a row changes
no arithmetic, so the schedule is stepped through row by row.  Rows past n
up to the instance's capacity are an identity block.  The factor is
K = C D Cᵀ, right-looking, L = C·D^½; column t of C⁻¹ comes from one
forward substitution and row t of K⁻¹ = C⁻ᵀD⁻¹C⁻¹ from dot products of the
columns.  Its thread instance (float64, n > 32) is a
left-looking factor and one forward and one back substitution a column.
Each is held to numpy's f64 inverse and to the JAX package's plain
``spd_inverse_elast`` (eager, 4–6 s a call at n = 20–32 on a CPU, 21 s at
64, so n ≤ 32 only).  FMAs are taken in float64 and rounded once, as the
card's ``fmaf``.

Kernel #5: blocks of queries against chunks of ``MEAN_CHUNK`` training
points, each chunk's partial sums in point order, then the partials added
in chunk order and scaled by the amplitude.  Held to JAX's Pallas kernel in
interpret mode (about a second a call at Nq, N ≤ 300) and, per query, to
the f64 formula with ``chip_smoke.py``'s bound."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_process_transportation_tpu.ops import batched_linalg as jbl
from gaussian_process_transportation_tpu.ops import pallas_gram as jpg
from gaussian_process_transportation_tpu_torch.ops import batched_linalg as tbl
from gaussian_process_transportation_tpu_torch.ops import pallas_gram as tpg

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

FAMILIES = ("rbf", "matern12", "matern32", "matern52")
# the tolerances of the on-card checks (chip_smoke.py: F32_ATOL against the
# twin, F32_INV_TOL against numpy's f64 inverse)
ATOL, INV_TOL = chip_smoke.F32_ATOL, chip_smoke.F32_INV_TOL


def _fma(a, b, c):
    """fmaf: the product exact in float64, one rounding to float32 after
    the sum (a double rounding off by one ulp at worst)."""
    return (a.double() * b.double() + c.double()).float()


def odd_quad_pitch(x):
    """The kernel's pitch: the smallest multiple of 4 ≥ x whose quarter is odd."""
    p = -(-x // 4) * 4
    return p if (p // 4) % 2 else p + 4


def block_members(rows):
    """Members a block stages (G = W·32/H) for the instance of ``rows``
    register rows a member: W warps of 32 / (rows / 2) members each."""
    return {8: 32, 16: 16, 20: 24, 24: 16, 32: 8}[rows]


def warp_schedule(Ke, rows):
    """The warp instance of ``rows`` register rows on K (n, n, E) float32:
    (L, K⁻¹), each (n, n, E)."""
    n, _, E = Ke.shape
    C, G = rows, block_members(rows)
    P, M = odd_quad_pitch(n), odd_quad_pitch(n * odd_quad_pitch(n))
    t = torch.arange(C)
    # staging: block b's members e = b·G + g land at g·M + i·P + j of a flat
    # slab, zeros past E; each row is then read by its lane (16 bytes at a time)
    blocks = -(-E // G)
    slab = torch.zeros(blocks, G * M)
    idx = (torch.arange(G)[:, None, None] * M + torch.arange(n)[None, :, None] * P
           + torch.arange(n)[None, None, :])  # (G, n, n)
    Kp = torch.zeros(n, n, blocks * G)
    Kp[:, :, :E] = Ke
    slab[:, idx.reshape(-1)] = Kp.reshape(n, n, blocks, G).permute(2, 3, 0, 1).reshape(blocks, -1)
    rows_in = slab[:, idx.reshape(-1)].reshape(blocks * G, n, n)[:E]
    A = torch.eye(C).expand(E, C, C).clone()  # rows past n: the identity
    A[:, :n, :n] = rows_in

    # K = C D Cᵀ, right-looking; row t keeps S_tk right of its diagonal
    dt, dinv = torch.ones(E, C), torch.ones(E, C)
    for j in range(n):
        piv = A[:, j, j].clone()  # row j's register j
        inv = 1.0 / piv
        ctj = torch.where(t > j, A[:, :, j] * inv[:, None], torch.zeros(()))  # (E, row)
        s_kj = A[:, :, j].clone()  # row k's register j, unscaled
        A[:, :, j + 1:] = _fma(-ctj[:, :, None], s_kj[:, None, j + 1:], A[:, :, j + 1:])
        dt[:, j], dinv[:, j] = piv, inv
        A[:, :, j] = torch.where(t > j, ctj, A[:, :, j])
    bad = ~(dt[:, :n] > 0).all(1)

    # row t of L: C_tj sqrt(d_j) left of the diagonal, sqrt(d_t) on it
    sq = torch.sqrt(dt)
    lower = t[:, None] > t[None, :]
    L = torch.where(lower, A * sq[:, None, :], torch.zeros(()))
    L = L + torch.diag_embed(sq)
    # column t of C⁻¹ (XC[:, t, i] = register i of row t's lane), then row t of
    # K⁻¹ = Σ_k (C⁻¹)_kt (C⁻¹)_kj / d_k
    XC = torch.zeros(E, C, C)
    for i in range(n):
        acc = (t == i).float().expand(E, C)
        for m in range(i):
            acc = _fma(-A[:, i, m][:, None], XC[:, :, m], acc)
        XC[:, :, i] = acc
    KI = torch.zeros(E, C, C)
    for k in range(n):
        w = XC[:, :, k] * dinv[:, k][:, None]
        KI[:, :, :k + 1] = _fma(w[:, :, None], XC[:, None, :k + 1, k], KI[:, :, :k + 1])
    nan = torch.full((), float("nan"))
    L = torch.where(bad[:, None, None], nan, L)[:, :n, :n]
    KI = torch.where(bad[:, None, None], nan, KI)[:, :n, :n]
    return L.permute(1, 2, 0).contiguous(), KI.permute(1, 2, 0).contiguous()


def thread_schedule(Ke):
    """The thread instance on K (n, n, E): left-looking Cholesky in place,
    then K⁻¹ a column at a time by L u = e_c and Lᵀ v = u (vectorised over
    the columns, which the kernel walks one after another)."""
    n, _, E = Ke.shape
    L = torch.zeros_like(Ke)
    for j in range(n):
        d = Ke[j, j].clone()
        for p in range(j):
            d = d - L[j, p] * L[j, p]
        r = torch.rsqrt(d)
        L[j, j] = d * r
        v = Ke[j + 1:, j].clone()
        for p in range(j):
            v = v - L[j + 1:, p] * L[j, p]
        L[j + 1:, j] = v * r
    KI = torch.zeros_like(Ke)
    eye = torch.eye(n, dtype=Ke.dtype)
    for i in range(n):  # forward: row i of every column c <= i
        acc = eye[i][:, None].expand(n, E).clone()
        for p in range(i):
            acc = acc - L[i, p] * KI[p]
        KI[i] = torch.where((torch.arange(n) <= i)[:, None], acc / L[i, i], KI[i])
    for i in reversed(range(n)):  # back substitution, in place
        acc = KI[i].clone()
        for p in range(i + 1, n):
            acc = acc - L[p, i] * KI[p]
        KI[i] = acc / L[i, i]
    return L, KI


def schedule(Ke):
    """The instance the wrapper picks for K, stepped through."""
    instance = tbl.spd_inverse_instance(Ke.shape[0], Ke.dtype)
    if instance == "thread":
        return thread_schedule(Ke)
    return warp_schedule(Ke, int(instance[4:]))


def _spd(n, E, seed=0):
    """(E, n, n) float32 SPD A Aᵀ + 3I (chip_smoke's matrices) and (n, n, E)."""
    K = chip_smoke.spd_batch(n, E, seed)
    return K, torch.as_tensor(np.ascontiguousarray(np.transpose(K, (1, 2, 0))))


def _check_f64(K, L, KI):
    """L lower with L Lᵀ = K, K⁻¹ = numpy's f64 inverse, to the on-card
    tolerances (the f64 factor's entries to ATOL)."""
    L64 = np.linalg.cholesky(K.astype(np.float64))
    Lb, KIb = L.permute(2, 0, 1).double().numpy(), KI.permute(2, 0, 1).double().numpy()
    assert np.abs(Lb - L64).max() <= ATOL
    assert np.abs(KIb - np.linalg.inv(K.astype(np.float64))).max() < INV_TOL
    assert not np.triu(Lb, 1).any()


def test_instances_by_n_and_dtype():
    """float32 takes the warp instance of the fewest register rows that hold
    n up to 32, then the thread instance; float64 always the thread one."""
    for n in range(1, tbl.FUSED_MAX_N + 1):
        want = next((f"warp{r}" for r in (8, 16, 20, 24, 32) if n <= r), "thread")
        assert tbl.spd_inverse_instance(n, torch.float32) == want
        assert tbl.spd_inverse_instance(n, torch.float64) == "thread"
    assert set(tbl.SPD_INVERSE_INSTANCES) == {"warp8", "warp16", "warp20", "warp24", "warp32",
                                              "thread"}
    assert set(tbl.spd_inverse_elast_fused.instance_launches) == set(tbl.SPD_INVERSE_INSTANCES)


@pytest.mark.parametrize("n", range(1, 33))
def test_staging_pitches_keep_eight_rows_and_members_apart(n):
    """Eight consecutive rows of a member (and the same entry of eight
    consecutive members) fall in eight distinct 16-byte bank groups, and
    the two slabs of a block fit in the card's 227 KB of shared memory."""
    P, M = odd_quad_pitch(n), odd_quad_pitch(n * odd_quad_pitch(n))
    assert P >= n and M >= n * P and P % 4 == 0 and M % 4 == 0
    for pitch in (P, M):
        assert len({(k * pitch // 4) % 8 for k in range(8)}) == 8
    rows = next(r for r in (8, 16, 20, 24, 32) if n <= r)
    assert 2 * block_members(rows) * M * 4 <= 232448


@pytest.mark.parametrize("n", [1, 2, 8, 20, 31, 32])
def test_warp_schedule_matches_f64_and_jax(n):
    """A ragged E (37) against every instance's block of G members."""
    K, Ke = _spd(n, 37)
    L, KI = schedule(Ke)
    _check_f64(K, L, KI)
    L_j, KI_j = jbl.spd_inverse_elast(jnp.asarray(Ke.numpy()))
    assert np.abs(L.numpy() - np.asarray(L_j)).max() <= ATOL
    assert np.abs(KI.numpy() - np.asarray(KI_j)).max() <= ATOL


@pytest.mark.parametrize("n", [33, 64])
def test_thread_schedule_matches_f64(n):
    """The thread instance's shapes past 32 in float32, and f64 at n = 20;
    ragged against the kernel's 64 threads a block (E = 70)."""
    K, Ke = _spd(n, 70)
    L, KI = schedule(Ke)
    _check_f64(K, L, KI)
    K, Ke = _spd(20, 70)
    L, KI = schedule(Ke.double())
    L64 = np.linalg.cholesky(K.astype(np.float64))
    assert np.abs(L.permute(2, 0, 1).numpy() - L64).max() < 1e-10
    assert np.abs(KI.permute(2, 0, 1).numpy() - np.linalg.inv(K.astype(np.float64))).max() < 1e-10


@pytest.mark.parametrize("n", [8, 20, 32])
def test_warp_schedule_matches_the_twin(n):
    """The stepwise schedule against the port's plain twin, which the card
    compares the kernel with, to the same tolerance."""
    _, Ke = _spd(n, 19, seed=n)
    L, KI = schedule(Ke)
    L0, KI0 = tbl.spd_inverse_elast(Ke)
    assert (L - L0).abs().max().item() <= ATOL
    assert (KI - KI0).abs().max().item() <= ATOL


def test_warp_schedule_a_bad_member_is_nan_there_only():
    _, Ke = _spd(20, 18)
    Ke[:, :, 3] = -Ke[:, :, 3]
    L, KI = schedule(Ke)
    assert torch.isnan(L[:, :, 3]).all() and torch.isnan(KI[:, :, 3]).all()
    keep = [e for e in range(18) if e != 3]
    assert torch.isfinite(L[:, :, keep]).all() and torch.isfinite(KI[:, :, keep]).all()


# ---- kernel #5: chunks of training points, combined in chunk order --------

def chunked_mean(Xq, X, alpha, lengthscale, amp, family, chunk=tpg.MEAN_CHUNK):
    """The mean kernel's schedule in float32: per chunk of ``chunk`` training
    points the partial sums Σ φ(d²) α in point order, d² summed by FMAs over
    the coordinates; then the partials added in chunk order and × amp."""
    Xq, X = Xq / lengthscale, X / lengthscale
    Nq, P = Xq.shape[0], alpha.shape[1]
    total = torch.zeros(Nq, P)
    for a0 in range(0, X.shape[0], chunk):
        part = torch.zeros(Nq, P)
        for a in range(a0, min(a0 + chunk, X.shape[0])):
            d2 = torch.zeros(Nq)
            for d in range(X.shape[1]):
                diff = Xq[:, d] - X[a, d]
                d2 = _fma(diff, diff, d2)
            k = tpg.stationary_from_sqdist(d2, family)
            part = _fma(k[:, None], alpha[a][None, :], part)
        total = total + part
    return amp * total


def _mean_inputs(Nq, N, D, P, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((Nq, D), (N, D), (N, P)))


def _mean_excess(got, Xq, X, alpha, ls, amp, family):
    """Error over ``chip_smoke.py``'s per-query bound of the f64 formula."""
    m64, _, scale = chip_smoke.predict_f64(
        torch.as_tensor(Xq), torch.as_tensor(X), torch.as_tensor(alpha),
        torch.eye(X.shape[0]), torch.as_tensor(ls), amp, 0.0, family)
    return ((got.double() - m64).abs() / (chip_smoke.MEAN_REL * scale)).max().item()


# (Nq, N): one query and one point; a chunk less one, one past a chunk
# (129 = 128 + 1) and past two; a 256-query block and one past it
MEAN_CASES = ([("rbf", 1, 1, 3, 2), ("rbf", 257, 129, 3, 2), ("rbf", 127, 300, 2, 1)]
              + [(fam, 256, 257, 2, 2) for fam in FAMILIES[1:]])


@pytest.mark.parametrize("family,Nq,N,D,P", MEAN_CASES)
def test_chunked_mean_matches_jax_interpret_and_f64(family, Nq, N, D, P):
    """Against JAX's Pallas kernel in interpret mode to its own tests'
    atol 1e-4 (tests/test_torch_pallas_gram.py), and per query to the f64
    formula within ``MEAN_REL`` of Σ|k α| (error/bound < 1, as on the card)."""
    Xq, X, alpha = _mean_inputs(Nq, N, D, P, seed=Nq + N)
    ls = np.linspace(0.9, 1.4, D).astype(np.float32)
    got = chunked_mean(*(torch.as_tensor(a) for a in (Xq, X, alpha, ls)), 2.0, family)
    want = jpg.fused_gp_predict_mean(jnp.asarray(Xq), jnp.asarray(X), jnp.asarray(alpha),
                                     jnp.asarray(ls), 2.0, tile_q=128, tile_k=128,
                                     interpret=True, family=family)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert _mean_excess(got, Xq, X, alpha, ls, 2.0, family) < 1


@pytest.mark.parametrize("D,P", [(5, 1), (2, 8), (16, 3)])
def test_chunked_mean_run_time_d_and_wide_p_within_the_f64_bound(D, P):
    """The run-time-D instance and the P ≤ 8 one, past one chunk."""
    Xq, X, alpha = _mean_inputs(70, 200, D, P, seed=D * 10 + P)
    ls = np.ones(D, np.float32)
    got = chunked_mean(*(torch.as_tensor(a) for a in (Xq, X, alpha, ls)), 1.5, "matern32")
    assert got.shape == (70, P)
    assert _mean_excess(got, Xq, X, alpha, ls, 1.5, "matern32") < 1
    plain = tpg.fused_gp_predict_mean(*(torch.as_tensor(a) for a in (Xq, X, alpha, ls)), 1.5,
                                      "matern32")
    assert (got - plain).abs().max().item() < 1e-5 * plain.abs().max().item()


def test_chunked_mean_without_training_points_is_zero():
    """N = 0: no chunk, and the fixed-order sum of none is 0, as the wrapper's
    CPU twin gives."""
    Xq = torch.ones(5, 2)
    got = chunked_mean(Xq, torch.zeros(0, 2), torch.zeros(0, 2), 1.0, 2.0, "rbf")
    assert torch.equal(got, torch.zeros(5, 2))
    assert torch.equal(tpg.fused_gp_predict_mean(Xq, torch.zeros(0, 2), torch.zeros(0, 2), 1.0,
                                                 2.0), got)
