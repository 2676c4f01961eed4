"""On-card tests of the torch port's CUDA kernels, marked ``cuda``: each
kernel against its plain twin on the card at small sizes, the wrappers
refusing what the kernels do not take, and the launch counts of the
batched transport, the blocked conditioning and the dense-grid predicts;
the learned models' graph-captured training and their transports against
the CPU.  They skip where no CUDA card is present.  On a machine with a card and nvcc (and no JAX):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_process_transportation_tpu_torch import kernels as K
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp
from gaussian_process_transportation_tpu_torch.ops import batched_linalg as tbl
from gaussian_process_transportation_tpu_torch.ops import blocked_chol as tbc
from gaussian_process_transportation_tpu_torch.ops import pallas_gram as tpg
from gaussian_process_transportation_tpu_torch.transport import gpt

pytestmark = pytest.mark.cuda

E_SMALL = 1024


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _spd_elast(n, E, seed=0):
    """(E, n, n) float32 SPD matrices A Aᵀ + 3I and their (n, n, E) stack."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((E, n, n)).astype(np.float32)
    K_ = np.einsum("eij,ekj->eik", A, A) + 3 * np.eye(n, dtype=np.float32)
    return K_, np.ascontiguousarray(np.transpose(K_, (1, 2, 0)))


def _check(device, n, E, dtype, atol, inv_tol):
    K_, Ke = _spd_elast(n, E)
    Kd = torch.as_tensor(Ke, dtype=dtype, device=device)
    L1, Ki1 = tbl.spd_inverse_elast_fused(Kd)
    L0, Ki0 = tbl.spd_inverse_elast(Kd)
    torch.cuda.synchronize()
    assert (L1 - L0).abs().max().item() <= atol
    assert (Ki1 - Ki0).abs().max().item() <= atol
    Lb = L1.permute(2, 0, 1)
    assert torch.equal(Lb, torch.tril(Lb))
    got = Ki1.permute(2, 0, 1).double().cpu().numpy()
    assert np.abs(got - np.linalg.inv(K_.astype(np.float64))).max() < inv_tol


@pytest.mark.parametrize("E", [E_SMALL, E_SMALL + 37])
@pytest.mark.parametrize("n", [8, 20, 24, 32, 64])
def test_kernel_matches_twin_f32(device, n, E):
    _check(device, n, E, torch.float32, atol=2e-5, inv_tol=1e-4)


def test_kernel_matches_twin_f64(device):
    _check(device, 20, E_SMALL + 37, torch.float64, atol=1e-10, inv_tol=1e-10)


# every instance of the kernel: warp8 (n = 1, 8), warp16 (16), warp20 (20),
# warp24 (24), warp32 (31, 32) and the thread instance (33, 64 and float64)
SPD_INSTANCE_N = [1, 8, 16, 20, 24, 31, 32, 33, 64]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", SPD_INSTANCE_N)
def test_kernel_every_instance(device, n, dtype, monkeypatch):
    """E = 133 is ragged against the warp instances' blocks of 32, 16, 24
    and 8 members and the thread instance's 64: the instance the wrapper names,
    the twin's and numpy's f64 results to the tolerances above, two runs
    bitwise equal, exact zeros above the diagonal."""
    monkeypatch.setattr(tbl.spd_inverse_elast_fused, "instance_launches",
                        dict.fromkeys(tbl.SPD_INVERSE_INSTANCES, 0))
    K_, Ke = _spd_elast(n, 133, seed=n)
    Kd = torch.as_tensor(Ke, dtype=dtype, device=device)
    first, second = tbl.spd_inverse_elast_fused(Kd), tbl.spd_inverse_elast_fused(Kd)
    L0, Ki0 = tbl.spd_inverse_elast(Kd)
    torch.cuda.synchronize()
    want = tbl.spd_inverse_instance(n, dtype)
    assert tbl.spd_inverse_elast_fused.instance_launches == {
        inst: 2 * (inst == want) for inst in tbl.SPD_INVERSE_INSTANCES}
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    atol, inv_tol = (2e-5, 1e-4) if dtype == torch.float32 else (1e-10, 1e-10)
    L1, Ki1 = first
    assert (L1 - L0).abs().max().item() <= atol and (Ki1 - Ki0).abs().max().item() <= atol
    Lb = L1.permute(2, 0, 1)
    assert torch.equal(Lb, torch.tril(Lb))
    got = Ki1.permute(2, 0, 1).double().cpu().numpy()
    assert np.abs(got - np.linalg.inv(K_.astype(np.float64))).max() < inv_tol


def test_kernel_a_bad_member_is_nan_there_only(device):
    _, Ke = _spd_elast(20, 40)
    Ke[:, :, 3] = -Ke[:, :, 3]
    L, Ki = tbl.spd_inverse_elast_fused(torch.as_tensor(Ke, device=device))
    torch.cuda.synchronize()
    assert torch.isnan(L[:, :, 3]).all() and torch.isnan(Ki[:, :, 3]).all()
    keep = [e for e in range(40) if e != 3]
    assert torch.isfinite(L[:, :, keep]).all() and torch.isfinite(Ki[:, :, keep]).all()


def test_warp_instance_refuses_more_rows_than_it_holds(device):
    Kd = torch.as_tensor(_spd_elast(20, 16)[1], device=device)
    with pytest.raises(RuntimeError, match="warp16"):
        tbl._launch(Kd, "warp16")


def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    good = torch.eye(4, device=device)[:, :, None].repeat(1, 1, 8)
    tbl.spd_inverse_elast_fused(good)
    with pytest.raises(TypeError):
        tbl.spd_inverse_elast_fused(good.half())
    with pytest.raises(ValueError, match="contiguous"):
        tbl.spd_inverse_elast_fused(good.transpose(0, 1))
    with pytest.raises(ValueError):
        tbl.spd_inverse_elast_fused(torch.eye(65, device=device)[:, :, None].contiguous())
    with pytest.raises(ValueError):
        tbl.spd_inverse_elast_fused(good[:3])


def test_batched_transport_launches_the_kernel_once(device, monkeypatch):
    monkeypatch.setattr(tbl.spd_inverse_elast_fused, "launches", 0)
    t = np.linspace(0, 1, 100)
    s = np.linspace(0, 1, 20)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    targets = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)[None] + np.linspace(0, 1, 64)[:, None, None]
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)

    def run(dtype, dev):
        kern = K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, dtype=dtype, device=dev)) + K.White(0.01)
        return gpt.fit_and_transport_batched(
            kern, *(torch.as_tensor(a, dtype=dtype, device=dev) for a in (S, targets, X, dX)))

    got = run(torch.float32, device)
    torch.cuda.synchronize()
    assert tbl.spd_inverse_elast_fused.launches == 1
    ref = run(torch.float64, "cpu")
    for name in ("traj", "delta"):
        err = (getattr(got, name).double().cpu() - getattr(ref, name)).abs().max().item()
        assert err / np.abs(X).max() < 1e-3, name


# ---- large-N exact GP: factor_panel and the stationary-Gram kernels --------

FAMILIES = ("rbf", "matern12", "matern32", "matern52")


@pytest.mark.parametrize("B", [128, 256, 384, 512, 1024])
def test_factor_panel_matches_f64(device, B):
    """L and L⁻¹ to 5e-6 relative (the JAX panel kernel's bound), exactly
    lower-triangular; B = 384 a ragged doubling of L⁻¹."""
    K_ = chip_smoke.panel_spd(B)
    L, Linv = tbc.factor_panel(torch.as_tensor(K_, device=device))
    torch.cuda.synchronize()
    L64 = np.linalg.cholesky(K_.astype(np.float64))
    Linv64 = np.linalg.inv(L64)
    L, Linv = L.double().cpu().numpy(), Linv.double().cpu().numpy()
    assert np.abs(L - L64).max() / np.abs(L64).max() < 5e-6
    assert np.abs(Linv - Linv64).max() / np.abs(Linv64).max() < 5e-6
    assert not np.triu(L, 1).any() and not np.triu(Linv, 1).any()


def test_factor_panel_issues_its_launch_sequence_and_counts_one(device, monkeypatch):
    """At B = 512: init, four diagonal steps, three col_solve and three
    trail launches, two doubling levels of two: 15 device launches, one
    wrapper launch."""
    monkeypatch.setattr(tbc.factor_panel, "launches", 0)
    launches, diag_ms = chip_smoke.panel_profile(torch.as_tensor(chip_smoke.panel_spd(512),
                                                                 device=device))
    assert launches == 15 and diag_ms > 0
    assert tbc.factor_panel.launches == 1 + chip_smoke.REPS


@pytest.mark.parametrize("family", FAMILIES)
def test_stationary_gram_matches_twin(device, family):
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.standard_normal((77, 3)), dtype=torch.float32, device=device)
    Z = torch.as_tensor(rng.standard_normal((45, 3)), dtype=torch.float32, device=device)
    ls = torch.tensor([1.5, 0.8, 1.2], device=device)
    got = tpg.stationary_gram(X, Z, ls, 2.5, family)
    want = tpg.stationary_gram_plain(X, Z, ls, 2.5, family)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < 2.5e-6


def _flat(panels):
    return torch.cat([p.reshape(-1) for p in panels])


@pytest.mark.parametrize("B", [128, 512])
@pytest.mark.parametrize("n", [1, 200, 511, 512, 513, 2500])
@pytest.mark.parametrize("family,D", [(f, D) for f in FAMILIES for D in (1, 2, 3, 5)])
def test_gram_panels_match_the_f64_formula(device, family, D, n, B):
    """The panel entry at the edges of its blocks and tiles, every family
    and D of its instances (D = 5 is the run-time instance), into a
    NaN-filled buffer, so that an entry the tile map misses reads as
    infinite: per entry against the f64 formula to ``chip_smoke.GRAM_TOL``,
    within 1e-5 of the f32 twin, two runs bitwise equal."""
    diff, ex = chip_smoke.check_gram_panels(device, n, B, D, family)
    assert ex < 1 and diff < 1e-5


def test_gram_panel_planted_faults_are_rejected(device):
    assert min(chip_smoke.gram_panel_faults(device).values()) > 10


@pytest.mark.parametrize("layout", ["contiguous", "padded_rows", "offset_base"])
@pytest.mark.parametrize("M", [1, 3, 129, 1001])
def test_stationary_gram_at_ragged_widths_and_any_row_stride(device, M, layout):
    """The generic entry into a NaN-filled output: a contiguous (N, M), rows
    M + 1 apart (the columns past M stay NaN), and a base 4 bytes past a
    16-byte boundary; per entry against the f64 formula."""
    N = 77
    X, ls = chip_smoke.gram_points(device, N, 3, seed=M)
    Z = chip_smoke.gram_points(device, M, 3, seed=M + 1)[0]
    pitch = M + (layout == "padded_rows")
    start = int(layout == "offset_base")
    store = torch.full((start + N * pitch,), float("nan"), device=device)
    out = store[start:].view(N, pitch)[:, :M]
    got = tpg.stationary_gram_into(out, X, Z, ls, 2.5, "matern32")
    ref = tpg.stationary_gram_plain(X.double(), Z.double(), ls.double(), 2.5, "matern32")
    assert got.data_ptr() == out.data_ptr()
    assert chip_smoke.gram_excess(out, ref, 2.5) < 1
    assert torch.isnan(store[start:].view(N, pitch)[:, M:]).all()


def test_gram_kernels_read_card_scalars_without_a_sync(device):
    """Lengthscales, amplitude and noise as CUDA tensors are read by the
    kernels from device memory: no synchronising call (the sync debug mode
    raises on one), and the same bits as the values passed from the host."""
    X, ls = chip_smoke.gram_points(device, 700, 3, seed=0)
    want = _flat(tbc.stationary_gram_panels(X, ls.tolist(), 2.0, 0.1, 128)[0])
    want_g = tpg.stationary_gram(X, X[:300], 1.3, 2.0)
    amp, noise = torch.tensor(2.0, device=device), torch.tensor([0.1], device=device)
    ls1 = torch.tensor([1.3], device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tbc.stationary_gram_panels(X, ls, amp, noise, 128)[0]
        got_g = tpg.stationary_gram(X, X[:300], ls1, amp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(_flat(got), want) and torch.equal(got_g, want_g)


def test_gram_panels_are_views_of_one_buffer(device):
    X, ls = chip_smoke.gram_points(device, 1100, 2, seed=1)
    panels, n = tbc.stationary_gram_panels(X, ls, 2.0, 0.1, 512)
    offsets = tbc.panel_offsets(n, 512)
    base = panels[0].data_ptr()
    assert [p.shape for p in panels] == [(1536, 512), (1024, 512), (512, 512)]
    assert [(p.data_ptr() - base) // 4 for p in panels] == offsets[:-1]
    assert panels[0].untyped_storage().nbytes() >= 4 * offsets[-1]


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_predicts_match_twins(device, family):
    """Ragged Nq and N (neither a multiple of the kernels' tiles).  Then,
    with the K⁻¹ of a conditioned GP so that the variance is a posterior
    one, per query against the same formula in float64 to
    ``chip_smoke.py``'s bounds."""
    rng = np.random.default_rng(2)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    Xq, X, alpha = t(rng.standard_normal((300, 2))), t(rng.standard_normal((211, 2))), t(
        rng.standard_normal((211, 2)))
    A = rng.standard_normal((211, 211))
    K_inv = t((A @ A.T / 211 + np.eye(211)) * 0.1)
    ls = torch.tensor([1.0, 1.5], device=device)
    m = tpg.fused_gp_predict_mean(Xq, X, alpha, ls, 2.0, family)
    m0 = tpg.fused_gp_predict_mean_plain(Xq, X, alpha, ls, 2.0, family)
    mv, var = tpg.fused_gp_predict_mean_var(Xq, X, alpha, K_inv, ls, 2.0, 2.05, family)
    mv0, var0 = tpg.fused_gp_predict_mean_var_plain(Xq, X, alpha, K_inv, ls, 2.0, 2.05, family)
    _, var_again = tpg.fused_gp_predict_mean_var(Xq, X, alpha, K_inv, ls, 2.0, 2.05, family)
    torch.cuda.synchronize()
    scale = m0.abs().max().item()
    assert (m - m0).abs().max().item() < 1e-5 * scale
    assert (mv - m0).abs().max().item() < 1e-5 * scale
    assert (var - var0).abs().max().item() < 1e-4
    assert torch.equal(var, var_again)  # no atomics: runs agree bitwise

    kern = K.Constant(2.0) * K.RBF(ls) + K.White(0.05)
    gp = tgp.condition(kern, X, torch.sin(X), cache_k_inv=True)
    m = tpg.fused_gp_predict_mean(Xq, X, gp.alpha, ls, 2.0, family)
    mv, var = tpg.fused_gp_predict_mean_var(Xq, X, gp.alpha, gp.K_inv, ls, 2.0, 2.05, family)
    ref = chip_smoke.predict_f64(Xq, X, gp.alpha, gp.K_inv, ls, 2.0, 2.05, family)
    ex_m, ex_v = chip_smoke.predict_excess(mv, var, ref)
    assert max(ex_m, chip_smoke.predict_excess(m, var, ref)[0], ex_v) < 1


TILE_EDGES = chip_smoke.TILE_EDGES  # around the mean-and-variance kernel's 128-wide tiles
MEAN_VAR_CASES = ([(Nq, N, "rbf", 3) for Nq in TILE_EDGES for N in TILE_EDGES]
                  + [(129, 300, fam, 3) for fam in FAMILIES[1:]]
                  + [(129, 300, "rbf", D) for D in (1, 2, 5)])  # D = 2, 3 are compiled in


@pytest.mark.parametrize("Nq,N,family,D", MEAN_VAR_CASES)
def test_fused_mean_var_matches_the_f64_formula_at_the_tile_edges(device, Nq, N, family, D):
    """Ragged on both axes, P=2: per query to ``chip_smoke.py``'s bounds."""
    args = chip_smoke.posterior_case(device, Nq, N, family, D)
    mean, var = tpg.fused_gp_predict_mean_var(*args, family)
    torch.cuda.synchronize()
    assert mean.shape == (Nq, 2) and var.shape == (Nq,)
    assert max(chip_smoke.predict_excess(mean, var, chip_smoke.predict_f64(*args, family))) < 1


# the mean kernel's 128-point chunks and 256-query blocks: every Nq, N of
# MEAN_EDGE_NQ_N (129 and 257 one past a chunk, 257 one past a query
# block), then every family, D (2 and 3 compiled in, 5 at run time) and P
# capacity (P <= 2, P <= 8) at one ragged shape
MEAN_EDGE_NQ_N = (1, 127, 128, 129, 257, 300)
MEAN_CASES = ([(Nq, N, "rbf", 3, 2) for Nq in MEAN_EDGE_NQ_N for N in MEAN_EDGE_NQ_N]
              + [(257, 300, fam, D, P) for fam in FAMILIES for D in (2, 3, 5) for P in (1, 2, 8)])


@pytest.mark.parametrize("Nq,N,family,D,P", MEAN_CASES)
def test_fused_mean_matches_the_f64_formula_at_the_chunk_edges(device, Nq, N, family, D, P):
    """Per query to ``chip_smoke.py``'s bound (MEAN_REL of Σ|k α|), and two
    runs bitwise equal (the partials are added in chunk order)."""
    assert chip_smoke.check_mean(device, Nq, N, D, P, family)[1] < 1
    Xq, X, alpha, ls = chip_smoke.mean_case(device, Nq, N, D, P)
    a = tpg.fused_gp_predict_mean(Xq, X, alpha, ls, 2.0, family)
    b = tpg.fused_gp_predict_mean(Xq, X, alpha, ls, 2.0, family)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_fused_mean_planted_faults_are_rejected(device):
    assert min(chip_smoke.mean_faults(device).values()) >= 1


def test_fused_mean_without_training_points_is_zero(device):
    Xq = torch.ones(300, 2, device=device)
    m = tpg.fused_gp_predict_mean(Xq, torch.zeros(0, 2, device=device),
                                  torch.zeros(0, 2, device=device), 1.0, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(m, torch.zeros(300, 2, device=device))


def test_fused_mean_var_repeat_runs_are_bitwise_equal(device):
    args = chip_smoke.posterior_case(device, 1000, 300, "matern52")
    a = tpg.fused_gp_predict_mean_var(*args, "matern52")
    b = tpg.fused_gp_predict_mean_var(*args, "matern52")
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("N", [300, 302])  # K⁻¹ rows 16-byte aligned when contiguous, and not
@pytest.mark.parametrize("layout", ["offset_view", "padded_rows", "transposed"])
def test_fused_mean_var_reads_any_k_inv_layout(device, N, layout):
    """A K⁻¹ view whose rows do not start 16-byte aligned, one with padded
    rows and a non-contiguous one give the result of a fresh contiguous copy."""
    Xq, X, alpha, K_inv, ls, amp, prior = chip_smoke.posterior_case(device, 200, N, "rbf")
    if layout == "offset_view":
        view = torch.zeros(N, N + 1, device=device)[:, 1:]
    elif layout == "padded_rows":
        view = torch.zeros(N, (N + 7) // 4 * 4, device=device)[:, :N]  # rows aligned, tail ragged
    else:
        view = torch.zeros(N, N, device=device).T
    view.copy_(K_inv)
    assert view.is_contiguous() is False
    fresh = view.contiguous()
    got = tpg.fused_gp_predict_mean_var(Xq, X, alpha, view, ls, amp, prior)
    want = tpg.fused_gp_predict_mean_var(Xq, X, alpha, fresh, ls, amp, prior)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_new_wrappers_refuse_what_the_kernels_do_not_take(device):
    A = torch.eye(128, device=device)
    with pytest.raises(TypeError):
        tbc.factor_panel(A.double())
    with pytest.raises(ValueError):
        tbc.factor_panel(torch.eye(100, device=device))
    X = torch.zeros(10, 2, device=device)
    with pytest.raises(TypeError):
        tpg.stationary_gram(X.double(), X.double(), 1.0, 1.0)
    with pytest.raises(ValueError):
        tpg.stationary_gram(X, X.cpu(), 1.0, 1.0)
    with pytest.raises(ValueError):
        tpg.stationary_gram(torch.zeros(10, 17, device=device), torch.zeros(3, 17, device=device),
                            1.0, 1.0)
    with pytest.raises(ValueError):
        tpg.stationary_gram(X, X, 1.0, 1.0, family="cosine")
    with pytest.raises(ValueError):
        tpg.stationary_gram(X, X, torch.ones(3, device=device), 1.0)
    with pytest.raises(TypeError):
        tbc.stationary_gram_panels(X.double(), 1.0, 1.0, 0.1, 128)
    with pytest.raises(ValueError):
        tbc.stationary_gram_panels(torch.zeros(10, 17, device=device), 1.0, 1.0, 0.1, 128)
    with pytest.raises(ValueError):
        tbc.stationary_gram_panels_into(torch.empty(100, device=device), X, 1.0, 1.0, 0.1, 128)
    with pytest.raises(ValueError):
        tbc.stationary_gram_panels(X, 1.0, torch.ones(2, device=device), 0.1, 128)
    with pytest.raises(ValueError):
        tpg.fused_gp_predict_mean(X, X, torch.zeros(10, 9, device=device), 1.0, 1.0)
    with pytest.raises(ValueError):
        tpg.fused_gp_predict_mean_var(X, X, torch.zeros(10, 2, device=device),
                                      torch.zeros(9, 9, device=device), 1.0, 1.0, 1.0)


def _reset_counts(monkeypatch):
    for fn in (tbc.factor_panel, tbc.stationary_gram_panels, tpg.stationary_gram,
               tpg.fused_gp_predict_mean, tpg.fused_gp_predict_mean_var):
        monkeypatch.setattr(fn, "launches", 0)


def _condition_4096(device):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((4096, 3))
    Y = np.sin(X[:, :2])
    kern = K.Constant(2.0) * K.RBF(torch.ones(3, device=device)) + K.White(0.1)
    gp = tgp.condition(kern, torch.as_tensor(X, dtype=torch.float32, device=device),
                       torch.as_tensor(Y, dtype=torch.float32, device=device))
    torch.cuda.synchronize()
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    a64 = np.linalg.solve(2.0 * np.exp(-0.5 * d2) + (0.1 + 1e-6) * np.eye(4096), Y)
    return gp, np.abs(gp.alpha.double().cpu().numpy() - a64).max() / np.abs(a64).max()


def test_condition_routes_large_n_through_the_panels(device, monkeypatch):
    _reset_counts(monkeypatch)
    monkeypatch.setattr(tgp, "BLOCKED_CHOL_MIN_N", 4096)
    gp, err = _condition_4096(device)
    assert gp.L is None and gp.chol is not None
    assert tbc.factor_panel.launches == 8
    assert tbc.stationary_gram_panels.launches == 1 and tpg.stationary_gram.launches == 0
    assert err < 5e-3


def test_condition_below_the_threshold_takes_the_dense_factor(device, monkeypatch):
    _reset_counts(monkeypatch)
    assert tgp.BLOCKED_CHOL_MIN_N > 4096
    gp, err = _condition_4096(device)
    assert gp.L is not None and gp.chol is None
    assert tbc.factor_panel.launches == 0 and tpg.stationary_gram.launches == 0
    assert tbc.stationary_gram_panels.launches == 0
    assert err < 5e-3


def test_dense_grid_predict_launches_each_fused_kernel_once(device, monkeypatch):
    """One launch each, and the f64 dense GP's mean and std to the JAX
    package's on-card bounds (tests/test_blocked_chol.py:315-317).  With
    White(0.1) the f32 K⁻¹ route holds the std to them; at White(0.01) the
    f32 sums of k K⁻¹ kᵀ lose it (PERF.md)."""
    _reset_counts(monkeypatch)
    rng = np.random.default_rng(4)
    X, Xq = rng.standard_normal((1024, 2)), rng.standard_normal((2048, 2))

    def gp_of(dtype):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        kern = K.Constant(2.0) * K.RBF(torch.ones(2, dtype=dtype, device=device)) + K.White(0.1)
        return tgp.condition(kern, t(X), t(np.sin(X)), cache_k_inv=True), t(Xq)

    gp, xq = gp_of(torch.float32)
    mean = tgp.predict(gp, xq)
    assert tpg.fused_gp_predict_mean.launches == 1
    mean_s, std = tgp.predict(gp, xq, return_std=True)
    assert tpg.fused_gp_predict_mean_var.launches == 1
    gp64, xq64 = gp_of(torch.float64)
    mean64, std64 = tgp.predict(gp64, xq64, return_std=True)
    assert tpg.fused_gp_predict_mean_var.launches == 1  # f64 keeps the dense path
    scale = mean64.abs().max().item()
    assert (mean.double() - mean64).abs().max().item() < 5e-3 * scale
    assert (mean_s.double() - mean64).abs().max().item() < 5e-3 * scale
    assert (std.double() - std64).abs().max().item() < 5e-3 * std64.abs().max().item() + 1e-3


def test_small_predict_takes_the_fused_mean_and_the_dense_std(device, monkeypatch):
    """Nq·N = 6,400, between FUSED_PREDICT_MIN_ELEMS and
    FUSED_MEAN_VAR_MIN_ELEMS: the mean through one launch of its kernel, the
    std through the dense path, both to the f64 dense GP's bounds above."""
    _reset_counts(monkeypatch)
    rng = np.random.default_rng(8)
    X, Xq = rng.standard_normal((100, 2)), rng.standard_normal((64, 2))
    assert tgp.FUSED_PREDICT_MIN_ELEMS <= 64 * 100 < tgp.FUSED_MEAN_VAR_MIN_ELEMS

    def gp_of(dtype):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        kern = K.Constant(2.0) * K.RBF(torch.ones(2, dtype=dtype, device=device)) + K.White(0.1)
        return tgp.condition(kern, t(X), t(np.sin(X)), cache_k_inv=True), t(Xq)

    gp, xq = gp_of(torch.float32)
    mean = tgp.predict(gp, xq)
    mean_s, std = tgp.predict(gp, xq, return_std=True)
    torch.cuda.synchronize()
    assert tpg.fused_gp_predict_mean.launches == 1 and tpg.fused_gp_predict_mean_var.launches == 0
    mean64, std64 = tgp.predict(*gp_of(torch.float64), return_std=True)
    scale = mean64.abs().max().item()
    assert (mean.double() - mean64).abs().max().item() < 5e-3 * scale
    assert (mean_s.double() - mean64).abs().max().item() < 5e-3 * scale
    assert (std.double() - std64).abs().max().item() < 5e-3 * std64.abs().max().item() + 1e-3


def test_batched_transport_of_large_members_launches_a_panel_each(device, monkeypatch):
    _reset_counts(monkeypatch)
    rng = np.random.default_rng(5)
    n, Q, E = gpt.BLOCKED_MIN_N, 60, 2
    S = 2 * rng.standard_normal((n, 3))
    targets = S[None] + np.linspace(0, 1, E)[:, None, None] + 0.05 * rng.standard_normal((E, n, 3))
    X = 2 * rng.standard_normal((Q, 3))
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)

    def run(dtype, dev):
        kern = K.Constant(2.0) * K.RBF(2.0 * torch.ones(3, dtype=dtype, device=dev)) + K.White(0.01)
        return gpt.fit_and_transport_batched(
            kern, *(torch.as_tensor(a, dtype=dtype, device=dev) for a in (S, targets, X, dX)))

    got = run(torch.float32, device)
    torch.cuda.synchronize()
    assert tbc.factor_panel.launches == -(-n // gpt.BLOCKED_PANEL) * E
    assert tbc.stationary_gram_panels.launches == E and tpg.stationary_gram.launches == 0
    ref = run(torch.float64, "cpu")
    scale = np.abs(X).max()
    for name in ("traj", "std", "delta"):
        err = (getattr(got, name).double().cpu() - getattr(ref, name)).abs().max().item()
        assert err / scale < 1e-3, name


# ---- the fused small-LML kernels (#2, #3) and their paths -------------------

from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl  # noqa: E402
from gaussian_process_transportation_tpu_torch.parallel import samplers as tsm  # noqa: E402


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_lml_kernels_match_twins_and_the_f64_formula(device, family):
    """Every phase-12 shape of the family, those past eight coordinates or
    columns included, E ragged, to chip_smoke's bound."""
    for case in chip_smoke.LML_CASES + chip_smoke.LML_WIDE_CASES:
        if case[0] == family:
            for name, (diff, excess) in chip_smoke.check_lml_case(device, case, 37).items():
                assert excess < 1 and diff < 1e-3, (name, case, diff, excess)


def test_fused_lml_planted_faults_are_rejected(device):
    assert min(chip_smoke.lml_faults(device, 1024).values()) > 10


def test_fused_lml_repeat_runs_are_bitwise_equal(device):
    for name, per_lane in (("small_lml_value_grad", False), ("small_lml_value_grad_md", True)):
        X, Y, th = chip_smoke.lml_inputs(device, 1001, 20, 2, 2, 2, True, per_lane)
        a = getattr(tfl, name)(X, Y, th, "matern52", 2, True)
        b = getattr(tfl, name)(X, Y, th, "matern52", 2, True)
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 20, 24, 25, 32])
def test_fused_lml_value_only_is_the_full_value_bit_for_bit(device, n):
    """Every register capacity and its edges, a wide X and a wide Y: the
    value-only instance gives the full instance's values, bit for bit."""
    for D, p, n_ls in ((2, 2, 2), (12, 1, 12), (3, 12, 1)):
        X, Y, th = chip_smoke.lml_inputs(device, 37, n, D, p, n_ls, True, True, seed=n)
        v, _ = tfl.small_lml_value_grad_md(X, Y, th, "matern32", n_ls, True, 1e-8)
        vo = tfl._small_lml_value_md(X, Y, th, "matern32", n_ls, True, 1e-8)
        torch.cuda.synchronize()
        assert torch.equal(v, vo), (n, D, p)


def test_fused_lml_value_only_planted_faults_are_rejected(device):
    assert chip_smoke.lml_value_faults(device, 1024) > 10


def test_fused_lml_a_bad_lane_is_nan_there_only(device):
    """Two equal points in lane 1 and a negative jitter: both instances give
    lane 1 a NaN value (and gradient), the other lanes finite ones."""
    X, Y, _ = chip_smoke.lml_inputs(device, 3, 6, 2, 1, 1, True, True)
    X[1, 1] = X[1, 0]
    th = torch.zeros(2, 3, device=device)
    val, grad = tfl.small_lml_value_grad_md(X, Y, th, "rbf", 1, False, jitter=-1e-4)
    vo = tfl._small_lml_value_md(X, Y, th, "rbf", 1, False, jitter=-1e-4)
    torch.cuda.synchronize()
    for v in (val, vo):
        assert torch.isnan(v[1]) and torch.isfinite(v[[0, 2]]).all()
    assert torch.isnan(grad[:, 1]).all() and torch.isfinite(grad[:, [0, 2]]).all()


def test_fused_lml_wrappers_refuse_what_the_kernels_do_not_take(device):
    X, Y, th = chip_smoke.lml_inputs(device, 8, 10, 2, 1, 1, True, True)
    md = tfl.small_lml_value_grad_md
    md(X, Y, th)
    X33, Y33, th33 = chip_smoke.lml_inputs(device, 8, 33, 2, 1, 1, True, True)
    with pytest.raises(ValueError, match="n <= 32"):
        md(X33, Y33, th33)
    with pytest.raises(ValueError, match="theta"):
        md(X, Y, th[:2])
    with pytest.raises(ValueError, match="tensors on"):
        md(X.cpu(), Y, th)
    with pytest.raises(TypeError):
        md(X.double(), Y.double(), th.double())
    with pytest.raises(ValueError, match="contiguous"):
        md(X, Y, th.T.contiguous().T)



def test_fused_lml_wide_y_launches_once_per_eight_columns(device, monkeypatch):
    """p = 12 is two launches whose values and gradients add up; D = 12
    is one."""
    _reset_lml_counts(monkeypatch)
    X, Y, th = chip_smoke.lml_inputs(device, 8, 10, 12, 12, 12, True, True)
    tfl.small_lml_value_grad_md(X, Y, th, "rbf", 12, True)
    assert tfl.small_lml_value_grad_md.launches == 2
    Xs, Ys, ths = chip_smoke.lml_inputs(device, 8, 10, 12, 3, 1, True, False)
    tfl.small_lml_value_grad(Xs, Ys, ths, "rbf", 1, True)
    assert tfl.small_lml_value_grad.launches == 1


def _reset_lml_counts(monkeypatch):
    for fn in (tfl.small_lml_value_grad, tfl.small_lml_value_grad_md,
               tbl.spd_inverse_elast_fused):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(tfl.small_lml_value_grad_md, "value_only_launches", 0)


def test_batched_opt_transport_launches_the_fused_fit(device, monkeypatch):
    _reset_lml_counts(monkeypatch)
    X, dX, S, S1 = chip_smoke.make_workload(n_traj=50)
    T = chip_smoke.fit_targets(S1, 16)
    f32 = dict(dtype=torch.float32, device=device)
    res = gpt.fit_and_transport_batched_opt(
        chip_smoke.fit_kernel(**f32), *(torch.as_tensor(a, **f32) for a in (S, T, X, dX)),
        n_restarts=2, maxiter=3)
    torch.cuda.synchronize()
    assert tfl.small_lml_value_grad_md.launches == 1 + 3 * 7
    assert tfl.small_lml_value_grad_md.value_only_launches == 3 * 6
    assert tbl.spd_inverse_elast_fused.launches == 1 and tfl.small_lml_value_grad.launches == 0
    assert torch.isfinite(res.traj).all() and res.traj.shape == (16, 50, 2)


def test_sample_gp_posterior_chains_do_not_depend_on_the_number_of_chains(device):
    """Phase 14's check at a small size: 8 chains alone equal the first 8
    of 32 bit for bit on the card."""
    X, Y = (torch.as_tensor(a, device=device) for a in chip_smoke.hmc_inputs())
    kern = K.Constant(1.0) * K.RBF(torch.ones(2, device=device)) + K.White(0.01)
    kw = dict(seed=2, num_warmup=6, num_samples=6, num_leapfrog=4)
    s32, _ = tsm.sample_gp_posterior(kern, X, Y, num_chains=32, **kw)
    s8, _ = tsm.sample_gp_posterior(kern, X, Y, num_chains=8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(s8, s32[:8])


def test_sample_gp_posterior_launches_the_fused_lml_each_leapfrog(device, monkeypatch):
    _reset_lml_counts(monkeypatch)
    X, Y = (torch.as_tensor(a, device=device) for a in chip_smoke.hmc_inputs())
    kern = K.Constant(1.0) * K.RBF(torch.ones(2, device=device)) + K.White(0.01)
    s, d = tsm.sample_gp_posterior(kern, X, Y, seed=1, num_chains=8, num_warmup=4, num_samples=4,
                                   num_leapfrog=3)
    torch.cuda.synchronize()
    assert tfl.small_lml_value_grad.launches == 1 + 8 * 3
    assert s.shape == (8, 4, 4) and torch.isfinite(s).all()


def test_nuts_chains_do_not_depend_on_the_number_of_chains(device, monkeypatch):
    """The NUTS route on the card: 8 chains alone equal the first 8 of 32
    bit for bit, every leapfrog step one launch of kernel #2."""
    _reset_lml_counts(monkeypatch)
    X, Y = (torch.as_tensor(a, device=device) for a in chip_smoke.hmc_inputs())
    kern = K.Constant(1.0) * K.RBF(torch.ones(2, device=device)) + K.White(0.01)
    kw = dict(seed=2, num_warmup=6, num_samples=6, algorithm="nuts", max_depth=5)
    s32, d32 = tsm.sample_gp_posterior(kern, X, Y, num_chains=32, **kw)
    launches = tfl.small_lml_value_grad.launches
    s8, _ = tsm.sample_gp_posterior(kern, X, Y, num_chains=8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(s8, s32[:8]) and torch.isfinite(s32).all()
    assert launches > 1 + 12 and d32["mean_tree_depth"].shape == (32,)


@pytest.mark.parametrize("family", ["rbf", "matern32"])
def test_blocked_lml_matches_its_cpu_twin(device, family, monkeypatch):
    """The blocked LML at n = 1000 (eight panels of 128, the last padded) on
    the card, one Gram launch and eight factor_panel calls, against the same
    float32 computation on the CPU: the value to 2e-6 of its magnitude plus
    the N·P terms, each gradient entry to 1e-3 of the largest."""
    from gaussian_process_transportation_tpu_torch.ops import blocked_lml as tbll

    monkeypatch.setattr(tbc.factor_panel, "launches", 0)
    monkeypatch.setattr(tbc.stationary_gram_panels, "launches", 0)
    rng = np.random.default_rng(5)
    X = rng.standard_normal((1000, 3)).astype(np.float32)
    Y = (np.sin(X[:, :2]) + 0.1 * rng.standard_normal((1000, 2))).astype(np.float32)
    args = (family, 0.3, torch.tensor([0.1, -0.2, 0.4]), -3.0)
    v_c, g_c = tbll.blocked_lml_value_and_grad(torch.as_tensor(X), torch.as_tensor(Y), *args,
                                               block=128)
    v_d, g_d = tbll.blocked_lml_value_and_grad(torch.as_tensor(X, device=device),
                                               torch.as_tensor(Y, device=device), *args,
                                               block=128)
    torch.cuda.synchronize()
    assert tbc.stationary_gram_panels.launches == 1 and tbc.factor_panel.launches == 8
    assert abs(v_d.item() - v_c.item()) <= 2e-6 * (abs(v_c.item()) + 2000)
    got = torch.cat([g_d[0].reshape(1), g_d[1], g_d[2].reshape(1)]).cpu()
    want = torch.cat([g_c[0].reshape(1), g_c[1], g_c[2].reshape(1)])
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()


def test_fit_jit_runs_its_lanes_on_kernel_2(device, monkeypatch):
    """fit_jit on float32 CUDA tensors: one launch of kernel #2 for each
    evaluation of all lanes that its L-BFGS counts (each iteration's, each
    line-search round's and the final values), no other hand kernel; the fitted
    LML (f64) within 1e-3 of the same fit through the twin on the CPU; and
    #2 at fit_jit's shape (n=20 D=2 p=2, six lanes, both n_ls) against its
    twin and the f64 formula to chip_smoke's bound."""
    from gaussian_process_transportation_tpu_torch.models._lbfgs import lbfgs_minimize

    _reset_lml_counts(monkeypatch)
    for name in ("iterations", "evaluations", "rounds"):
        monkeypatch.setattr(lbfgs_minimize, name, 0)
    src, res = chip_smoke.residual_inputs(device, torch.float32)
    kern = chip_smoke.fit_kernel(dtype=torch.float32, device=device)
    gp = tgp.fit_jit(kern, src, res, n_restarts=2, maxiter=5,
                     generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert lbfgs_minimize.iterations == 5
    assert lbfgs_minimize.evaluations == 5 + lbfgs_minimize.rounds + 1
    assert tfl.small_lml_value_grad.launches == lbfgs_minimize.evaluations
    assert tfl.small_lml_value_grad_md.launches == 0
    src_c, res_c = chip_smoke.residual_inputs("cpu", torch.float32)
    twin = tgp.fit_jit(chip_smoke.fit_kernel(dtype=torch.float32, device="cpu"), src_c, res_c,
                       n_restarts=2, maxiter=5, generator=torch.Generator().manual_seed(0))
    s64, r64 = chip_smoke.residual_inputs("cpu", torch.float64)
    k64 = chip_smoke.fit_kernel(dtype=torch.float64, device="cpu")
    lml = [tgp.log_marginal_likelihood(k64.with_theta(g.kernel.theta.double().cpu()), s64,
                                       r64).item() for g in (gp, twin)]
    assert abs(lml[0] - lml[1]) <= 1e-3 * abs(lml[1]), lml
    for n_ls in (1, 2):
        case = ("rbf", chip_smoke.N_MAIN, 2, 2, n_ls, True)
        diff, excess = chip_smoke.check_lml_case(device, case, 6)["small_lml_value_grad"]
        assert excess < 1 and diff < 1e-3, (case, diff, excess)


def test_greedy_selection_on_the_card_matches_the_cpu(device):
    """The selection loop on the card: float64 picks equal the CPU's; each
    float32 greedy pick attains the largest float64 conditional variance
    given the picks before it, to 1e-5 of amp + noise (float32 rounds
    near-ties, e.g. points no pick has reached yet, which then go to the
    lowest index)."""
    from gaussian_process_transportation_tpu_torch.models import gp_active as tga

    X, _ = chip_smoke.surface_inputs(1000)
    seed = torch.randperm(1000, generator=torch.Generator().manual_seed(0))[:20]
    picks = {}
    for dev, dt in ((device, torch.float64), ("cpu", torch.float64), (device, torch.float32)):
        kern = chip_smoke.al_kernel(dtype=dt, device=dev)
        picks[(str(dev), dt)] = tga.greedy_variance_select(
            kern, torch.as_tensor(X, dtype=dt, device=dev), 200, seed, noise=0.01).cpu()
    assert torch.equal(picks[(str(device), torch.float64)], picks[("cpu", torch.float64)])
    k64 = chip_smoke.al_kernel(dtype=torch.float64, device="cpu")
    X64, p32 = torch.as_tensor(X, dtype=torch.float64), picks[(str(device), torch.float32)]
    assert torch.equal(p32[:20], seed) and len(set(p32.tolist())) == 200
    for j in range(20, 200, 20):
        S = X64[p32[:j]]
        V = torch.linalg.solve_triangular(torch.linalg.cholesky(k64(S)), k64(S, X64), upper=False)
        var = k64.diag(X64) - (V * V).sum(0)
        var[p32[:j]] = -float("inf")
        assert var[p32[j]] >= var.max() - 1e-5 * 1.01, j


def test_active_learning_blocked_predict_takes_k_star(device, monkeypatch):
    """A panel-form GP's predict(return_std) takes its mean from k_star @ α,
    as JAX's predict does (no launch of kernel #5), and agrees with the
    dense float64 predict."""
    from gaussian_process_transportation_tpu_torch.models import gp_active as tga

    monkeypatch.setattr(tpg.fused_gp_predict_mean, "launches", 0)
    X, Y = chip_smoke.surface_inputs(600)
    m = tga.GaussianProcessActiveLearning(chip_smoke.al_kernel(device=device), n_samples_max=512,
                                          use_blocked=True,
                                          blocked_kwargs=dict(maxiter=2, block=128)).fit(X, Y)
    q = chip_smoke.surface_inputs(64, seed=3)[0]
    mean, std = m.predict(q)
    torch.cuda.synchronize()
    assert m.state.chol is not None and tpg.fused_gp_predict_mean.launches == 0
    gp64 = tgp.condition(m.state.kernel.with_theta(m.state.kernel.theta.double()),
                         m.X.double(), m.state.Y.double(), 1e-6)
    mean64, std64 = tgp.predict(gp64, torch.as_tensor(q, dtype=torch.float64, device=device),
                                return_std=True, epistemic_only=True)
    assert (mean - mean64).abs().max().item() <= 5e-3 * mean64.abs().max().item()
    assert (std - std64).abs().max().item() <= 5e-3 * std64.abs().max().item() + 1e-3


# ---- the learned models: graph-captured training and the transports ----------

def _learned_data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    X = 2.0 * rng.standard_normal((n, 2))
    return X, np.stack([np.sin(X[:, 0]), X[:, 0] * np.cos(X[:, 1])], 1)


def _train_case(which, device, dtype):
    """One deterministic training run (draws from a CPU generator) in
    ``dtype`` on ``device``: the trained tensors, flattened."""
    from gaussian_process_transportation_tpu_torch.models import flows, mlp, svgp
    from gaussian_process_transportation_tpu_torch.models._training import (
        cpu_generator, schedule,
    )

    Xn, Yn = _learned_data()
    X, Y = (torch.as_tensor(a, dtype=dtype, device=device) for a in (Xn, Yn))
    gen = cpu_generator(3)
    if which == "mlp":
        p0 = mlp.init_params(gen, (2, 16, 16, 2), members=3, dtype=dtype, device=device)
        out, _ = mlp.train(p0, X, Y, schedule(gen, 40, 4, 8, members=3, device=device))
        return [t for layer in out for t in layer]
    if which == "flow":
        l0 = flows.init_flow(gen, 2, 2, 8, members=2, dtype=dtype, device=device)
        out, _ = flows.train_flow(l0, X, Y, schedule(gen, 40, 4, 8, members=2, device=device))
        return [t for p in out for net in p for layer in net.layers for t in layer]
    kernel = K.Constant(1.0) * K.RBF(torch.ones(2, dtype=dtype, device=device))
    params = svgp.init_params(kernel, X, Y, svgp.draw_inducing(gen, 40, 2, 10, device))
    step = svgp.train_natgrad if which == "natgrad" else svgp.train
    out, _ = step(kernel, params, X, Y, schedule(gen, 40, 4, 16, device=device))
    return [out.theta, out.Z, out.m_w, out.L_w_raw, out.raw_noise]


@pytest.mark.parametrize("which", ["mlp", "flow", "svgp", "natgrad"])
def test_graph_captured_training_matches_the_cpu(device, which, monkeypatch):
    """On the card each step is one replay of a captured graph; float64
    there equals the eager float64 run on the CPU to 1e-10 of each tensor's
    largest entry, and float32 is finite."""
    replays = []
    replay = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda g: (replays.append(1), replay(g))[1])
    got = _train_case(which, device, torch.float64)
    assert len(replays) == (4 * (40 // 16) if which in ("svgp", "natgrad") else 4 * (40 // 8))
    want = _train_case(which, "cpu", torch.float64)
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max().item() <= 1e-10 * max(w.abs().max().item(), 1.0)
    assert all(torch.isfinite(t).all() for t in _train_case(which, device, torch.float32))


@pytest.mark.parametrize("name", ["MLPTransport", "NeuralTransport", "EnsembleNeuralTransport",
                                  "BijectiveTransport", "EnsembleBijectiveTransport",
                                  "GMRTransport", "SVGPTransport"])
def test_learned_transports_on_the_card_match_the_cpu(device, name):
    """Each transport at narrow settings, float64 on the card against the
    CPU to 1e-6 of each field's largest entry, chip_smoke's bound (GMR's
    std moves by ~1e-9 of itself for last-bit input changes here; the
    forest's host fit is held by chip_smoke's phase 26)."""
    from gaussian_process_transportation_tpu_torch.transport import variants

    kw, fit_kw = {
        "MLPTransport": (dict(n_estimators=2, num_epochs=5), {}),  # num_epochs: the fit's
        "NeuralTransport": (dict(hidden=(16, 16)), dict(num_epochs=20)),
        "EnsembleNeuralTransport": (dict(n_estimators=2), dict(num_epochs=5)),
        "BijectiveTransport": (dict(num_blocks=2, num_hidden=8), dict(num_epochs=20)),
        "EnsembleBijectiveTransport": (dict(n_estimators=2, num_blocks=2, num_hidden=8),
                                       dict(num_epochs=20)),
        "GMRTransport": (dict(n_components=3, n_iter=20), {}),
        "SVGPTransport": ({}, dict(num_epochs=5, num_inducing=12)),
    }[name]
    t = np.linspace(0, 1, 60)
    X = np.stack([10 * t, 3 + 2 * np.sin(3 * t)], 1)
    dX = np.vstack([np.diff(X, axis=0), np.zeros((1, 2))])
    s = np.linspace(0, 1, 15)
    S = np.stack([10 * s, 3 + 2 * np.sin(3 * s) + 0.3 * np.cos(7 * s)], 1)
    S1 = S @ np.array([[0.96, -0.28], [0.28, 0.96]]).T + np.stack([0 * s + 1, np.sin(2 * s)], 1)
    runs = []
    for dev in (device, "cpu"):
        tr = getattr(variants, name)(device=dev, **kw)
        tr.source_distribution, tr.target_distribution = S, S1
        tr.training_traj, tr.training_delta = X, dX
        tr.fit_transportation(**fit_kw)
        tr.apply_transportation()
        runs.append(tr)
    card, cpu = runs
    for field in ("training_traj", "training_delta", "std", "var_vel_transported"):
        if getattr(cpu, field, None) is not None:
            want = getattr(cpu, field)
            err = (getattr(card, field).cpu() - want).abs().max().item()
            assert err <= 1e-6 * max(want.abs().max().item(), 1e-12), (field, err)


def test_gp_ds_rollout_step_reads_nothing_back(device, monkeypatch):
    """A rollout step of the GP dynamical system with the fitted kernel's
    amplitude a CUDA tensor: kernel #5 takes it by device pointer, so three
    steps run under set_sync_debug_mode("error"), one launch each; and #5
    and #6 with a CUDA-tensor amplitude and prior equal their runs with the
    same values passed as numbers, bit for bit."""
    from gaussian_process_transportation_tpu_torch import viz

    _reset_counts(monkeypatch)
    rng = np.random.default_rng(14)
    f32 = dict(dtype=torch.float32, device=device)
    X = torch.as_tensor(rng.uniform(-4, 4, (300, 2)), **f32)
    kern = (K.Constant(torch.tensor(1.3, **f32)) * K.Matern(torch.tensor([1.5, 2.0], **f32), nu=2.5)
            + K.White(torch.tensor(0.01, **f32)))
    gp = tgp.condition(kern, X, -0.1 * X + 0.05 * torch.sin(X), cache_k_inv=True)
    x0 = torch.as_tensor(rng.uniform(-4, 4, (7, 2)), **f32)
    assert 7 * 300 >= tgp.FUSED_PREDICT_MIN_ELEMS
    viz.rollout_gp_ds(gp, x0, 1)  # the build and the first launch
    torch.cuda.synchronize()
    tpg.fused_gp_predict_mean.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        traj = viz.rollout_gp_ds(gp, x0, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tpg.fused_gp_predict_mean.launches == 3 and torch.isfinite(traj).all()
    ls, amp = torch.tensor([1.5, 2.0], **f32), torch.tensor(1.3, **f32)
    prior = amp + 0.01
    by_value = tpg.fused_gp_predict_mean(x0, X, gp.alpha, ls, 1.3, "matern52")
    assert torch.equal(tpg.fused_gp_predict_mean(x0, X, gp.alpha, ls, amp, "matern52"), by_value)
    Xq = torch.as_tensor(rng.uniform(-4, 4, (500, 2)), **f32)
    want = tpg.fused_gp_predict_mean_var(Xq, X, gp.alpha, gp.K_inv, ls, 1.3, prior.item(),
                                         "matern52")
    got = tpg.fused_gp_predict_mean_var(Xq, X, gp.alpha, gp.K_inv, ls, amp, prior, "matern52")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_high_precision_route_on_the_card(device, monkeypatch):
    """precision="high" on float32 CUDA tensors (three bfloat16 passes on
    parts split once, ops.linalg's mapping), n = 1000 in panels of 128: the
    solve's α within 2e-4 of the f64 solve (its refinement step takes the
    residual in float32; the bound of the CPU split-route test); the
    blocked LML at "high" against the CPU's float32 one, the value to 1e-4
    of its magnitude plus the N·P terms and each gradient entry to 1e-3 of
    the largest (the CPU emulation's tolerances); the sharded solve in one
    process, which has no refinement (as JAX's), within chip_smoke's bound
    for the N=10240 solve's α, SOLVE_REL_TOL (phase 34's unrefined "high"
    solve reads within it); 1 Gram launch and 8 factor_panel calls a
    solve."""
    from gaussian_process_transportation_tpu_torch.ops import blocked_lml as tbll
    from gaussian_process_transportation_tpu_torch.parallel.sharded_chol import (
        sharded_gram_cholesky_solve,
    )

    monkeypatch.setattr(tbc.factor_panel, "launches", 0)
    monkeypatch.setattr(tbc.stationary_gram_panels, "launches", 0)
    rng = np.random.default_rng(15)
    X = rng.standard_normal((1000, 3)).astype(np.float32)
    Y = (np.sin(X[:, :2]) + 0.1 * rng.standard_normal((1000, 2))).astype(np.float32)
    Xd, Yd = torch.as_tensor(X, device=device), torch.as_tensor(Y, device=device)
    ls = torch.ones(3, device=device)
    alpha, chol = tbc.gram_cholesky_solve(Xd, Yd, ls, 2.0, 0.1, block=128, precision="high")
    torch.cuda.synchronize()
    assert tbc.stationary_gram_panels.launches == 1 and tbc.factor_panel.launches == 8
    assert "high" in chol._operands
    X64 = torch.as_tensor(X, dtype=torch.float64)
    K64 = tpg.stationary_gram_plain(X64, X64, torch.ones(3, dtype=torch.float64), 2.0, "rbf")
    a64 = torch.linalg.solve(K64 + 0.1 * torch.eye(1000, dtype=torch.float64),
                             torch.as_tensor(Y, dtype=torch.float64))
    rel = lambda a: ((a.double().cpu() - a64).abs().max() / a64.abs().max()).item()
    assert rel(alpha) < 2e-4
    args = ("rbf", 0.3, torch.tensor([0.1, -0.2, 0.4]), -3.0)
    v_c, g_c = tbll.blocked_lml_value_and_grad(torch.as_tensor(X), torch.as_tensor(Y), *args,
                                               block=128)
    v_d, g_d = tbll.blocked_lml_value_and_grad(Xd, Yd, *args, block=128, precision="high")
    assert abs(v_d.item() - v_c.item()) <= 1e-4 * (abs(v_c.item()) + 2000)
    got = torch.cat([g_d[0].reshape(1), g_d[1], g_d[2].reshape(1)]).cpu()
    want = torch.cat([g_c[0].reshape(1), g_c[1], g_c[2].reshape(1)])
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    a_s, _ = sharded_gram_cholesky_solve(Xd, Yd, ls, 2.0, 0.1, None, block=128, precision="high")
    assert rel(a_s) < chip_smoke.SOLVE_REL_TOL


# ---- the fused transport apply: ops/transport_apply.py, csrc/transport_apply.cu ----

from gaussian_process_transportation_tpu_torch.ops import transport_apply as tfa  # noqa: E402


def _apply_case(device, E, n, Q, D, theta="shared", seed=0):
    """The batched route's float32 state on the card (γ, the E GPs from the
    Cholesky kernel) under C(10)·RBF(4)+White(0.01), its θ shared or moved
    per member, and a demo of Q points: the floor curves in 2-D, a 3-D curve."""
    rng = np.random.default_rng(seed + 100 * n + 10 * D + E)
    t, s = np.linspace(0, 1, Q), np.linspace(0, 1, n)
    if D == 2:
        X, S = np.stack([10 * t, 5 * np.sin(3 * t)], 1), np.stack([10 * s, -2 + 0 * s], 1)
    else:
        X = np.stack([4 * t, np.sin(3 * t), 0.5 * np.cos(2 * t)], 1)
        S = np.stack([4 * s, np.sin(4 * s), np.cos(3 * s)], 1)
    T = S[None] + 0.3 * rng.standard_normal((E, n, D)) + 0.2
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    kern = K.Constant(10.0) * K.RBF(4.0 * torch.ones(D, device=device)) + K.White(0.01)
    if theta == "per_member":
        kern = kern.with_theta(kern.theta[None] + 0.2 * f(rng.standard_normal((E, 4 if D == 2 else 5))))
    aff, src_al, y = gpt._affine_batched(f(S), f(T), False, True)
    return aff, gpt._condition_batched(kern, src_al, y, 1e-10), f(X), f(dX)


@pytest.mark.parametrize("theta", ["shared", "per_member"])
@pytest.mark.parametrize("E,Q", [(1, 1), (1, 129), (3, 1), (3, 129), (3, 400)])
@pytest.mark.parametrize("n", [1, 20, 24, 25, 33, 64])
@pytest.mark.parametrize("D", [2, 3])
def test_fused_apply_matches_twin(device, D, n, E, Q, theta, monkeypatch):
    monkeypatch.setattr(tfa.transport_apply_rbf, "launches", 0)
    chip_smoke.check_apply(*_apply_case(device, E, n, Q, D, theta))
    assert tfa.transport_apply_rbf.launches == 1


@pytest.mark.parametrize("theta", ["shared", "per_member"])
@pytest.mark.parametrize("n", [20, 64])
@pytest.mark.parametrize("D", [2, 3])
def test_fused_apply_matches_twin_at_the_floor_ensemble(device, D, n, theta):
    """E = 16,384 members, Q = 400: the floor cell's size, 2,048 blocks."""
    chip_smoke.check_apply(*_apply_case(device, 16384, n, 400, D, theta))


def test_transport_apply_takes_one_fused_launch_with_no_host_sync(device, monkeypatch):
    """The floor's inputs: one launch an apply, no synchronising call
    (sync debug mode "error"), the fields' shapes and views, and min|det J_Φ|
    within the floor cell's limit (0.003) of the plain route's (the same GP
    without L, which the fused route needs: today's route through K⁻¹)."""
    monkeypatch.setattr(tfa.transport_apply_rbf, "launches", 0)
    aff, gp, X, dX = _apply_case(device, 2048, 20, 400, 2)
    assert gpt.fused_apply_inputs(aff, gp, X, dX)
    gpt.transport_apply(aff, gp, X, dX)  # built and loaded before the debug mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = gpt.transport_apply(aff, gp, X, dX)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    plain = gpt.transport_apply(aff, replace(gp, L=None), X, dX)  # the plain route, by K⁻¹
    torch.cuda.synchronize()
    assert tfa.transport_apply_rbf.launches == 2
    for name in ("traj", "std", "delta", "delta_var", "min_abs_det"):
        assert getattr(res, name).shape == getattr(plain, name).shape, name
    assert res.std.stride()[-1] == 0 and res.delta_var.stride()[-1] == 0
    rel = ((res.min_abs_det - plain.min_abs_det).abs() / plain.min_abs_det.abs()).max().item()
    assert rel <= 0.003


def test_one_member_without_an_axis_takes_the_fused_launch(device, monkeypatch):
    monkeypatch.setattr(tfa.transport_apply_rbf, "launches", 0)
    aff, gp, X, dX = _apply_case(device, 1, 20, 50, 2)
    S = gp.X[0]
    aff1, gp1 = gpt.fit_pipeline(gp.kernel, S, S + 0.1 * torch.sin(S))
    res = gpt.transport_apply(aff1, gp1, X, dX)
    plain = gpt.transport_apply(aff1, replace(gp1, L=None), X, dX)
    torch.cuda.synchronize()
    assert tfa.transport_apply_rbf.launches == 1
    assert res.traj.shape == (50, 2) and res.min_abs_det.shape == ()
    assert (res.traj - plain.traj).abs().max().item() <= 1e-4 * plain.traj.abs().max().item()


def test_members_past_64_points_launch_nothing(device, monkeypatch):
    """n = 65: the batched entry's per-member route, each apply plain."""
    monkeypatch.setattr(tfa.transport_apply_rbf, "launches", 0)
    aff, gp, X, dX = _apply_case(device, 2, 20, 40, 2)
    s = torch.linspace(0, 1, 65, device=device)
    S = torch.stack([10 * s, -2 + 0.3 * torch.sin(7 * s)], 1)
    T = torch.stack([S + 0.1 * torch.sin(S), S - 0.1])
    res = gpt.fit_and_transport_batched(gp.kernel, S, T, X, dX)
    torch.cuda.synchronize()
    assert tfa.transport_apply_rbf.launches == 0 and torch.isfinite(res.traj).all()


@pytest.mark.parametrize("case", ["ori", "float64", "sum_of_rbfs"])
def test_inputs_outside_the_fused_kernel_launch_nothing(device, case, monkeypatch):
    monkeypatch.setattr(tfa.transport_apply_rbf, "launches", 0)
    D = 3 if case == "ori" else 2
    aff, gp, X, dX = _apply_case(device, 4, 20, 40, D)
    ori = None
    if case == "ori":
        ori = torch.nn.functional.normalize(torch.randn(40, 4, device=device), dim=-1)
    if case == "float64":
        gp = gpt.gp_core.ExactGP(
            kernel=K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, dtype=torch.float64, device=device))
            + K.White(0.01), X=gp.X.double(), Y=gp.Y.double(), alpha=gp.alpha.double(),
            L=gp.L.double(), K_inv=gp.K_inv.double())
        aff = type(aff)(*(t.double() for t in (aff.rotation, aff.scale, aff.source_centroid,
                                               aff.target_centroid)))
        X, dX = X.double(), dX.double()
    if case == "sum_of_rbfs":
        gp = gpt.gp_core.ExactGP(kernel=K.RBF(torch.ones(2, device=device)) + K.RBF(2.0), X=gp.X,
                                 Y=gp.Y, alpha=gp.alpha, L=gp.L, K_inv=gp.K_inv)
    res = gpt.transport_apply(aff, gp, X, dX, ori=ori)
    torch.cuda.synchronize()
    assert tfa.transport_apply_rbf.launches == 0 and torch.isfinite(res.traj).all()
