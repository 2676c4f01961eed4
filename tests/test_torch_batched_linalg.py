"""Port parity: ensemble-last Cholesky / inverse twins
(``ops/batched_linalg.py``) against JAX, and the CPU routing of the
kernel wrapper.  The CUDA kernel itself is checked on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.ops import batched_linalg as jbl
from gaussian_process_transportation_tpu_torch.ops import batched_linalg as tbl

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)


def _spd_batch(n, E, seed=0):
    """(E, n, n) float32 SPD matrices A Aᵀ + 3I, as the JAX package's
    fused-kernel tests build them."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((E, n, n)).astype(np.float32)
    return np.einsum("eij,ekj->eik", A, A) + 3 * np.eye(n, dtype=np.float32)


def _elast(K):
    return np.ascontiguousarray(np.transpose(K, (1, 2, 0)))


@pytest.fixture(scope="module", params=[(13, 6), (20, 9)])
def case64(request):
    n, E = request.param
    Ke = _elast(_spd_batch(n, E, seed=n).astype(np.float64))
    L, Kinv = jbl.spd_inverse_elast(jnp.asarray(Ke))
    return Ke, np.array(L), np.array(Kinv)


def test_twins_match_jax_f64(case64):
    """cholesky_elast / inv_lower_elast / spd_inverse_elast to 1e-10."""
    Ke, L_j, Kinv_j = case64
    L, Kinv = tbl.spd_inverse_elast(torch.as_tensor(Ke))
    np.testing.assert_allclose(L.numpy(), L_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(Kinv.numpy(), Kinv_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tbl.cholesky_elast(torch.as_tensor(Ke)).numpy(), L_j,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        tbl.inv_lower_elast(torch.as_tensor(L_j)).numpy(),
        np.asarray(jbl.inv_lower_elast(jnp.asarray(L_j))), rtol=1e-10, atol=1e-10)


def test_cho_solve_elast_matches_jax_f64(case64):
    Ke, L_j, _ = case64
    n, _, E = Ke.shape
    B = np.random.default_rng(1).standard_normal((n, 3, E))
    want = np.asarray(jbl.cho_solve_elast(jnp.asarray(L_j), jnp.asarray(B)))
    got = tbl.cho_solve_elast(torch.as_tensor(L_j), torch.as_tensor(B))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n,E,lanes", [(20, 70, 64), (7, 129, 128), (32, 64, 64)])
def test_twin_matches_pallas_kernel_f32(n, E, lanes):
    """The f32 twin against the TPU kernel run in interpret mode, to the
    JAX package's own kernel tolerance (2e-5)."""
    K = _spd_batch(n, E)
    L_p, Kinv_p = jbl.spd_inverse_elast_fused(jnp.asarray(_elast(K)), interpret=True,
                                              lanes=lanes)
    L, Kinv = tbl.spd_inverse_elast(torch.as_tensor(_elast(K)))
    assert L.dtype == torch.float32
    np.testing.assert_allclose(L.numpy(), np.asarray(L_p), atol=2e-5)
    np.testing.assert_allclose(Kinv.numpy(), np.asarray(Kinv_p), atol=2e-5)
    ref = np.linalg.inv(K.astype(np.float64))
    assert np.abs(np.transpose(Kinv.numpy(), (2, 0, 1)) - ref).max() < 1e-4
    Lb = L.permute(2, 0, 1)
    assert torch.equal(Lb, torch.tril(Lb))


def test_auto_on_cpu_takes_the_twin_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(tbl.spd_inverse_elast_fused, "launches", 0)
    Ke = torch.as_tensor(_elast(_spd_batch(8, 5).astype(np.float64)))
    L, Kinv = tbl.spd_inverse_elast_auto(Ke)
    L0, Kinv0 = tbl.spd_inverse_elast(Ke)
    torch.testing.assert_close(L, L0, rtol=0, atol=0)
    torch.testing.assert_close(Kinv, Kinv0, rtol=0, atol=0)
    assert tbl.spd_inverse_elast_fused.launches == 0


def test_fused_wrapper_refuses_cpu_tensors(monkeypatch):
    monkeypatch.setattr(tbl.spd_inverse_elast_fused, "launches", 0)
    K = torch.eye(4, dtype=torch.float32)[:, :, None].expand(4, 4, 3).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        tbl.spd_inverse_elast_fused(K)
    assert tbl.spd_inverse_elast_fused.launches == 0


@pytest.mark.parametrize("batched", [False, True], ids=["one", "vmap"])
def test_small_cholesky_and_cho_solve_match_jax_f64(batched):
    """small_cholesky and small_cho_solve against JAX's, float64, to 1e-10:
    one (n, n) matrix, and a batch that JAX runs under ``jax.vmap`` (its
    custom_vmap rule: the ensemble-last twins) and the port as leading
    axes; a matrix that is not positive definite factors to NaN."""
    import jax

    n, E, p = 11, 5, 3
    K = _spd_batch(n, E, seed=7).astype(np.float64)
    B = np.random.default_rng(8).standard_normal((E, n, p))
    if not batched:
        K, B = K[0], B[0]
        chol, solve = jbl.small_cholesky, jbl.small_cho_solve
    else:
        chol, solve = jax.vmap(jbl.small_cholesky), jax.vmap(jbl.small_cho_solve)
    L_j = np.asarray(chol(jnp.asarray(K)))
    X_j = np.asarray(solve(jnp.asarray(L_j), jnp.asarray(B)))
    L = tbl.small_cholesky(torch.as_tensor(K))
    np.testing.assert_allclose(L.numpy(), L_j, rtol=1e-10, atol=1e-10)
    X = tbl.small_cho_solve(L, torch.as_tensor(B))
    np.testing.assert_allclose(X.numpy(), X_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.einsum("...ij,...jk->...ik", K, X.numpy()), B, atol=1e-10)
    bad = torch.as_tensor(K).clone()
    bad[..., 0, 0] = -1.0
    assert torch.isnan(tbl.small_cholesky(bad)).all()
