"""Port parity: ``ops/mixed_linalg.py`` (the mixed-precision blocked
Cholesky, fixed-point refinement, PCG and the refined GP solve) against the
JAX package's, float64 on the CPU, within the tolerances of JAX's own
tests (tests/test_mixed_linalg.py).  The CPU computes every product in the
operands' dtype, as JAX's CPU backend does; ``emulate_bf16`` rounds the
trailing update's panel through bfloat16 in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.ops import mixed_linalg as jmx
from gaussian_process_transportation_tpu.ops.linalg import add_diagonal as jadd
from gaussian_process_transportation_tpu_torch import ops as tops
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.ops import linalg as tlin
from gaussian_process_transportation_tpu_torch.ops import mixed_linalg as tmx
from gaussian_process_transportation_tpu_torch.ops.linalg import cho_solve_lower

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)


def _spd(n, d=3, noise=0.1, seed=0):
    """JAX's test Gram: C(2)·RBF(1)+White(noise) at standard-normal points
    (drawn once, here with numpy), plus 1e-8; (K numpy, X numpy, JAX kernel)."""
    X = np.random.default_rng(seed).standard_normal((n, d))
    kern = JK.Constant(2.0) * JK.RBF(jnp.ones(d)) + JK.White(noise)
    return np.array(jadd(kern(jnp.asarray(X)), 1e-8)), X, kern


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _rhs(n, p, seed):
    return np.random.default_rng(seed).standard_normal((n, p))


@pytest.mark.parametrize("n,block", [(256, 64), (300, 128), (512, 512), (130, 64)])
def test_blocked_cholesky_matches_jax_and_the_builtin(n, block):
    K, _, _ = _spd(n)
    got = tmx.blocked_cholesky(_t(K), block=block, syrk_precision="highest")
    want = jmx.blocked_cholesky(jnp.asarray(K), block=block, syrk_precision="highest")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(K), rtol=1e-9, atol=1e-9)


def test_blocked_cholesky_reconstructs_and_is_lower():
    K, _, _ = _spd(320)
    L = tops.blocked_cholesky_mixed(_t(K), block=128)
    np.testing.assert_allclose((L @ L.T).numpy(), K, rtol=1e-9, atol=1e-9)
    assert torch.triu(L, 1).abs().max().item() == 0.0


def test_emulated_bf16_factor_matches_jax():
    """The trailing update's panel rounded through bfloat16: the same
    rounding in both packages, so the same factor to f64 rounding of the
    products."""
    K, _, _ = _spd(384, noise=0.1)
    got = tmx.blocked_cholesky(_t(K), block=128, emulate_bf16=True)
    want = jmx.blocked_cholesky(jnp.asarray(K), block=128, emulate_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)


def test_pcg_recovers_accuracy_from_a_bf16_factor():
    """GP-realistic conditioning (κ ~ 1.7e3), where fixed-point refinement
    diverges: the bf16 factor alone is visibly wrong, PCG restores the
    solve, and the iterates match JAX's."""
    K, _, _ = _spd(384, noise=0.1)
    K = K.astype(np.float32).astype(np.float64)
    B = _rhs(384, 3, 1)
    L_lo = tmx.blocked_cholesky(_t(K), block=128, emulate_bf16=True)
    assert torch.isfinite(L_lo).all()
    x_ref = np.linalg.solve(K, B)
    err_lo = np.linalg.norm(cho_solve_lower(L_lo, _t(B)).numpy() - x_ref) / np.linalg.norm(x_ref)
    assert err_lo > 1e-6
    x, rel = tmx.pcg_solve(_t(K), L_lo, _t(B), iters=30)
    assert rel.item() < 1e-10
    assert np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref) < 1e-8
    xj, relj = jmx.pcg_solve(jnp.asarray(K), jnp.asarray(L_lo.numpy()), jnp.asarray(B), iters=30)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8, atol=1e-10)


def test_ir_solve_converges_when_well_conditioned_and_matches_jax():
    K, _, _ = _spd(256, noise=1.0)  # a large noise floor: a small κ
    B = _rhs(256, 2, 3)
    L_lo = tmx.blocked_cholesky(_t(K), block=128, emulate_bf16=True)
    x, rel = tmx.ir_solve(_t(K), L_lo, _t(B), sweeps=5)
    assert rel.item() < 1e-9
    xj, relj = jmx.ir_solve(jnp.asarray(K), jnp.asarray(L_lo.numpy()), jnp.asarray(B), sweeps=5)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    assert rel.item() == pytest.approx(float(relj), rel=1e-3, abs=1e-15)


def test_gram_chol_solve_mixed_end_to_end():
    n = 320
    K, X, kern = _spd(n)
    Y = _rhs(n, 2, 2)
    alpha, L, rel = tops.gram_chol_solve_mixed(kernel_from_tree(kern, device="cpu"), _t(X),
                                               _t(Y), jitter=1e-8, block=128, emulate_bf16=True,
                                               iters=30)
    assert rel.item() < 1e-9
    np.testing.assert_allclose(alpha.numpy(), np.linalg.solve(K, Y), rtol=1e-6, atol=1e-8)
    aj, Lj, relj = jmx.gram_chol_solve_mixed(kern, jnp.asarray(X), jnp.asarray(Y), jitter=1e-8,
                                             block=128, emulate_bf16=True, iters=30)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(aj), rtol=1e-8, atol=1e-10)


def test_precisions_and_their_cpu_meaning():
    """The three names map per call, never through the process-wide flags;
    on the CPU every product is taken in the operands' dtype; an unknown
    name is refused."""
    a = torch.randn(40, 30, generator=torch.Generator().manual_seed(0))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    for p in tlin.PRECISIONS:
        torch.testing.assert_close(tlin.matmul_at(a, a.T, p), a @ a.T, rtol=0, atol=0)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()) == flags
    with pytest.raises(ValueError, match="precision"):
        tlin.matmul_at(a, a.T, "fast")


def test_a_factor_that_is_not_definite_reads_nan():
    """As XLA's Cholesky: NaN, not an exception, so a caller can gate on it."""
    K, _, _ = _spd(200)
    K[150, 150] = -5.0
    assert torch.isnan(tmx.blocked_cholesky(_t(K), block=64)).any()
    assert bool(jnp.isnan(jmx.blocked_cholesky(jnp.asarray(K), block=64)).any())
