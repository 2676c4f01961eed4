"""Port parity: ``utils/metrics.py`` against the JAX package's, float64 on
the CPU.  DTW and the discrete Fréchet distance: the anti-diagonal
wavefront bit for bit equal to a row-by-row sweep of the same cells on
the port's own distances (``chip_smoke.row_sweep``, the JAX package's
schedule cell by cell), and to 1e-12 of JAX's; every other metric a
closed form, to 1e-12 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import row_sweep
from gaussian_process_transportation_tpu.utils import metrics as jm
from gaussian_process_transportation_tpu_torch.utils import metrics as tm

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _curves(n, m, seed=0):
    rng = np.random.default_rng(seed)
    A = np.cumsum(rng.standard_normal((n, 2)), 0)
    B = np.cumsum(rng.standard_normal((m, 2)), 0) + 0.5
    return A, B


@pytest.mark.parametrize("n,m", [(60, 45), (1, 7), (9, 1), (2, 2), (33, 60)])
@pytest.mark.parametrize("name", ["dtw", "frechet"])
def test_dynamic_programs_are_the_row_sweep_bitwise_and_match_jax(name, n, m):
    A, B = _curves(n, m, seed=n + m)
    tfn = getattr(tm, f"{name}_distance")
    jfn = getattr(jm, f"{name}_distance")
    got = tfn(torch.as_tensor(A), torch.as_tensor(B)).item()
    D = tm._pairwise_dist(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert got == row_sweep(D, np.add if name == "dtw" else np.maximum)
    np.testing.assert_allclose(got, float(jfn(jnp.asarray(A), jnp.asarray(B))), **TOL)


def test_dynamic_programs_of_identical_curves():
    A, _ = _curves(40, 1, seed=3)
    At = torch.as_tensor(A)
    assert tm.frechet_distance(At, At).item() < 1e-6
    np.testing.assert_allclose(tm.dtw_distance(At, At).item(),
                               float(jm.dtw_distance(jnp.asarray(A), jnp.asarray(A))), **TOL)


@pytest.mark.parametrize("name", ["area_between_curves", "final_position_error",
                                  "final_angle_error", "hausdorff_distance", "chamfer_distance",
                                  "euclidean_distance", "comparison_euclidean_distance"])
def test_curve_metrics_match_jax(name):
    A, B = _curves(50, 50, seed=7)
    got = getattr(tm, name)(torch.as_tensor(A), torch.as_tensor(B)).item()
    want = float(getattr(jm, name)(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(got, want, **TOL)


def test_area_between_curves_of_unequal_lengths_cuts_to_the_shorter():
    A, B = _curves(30, 50, seed=8)
    got = tm.area_between_curves(torch.as_tensor(A), torch.as_tensor(B)).item()
    np.testing.assert_allclose(got, float(jm.area_between_curves(jnp.asarray(A), jnp.asarray(B))),
                               **TOL)


@pytest.mark.parametrize("name", ["gaussian_kl_divergence", "weighted_distribution_distance"])
def test_distribution_metrics_match_jax(name):
    rng = np.random.default_rng(11)
    mp, mq = rng.standard_normal((2, 40, 2))
    sp, sq = rng.uniform(0.1, 2.0, (2, 40, 2))
    got = getattr(tm, name)(*(torch.as_tensor(a) for a in (mp, sp, mq, sq))).item()
    want = float(getattr(jm, name)(*(jnp.asarray(a) for a in (mp, sp, mq, sq))))
    np.testing.assert_allclose(got, want, **TOL)
