"""Port parity: quaternion algebra (``ops/quaternion.py``) against JAX, f64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.ops import quaternion as jq
from gaussian_process_transportation_tpu_torch.ops import quaternion as tq

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)


def _near_rotations(n=64, perturb=0.3, seed=0):
    """Random rotations with up to ``perturb`` non-orthogonal noise."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4))
    R = np.asarray(jq.to_rotation_matrix(jnp.asarray(q)))
    return R + perturb * rng.uniform(-1, 1, R.shape)


@pytest.mark.parametrize("perturb", [0.0, 0.3, 0.5])
def test_from_rotation_matrix_iter_matches_jax_and_eigh(perturb):
    R = _near_rotations(perturb=perturb)
    got = tq.from_rotation_matrix_iter(torch.as_tensor(R))
    want = np.asarray(jq.from_rotation_matrix_iter(jnp.asarray(R)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    # same optimum as the eigensolver form (the JAX package's own bound)
    eig = tq.from_rotation_matrix(torch.as_tensor(R))
    np.testing.assert_allclose(got.numpy(), eig.numpy(), atol=1e-6)
    np.testing.assert_allclose(eig.numpy(), np.asarray(jq.from_rotation_matrix(jnp.asarray(R))),
                               atol=1e-10)


def test_algebra_matches_jax():
    rng = np.random.default_rng(3)
    q1, q2 = rng.standard_normal((2, 10, 4))
    cases = [
        (tq.multiply(torch.as_tensor(q1), torch.as_tensor(q2)), jq.multiply(q1, q2)),
        (tq.conjugate(torch.as_tensor(q1)), jq.conjugate(jnp.asarray(q1))),
        (tq.normalize(torch.as_tensor(q1)), jq.normalize(jnp.asarray(q1))),
        (tq.to_rotation_matrix(torch.as_tensor(q1)), jq.to_rotation_matrix(jnp.asarray(q1))),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_round_trip_through_rotation_matrix():
    q = tq.normalize(torch.as_tensor(np.random.default_rng(4).standard_normal((8, 4))))
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)
    back = tq.from_rotation_matrix_iter(tq.to_rotation_matrix(q))
    torch.testing.assert_close(back, q, rtol=0, atol=1e-9)
