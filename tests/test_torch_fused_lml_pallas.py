"""Port parity: the fused small-LML twins against the JAX package's Pallas
kernels themselves, run in interpret mode as the JAX tests run them (eb=8,
n ≤ 8, ragged E).  Each family meets both lengthscale forms, both noise
settings and p ∈ {1, 3} over the two cases of a kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.ops import fused_lml as jfl
from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

VAL_RTOL, GRAD_RTOL = 2e-5, 2e-4  # tests/test_fused_lml.py:97-98
FAMILIES = ("rbf", "matern12", "matern32", "matern52")
FORMS = [(1, True, 1), (2, False, 3)]  # (n_ls, has_noise, p) with D = 2
JITTER = {True: 1e-8, False: 1e-2}  # no noise: a jitter that keeps the f32 Gram definite


def _case(n, D, p, E, T, per_lane, seed):
    rng = np.random.default_rng(seed)
    lead = (E,) if per_lane else ()
    X = rng.standard_normal(lead + (n, D)).astype(np.float32)
    Y = (np.sin(X[..., :1]) + 0.1 * rng.standard_normal(lead + (n, p))).astype(np.float32)
    th = rng.uniform(-1.0, 1.0, (T, E)).astype(np.float32)
    return X, Y, th


def _compare(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL, atol=VAL_RTOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=GRAD_RTOL, atol=GRAD_RTOL)


@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"nls{f[0]}-noise{int(f[1])}-p{f[2]}")
@pytest.mark.parametrize("family", FAMILIES)
def test_shared_data_twin_matches_jax_pallas_interpret(family, form):
    n_ls, has_noise, p = form
    X, Y, th = _case(8, 2, p, 11, 1 + n_ls + has_noise, False, 5)
    want = jfl.small_lml_value_grad(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(th), family, n_ls,
                                    has_noise, JITTER[has_noise], eb=8, interpret=True)
    _compare(tfl.small_lml_value_grad(*map(torch.as_tensor, (X, Y, th)), family, n_ls, has_noise,
                                      JITTER[has_noise]), want)


@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"nls{f[0]}-noise{int(f[1])}-p{f[2]}")
@pytest.mark.parametrize("family", FAMILIES)
def test_per_lane_data_twin_matches_jax_pallas_interpret(family, form):
    n_ls, has_noise, p = (form[0], not form[1], 4 - form[2])  # the other noise and p per form
    X, Y, th = _case(7, 2, p, 13, 1 + n_ls + has_noise, True, 6)
    want = jfl.small_lml_value_grad_md(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(th), family,
                                       n_ls, has_noise, JITTER[has_noise], eb=8, interpret=True)
    _compare(tfl.small_lml_value_grad_md(*map(torch.as_tensor, (X, Y, th)), family, n_ls,
                                         has_noise, JITTER[has_noise]), want)
