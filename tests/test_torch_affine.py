"""Port parity: Kabsch affine fit (``models/affine.py``) against JAX, f64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.models import affine as jaff
from gaussian_process_transportation_tpu_torch.convert import affine_from_numpy
from gaussian_process_transportation_tpu_torch.models import affine as taff

TOL = 1e-10  # SVD / atan2 of the same 2x2 or 3x3 matrices in float64
FIELDS = ("rotation", "scale", "source_centroid", "target_centroid")


def _points(d, n=15, E=None, seed=0):
    rng = np.random.default_rng(seed + d)
    src = rng.standard_normal((n, d)) * 2.0
    A = np.linalg.qr(rng.standard_normal((d, d)))[0]
    shape = (n, d) if E is None else (E, n, d)
    tgt = 1.3 * src @ A.T + 0.1 * rng.standard_normal(shape) + 0.5
    return src, tgt


def _assert_params(got, want):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=TOL, atol=TOL, err_msg=f)


@pytest.mark.parametrize("do_scale", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_fit_and_predict_match_jax(d, do_scale):
    src, tgt = _points(d)
    want = jaff.fit(jnp.asarray(src), jnp.asarray(tgt), do_scale=do_scale)
    got = taff.fit(torch.as_tensor(src), torch.as_tensor(tgt), do_scale=do_scale)
    _assert_params(got, want)
    x = np.random.default_rng(5).standard_normal((9, d))
    np.testing.assert_allclose(taff.predict(got, torch.as_tensor(x)).numpy(),
                               np.asarray(jaff.predict(want, jnp.asarray(x))), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(taff.derivative(got, torch.as_tensor(x)).numpy(),
                               np.asarray(jaff.derivative(want, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("do_rotation", [False, True])
def test_fit_without_rotation_or_with_too_few_points(do_rotation):
    src, tgt = _points(3, n=2)  # n < d: identity rotation in both
    want = jaff.fit(jnp.asarray(src), jnp.asarray(tgt), do_rotation=do_rotation)
    got = taff.fit(torch.as_tensor(src), torch.as_tensor(tgt), do_rotation=do_rotation)
    _assert_params(got, want)


@pytest.mark.parametrize("do_scale", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_fit_batched_matches_jax(d, do_scale):
    src, tgts = _points(d, E=6)
    want = jaff.fit_batched(jnp.asarray(src), jnp.asarray(tgts), do_scale=do_scale)
    got = taff.fit_batched(torch.as_tensor(src), torch.as_tensor(tgts), do_scale=do_scale)
    _assert_params(got, want)
    assert np.allclose(np.linalg.det(got.rotation.numpy()), 1.0, atol=1e-12)
    # the batched predict broadcasts one shared point set over members
    pred = taff.predict(got, torch.as_tensor(src))
    ref = jax.vmap(lambda a: jaff.predict(a, jnp.asarray(src)))(want)
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_affine_from_numpy_round_trip():
    src, tgt = _points(2)
    want = jaff.fit(jnp.asarray(src), jnp.asarray(tgt))
    got = affine_from_numpy({f: np.asarray(getattr(want, f)) for f in FIELDS})
    _assert_params(got, want)


def test_fit_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        taff.fit(torch.zeros(4, 2, dtype=torch.float64), torch.zeros(5, 2, dtype=torch.float64))
