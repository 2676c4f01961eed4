"""Port parity: ``models/random_forest.py`` against the JAX package's.  The
host fit draws its bootstrap samples from the same
``np.random.RandomState(seed)``, so the fitted arrays and every tree's
prediction must equal JAX's exactly; the split search through the port's
copy of ``cart.cpp`` must equal its numpy twin, ties included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.models import random_forest as jr
from gaussian_process_transportation_tpu_torch.convert import forest_params_from_numpy
from gaussian_process_transportation_tpu_torch.models import random_forest as tr
from gaussian_process_transportation_tpu_torch.ops import _cuda

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)


def _data(seed, n=60, d=2, p=2):
    """Coordinates rounded to one decimal, so that columns hold ties."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.standard_normal((n, d)), 1)
    return X, np.sin(X[:, :p]) + 0.1 * rng.standard_normal((n, p))


@pytest.mark.parametrize("seed,depth,n", [(0, 5, 60), (3, 6, 25)])
def test_forest_fit_and_members_equal_jaxs(seed, depth, n):
    X, Y = _data(seed, n)
    want = jr.fit_forest(X, Y, n_estimators=12, max_depth=depth, seed=seed)
    got = tr.fit_forest(X, Y, n_estimators=12, max_depth=depth, seed=seed, device="cpu")
    for name in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert (got.feature == -1).any()  # some node stopped early
    xq = np.concatenate([np.round(np.random.default_rng(9).standard_normal((30, 2)), 1), X[:10]])
    np.testing.assert_array_equal(tr.forest_member_predict(got, torch.as_tensor(xq)).numpy(),
                                  np.asarray(jr.forest_member_predict(want, jnp.asarray(xq))))


def test_split_search_equals_its_numpy_twin():
    """The C++ copy against the numpy twin on tied columns, a constant
    column, one that cannot split and multi-output targets."""
    rng = np.random.default_rng(1)
    for trial in range(40):
        n, d, p = rng.integers(2, 40), rng.integers(1, 4), rng.integers(1, 3)
        X = np.round(rng.standard_normal((n, d)), 1)
        if trial % 5 == 0:
            X[:, 0] = 0.5
        y = rng.standard_normal((n, p))
        assert tr._best_split_native(X, y) == tr._best_split(X, y), trial
    assert tr._best_split_native(np.ones((6, 2)), rng.standard_normal((6, 1))) is None
    assert tr._best_split(np.ones((6, 2)), rng.standard_normal((6, 1))) is None


def test_fit_with_the_numpy_twin_is_the_same_forest():
    X, Y = _data(5)
    a = tr.fit_forest_numpy(X, Y, n_estimators=6, max_depth=4, seed=2)
    b = tr.fit_forest_numpy(X, Y, n_estimators=6, max_depth=4, seed=2, best_split=tr._best_split)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_wrapper_matches_jax_with_ddof_zero():
    """Mean and std (ddof 0) over the trees, and the trees' predictions as
    samples; a forest carried across from JAX's arrays predicts the same."""
    X, Y = _data(2)
    xq = np.random.default_rng(4).standard_normal((15, 2))
    want = jr.EnsembleRandomForest(n_estimators=10, max_depth=4, seed=7).fit(X, Y)
    got = tr.EnsembleRandomForest(n_estimators=10, max_depth=4, seed=7, device="cpu").fit(X, Y)
    for g, w in zip(got.predict(xq, return_std=True), want.predict(xq, return_std=True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)
    members = got.samples(xq).numpy()
    np.testing.assert_allclose(got.predict(xq, return_std=True)[1].numpy(),
                               members.std(0, ddof=0), rtol=1e-12, atol=1e-14)
    got.params = forest_params_from_numpy(want.params, device="cpu")
    np.testing.assert_array_equal(got.samples(xq).numpy(), np.asarray(want.samples(xq)))


def test_a_failed_host_build_raises_with_the_compilers_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .* building broken.cpp"):
        _cuda._compile(bad, "g++", _cuda.GXX_FLAGS)
