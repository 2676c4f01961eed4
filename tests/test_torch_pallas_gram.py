"""Port parity: the stationary-Gram tile and the fused dense-grid predicts
(``ops/pallas_gram.py``) against the JAX Pallas kernels in interpret mode,
at the JAX tests' sizes and tiles (tile_q=16, tile_k=32; Nq=70, N=90), all
four families, float32, with the JAX tests' tolerances.  CPU tensors take
the plain twins and launch nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.models import exact_gp as jgp
from gaussian_process_transportation_tpu.ops import pallas_gram as jpg
from gaussian_process_transportation_tpu_torch.ops import pallas_gram as tpg

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

FAMILIES = ("rbf", "matern12", "matern32", "matern52")
NU = {"rbf": None, "matern12": 0.5, "matern32": 1.5, "matern52": 2.5}


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("family", FAMILIES)
def test_stationary_gram_matches_jax(family):
    rng = np.random.default_rng(0)
    X, Z = _f32(rng, 50, 2), _f32(rng, 37, 2)
    ls = np.array([1.5, 0.7], np.float32)
    want = jpg.stationary_gram(jnp.asarray(X), jnp.asarray(Z), jnp.asarray(ls), 2.5, tile=16,
                               interpret=True, family=family)
    got = tpg.stationary_gram(_t(X), _t(Z), _t(ls), 2.5, family)
    assert got.shape == (50, 37) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("M", [1, 3, 129])
def test_stationary_gram_at_ragged_widths_matches_jax(M):
    """Widths that are no multiple of the kernel's 4-column stores (the
    rows then start off 16-byte boundaries) and one past its 128-column
    tile; JAX's kernel in interpret mode, as above."""
    rng = np.random.default_rng(M)
    X, Z = _f32(rng, 37, 3), _f32(rng, M, 3)
    ls = np.array([1.5, 0.7, 1.1], np.float32)
    want = jpg.stationary_gram(jnp.asarray(X), jnp.asarray(Z), jnp.asarray(ls), 2.5, tile=16,
                               interpret=True, family="matern52")
    got = tpg.stationary_gram(_t(X), _t(Z), _t(ls), 2.5, "matern52")
    assert got.shape == (37, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_stationary_gram_into_writes_any_row_stride_on_the_cpu():
    rng = np.random.default_rng(4)
    X, Z = torch.as_tensor(_f32(rng, 20, 2)), torch.as_tensor(_f32(rng, 5, 2))
    store = torch.full((20, 8), float("nan"))
    out = tpg.stationary_gram_into(store[:, :5], X, Z, 1.3, 2.0, "rbf")
    assert torch.equal(out, tpg.stationary_gram_plain(X, Z, 1.3, 2.0, "rbf"))
    assert out.data_ptr() == store.data_ptr() and store[:, 5:].isnan().all()


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_predict_mean_matches_jax(family):
    rng = np.random.default_rng(1)
    X, Xq, alpha = _f32(rng, 90, 2), _f32(rng, 70, 2), _f32(rng, 90, 2)
    ls = np.array([1.0, 2.0], np.float32)
    want = jpg.fused_gp_predict_mean(jnp.asarray(Xq), jnp.asarray(X), jnp.asarray(alpha),
                                     jnp.asarray(ls), 3.0, tile_q=16, tile_k=32, interpret=True,
                                     family=family)
    got = tpg.fused_gp_predict_mean(_t(Xq), _t(X), _t(alpha), _t(ls), 3.0, family)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_predict_mean_var_matches_jax(family):
    """On a conditioned GP's α and K⁻¹, as the JAX test builds them."""
    rng = np.random.default_rng(2)
    X, Xq = _f32(rng, 60, 2), _f32(rng, 41, 2)
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1])], 1).astype(np.float32)
    ls = jnp.asarray([1.0, 1.5])
    base = JK.RBF(ls) if NU[family] is None else JK.Matern(ls, nu=NU[family])
    gp = jgp.condition(JK.Constant(2.0) * base + JK.White(0.05), jnp.asarray(X), jnp.asarray(Y),
                       cache_k_inv=True)
    alpha = np.asarray(gp.alpha, np.float32)
    K_inv = np.asarray(gp.K_inv, np.float32)
    wm, wv = jpg.fused_gp_predict_mean_var(jnp.asarray(Xq), jnp.asarray(X), jnp.asarray(alpha),
                                           jnp.asarray(K_inv), ls, 2.0, 2.05, tile_q=16,
                                           tile_k=32, interpret=True, family=family)
    gm, gv = tpg.fused_gp_predict_mean_var(_t(Xq), _t(X), _t(alpha), _t(K_inv),
                                           _t(np.asarray(ls, np.float32)), 2.0, 2.05, family)
    assert gv.shape == (41,)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=3e-4)
    np.testing.assert_allclose(np.sqrt(gv.numpy()), np.sqrt(np.asarray(wv)), atol=3e-4)


TILE_EDGES = chip_smoke.TILE_EDGES  # around the CUDA kernel's 128-wide tiles


@pytest.mark.parametrize("N", TILE_EDGES)
@pytest.mark.parametrize("Nq", TILE_EDGES)
def test_fused_predict_mean_var_matches_jax_at_the_tile_edges(Nq, N):
    """The twin at the shapes the on-card tests hold the kernel at (ragged on
    both axes, D=3, P=2) against the Pallas kernel in interpret mode.  Both
    are float32 sums in another order: the mean, N terms, to 3e-4 absolute as
    above; the variance, prior − N² terms that cancel, to the per-query
    bound ``chip_smoke.py`` holds a float32 evaluation to (2e-2·var + 5e-4;
    the std differs by up to 3.4e-4 at N=300)."""
    rng = np.random.default_rng(6)
    X, Xq = _f32(rng, N, 3), _f32(rng, Nq, 3)
    Y = np.sin(X[:, :2])
    ls = jnp.asarray([0.9, 1.15, 1.4])
    gp = jgp.condition(JK.Constant(2.0) * JK.RBF(ls) + JK.White(0.05), jnp.asarray(X),
                       jnp.asarray(Y), cache_k_inv=True)
    alpha, K_inv = np.asarray(gp.alpha, np.float32), np.asarray(gp.K_inv, np.float32)
    wm, wv = jpg.fused_gp_predict_mean_var(jnp.asarray(Xq), jnp.asarray(X), jnp.asarray(alpha),
                                           jnp.asarray(K_inv), ls, 2.0, 2.05, tile_q=64,
                                           tile_k=128, interpret=True)
    gm, gv = tpg.fused_gp_predict_mean_var(_t(Xq), _t(X), _t(alpha), _t(K_inv),
                                           _t(np.asarray(ls, np.float32)), 2.0, 2.05)
    assert gm.shape == (Nq, 2) and gv.shape == (Nq,)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=3e-4)
    wv = np.asarray(wv)
    assert (np.abs(gv.numpy() - wv) <= 2e-2 * wv + 5e-4).all()


def test_mean_var_twin_clamps_at_zero():
    X = torch.zeros(3, 2)
    _, var = tpg.fused_gp_predict_mean_var_plain(X, X, torch.ones(3, 1), torch.eye(3) * 10,
                                                 1.0, 1.0, 1.0)
    assert torch.equal(var, torch.zeros(3))


def test_cpu_wrappers_take_the_twins(monkeypatch):
    for fn in (tpg.stationary_gram, tpg.fused_gp_predict_mean, tpg.fused_gp_predict_mean_var):
        monkeypatch.setattr(fn, "launches", 0)
    rng = np.random.default_rng(3)
    X, Xq, alpha = (torch.as_tensor(rng.standard_normal(s)) for s in ((20, 3), (15, 3), (20, 2)))
    K_inv = torch.eye(20, dtype=torch.float64)
    assert torch.equal(tpg.stationary_gram(Xq, X, 1.2, 2.0, "matern32"),
                       tpg.stationary_gram_plain(Xq, X, 1.2, 2.0, "matern32"))
    assert torch.equal(tpg.fused_gp_predict_mean(Xq, X, alpha, 1.2, 2.0),
                       tpg.fused_gp_predict_mean_plain(Xq, X, alpha, 1.2, 2.0))
    m, v = tpg.fused_gp_predict_mean_var(Xq, X, alpha, K_inv, 1.2, 2.0, 2.1)
    assert m.dtype == torch.float64 and v.shape == (15,)
    assert (tpg.stationary_gram.launches, tpg.fused_gp_predict_mean.launches,
            tpg.fused_gp_predict_mean_var.launches) == (0, 0, 0)
