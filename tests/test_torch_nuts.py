"""Port parity: batched NUTS (``parallel/samplers.py::nuts_batched``) and
the NUTS route of ``sample_gp_posterior`` against the JAX package's, the
sampler on a known Gaussian, and the per-chain draws that make a run of
chains [0, k) the first k chains of a longer run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.parallel import samplers as js
from gaussian_process_transportation_tpu_torch.convert import kernel_from_tree
from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl
from gaussian_process_transportation_tpu_torch.parallel import samplers as ts

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

MU = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
SIGMA = torch.tensor([0.5, 2.0, 1.0], dtype=torch.float64)


def _gaussian(q):
    z = (q - MU[:, None]) / SIGMA[:, None]
    return -0.5 * (z * z).sum(0), -z / SIGMA[:, None]


def test_nuts_batched_recovers_a_gaussian():
    """32 chains, 100 + 150 steps: the means to 0.15 and the sds to 0.3 of a
    known diagonal Gaussian (tests/test_samplers.py's tolerances), split-R̂
    below 1.1, the accept statistic above 0.6 and the trees of depth 1 to 8."""
    samples, info = ts.nuts_batched(_gaussian, torch.zeros(3, 32, dtype=torch.float64), seed=0,
                                    num_warmup=100, num_samples=150)
    assert samples.shape == (32, 150, 3) and info["inv_mass"].shape == (32, 3)
    flat = samples.reshape(-1, 3)
    torch.testing.assert_close(flat.mean(0), MU, rtol=0, atol=0.15)
    torch.testing.assert_close(flat.std(0), SIGMA, rtol=0, atol=0.3)
    assert (ts.split_rhat(samples) < 1.1).all()
    assert info["mean_accept"].mean() > 0.6
    depth = info["mean_tree_depth"]
    assert ((depth >= 1) & (depth <= 8)).all()


@pytest.mark.parametrize("k", [1, 3])
def test_nuts_batched_chains_do_not_depend_on_the_number_of_chains(k):
    """Chain e's momenta, directions and selections hash (seed, e, phase,
    step, slot) alone: a run of chains [0, k) is the first k chains of an
    8-chain run, bit for bit, though the longer run's trees may need more
    rounds (those lanes are masked)."""
    q0 = torch.as_tensor(np.random.default_rng(2).standard_normal((3, 8)))
    kw = dict(seed=4, num_warmup=8, num_samples=6, max_depth=5)
    s8, i8 = ts.nuts_batched(_gaussian, q0, **kw)
    sk, ik = ts.nuts_batched(_gaussian, q0[:, :k].contiguous(), **kw)
    assert torch.equal(sk, s8[:k])
    assert torch.equal(ik["step_size"], i8["step_size"][:k])


def test_nuts_draw_slots_do_not_overlap():
    """The momentum, direction, merge and selection slots of one NUTS step
    are disjoint and fill [0, total): every draw is its own hash."""
    at = ts._nuts_slots(rows=4, max_depth=8)
    spans = [(0, 8), (at["dir"], at["dir"] + 8), (at["merge"], at["merge"] + 8),
             (at["select"], at["select"] + 2**8 - 1)]
    covered = sorted(i for a, b in spans for i in range(a, b))
    assert covered == list(range(at["total"]))


def _gp_case(n=10, seed=0):
    """bench.py's hmc workload shape (bench.py:340-345) at a small n."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 2)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    return X, Y, JK.Constant(1.0) * JK.RBF(jnp.ones(2, jnp.float32)) + JK.White(0.01)


def test_sample_gp_posterior_nuts_agrees_with_jax(monkeypatch):
    """The fused NUTS route: posterior means per θ within 0.8·sd + 0.3 of
    JAX's (the rule of tests/test_fused_lml.py:248); every leapfrog step one
    call of the fused LML's twin on the CPU and no launch of the kernel.
    max_depth 2 on both sides (trees of up to three leapfrog steps, every
    part of the tree policy): JAX's compile grows with the depth and takes
    tens of seconds on a CPU already at 2."""
    X, Y, jk = _gp_case()
    calls = []
    real = tfl.small_lml_value_grad_ref
    monkeypatch.setattr(tfl, "small_lml_value_grad_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    common = dict(num_chains=16, num_warmup=30, num_samples=30, algorithm="nuts", max_depth=2)
    tk = kernel_from_tree(jk, torch.float32, "cpu")
    s_t, d_t = ts.sample_gp_posterior(tk, torch.as_tensor(X), torch.as_tensor(Y), seed=0,
                                      **common)
    assert len(calls) > 1 + 60 and tfl.small_lml_value_grad.launches == 0
    assert s_t.shape == (16, 30, 4) and torch.isfinite(s_t).all()
    assert d_t["mean_tree_depth"].shape == (16,) and d_t["rhat"].shape == (4,)
    s_j, _ = js.sample_gp_posterior(jk, jnp.asarray(X), jnp.asarray(Y), jax.random.PRNGKey(0),
                                    **common)
    m_t = s_t.reshape(-1, 4).double().numpy().mean(0)
    flat_j = np.asarray(s_j).reshape(-1, 4)
    assert np.all(np.abs(m_t - flat_j.mean(0)) < 0.8 * flat_j.std(0) + 0.3), (m_t, flat_j.mean(0))


def test_sample_gp_posterior_nuts_chains_do_not_depend_on_the_number_of_chains():
    X, Y, jk = _gp_case()
    tk = kernel_from_tree(jk, torch.float32, "cpu")
    kw = dict(seed=3, num_warmup=6, num_samples=5, algorithm="nuts", max_depth=4)
    s8, _ = ts.sample_gp_posterior(tk, torch.as_tensor(X), torch.as_tensor(Y), num_chains=8,
                                   **kw)
    s3, _ = ts.sample_gp_posterior(tk, torch.as_tensor(X), torch.as_tensor(Y), num_chains=3,
                                   **kw)
    assert torch.equal(s3, s8[:3])
