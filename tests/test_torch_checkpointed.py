"""Port parity: checkpointed sampler runs (``parallel/checkpointed.py``)
and the artifact store (``utils/artifacts.py``): a run killed after any
segment and resumed gives the samples of an uninterrupted run, bit for
bit, as the JAX package's tests/test_checkpointed.py asks of its own; both
runs agree with the JAX package's in distribution on a known Gaussian, and
the artifact files hold JAX's leaves in JAX's order."""
import json

import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu_torch.parallel import checkpointed as ck
from gaussian_process_transportation_tpu_torch.parallel import samplers as ts
from gaussian_process_transportation_tpu_torch.utils import artifacts

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

MU = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
KW = dict(num_warmup=10, num_samples=12, segment=5, num_leapfrog=4)


def _batched(q):
    z = q - MU[:, None]
    return -0.5 * (z * z).sum(0), -z


def _logprob(q):
    return -0.5 * ((q - MU) ** 2).sum()


class Killed(Exception):
    pass


def _kill_after(monkeypatch, segments):
    """Make the run die right after its ``segments``-th sample segment is
    saved (the warm-up's save is number 0)."""
    real = ck.save_pytree
    saves = []

    def save(path, tree, metadata=None):
        real(path, tree, metadata)
        saves.append(metadata["done"])
        if len(saves) == segments + 1:
            raise Killed

    monkeypatch.setattr(ck, "save_pytree", save)
    return saves


@pytest.mark.parametrize("segments", [1, 2])
def test_batched_resume_after_kill_is_bitwise(tmp_path, monkeypatch, segments):
    q0 = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 6)))
    whole, info = ts.hmc_batched(_batched, q0, seed=3, num_warmup=10, num_samples=12,
                                 num_leapfrog=4)
    path = str(tmp_path / "run")
    saves = _kill_after(monkeypatch, segments)
    with pytest.raises(Killed):
        ck.run_hmc_batched_checkpointed(_batched, q0, 3, path, **KW)
    assert saves == [0, 5, 10][:segments + 1]
    monkeypatch.undo()
    resumed, info_r = ck.run_hmc_batched_checkpointed(_batched, q0, 3, path, **KW)
    assert torch.equal(resumed, whole)
    assert torch.equal(info_r["step_size"], info["step_size"])
    assert torch.equal(info_r["inv_mass"], info["inv_mass"])
    torch.testing.assert_close(info_r["mean_accept"], info["mean_accept"], rtol=1e-12, atol=0)
    again, _ = ck.run_hmc_batched_checkpointed(_batched, q0, 3, path, **KW)  # already done
    assert torch.equal(again, whole)


def test_vmapped_resume_after_kill_is_bitwise(tmp_path, monkeypatch):
    """C chains over an autograd log-density: killed after one segment and
    resumed equals the uninterrupted run and the batched sampler's chains."""
    q0 = torch.as_tensor(np.random.default_rng(1).standard_normal((4, 3)))
    path_a, path_b = str(tmp_path / "a"), str(tmp_path / "b")
    whole, _ = ck.run_hmc_checkpointed(_logprob, q0, 7, path_a, **KW)
    _kill_after(monkeypatch, 1)
    with pytest.raises(Killed):
        ck.run_hmc_checkpointed(_logprob, q0, 7, path_b, **KW)
    monkeypatch.undo()
    resumed, info = ck.run_hmc_checkpointed(_logprob, q0, 7, path_b, **KW)
    assert torch.equal(resumed, whole) and resumed.shape == (4, 12, 3)
    assert info["step_size"].shape == (4,) and info["inv_mass"].shape == (4, 3)
    batched, _ = ts.hmc_batched(_batched, q0.T.contiguous(), seed=7, num_warmup=10,
                                num_samples=12, num_leapfrog=4)
    torch.testing.assert_close(resumed, batched, rtol=1e-12, atol=1e-12)


def test_artifact_store_round_trips_trees(tmp_path):
    """Nested dicts, tuples and named tuples of tensors, arrays and numbers
    come back with the exemplar's structure, dtypes and values; versions
    count up."""
    tree = {"state": ts.HMCState(torch.arange(3.0), torch.tensor(-1.5), torch.ones(3)),
            "steps": (torch.tensor([0.1, 0.2], dtype=torch.float64), np.arange(4)),
            "done": 7}
    store = artifacts.ArtifactStore(str(tmp_path / "store"))
    assert store.save("chains", tree, {"note": "a"}) == 1
    tree2 = dict(tree, done=8)
    assert store.save("chains", tree2) == 2 and store.latest_version("chains") == 2
    like = {"state": ts.HMCState(torch.zeros(3), torch.zeros(()), torch.zeros(3)),
            "steps": (torch.zeros(2, dtype=torch.float64), np.zeros(4, np.int64)), "done": 0}
    got = store.load("chains", like, version=1)
    assert isinstance(got["state"], ts.HMCState) and got["done"] == 7
    assert torch.equal(got["state"].position, tree["state"].position)
    assert got["steps"][0].dtype == torch.float64 and np.array_equal(got["steps"][1], np.arange(4))
    assert store.load("chains", like)["done"] == 8
    assert artifacts.load_metadata(str(tmp_path / "store" / "chains.v1")) == {"note": "a"}
    with pytest.raises(FileNotFoundError):
        store.load("other", like)
    with pytest.raises(ValueError, match="leaves"):
        artifacts.load_pytree(str(tmp_path / "store" / "chains.v1"), {"done": 0})


# ---- against the JAX package's checkpointed runs --------------------------
# Different random streams (JAX's threefry keys, the port's counter hash),
# so the runs agree in distribution: on a known Gaussian, each package's
# posterior mean of every coordinate within 0.8·sd + 0.3 of the other's and
# of the truth (tests/test_fused_lml.py:248's rule, sd the coordinate's
# true standard deviation), and the sample sd within a factor 1.5 of the
# truth.  8 chains × 100 samples after 100 warm-up steps; the port's in two
# segments, JAX's in one (each of its segments compiles anew, and none
# changes a draw).

GAUSS_SD = np.array([1.0, 0.5, 2.0])
CK_KW = dict(num_warmup=100, num_samples=100, segment=50, num_leapfrog=8)


def _gauss_inits(C):
    return np.random.default_rng(5).standard_normal((C, 3)) * 0.5


def _agree(port, ref):
    """port, ref: samples (C, S, 3); the rule above."""
    mu, sd = MU.numpy(), GAUSS_SD
    m_p, m_r = port.reshape(-1, 3).mean(0), ref.reshape(-1, 3).mean(0)
    assert (np.abs(m_p - m_r) < 0.8 * sd + 0.3).all(), (m_p, m_r)
    for m, s in ((m_p, port), (m_r, ref)):
        assert (np.abs(m - mu) < 0.8 * sd + 0.3).all(), m
        ratio = s.reshape(-1, 3).std(0) / sd
        assert ((ratio > 1 / 1.5) & (ratio < 1.5)).all(), ratio


@pytest.fixture(scope="module")
def jax_checkpointed_runs(tmp_path_factory):
    """JAX's run_hmc_checkpointed (chains (C, D)) and
    run_hmc_batched_checkpointed (ensemble-last (T, E)) on the Gaussian,
    once for the module."""
    import jax
    import jax.numpy as jnp

    from gaussian_process_transportation_tpu.parallel import checkpointed as jck

    mu, sd = jnp.asarray(MU.numpy()), jnp.asarray(GAUSS_SD)
    root = tmp_path_factory.mktemp("jax_ckpt")

    def logprob(q):
        return -0.5 * jnp.sum(((q - mu) / sd) ** 2)

    def batched(q):  # (T, E)
        z = (q - mu[:, None]) / sd[:, None]
        return -0.5 * jnp.sum(z * z, 0), -z / sd[:, None]

    q0 = jnp.asarray(_gauss_inits(8))
    kw = dict(CK_KW, segment=CK_KW["num_samples"])
    vm, _ = jck.run_hmc_checkpointed(logprob, q0, jax.random.PRNGKey(3), str(root / "vm"), **kw)
    bt, info = jck.run_hmc_batched_checkpointed(batched, q0.T, jax.random.PRNGKey(3),
                                                str(root / "bt"), **kw)
    return np.asarray(vm), np.asarray(bt), np.asarray(info["mean_accept"])


def test_run_hmc_checkpointed_agrees_with_jax(tmp_path, jax_checkpointed_runs):
    sd = torch.as_tensor(GAUSS_SD)

    def logprob(q):
        return -0.5 * (((q - MU) / sd) ** 2).sum()

    got, info = ck.run_hmc_checkpointed(logprob, torch.as_tensor(_gauss_inits(8)), 3,
                                        str(tmp_path / "run"), **CK_KW)
    assert got.shape == (8, 100, 3) and info["inv_mass"].shape == (8, 3)
    _agree(got.numpy(), jax_checkpointed_runs[0])


def test_run_hmc_batched_checkpointed_agrees_with_jax(tmp_path, jax_checkpointed_runs):
    """Also the mean accept probability within 0.15 of JAX's (both adapt
    to the target 0.8)."""
    sd = torch.as_tensor(GAUSS_SD)[:, None]

    def batched(q):
        z = (q - MU[:, None]) / sd
        return -0.5 * (z * z).sum(0), -z / sd

    got, info = ck.run_hmc_batched_checkpointed(batched, torch.as_tensor(_gauss_inits(8)).T, 3,
                                                str(tmp_path / "run"), **CK_KW)
    assert got.shape == (8, 100, 3)
    _agree(got.numpy(), jax_checkpointed_runs[1])
    assert abs(info["mean_accept"].mean().item() - jax_checkpointed_runs[2].mean()) < 0.15


def test_artifact_files_hold_jax_leaf_order_and_sidecar(tmp_path):
    """The same tree saved by JAX's save_pytree and by the port's: the same
    leaves under the same ``leaf_i`` names (dict keys sorted, sequences in
    order), values equal; the same sidecar leaf count, metadata and version;
    ArtifactStore numbers versions alike."""
    from gaussian_process_transportation_tpu.utils import artifacts as jart

    rng = np.random.default_rng(2)
    tree = {"b": (rng.standard_normal(3), rng.standard_normal((2, 2))),
            "a": {"z": np.arange(4.0), "y": [rng.standard_normal(1), np.float64(2.5)]}}
    meta = {"done": 5, "note": "x"}
    jart.save_pytree(str(tmp_path / "j"), tree, meta)
    artifacts.save_pytree(str(tmp_path / "t"), tree, meta)
    jleaves = np.load(str(tmp_path / "j.npz"))
    tleaves = torch.load(str(tmp_path / "t.pt"), weights_only=True)
    assert sorted(jleaves.files) == sorted(tleaves)
    for name in jleaves.files:
        np.testing.assert_array_equal(tleaves[name].numpy(), jleaves[name])
    with open(tmp_path / "j.json") as f:
        jside = json.load(f)
    with open(tmp_path / "t.json") as f:
        tside = json.load(f)
    for key in ("n_leaves", "metadata", "version"):
        assert tside[key] == jside[key]
    assert artifacts.load_metadata(str(tmp_path / "t")) == jart.load_metadata(str(tmp_path / "j"))
    js, ts_ = jart.ArtifactStore(str(tmp_path / "js")), artifacts.ArtifactStore(str(tmp_path / "ts"))
    assert [js.save("x", tree) for _ in range(3)] == [ts_.save("x", tree) for _ in range(3)]
    assert js.latest_version("x") == ts_.latest_version("x") == 3
