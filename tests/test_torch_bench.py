"""The port's bench stages and graft entry (``bench.py``, ``entry.py``) against
the root ``bench.py`` and ``__graft_entry__.py`` (imported read-only) and the
JAX package, on the CPU at small sizes: the workload bit for bit, the
transport stage in float64 against JAX's jitted batched transport, the
numpy/scipy reference against sklearn's pipeline, the Cholesky stage's
operation count, the samplers' stages at four chains or particles, the
graft entry's forward pass, and ``main``'s one JSON line."""
import inspect
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench as jbench
from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.transport import gpt as jgpt
from gaussian_process_transportation_tpu_torch import bench as tbench
from gaussian_process_transportation_tpu_torch import entry as tentry

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them.
torch.set_num_threads(1)

E_SMALL = 8
FIELDS = ("traj", "std", "delta", "delta_var", "min_abs_det")


def test_make_workload_is_bench_pys_bit_for_bit(monkeypatch):
    """With no example.npz (none under ``GPT_REFERENCE_ROOT``, none at
    bench.py's fixed path here), both take the synthetic branch."""
    monkeypatch.delenv("GPT_REFERENCE_ROOT", raising=False)
    for kw in ({}, dict(dtype=np.float64, n_traj=57, n_dist=11)):
        for got, want in zip(tbench.make_workload(**kw), jbench.make_workload(**kw)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_make_workload_reads_example_npz_under_root(tmp_path):
    """The reference branch: example.npz under ``root``, resampled as
    bench.py's ``_np_resample`` does."""
    rng = np.random.default_rng(0)
    data = {k: np.cumsum(rng.standard_normal((m, 2)), 0)
            for k, m in (("demo", 90), ("floor", 30), ("newfloor", 30))}
    path = tmp_path / "example" / "2D" / "data"
    path.mkdir(parents=True)
    np.savez(path / "example.npz", **data)
    X, dX, S, S1 = tbench.make_workload(root=str(tmp_path))
    for got, key, m in ((X, "demo", 400), (S, "floor", 20), (S1, "newfloor", 20)):
        assert np.array_equal(got, np.asarray(jbench._np_resample(data[key], m), np.float32))
    assert np.array_equal(dX[:-1], np.diff(X, axis=0)) and not dX[-1].any()


@pytest.fixture(scope="module")
def jax_batched():
    """JAX's fit_and_transport_batched under jax.jit in float64 at E = 8,
    on bench_ours's inputs."""
    X, dX, S, S1 = (a.astype(np.float64) for a in jbench.make_workload())
    kernel = JK.Constant(10.0) * JK.RBF(4.0 * jnp.ones(2, jnp.float64)) + JK.White(0.01)
    targets = jnp.asarray(S1)[None] + jnp.linspace(0.0, 1.0, E_SMALL)[:, None, None]
    f = jax.jit(lambda t: jgpt.fit_and_transport_batched(kernel, jnp.asarray(S), t,
                                                         jnp.asarray(X), jnp.asarray(dX)))
    return f(targets)


def test_bench_ours_transport_is_jaxs_in_float64(jax_batched):
    """Every field within 1e-10 of JAX's (of the field's largest entry, or
    absolutely below 1); the stage's rate on the CPU is finite and its
    details carry the reps."""
    X, dX, S, S1 = tbench.make_workload()
    res = tbench.transport_fn(X, dX, S, S1, E_SMALL, device="cpu", dtype=torch.float64)()
    for name in FIELDS:
        got, want = getattr(res, name).numpy(), np.asarray(getattr(jax_batched, name))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max()), name
    rate, details = tbench.bench_ours(X, dX, S, S1, ensemble=E_SMALL, iters=1, reps=2,
                                      device="cpu", dtype=torch.float64)
    assert math.isfinite(rate) and rate > 0 and len(details["rep_ms"]) == 2


def _sklearn_one(X, dX, S, S1, shift):
    """bench.py:126-164's ``one(shift)`` as it writes it, sklearn and all,
    plus the GP's predicted std it computes."""
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import RBF, WhiteKernel, ConstantKernel as C

    X, dX, S, S1 = (a.astype(np.float64) for a in (X, dX, S, S1))
    tgt = S1 + shift
    cs, ct = S.mean(0), tgt.mean(0)
    H = (S - cs).T @ (tgt - ct)
    U, _, Vt = np.linalg.svd(H)
    V = Vt.T
    R = V @ U.T
    if np.linalg.det(R) < 0:
        V[:, -1] *= -1
        R = V @ U.T
    gamma = lambda x: (R @ (x - cs).T).T + ct
    Sg = gamma(S)
    delta = tgt - Sg
    sk = C(10.0) * RBF([4.0, 4.0]) + WhiteKernel(0.01)
    g = GaussianProcessRegressor(kernel=sk, alpha=1e-10, optimizer=None)
    g.fit(Sg, delta)
    Xg = gamma(X)
    mean, std = g.predict(Xg, return_std=True)
    K_ = sk(Sg) + 1e-10 * np.eye(len(Sg))
    K_inv = np.linalg.inv(K_)
    alfa = K_inv @ delta
    k_star = sk(Xg, Sg)
    ls = np.array([4.0, 4.0]).reshape(-1, 1)
    diff = Sg.T[:, None, :] - Xg.T[:, :, None]
    dk = (diff / (ls[:, :, None] ** 2)) * k_star
    J_psi = (dk.transpose(1, 0, 2) @ alfa).transpose(0, 2, 1)
    dk_Kinv = dk @ K_inv
    var = 10.0 / ls**2 - np.sum(dk_Kinv * dk, axis=2)
    J_psi_var = np.repeat(var[None], 2, axis=0).transpose(2, 0, 1)
    J_gamma = np.repeat(R[None], len(X), axis=0)
    J_phi = J_gamma + J_psi @ J_gamma
    v = dX[:, :, None]
    vel = (J_phi @ v)[:, :, 0]
    vvar = (J_psi_var @ (J_gamma @ v) ** 2)[:, :, 0]
    return Xg + mean, vel, vvar, std


@pytest.mark.parametrize("shift", [0.0, 0.03])
def test_reference_transport_is_sklearns_pipeline(shift):
    """The numpy/scipy reference (the card's machine has no sklearn) against
    sklearn's GaussianProcessRegressor pipeline: traj, vel, vvar and the
    std to 1e-10 of each one's largest entry."""
    pytest.importorskip("sklearn")
    X, dX, S, S1 = tbench.make_workload()
    got = tbench.reference_transport(X, dX, S, S1, shift)
    want = _sklearn_one(X, dX, S, S1, shift)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-10 * np.abs(w).max()
    assert tbench.bench_reference_cpu(X, dX, S, S1, iters=2) > 0


@pytest.mark.parametrize("n", [10240, 4096])
def test_cholesky_flops_are_bench_pys(n):
    """The operation count read from bench.py's own ``flops = …`` line."""
    line = re.search(r"^\s*flops = (.+)$", inspect.getsource(jbench.bench_cholesky), re.M)
    assert tbench.cholesky_flops(n) == eval(line.group(1), {"n": n})


def test_cholesky_stage_and_roofline_run_on_the_cpu():
    """At N = 300 (three panels of 128), the rooflines at 64²: a finite
    rate, both precisions' product rates and shares in the details."""
    tflops, details = tbench.bench_cholesky(n=300, block=128, iters=1, reps=1, device="cpu",
                                            roofline_m=64)
    assert math.isfinite(tflops) and tflops > 0 and details["precision"] == "high"
    assert all(details[k] > 0 for k in ("roofline_highest_tflops", "roofline_high_tflops",
                                        "share_of_highest", "share_of_high"))
    assert tbench._matmul_roofline("high", m=64, iters=1, device="cpu") > 0


def test_samplers_stages_at_four_chains_and_particles():
    """bench_smc at 4 particles and 2 steps, bench_hmc at 4 chains and 2 + 2
    steps: finite rates, samples of the right shapes."""
    rate, d = tbench.bench_smc(n_particles=4, n_steps=2, iters=1, reps=1, device="cpu")
    assert math.isfinite(rate) and rate > 0 and d["particles_shape"] == [4, 100, 2]
    rate, d = tbench.bench_hmc(num_chains=4, num_warmup=2, num_samples=2, reps=1, device="cpu")
    assert math.isfinite(rate) and rate > 0 and d["samples_shape"] == [4, 2, 4]


def test_entry_is_graft_entrys_forward_pass():
    """entry(device="cpu")'s fn(*args) against __graft_entry__.entry()'s
    (JAX on the CPU): traj, the velocity (delta) and std within 1e-4 of
    max|X| in float32; dryrun_multichip is the parallel slice's."""
    from gaussian_process_transportation_tpu_torch.parallel import dryrun

    fn, args = tentry.entry(device="cpu")
    jfn, jargs = graft.entry()
    got, want = fn(*args), jfn(*jargs)
    scale = float(np.abs(np.asarray(jargs[3])).max())
    assert args[3].dtype == torch.float32 and args[3].shape == (64, 2) and args[1].shape == (16, 2)
    for name in ("traj", "delta", "std"):
        g, w = getattr(got, name).double().numpy(), np.asarray(getattr(want, name), np.float64)
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-4 * scale, name
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip


def _fake_stages(monkeypatch, fail=None):
    for name, value in (("bench_reference_cpu", 10.0), ("bench_ours", 40.0),
                        ("bench_cholesky", 2.5), ("bench_smc", 7.0), ("bench_hmc", 3.0)):
        def stage(*a, _value=value, _name=name, **k):
            if _name == fail:
                raise RuntimeError(f"{_name} planted failure")
            return _value if _name == "bench_reference_cpu" else (_value, {"rep_ms": [1.0]})
        monkeypatch.setattr(tbench, name, stage)


def test_main_prints_one_json_line_or_fails_without_one(monkeypatch, capsys):
    """main's contract, the stages stubbed: one JSON line with bench.py's
    five metrics and each stage's rep_ms; a stage that raises is named on
    standard error, and main raises with nothing on standard output."""
    _fake_stages(monkeypatch)
    tbench.main(["--device", "cpu"])
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "transported_trajectories_per_s_per_chip" and line["value"] == 40.0
    assert line["vs_baseline"] == 4.0 and line["tflops_chol_n10240"] == 2.5
    assert line["hmc_samples_per_s"] == 3.0 and line["smc_particles_per_s"] == 7.0
    assert all(s["rep_ms"] == [1.0] for s in line["stages"].values())
    _fake_stages(monkeypatch, fail="bench_smc")
    with pytest.raises(RuntimeError, match="planted"):
        tbench.main(["--device", "cpu"])
    out = capsys.readouterr()
    assert out.out == "" and "stage smc failed" in out.err
