"""Port parity: ``benchmarks/{statistics,comparison,multi_frame,baselines}.py``
against the JAX package's, float64 on the CPU, on a synthetic file in the
reach-target layout (5 demos of 40 points, two frames each) written under
``tmp_path``: the ablation study, the cross-method comparison (GPT and the
DMP, TP-GMM, HMM, KMP and Laplacian-editing baselines) and the surfaces
comparison, at the same states (no hyperparameter refit, or the
deterministic EM fits both packages run), to 1e-8; the statistics exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_reach_file
from gaussian_process_transportation_tpu import benchmarks as JB
from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.benchmarks import baselines as jbase
from gaussian_process_transportation_tpu.benchmarks import statistics as jstats
from gaussian_process_transportation_tpu.transport import (
    GaussianProcessTransportation as JGPT,
    LaplacianEditingTransport as JLE,
)
from gaussian_process_transportation_tpu_torch import benchmarks as TB
from gaussian_process_transportation_tpu_torch import kernels as TK
from gaussian_process_transportation_tpu_torch.benchmarks import baselines as tbase
from gaussian_process_transportation_tpu_torch.benchmarks import comparison as tcmp
from gaussian_process_transportation_tpu_torch.benchmarks import statistics as tstats
from gaussian_process_transportation_tpu_torch.transport import (
    GaussianProcessTransportation as TGPT,
    LaplacianEditingTransport as TLE,
)

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)


@pytest.fixture(scope="module")
def reach(tmp_path_factory):
    return write_reach_file(str(tmp_path_factory.mktemp("reach") / "reach_target.npy"),
                            n_demos=5, T=40)


def test_ablation_study_matches_jax(reach):
    got = TB.ablation_study(number_repetitions=2, path=reach, device="cpu")
    want = JB.ablation_study(number_repetitions=2, path=reach)
    assert got.keys() == want.keys() and len(got["df"]) == 8 and len(got["fde_ood"]) == 10
    for key in got:
        np.testing.assert_allclose(got[key], want[key], **TOL)
    assert np.isfinite(got["dtw"]).all()


def test_compare_methods_matches_jax(reach):
    """The default methods (GPT without refits, DMP, TP-GMM, HMM-LQR) on the
    same pairs; TP-GMM's and HMM-LQR's EM fits are deterministic in both."""
    got = TB.compare_methods(number_repetitions=1, path=reach, device="cpu")
    want = JB.compare_methods(number_repetitions=1, path=reach)
    assert got.keys() == want.keys()
    for title in got:
        assert list(got[title]) == ["GPT", "DMP", "TPGMM", "HMM"]
        for name in got[title]:
            assert len(got[title][name]) == 4
            np.testing.assert_allclose(got[title][name], want[title][name], **TOL)


def _no_restarts(tr):
    tr.transportation.n_restarts = 0
    return tr


@pytest.mark.parametrize("cls", ["MultipleReferenceFramesKMP", "MultipleReferenceFramesLE"])
def test_transport_baselines_match_jax(reach, cls):
    tb, jb = getattr(tbase, cls)(device="cpu"), getattr(jbase, cls)()
    for policy in (tb, jb):
        policy.load_dataset(reach)
        if cls == "MultipleReferenceFramesKMP":  # no restarts, so no random draw differs
            policy._make_transport = lambda make=policy._make_transport: _no_restarts(make())
    np.testing.assert_allclose(tb.reproduce(0, 3), jb.reproduce(0, 3), **TOL)
    X1, std = tb.reproduce(2, 1, compute_metrics=False)
    np.testing.assert_allclose(X1, np.asarray(jb.reproduce(2, 1, compute_metrics=False)[0]),
                               **TOL)
    assert X1.shape == (40, 2) and std.shape == (40, 2)


def test_run_comparison_matches_jax():
    """Two methods without refits on a synthetic drawing: trajectories, stds
    and the three matrices."""
    t = np.linspace(0, 1, 80)
    demo = np.stack([10 * t, 3 + 2 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, 30)
    source = np.stack([10 * s, np.zeros_like(s)], 1)
    target = np.stack([10 * s, 1 + np.sin(2 * s)], 1)
    jk = JK.Constant(1.0) * JK.RBF(4.0 * jnp.ones(2)) + JK.White(1e-4)
    tk = TK.Constant(1.0) * TK.RBF(4.0 * torch.ones(2, dtype=torch.float64)) + TK.White(1e-4)
    want = JB.run_comparison(demo, source, target, n_traj=50, n_dist=15,
                             methods={"GPT": JGPT(kernel_transport=jk, optimizer=None),
                                      "LE": JLE()})
    got = TB.run_comparison(demo, source, target, n_traj=50, n_dist=15, device="cpu",
                            methods={"GPT": TGPT(kernel_transport=tk, optimizer=None,
                                                 device="cpu"),
                                     "LE": TLE(device="cpu")})
    assert got["names"] == want["names"] == ["GPT", "LE"]
    for key in ("trajectories", "stds"):
        for name in got["names"]:
            np.testing.assert_allclose(got[key][name], want[key][name], **TOL)
    for key in ("divergence", "distribution_distance", "euclidean_distance"):
        np.testing.assert_allclose(got[key], want[key], **TOL)
        np.testing.assert_allclose(np.diag(got[key]), 0.0, atol=1e-12)


def test_default_methods_are_jax_six(tmp_path):
    names = list(tcmp.default_methods(device="cpu"))
    from gaussian_process_transportation_tpu.benchmarks import comparison as jcmp

    assert names == list(jcmp.default_methods())
    M = np.arange(6.0).reshape(2, 3) / 7
    for mod, name in ((tcmp, "t.tex"), (jcmp, "j.tex")):
        mod.save_array_as_latex(M, str(tmp_path / name), names=["a", "b"])
    assert (tmp_path / "t.tex").read_text() == (tmp_path / "j.tex").read_text()


def test_statistics_match_jax():
    rng = np.random.RandomState(0)
    metrics = {
        "Frechet Distance": {"GPT": np.abs(rng.randn(40)) * 0.1,
                             "DMP": np.abs(rng.randn(40)) * 5 + 1,
                             "HMM": np.abs(rng.randn(40)) * 2 + 0.5},
        "Final Position Error": {"GPT": np.abs(rng.randn(40)) * 0.2,
                                 "DMP": np.abs(rng.randn(40)) * 3 + 1,
                                 "HMM": np.concatenate([np.abs(rng.randn(39)), [np.nan]])},
    }
    assert tstats.ranking_report(metrics) == jstats.ranking_report(metrics)
    for samples in metrics.values():
        assert tstats.mann_whitney_ranking(samples) == jstats.mann_whitney_ranking(samples)
        assert tstats.best_method(samples) == jstats.best_method(samples)
    assert tstats.ranking_report(metrics).splitlines()[0].startswith("Frechet Distance: GPT(1)")
