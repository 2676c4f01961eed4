"""The fused-predict check of ``chip_smoke.py`` on the CPU: a sound float32
evaluation (the plain twin, which the wrappers take for CPU tensors) reads
below its per-query bound for every family, and the planted faults of the
variance read above it."""
import contextlib
import math

import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_process_transportation_tpu_torch import kernels as K
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)


def _grid_gp():
    """A small dense-grid case: N=300 standard-normal 2-D points, Y = sin X,
    a 30x30 grid on [-3, 3]², C(2)·RBF(1)+White(0.1) with K⁻¹ cached."""
    rng = np.random.default_rng(11)
    X = torch.as_tensor(rng.standard_normal((300, 2)), dtype=torch.float32)
    g = torch.linspace(-3, 3, 30)
    Xq = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    kern = K.Constant(2.0) * K.RBF(torch.ones(2)) + K.White(0.1)
    return tgp.condition(kern, X, torch.sin(X), cache_k_inv=True), Xq


@pytest.mark.parametrize("family", chip_smoke.FAMILIES)
def test_predict_check_passes_a_sound_f32_evaluation(family):
    gp, Xq = _grid_gp()
    em, ev, ex_m, ex_v = chip_smoke.check_predicts(
        "cpu", Xq, gp.X, gp.alpha, gp.K_inv, torch.ones(2), 2.0, 2.1, family)
    assert em == 0.0 and ev == 0.0  # on the CPU the wrappers are the twins
    assert ex_m < 0.5 and ex_v < 0.5


@pytest.mark.parametrize("Nq,N", [(1, 1), (127, 129), (129, 300), (300, 128)])
def test_predict_check_passes_the_twin_at_the_tile_edges(Nq, N):
    """Phase 7's ragged shapes around the kernel's 128-wide tiles: the f32
    twin reads below half the bound there too."""
    args = chip_smoke.posterior_case("cpu", Nq, N, "rbf")
    em, ev, ex_m, ex_v = chip_smoke.check_predicts("cpu", *args, "rbf")
    assert em == 0.0 and ev == 0.0
    assert ex_m < 0.5 and ex_v < 0.5


def test_predict_check_rejects_planted_faults():
    gp, Xq = _grid_gp()
    faults = chip_smoke.planted_faults(Xq, gp.X, gp.alpha, gp.K_inv, torch.ones(2), 2.0, 2.1)
    assert set(faults) == {"var x2", "column tile 1 dropped"}
    assert min(faults.values()) > 10


# ---- kernel #7's check of phase 7 ------------------------------------------


@pytest.mark.parametrize("N,M,D", chip_smoke.GRAM_CASES[:-1])
def test_gram_check_passes_a_sound_f32_evaluation(N, M, D):
    """The generic entry's twin, every family, per entry below half of
    ``GRAM_TOL``·amp against the f64 formula."""
    for family in chip_smoke.FAMILIES:
        diff, ex = chip_smoke.check_gram("cpu", N, M, D, family)
        assert diff == 0.0 and ex < 0.5, family  # on the CPU the wrapper is the twin


@pytest.mark.parametrize("family,n,B,D", [c for c in chip_smoke.GRAM_PANEL_CASES
                                          if c[1] < chip_smoke.N_SOLVE])
def test_gram_panel_check_passes_a_sound_f32_evaluation(family, n, B, D):
    """Phase 7's panel cases (but the 10240-point one) on the f32 twin: below
    half of ``GRAM_TOL``·(amp + noise) per entry, with the NaN-filled buffer
    written throughout."""
    diff, ex = chip_smoke.check_gram_panels("cpu", n, B, D, family)
    assert diff == 0.0 and ex < 0.5


def test_gram_panel_check_rejects_planted_faults():
    faults = chip_smoke.gram_panel_faults("cpu")
    assert set(faults) == {"noise dropped on diagonal block 1",
                           "tile (panel 1, rows 64-127) skipped", "padding row coupled"}
    assert min(faults.values()) > 10 and faults["tile (panel 1, rows 64-127) skipped"] == math.inf


# ---- the fused-LML check of phases 12-14 -----------------------------------


@pytest.mark.parametrize("family", chip_smoke.FAMILIES)
def test_lml_check_passes_a_sound_f32_evaluation(family):
    """The f32 twin (what the wrappers take on the CPU) against the per-lane
    f64 formula, over the phase-12 shapes of the family (those past eight
    coordinates or columns included), below half the bound."""
    for case in chip_smoke.LML_CASES + chip_smoke.LML_WIDE_CASES:
        if case[0] == family:
            for name, (diff, excess) in chip_smoke.check_lml_case("cpu", case, 37).items():
                assert diff == 0.0 and excess < 0.5, (name, case, excess)


def test_lml_check_rejects_planted_faults():
    faults = chip_smoke.lml_faults("cpu", 512)
    assert set(faults) == {"amplitude gradient negated", "lanes 0 and 1 datasets swapped"}
    assert min(faults.values()) > 10


def test_lml_check_rejects_a_planted_fault_of_the_value_only_instance():
    """Phase 12's checks of the value-only instance, on its twin: a
    dataset swap reads far above the bound, a one-ulp change is caught."""
    assert chip_smoke.lml_value_faults("cpu", 512) > 10


def test_lml_check_holds_at_the_hmc_chains_final_positions():
    """Phase 14 holds kernel #2 at the chains' final positions to the same
    bound; on the CPU the f32 twin of a short run reads below half of it."""
    from gaussian_process_transportation_tpu_torch.models.exact_gp import small_lml_theta_layout
    from gaussian_process_transportation_tpu_torch.ops import fused_lml as tfl
    from gaussian_process_transportation_tpu_torch.parallel import samplers

    X, Y = (torch.as_tensor(a) for a in chip_smoke.hmc_inputs())
    kern = K.Constant(1.0) * K.RBF(torch.ones(2)) + K.White(0.01)
    s, _ = samplers.sample_gp_posterior(kern, X, Y, seed=0, num_chains=32, num_warmup=24,
                                        num_samples=8, num_leapfrog=8)
    fam, n_ls, noise, perm = small_lml_theta_layout(kern)
    th = s[:, -1, :][:, torch.as_tensor(perm)].T.contiguous()
    v, g = tfl.small_lml_value_grad(X, Y, th, fam, n_ls, noise, 1e-10)
    ref = chip_smoke.lml_f64(X[None], Y[None], th, fam, n_ls, noise, 1e-10)
    assert max(chip_smoke.lml_excess(v, g, ref)) < 0.5


@pytest.mark.parametrize("family,Nq,N,D,P", [("rbf", 1, 1, 3, 2), ("rbf", 257, 129, 3, 2),
                                             ("matern12", 256, 300, 5, 8),
                                             ("matern52", 127, 257, 2, 1)])
def test_mean_check_passes_the_twin_at_the_chunk_edges(family, Nq, N, D, P):
    """Phase 7's mean-kernel shapes around its 128-point chunks and
    256-query blocks: the f32 twin reads below half the bound."""
    diff, ex = chip_smoke.check_mean("cpu", Nq, N, D, P, family)
    assert diff == 0.0 and ex < 0.5  # on the CPU the wrapper is the twin


def test_mean_check_rejects_planted_faults():
    faults = chip_smoke.mean_faults("cpu")
    assert set(faults) == {"chunk 1 dropped", "queries shifted by one"}
    assert min(faults.values()) > 10


def test_bound_takes_the_slower_pipe():
    """The mean's bound at the grid shape: as many exponentials as entries
    at the special-function units' rate, beside the f32 operations."""
    Nq, N, D, P = 10**4, 2048, 2, 2
    ms, by = chip_smoke.bound((Nq * D + N * D + N * P + Nq * P) * 4,
                              chip_smoke.gram_flops(Nq, N, D) + 2 * Nq * N * P,
                              transcendentals=Nq * N)
    assert by == "operations"
    assert ms == pytest.approx(max(Nq * N / chip_smoke.SFU_PER_S,
                                   (chip_smoke.gram_flops(Nq, N, D) + 2 * Nq * N * P)
                                   / chip_smoke.F32_FLOP_PER_S) * 1e3)
    assert chip_smoke.bound(4e9, 1.0) == (pytest.approx(4e9 / chip_smoke.HBM_BYTES_PER_S * 1e3),
                                          "bytes")


def test_ptxas_summary_names_each_instance():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_123spd_inverse_warp_kernelILi24ELi16EEEvPKfPfS3_ix' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_123spd_inverse_warp_kernelILi24ELi16EEEvPKfPfS3_ix",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_124spd_inverse_elast_kernelIdEEvPKT_PS1_S4_ix' for 'sm_90a'",
        "    8 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 40 registers, 384 bytes cmem[0]"])
    assert chip_smoke.ptxas_summary(log) == (
        "spd_inverse_warp_kernel<24,16>: 80 registers, 0 B spill stores; "
        "spd_inverse_elast_kernel<double>: 40 registers, 16 B spill stores")


class _Row:
    def __init__(self, key, us, count=1):
        self.key, self.self_device_time_total, self.count = key, us, count


@pytest.mark.parametrize("empty,want_ms", [(0, 0.004), (3, 0.004), (4, None)])
def test_an_empty_profiler_session_is_traced_again(monkeypatch, empty, want_ms):
    """``cupti_ms`` takes the first of ``CUPTI_TRIES`` sessions that holds a
    kernel record; where all four were empty it gives None, and ``measured``
    then reports the CUDA-event time as such."""
    sessions = iter([[]] * empty + [[_Row("k", 20.0)]] * 8)
    monkeypatch.setattr(chip_smoke, "traced", contextlib.nullcontext)
    monkeypatch.setattr(chip_smoke, "kernel_rows", lambda prof: next(sessions))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=5: (0.5, [0.5] * reps))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke.time, "sleep", lambda s: None)
    calls = []
    got = chip_smoke.cupti_ms(lambda: calls.append(1))
    assert got == want_ms
    assert len(calls) == 1 + chip_smoke.REPS * min(empty + 1, chip_smoke.CUPTI_TRIES)
    sessions = iter([[]] * empty + [[_Row("k", 20.0)]] * 8)
    ms, event, cupti = chip_smoke.measured(lambda: None)
    assert (ms, event, cupti) == ((want_ms, 0.5, True) if want_ms else (0.5, 0.5, False))


def test_the_record_names_times_that_fell_back_to_cuda_events():
    assert chip_smoke.timing_of({"ms": (1.0, 1.1, True), "bound": (0.5, "bytes")}) == "cupti_device"
    v = {"ms": (1.0, 1.1, True), "plain_ms": (2.0, 2.0, False), "library_ms": None,
         "event_timed": ["generic_ms"]}
    assert chip_smoke.timing_of(v) == "cupti_device; cuda_event for plain_ms, generic_ms"


def test_phase_27_frames_are_the_baseline_tests_and_phase_26_inputs_the_suites():
    """Phase 27's copy of the baseline tests' synthetic frames equals
    theirs; phase 26's inputs are phase 4's, resampled to the comparison
    suite's 100 points as the JAX package resamples them."""
    import jax.numpy as jnp

    from gaussian_process_transportation_tpu.utils.resample import resample
    from test_baselines import synthetic_frames

    for got, want in zip(chip_smoke.synthetic_frames(), synthetic_frames(n_demos=7)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    X, dX, S, S1 = chip_smoke.comparison_inputs()
    X4, _, S4, S14 = chip_smoke.make_workload()
    for got, raw in ((X, X4), (S, S4), (S1, S14)):
        want = np.asarray(resample(jnp.asarray(raw, dtype=jnp.float64), num_points=100))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(dX[:-1], np.diff(X, axis=0))
    assert not dX[-1].any()


def test_the_forest_reference_applies_the_card_runs_fitted_map():
    """``forest_on_cpu`` carries a fitted forest transport's affine map and
    trees to a CPU copy that transports exactly as the original."""
    X, dX, S, S1 = chip_smoke.comparison_inputs()
    tr = chip_smoke.fit_learned("RandomForestTransport", "cpu", torch.float64, S, S1)
    want = chip_smoke.apply_learned(tr, X, dX)
    got = chip_smoke.apply_learned(chip_smoke.forest_on_cpu(want), X, dX)
    assert max(chip_smoke.field_errors(got, want).values()) == 0.0


def test_apply_check_passes_the_twin_at_the_bench_members():
    """``check_apply`` on the CPU, where ``transport_apply_rbf`` takes the
    twin: phase 4's members read their own float32 error."""
    errs, twin_errs = chip_smoke.check_apply(*chip_smoke.apply_bench_state("cpu", E=4))
    assert errs == twin_errs and max(errs.values()) < chip_smoke.APPLY_FLOOR


def test_apply_check_rejects_the_k_inv_form():
    """The quadratic forms through the cached K⁻¹ (the plain route's) read
    above the bound at phase 4's members, by more than twice."""
    state = chip_smoke.apply_bench_state("cpu", E=4)
    errs, twin_errs = chip_smoke.apply_check_errors(
        *state, got=chip_smoke.apply_k_inv_form(*state))
    assert not chip_smoke.apply_within(errs, twin_errs)
    bound = {k: chip_smoke.APPLY_REL * twin_errs[k] + chip_smoke.APPLY_FLOOR for k in errs}
    assert max(errs[k] / bound[k] for k in ("std", "delta_var")) > 2
