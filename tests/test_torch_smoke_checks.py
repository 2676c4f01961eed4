"""The fused-predict check of ``chip_smoke.py`` on the CPU: a sound float32
evaluation (the plain twin, which the wrappers take for CPU tensors) reads
below its per-query bound for every family, and the planted faults of the
variance read above it."""
import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_process_transportation_tpu_torch import kernels as K
from gaussian_process_transportation_tpu_torch.models import exact_gp as tgp


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


def test_predict_check_rejects_planted_faults():
    gp, Xq = _grid_gp()
    faults = chip_smoke.planted_faults(Xq, gp.X, gp.alpha, gp.K_inv, torch.ones(2), 2.0, 2.1)
    assert set(faults) == {"var x2", "column tile 1 dropped"}
    assert min(faults.values()) > 10
