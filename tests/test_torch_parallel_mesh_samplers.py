"""``sample_gp_posterior(mesh=)`` and the SMC ``mesh=`` path on two gloo
ranks against the port's own runs in one process: chains and particles
depend on their global indices and a seeded generator alone, so the
sharded runs equal the unsharded ones bit for bit (kernel #2's plain twin
and plain SMC here)."""
import math

import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu_torch import kernels as TK
from gaussian_process_transportation_tpu_torch.parallel import _launch, _programs, smc
from gaussian_process_transportation_tpu_torch.parallel.samplers import sample_gp_posterior

torch.set_num_threads(1)

WORLD, PARTICLES, SMC_STEPS = 2, 64, 3
HMC_KW = dict(seed=0, num_warmup=10, num_samples=10, num_leapfrog=4)
CHAINS = (8, 7)  # 7: a count the mesh does not divide runs unsharded on every rank


def _problem():
    s = np.linspace(0, 1, 20, dtype=np.float32)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)
    t = np.linspace(0, 1, 100, dtype=np.float32)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    return torch.as_tensor(S), torch.as_tensor(S1), torch.as_tensor(X)


def _kernels():
    kb = (TK.Constant(1.0, bounds=(0.01, 100.0)) * TK.RBF(torch.ones(2), bounds=(0.5, 50.0))
          + TK.White(0.05, bounds=(1e-4, 1.0)))
    ks = TK.Constant(10.0) * TK.RBF(4.0 * torch.ones(2)) + TK.White(0.01)
    return kb, ks


@pytest.fixture(scope="module")
def ranks():
    S, S1, X = _problem()
    kb, ks = _kernels()
    return _launch.launch(_programs.sampler_cases,
                          (kb, S, S1 - S, HMC_KW, CHAINS, ks, S, S1, X, X[-1], PARTICLES,
                           SMC_STEPS), nprocs=WORLD)


@pytest.mark.parametrize("chains", CHAINS)
def test_mesh_hmc_equals_the_unsharded_run(ranks, chains):
    """Every rank gets all chains, each equal to the unsharded run's bit for
    bit, and so R-hat and ESS over them; the per-chain mean acceptance to
    float32 rounding (a sum over steps whose order the CPU's vectorised
    reduction picks by the number of chains, as in
    tests/test_torch_samplers.py)."""
    S, S1, _ = _problem()
    kb, _ = _kernels()
    want, wd = sample_gp_posterior(kb, S, S1 - S, num_chains=chains, **HMC_KW)
    assert want.shape == (chains, 10, 4)
    for out in ranks:
        got, gd = out[chains]
        assert torch.equal(got, want)
        torch.testing.assert_close(gd["mean_accept"], wd["mean_accept"], rtol=1e-6, atol=1e-7)
        assert torch.equal(gd["rhat"], wd["rhat"]) and torch.equal(gd["ess"], wd["ess"])


def test_mesh_smc_equals_the_one_rank_run(ranks):
    """init_particles and three smc_steps with a goal likelihood: each rank
    holds its half of the particles and the whole weights; gathered, they
    are the one-process run's, and so are the ESS values."""
    S, S1, X = _problem()
    _, ks = _kernels()
    p = smc.init_particles(ks, S, S1, X, PARTICLES, torch.Generator().manual_seed(0))
    gen, esss = torch.Generator().manual_seed(1), []
    for _ in range(SMC_STEPS):
        p, ess = smc.smc_step(p, smc.goal_likelihood(X[-1], 0.5), gen)
        esss.append(ess)
    assert any(e < 0.5 * PARTICLES for e in esss)  # the resampling's gather ran
    for r, out in enumerate(ranks):
        got = out["smc"]
        assert torch.equal(got["trajectories"], p.trajectories)
        half = PARTICLES // WORLD
        assert torch.equal(got["local"], p.trajectories[r * half:(r + 1) * half])
        assert torch.equal(got["log_weights"], p.log_weights)
        assert torch.equal(got["ess"], torch.stack(esss))
        assert math.isfinite(got["ess"][-1].item())
