"""The multi-device slice end to end on n ranks: ``dryrun_multichip``.

The port's counterpart of the JAX package's ``dryrun_multichip``: n ranks
(``_launch``), an (ens × data) mesh of them, and six steps, each with its
check:

1. the transport ensemble (E = max(512, 2n) targets, Q = 400, n = 20)
   sharded over ``ens`` equals the unsharded one to 1e-5·max|ref|;
2. one joint Adam step on the kernel's log-hyperparameters: a finite loss;
3. HMC hyperposterior chains sharded over ``ens``: (n, 10, 4) samples;
4. SMC particles sharded over ``ens``, one reweight-and-resample step: a
   finite ESS;
5. the distributed Cholesky over all n ranks on ``data`` (N = max(400,
   256·n), blocks of 128, so every rank owns at least two panels): α
   within 2e-3 of a dense float64 solve;
6. the distributed LML and gradient on the same points: the value within
   1e-4 and the gradient within 1e-3·scale of the one-process
   ``blocked_lml_value_and_grad(refine_iters=0)``.

Rank 0 prints the summary line.  On the card every rank also holds kernel
#4 against its plain twin at the path's block (B = 128).  The launches of
the kernels are counted per rank and step.
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import _launch

__all__ = ["dryrun_multichip"]

F32_EPS = 2.0**-24


def _example_problem(n_traj: int, n_dist: int):
    """The JAX dryrun's problem: a demo X (n_traj, 2) with velocities dX, a
    source S and a target S1 (n_dist, 2), float32 numpy."""
    t = np.linspace(0, 1, n_traj, dtype=np.float32)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], axis=1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    s = np.linspace(0, 1, n_dist, dtype=np.float32)
    S = np.stack([10 * s, -2 + 0 * s], axis=1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], axis=1)
    return X, dX, S, S1


def _wrappers():
    from ..ops.batched_linalg import spd_inverse_elast_fused
    from ..ops.blocked_chol import factor_panel, stationary_gram_panels
    from ..ops.fused_lml import small_lml_value_grad
    from ..ops.transport_apply import transport_apply_rbf

    return (spd_inverse_elast_fused, small_lml_value_grad, factor_panel, stationary_gram_panels,
            transport_apply_rbf)


def _counted(fn, device):
    """(fn(), the launches of each kernel wrapper during it)."""
    for w in _wrappers():
        w.launches = 0
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, {w.__name__: w.launches for w in _wrappers()}


def _factor_panel_check(Xc: np.ndarray, rank: int, device, B: int = 128):
    """Kernel #4 against ``factor_panel_plain`` on this rank's card, on the
    diagonal block of the step-5 Gram at panel ``rank`` (B = 128): the
    largest difference of L and of L⁻¹ over the twin's largest entry, and
    its bound 8·κ·ε32 (κ the block's condition number in float64)."""
    from ..ops.blocked_chol import factor_panel, factor_panel_plain
    from ..ops.pallas_gram import stationary_gram_plain

    x = torch.as_tensor(Xc[rank * B:(rank + 1) * B], device=device)
    A = stationary_gram_plain(x, x, 1.0, 2.0, "rbf")
    A.diagonal().add_(0.1)
    got, want = factor_panel(A), factor_panel_plain(A)
    rel = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
    kappa = float(np.linalg.cond(A.double().cpu().numpy()))
    return rel, 8 * kappa * F32_EPS


def _rank(n: int, device_type: str):
    from .. import kernels as K
    from ..ops.blocked_lml import blocked_lml_value_and_grad
    from ..transport import gpt as gpt_mod
    from . import smc
    from .ensemble import make_ensemble_train_step, transport_ensemble
    from .mesh import make_mesh
    from .samplers import sample_gp_posterior
    from .sharded_chol import sharded_gram_cholesky_solve
    from .sharded_lml import sharded_lml_value_and_grad

    rank = dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else \
        torch.device("cpu")
    f32 = dict(dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    marks, counts = {}, {}

    def mark(step):
        marks[step] = time.perf_counter() - t0

    n_data = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n // n_data, n_data, device_type)
    X, dX, S, S1 = (torch.as_tensor(a, **f32) for a in _example_problem(400, 20))
    E = max(512, 2 * n)
    shifts = torch.as_tensor(np.linspace(0.0, 1.0, E, dtype=np.float32), **f32)
    targets = S1[None] + shifts[:, None, None]
    kernel = K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, **f32)) + K.White(0.01)

    # 1) the transport ensemble, sharded over 'ens', against the unsharded one
    res, counts["transport"] = _counted(
        lambda: transport_ensemble(kernel, S, targets, X, dX, mesh=mesh), device)
    assert res.traj.shape == (E,) + tuple(X.shape)
    if rank == 0:
        ref = gpt_mod.fit_and_transport_batched(kernel, S, targets, X, dX)
        for field in ("traj", "delta", "std"):
            a, b = getattr(res, field), getattr(ref, field)
            err = (a - b).abs().max().item()
            assert err < 1e-5 * max(1.0, b.abs().max().item()), (field, err)
    mark(1)

    # 2) one joint hyperparameter Adam step (the gradient summed over 'ens')
    step, optimizer = make_ensemble_train_step(kernel, mesh=mesh)
    theta = kernel.theta
    sources = S.expand(E, *S.shape)
    (theta, _, loss), counts["train_step"] = _counted(
        lambda: step(theta, optimizer.init(theta), sources, targets), device)
    assert math.isfinite(loss.item())
    mark(2)

    # 3) HMC hyperparameter chains sharded over 'ens'
    kb = (K.Constant(1.0, bounds=(0.01, 100.0)) * K.RBF(torch.ones(2, **f32), bounds=(0.5, 50.0))
          + K.White(0.05, bounds=(1e-4, 1.0)))
    (chains, _), counts["hmc"] = _counted(
        lambda: sample_gp_posterior(kb, S, S1 - S, seed=0, num_chains=n, num_warmup=10,
                                    num_samples=10, num_leapfrog=4, mesh=mesh), device)
    assert chains.shape == (n, 10, kb.n_theta) and torch.isfinite(chains).all()
    mark(3)

    # 4) SMC particles: a reweight and a resample over the mesh
    def smc_run():
        p0 = smc.init_particles(kernel, S, S1, X, 2 * n,
                                torch.Generator(device).manual_seed(1), mesh=mesh)
        return smc.smc_step(p0, smc.goal_likelihood(X[-1], 0.5),
                            torch.Generator(device).manual_seed(2), ess_threshold=1.0, mesh=mesh)

    (_, ess), counts["smc"] = _counted(smc_run, device)
    assert math.isfinite(ess.item())
    mark(4)

    # 5) the distributed Cholesky over all ranks on 'data'
    mesh1d = make_mesh(1, n, device_type)
    Nc = max(400, 2 * 128 * n)
    rngc = np.random.RandomState(3)
    Xc = rngc.randn(Nc, 3).astype(np.float32)
    Yc = rngc.randn(Nc, 2).astype(np.float32)
    Xt, Yt = torch.as_tensor(Xc, **f32), torch.as_tensor(Yc, **f32)
    (alpha, _), counts["cholesky"] = _counted(
        lambda: sharded_gram_cholesky_solve(Xt, Yt, torch.ones(3, **f32), 2.0, 0.1, mesh=mesh1d,
                                            block=128), device)
    chol_err = None
    if rank == 0:
        X64 = Xc.astype(np.float64)
        K64 = 2.0 * np.exp(-0.5 * ((X64[:, None, :] - X64[None, :, :]) ** 2).sum(-1)) \
            + 0.1 * np.eye(Nc)
        a64 = np.linalg.solve(K64, Yc.astype(np.float64))
        chol_err = float(np.abs(alpha.double().cpu().numpy() - a64).max() / np.abs(a64).max())
        assert chol_err < 2e-3, chol_err
    mark(5)

    # 6) the distributed LML and gradient against the one-process blocked LML
    la = torch.tensor(math.log(2.0), **f32)
    ll = torch.zeros(3, **f32)
    ln = torch.tensor(math.log(0.1), **f32)
    (vs, gs), counts["lml"] = _counted(
        lambda: sharded_lml_value_and_grad(Xt, Yt, "rbf", la, ll, ln, mesh=mesh1d, block=128),
        device)
    if rank == 0:
        v1, g1 = blocked_lml_value_and_grad(Xt, Yt, "rbf", la, ll, ln, block=128,
                                            refine_iters=0)
        scale = max(g.abs().max().item() for g in g1)
        assert abs(vs.item() - v1.item()) < 1e-4 * abs(v1.item()), (vs.item(), v1.item())
        for a, b in zip(gs, g1):
            assert (a - b).abs().max().item() < 1e-3 * scale, (a, b)
    mark(6)

    out = dict(rank=rank, device=str(device), backend=dist.get_backend(), counts=counts,
               marks=marks, loss=loss.item(), sharded_lml=vs.item(), smc_ess=ess.item(),
               hmc_chains=tuple(chains.shape), chol_err=chol_err,
               mesh={"ens": n // n_data, "data": n_data}, E=E)
    if device.type == "cuda":
        out["factor_panel_vs_twin"] = _factor_panel_check(Xc, rank, device)
        rel, bound = out["factor_panel_vs_twin"]
        assert rel <= bound, f"rank {rank}: factor_panel vs its twin {rel:.3g} > {bound:.3g}"
    if rank == 0:
        print(f"dryrun_multichip OK: mesh={out['mesh']}, E={E}, loss={out['loss']:.4f}, "
              f"hmc_chains={out['hmc_chains']}, smc_ess={out['smc_ess']:.1f}, "
              f"sharded_lml={out['sharded_lml']:.1f}", flush=True)
    return out


def dryrun_multichip(n_devices: int = 8, device: str = "cuda", backend=None):
    """Run the six steps on ``n_devices`` ranks; returns each rank's record
    (the step results, the launches of each kernel per step, the seconds at
    the end of each step, the backend and device).  The ranks take cards
    rank mod the card count for "cuda"; ``backend`` None takes the device's
    (nccl for cuda, gloo for cpu), and nothing falls back from one to the
    other: NCCL refuses two ranks on one card, so a one-card run of
    several ranks names ``backend="gloo"``, whose collectives take CUDA
    tensors."""
    t0 = time.perf_counter()
    outs = _launch.launch(_rank, (n_devices, device), nprocs=n_devices, backend=backend,
                          device=device)
    print(f"dryrun_multichip: {n_devices} ranks on {device} over {outs[0]['backend']} in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return outs
