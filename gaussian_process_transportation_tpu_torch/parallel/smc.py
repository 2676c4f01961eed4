"""SMC-style particle ensembles of transported policies.

Port of ``gaussian_process_transportation_tpu/parallel/smc.py``.  A
particle is one posterior draw of a transported trajectory; its weight
comes from a task-space likelihood (reaching a goal, clearing obstacles).
``smc_step`` reweights the particles and resamples them systematically
when the effective sample size falls below a share of their number.

Randomness comes from an explicit ``torch.Generator`` on the particles'
device: the normals of ``init_particles`` and the one uniform offset of
``systematic_resample``.  Each function also takes those numbers directly
(``normals``, ``offset``), so the same inputs give the same particles as
another implementation.

Under a mesh (``mesh=``) the particles shard over ``ens``: each rank holds
its contiguous share of the trajectories and the whole (E,) log-weights.
JAX carries that sharding on the arrays and XLA inserts the collectives;
here they are explicit: each rank evaluates the likelihood on its share,
the (E,) log-likelihoods are gathered by broadcasts, every rank reweights
and draws the resampling indices alike (the same generator state on every
rank), and the survivors are taken from the gathered trajectories.  So a
run on D ranks equals the one-rank run.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..kernels import Kernel
from .ensemble import posterior_draws
from .mesh import axis_of

__all__ = [
    "ParticleEnsemble", "clearance_likelihood", "effective_sample_size", "goal_likelihood",
    "init_particles", "reweight", "smc_step", "systematic_resample",
]

class ParticleEnsemble(NamedTuple):
    trajectories: Tensor  # (E, N, D) transported trajectory per particle
    log_weights: Tensor  # (E,)


def _uniform_log_weights(E: int, like: Tensor) -> Tensor:
    return torch.full((E,), -math.log(E), dtype=like.dtype, device=like.device)


def init_particles(
    kernel: Kernel,
    source: Tensor,
    target: Tensor,
    traj: Tensor,
    n_particles: int,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    normals: Optional[Tensor] = None,
) -> ParticleEnsemble:
    """E posterior draws of the transported trajectory with uniform
    weights: γ(traj) + mean + L·ε, the GP fitted on (source, target) with
    fixed hyperparameters, L the Cholesky factor of the posterior
    covariance along γ(traj) (+1e-8·I), ε standard normals (E, N, D) from
    ``generator`` (on the points' device) or given as ``normals``.  Under a
    mesh the trajectories are this rank's share over ``ens`` (all normals
    are drawn on every rank, and each keeps its rows) and the (E,)
    log-weights are whole."""
    trajs = posterior_draws(kernel, source, target, traj, n_particles, generator, normals,
                            axis_of(mesh, "ens").shard(n_particles))
    return ParticleEnsemble(trajectories=trajs,
                            log_weights=_uniform_log_weights(n_particles, trajs))


def reweight(particles: ParticleEnsemble, log_likelihoods: Tensor,
             mesh=None) -> ParticleEnsemble:
    """Multiply the weights by per-particle likelihoods and renormalise, in
    log space.  Under a mesh ``log_likelihoods`` are this rank's share's,
    gathered over ``ens`` first."""
    if mesh is not None:
        log_likelihoods = axis_of(mesh, "ens").gather(log_likelihoods,
                                                      particles.log_weights.shape[0])
    lw = particles.log_weights + log_likelihoods
    return particles._replace(log_weights=lw - torch.logsumexp(lw, 0))


def effective_sample_size(particles: ParticleEnsemble) -> Tensor:
    """1 / Σ w² of the normalised weights."""
    w = torch.exp(particles.log_weights)
    return 1.0 / (w * w).sum()


def systematic_resample(particles: ParticleEnsemble, generator: Optional[torch.Generator] = None,
                        offset: Optional[Tensor] = None, mesh=None) -> ParticleEnsemble:
    """Systematic (low-variance) resampling with one uniform ``offset`` in
    [0, 1) (drawn from ``generator`` when None): particle j is the first i
    whose cumulative weight reaches (offset + j)/E, the count of cumulative
    weights below that point (JAX's prefix count), clipped to E − 1.  Under
    a mesh every rank computes all E indices alike, gathers the (E, N, D)
    trajectories over ``ens`` and keeps its share of the survivors."""
    lw = particles.log_weights
    E = lw.shape[0]
    if offset is None:
        offset = torch.rand((), generator=generator, dtype=lw.dtype, device=lw.device)
    cum = torch.cumsum(torch.exp(lw), 0)
    points = (torch.as_tensor(offset, dtype=lw.dtype, device=lw.device) / E
              + torch.arange(E, dtype=lw.dtype, device=lw.device) / E)
    idx = torch.clamp(torch.searchsorted(cum, points, right=False), max=E - 1)
    trajs = particles.trajectories
    if mesh is not None:
        ens = axis_of(mesh, "ens")
        trajs, idx = ens.gather(trajs, E), idx[ens.shard(E)]
    return ParticleEnsemble(trajectories=trajs[idx],
                            log_weights=_uniform_log_weights(E, lw))


def smc_step(
    particles: ParticleEnsemble,
    log_likelihood_fn: Callable[[Tensor], Tensor],
    generator: Optional[torch.Generator] = None,
    ess_threshold: float = 0.5,
    offset: Optional[Tensor] = None,
    mesh=None,
) -> Tuple[ParticleEnsemble, Tensor]:
    """One reweight step, resampled when ESS < ``ess_threshold``·E.

    ``log_likelihood_fn`` maps the (E, N, D) trajectories to (E,)
    log-likelihoods.  The resample's offset is drawn from ``generator`` at
    every step (or given), whether or not it resamples, so the stream does
    not depend on the branch.  The branch is taken on the host: one read of
    the ESS (a device sync) per step, the same on every rank of a mesh,
    where ``log_likelihood_fn`` sees this rank's share."""
    particles = reweight(particles, log_likelihood_fn(particles.trajectories), mesh)
    ess = effective_sample_size(particles)
    lw = particles.log_weights
    if offset is None:
        offset = torch.rand((), generator=generator, dtype=lw.dtype, device=lw.device)
    if bool(ess < ess_threshold * lw.shape[0]):
        particles = systematic_resample(particles, offset=offset, mesh=mesh)
    return particles, ess


def goal_likelihood(goal: Tensor, scale: float = 1.0) -> Callable[[Tensor], Tensor]:
    """log p ∝ −‖x_T − goal‖²/(2 scale²) of each trajectory's last point."""

    def ll(trajs: Tensor) -> Tensor:
        d = torch.linalg.vector_norm(trajs[:, -1, :] - goal, dim=1)
        return -0.5 * (d / scale) ** 2

    return ll


def clearance_likelihood(gamma_fn: Callable[[Tensor], Tensor], margin: float = 1.0,
                         sharpness: float = 5.0) -> Callable[[Tensor], Tensor]:
    """−sharpness · Σ relu(margin − min_k Γ_k) along each trajectory, for
    ``gamma_fn`` (N, D) → (K, N) obstacle Γ values, evaluated for all
    particles at once by ``torch.func.vmap``."""
    from torch.func import vmap

    def one(traj: Tensor) -> Tensor:
        g = gamma_fn(traj)
        return -sharpness * torch.relu(margin - g.min(0).values).sum()

    return vmap(one)
