"""SMC-style particle ensembles of transported policies, on one device.

Port of ``gaussian_process_transportation_tpu/parallel/smc.py``.  A
particle is one posterior draw of a transported trajectory; its weight
comes from a task-space likelihood (reaching a goal, clearing obstacles).
``smc_step`` reweights the particles and resamples them systematically
when the effective sample size falls below a share of their number.

Randomness comes from an explicit ``torch.Generator`` on the particles'
device: the normals of ``init_particles`` and the one uniform offset of
``systematic_resample``.  Each function also takes those numbers directly
(``normals``, ``offset``), so the same inputs give the same particles as
another implementation.  The ``mesh=`` sharding of the JAX package is not
ported yet (``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..kernels import Kernel
from ..models import affine as affine_core
from ..models import exact_gp as gp_core
from ..ops.linalg import add_diagonal

__all__ = [
    "ParticleEnsemble", "clearance_likelihood", "effective_sample_size", "goal_likelihood",
    "init_particles", "reweight", "smc_step", "systematic_resample",
]

_ROADMAP = "not ported yet: see ROADMAP.md, queue 1"


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
    ``generator`` (on the points' device) or given as ``normals``."""
    from ..transport import gpt as gpt_mod

    if mesh is not None:
        raise NotImplementedError(f"init_particles(mesh=...) is {_ROADMAP}")
    aff, gp = gpt_mod.fit_pipeline(kernel, source, target)
    pos_aligned = affine_core.predict(aff, traj)
    mean, cov = gp_core.predict_cov(gp, pos_aligned)
    L = torch.linalg.cholesky(add_diagonal(cov, 1e-8))
    if normals is None:
        normals = torch.randn((n_particles,) + tuple(mean.shape), generator=generator,
                              dtype=mean.dtype, device=mean.device)
    trajs = (pos_aligned + mean)[None] + torch.matmul(L, normals)
    return ParticleEnsemble(trajectories=trajs, log_weights=_uniform_log_weights(n_particles,
                                                                                 mean))


def reweight(particles: ParticleEnsemble, log_likelihoods: Tensor) -> ParticleEnsemble:
    """Multiply the weights by per-particle likelihoods and renormalise, in
    log space."""
    lw = particles.log_weights + log_likelihoods
    return particles._replace(log_weights=lw - torch.logsumexp(lw, 0))


def effective_sample_size(particles: ParticleEnsemble) -> Tensor:
    """1 / Σ w² of the normalised weights."""
    w = torch.exp(particles.log_weights)
    return 1.0 / (w * w).sum()


def systematic_resample(particles: ParticleEnsemble, generator: Optional[torch.Generator] = None,
                        offset: Optional[Tensor] = None) -> ParticleEnsemble:
    """Systematic (low-variance) resampling with one uniform ``offset`` in
    [0, 1) (drawn from ``generator`` when None): particle j is the first i
    whose cumulative weight reaches (offset + j)/E, the count of cumulative
    weights below that point (JAX's prefix count), clipped to E − 1."""
    lw = particles.log_weights
    E = lw.shape[0]
    if offset is None:
        offset = torch.rand((), generator=generator, dtype=lw.dtype, device=lw.device)
    cum = torch.cumsum(torch.exp(lw), 0)
    points = (torch.as_tensor(offset, dtype=lw.dtype, device=lw.device) / E
              + torch.arange(E, dtype=lw.dtype, device=lw.device) / E)
    idx = torch.clamp(torch.searchsorted(cum, points, right=False), max=E - 1)
    return ParticleEnsemble(trajectories=particles.trajectories[idx],
                            log_weights=_uniform_log_weights(E, lw))


def smc_step(
    particles: ParticleEnsemble,
    log_likelihood_fn: Callable[[Tensor], Tensor],
    generator: Optional[torch.Generator] = None,
    ess_threshold: float = 0.5,
    offset: Optional[Tensor] = None,
) -> Tuple[ParticleEnsemble, Tensor]:
    """One reweight step, resampled when ESS < ``ess_threshold``·E.

    ``log_likelihood_fn`` maps the (E, N, D) trajectories to (E,)
    log-likelihoods.  The resample's offset is drawn from ``generator`` at
    every step (or given), whether or not it resamples, so the stream does
    not depend on the branch.  The branch is taken on the host: one read of
    the ESS (a device sync) per step."""
    particles = reweight(particles, log_likelihood_fn(particles.trajectories))
    ess = effective_sample_size(particles)
    lw = particles.log_weights
    if offset is None:
        offset = torch.rand((), generator=generator, dtype=lw.dtype, device=lw.device)
    if bool(ess < ess_threshold * lw.shape[0]):
        particles = systematic_resample(particles, offset=offset)
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
