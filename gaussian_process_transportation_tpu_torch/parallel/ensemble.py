"""Transport ensembles sharded over the ``ens`` mesh axis.

Port of ``gaussian_process_transportation_tpu/parallel/ensemble.py``.  An
ensemble of E transport problems (different target distributions,
hyperparameters or posterior draws) runs as one batched call on each
rank's contiguous share of the members (``ops`` kernel #1 once a rank on
the card), with no communication until the results are gathered.  Ranks
along the ``data`` axis compute the same share, as JAX leaves that axis to
XLA.

:func:`make_ensemble_train_step` takes a joint Adam step on the kernel's
log-hyperparameters against the members' mean negative LML: each rank
sums its members' values and gradients and one ``all_reduce`` over
``ens`` adds the shares (JAX's XLA-inserted ``psum``).  Every function
takes ``mesh=None`` for this process alone.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from ..kernels import Kernel
from ..models import affine as affine_core
from ..models import exact_gp as gp_core
from ..ops.linalg import add_diagonal
from ..transport import gpt as gpt_mod
from .mesh import axis_of

__all__ = ["Adam", "make_ensemble_train_step", "posterior_transport_ensemble",
           "transport_ensemble"]


def transport_ensemble(
    kernel: Kernel,
    source: Tensor,  # (M, D)
    targets: Tensor,  # (E, M, D): one target distribution per member
    traj: Tensor,  # (N, D)
    delta: Tensor,  # (N, D)
    mesh=None,
    ori: Optional[Tensor] = None,  # (N, 4) demo quaternions (3-D maps)
) -> gpt_mod.TransportResult:
    """Fit and apply E independent transports, the members split over
    ``ens``: every rank passes the same (replicated) inputs, transports its
    share with ``fit_and_transport_batched`` and receives the whole
    ``TransportResult``, gathered over ``ens`` by one broadcast per rank
    into views of a preallocated output (exact)."""
    if mesh is None:
        return gpt_mod.fit_and_transport_batched(kernel, source, targets, traj, delta, ori=ori)
    ens = axis_of(mesh, "ens")
    E = targets.shape[0]
    local = gpt_mod.fit_and_transport_batched(kernel, source, targets[ens.shard(E)], traj, delta,
                                              ori=ori)
    return gpt_mod.TransportResult(*(None if f is None else ens.gather(f, E) for f in local))


def posterior_draws(kernel: Kernel, source: Tensor, target: Tensor, traj: Tensor,
                    n_draws: int, generator: Optional[torch.Generator], normals: Optional[Tensor],
                    rows: slice) -> Tensor:
    """Draws ``rows`` of n_draws posterior draws of the transported
    trajectory, γ(traj) + mean + L·ε: the GP fitted on (source, target)
    with fixed hyperparameters, L the Cholesky factor of the posterior
    covariance along γ(traj) (+1e-8·I), ε the standard normals (n_draws, N,
    D) from ``generator`` (on the points' device; all of them are drawn,
    whichever rows are kept) or given as ``normals``."""
    aff, gp = gpt_mod.fit_pipeline(kernel, source, target)
    pos_aligned = affine_core.predict(aff, traj)
    mean, cov = gp_core.predict_cov(gp, pos_aligned)
    L = torch.linalg.cholesky(add_diagonal(cov, 1e-8))
    if normals is None:
        normals = torch.randn((n_draws,) + tuple(mean.shape), generator=generator,
                              dtype=mean.dtype, device=mean.device)
    return (pos_aligned + mean)[None] + torch.matmul(L, normals[rows])


def posterior_transport_ensemble(
    kernel: Kernel,
    source: Tensor,
    target: Tensor,
    traj: Tensor,
    n_members: int,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    normals: Optional[Tensor] = None,
) -> Tensor:
    """E posterior draws of the transported trajectory (E, N, D): each
    member moves ``traj`` through an independent posterior sample of the
    delta map (the original project's ``sample_transportation``, scaled to
    an ensemble).  Under a mesh each rank computes its share of the
    members and the draws are gathered over ``ens``; every rank draws all
    E·N·D normals from its ``generator`` (seeded alike on every rank) and
    keeps its rows, so a run on D ranks equals the one-rank run bit for
    bit."""
    ens = axis_of(mesh, "ens")
    local = posterior_draws(kernel, source, target, traj, n_members, generator, normals,
                            ens.shard(n_members))
    return local if mesh is None else ens.gather(local, n_members)


class Adam:
    """Adam as ``optax.adam``: moments m ← b1·m + (1 − b1)·g and
    v ← b2·v + (1 − b2)·g², the step −lr·m̂/(√v̂ + eps) with m̂, v̂ the
    bias-corrected moments (eps outside the square root).  The state is a
    plain dict of tensors, the step count on the CPU, so the same
    gradients give the same θ on every rank."""

    def __init__(self, learning_rate: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, theta: Tensor) -> Dict[str, Tensor]:
        return {"count": torch.zeros((), dtype=torch.int64), "mu": torch.zeros_like(theta),
                "nu": torch.zeros_like(theta)}

    def update(self, g: Tensor, state: Dict[str, Tensor]):
        """(the update to add to θ, the new state)."""
        count = state["count"] + 1
        mu = (1 - self.b1) * g + self.b1 * state["mu"]
        nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"]
        t = int(count)
        mu_hat = mu / (1 - self.b1**t)
        nu_hat = nu / (1 - self.b2**t)
        return (mu_hat / (torch.sqrt(nu_hat) + self.eps)) * -self.learning_rate, \
            {"count": count, "mu": mu, "nu": nu}


def _aligned_residuals(sources: Tensor, targets: Tensor):
    """Each member's own Kabsch fit (rotation, no scale: ``affine.fit``'s
    defaults) of sources (E, n, D) onto targets: (γ_e(source_e),
    target_e − γ_e(source_e))."""
    n, d = sources.shape[-2:]
    cs, ct = sources.mean(-2, keepdim=True), targets.mean(-2, keepdim=True)
    Xc = sources - cs
    if n >= d:
        R = affine_core._kabsch_rotation(Xc.transpose(-1, -2) @ (targets - ct))
        aligned = Xc @ R.transpose(-1, -2) + ct
    else:
        aligned = Xc + ct
    return aligned, targets - aligned


def make_ensemble_train_step(kernel: Kernel, optimizer: Optional[Adam] = None, mesh=None):
    """Joint hyperparameter training over an ensemble: returns
    (``step(theta, opt_state, sources, targets) -> (theta, opt_state,
    loss)``, the optimizer; ``Adam(1e-2)`` by default).

    The loss is the mean over all E members of −LML of the member's
    residual dataset after its own Kabsch fit.  ``sources`` and ``targets``
    (E, n, D) are replicated; under a mesh each rank takes its share over
    ``ens``, and the loss and gradient (autograd through the Gram only:
    ``log_marginal_likelihood``'s closed-form backward) are summed over
    the shares by one ``all_reduce`` and divided by E, so θ stays the same
    on every rank."""
    optimizer = optimizer or Adam(1e-2)
    ens = axis_of(mesh, "ens")

    def step(theta: Tensor, opt_state: Dict[str, Tensor], sources: Tensor, targets: Tensor):
        E = sources.shape[0]
        rows = ens.shard(E)
        X, Y = _aligned_residuals(sources[rows], targets[rows])
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            nll = -gp_core.log_marginal_likelihood(kernel.with_theta(th), X, Y).sum()
            (g,) = torch.autograd.grad(nll, th)
        total = ens.all_reduce(torch.cat([nll.detach().reshape(1), g]))
        updates, opt_state = optimizer.update(total[1:] / E, opt_state)
        return theta + updates, opt_state, total[0] / E

    return step, optimizer
