"""Heteroscedastic uncertainty after a transport.

Port of ``gaussian_process_transportation_tpu/transport/heteroscedastic.py``
(the original project's heteroscedastic surface example): a second GP is
fitted to the aleatoric std labels √var_vel_transported along the
transported trajectory, and at query points its prediction is combined
with the epistemic std of the dynamics GP:

    σ_hetero(x)² = σ_epistemic(x)² + σ_aleatoric(x)².
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from .. import kernels as K
from ..models import exact_gp as core


def default_uncertainty_kernel(d_out: int = 1, dtype: torch.dtype = torch.float32,
                               device="cuda") -> K.Kernel:
    """C(√0.1)·RBF(4, [0.01, 500]) + White(0.01, [0.01, 0.1]), the original
    project's, with its lengthscale on ``device`` (the card unless the
    caller asks for the CPU)."""
    return (K.Constant(math.sqrt(0.1))
            * K.RBF(4.0 * torch.ones(d_out, dtype=dtype, device=device), bounds=(0.01, 500.0))
            + K.White(0.01, bounds=(0.01, 0.1)))


def fit_aleatoric_gp(traj: Tensor, var_vel_transported: Tensor,
                     kernel: Optional[K.Kernel] = None, n_restarts: int = 5,
                     generator: Optional[torch.Generator] = None) -> core.ExactGP:
    """The GP of the aleatoric std labels √var on the transported
    trajectory (scipy's L-BFGS-B, ``exact_gp.fit``), on traj's device."""
    if kernel is None:
        kernel = default_uncertainty_kernel(traj.shape[1], traj.dtype, traj.device)
    labels = torch.sqrt(torch.clamp(var_vel_transported, min=0.0))
    return core.fit(kernel, traj, labels, n_restarts=n_restarts, generator=generator)


def heteroscedastic_field(dynamics_gp: core.ExactGP, aleatoric_gp: core.ExactGP,
                          query: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(velocity mean (Nq, P), σ_hetero (Nq,), σ_aleatoric (Nq,)) at query,
    σ_hetero = sqrt(Σ_d [σ_epistemic,d² + σ_aleatoric,d²]): the combined
    field the original project colours its streamlines with."""
    mean, std_epi = core.predict(dynamics_gp, query, return_std=True)
    std_alea = core.predict(aleatoric_gp, query)
    sigma_hetero = torch.sqrt((std_epi**2 + std_alea**2).sum(1))
    sigma_alea = torch.sqrt((std_alea**2).sum(1))
    return mean, sigma_hetero, sigma_alea
