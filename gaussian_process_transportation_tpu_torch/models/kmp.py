"""Kernelized Movement Primitives: time-indexed GP conditioning.

Port of ``gaussian_process_transportation_tpu/models/kmp.py`` (the original
project's KMP model):

* a GP over normalized time t ∈ [0, 1] models the trajectory;
* trajectory waypoints are matched to source-distribution points (scipy's
  Hungarian assignment);
* the time GP is conditioned on the matched waypoints' displacements:
  traj ← traj + k(t, t_m) (K_mm + σ²I)⁻¹ (target_m − source_m);
* the transportation covariance k(t, t) − k(t, t_m)(K_mm + σ²I)⁻¹k(t_m, t)
  is kept for the std and posterior samples;
* ``predict`` returns the conditioned trajectory: it is indexed by time,
  and the query points are ignored, as in the original.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from .. import kernels as K
from ..ops.assignment import match_waypoints
from ..ops.linalg import add_diagonal, cho_solve_lower
from .gp_regressor import GaussianProcess


def default_kmp_kernel(device="cuda") -> K.Kernel:
    """C(0.1, [0.1, 2]) · RBF(0.1, [0.05, 0.2]) + White(1e-5, [1e-5, 0.1]),
    the JAX package's (the original transport wrapper's bounds, and the
    comparison suite's noise bound, without which the fit collapses to all
    noise), with its lengthscale on ``device`` (the card unless the caller
    asks for the CPU)."""
    return (K.Constant(0.1, bounds=(0.1, 2.0))
            * K.RBF(torch.tensor([0.1], dtype=torch.float64, device=device), bounds=(0.05, 0.2))
            + K.White(1e-5, bounds=(1e-5, 0.1)))


class KMP:
    def __init__(self, kernel: Optional[K.Kernel] = None, n_restarts: int = 5, seed: int = 0,
                 device="cuda"):
        self.kernel = kernel if kernel is not None else default_kmp_kernel(device)
        self.n_restarts = n_restarts
        self.seed = seed
        self.mask_traj: Optional[np.ndarray] = None
        self.mask_dist: Optional[np.ndarray] = None
        self.periodic: Optional[bool] = None

    def find_matching_waypoints(self, source_distribution: Tensor, training_traj: Tensor):
        seg = torch.linalg.norm(training_traj[1:] - training_traj[:-1], dim=1)
        thr = 5.0 * seg.max()
        self.periodic = bool(torch.linalg.norm(training_traj[0] - training_traj[-1]) < thr)
        return match_waypoints(training_traj, source_distribution)

    def fit(self, source_distribution: Tensor, target_distribution: Tensor,
            training_traj: Tensor, kernel: Optional[K.Kernel] = None):
        if self.mask_traj is None:
            self.mask_traj, self.mask_dist = self.find_matching_waypoints(
                source_distribution, training_traj)
        kernel = kernel if kernel is not None else self.kernel
        traj = training_traj
        n = traj.shape[0]
        self.time = torch.linspace(0.0, 1.0, n, dtype=traj.dtype, device=traj.device)[:, None]

        gp = GaussianProcess(kernel, n_restarts_optimizer=self.n_restarts, seed=self.seed)
        gp.fit(self.time, traj)
        fitted_kernel = gp.kernel_
        mask_traj = torch.as_tensor(self.mask_traj, device=traj.device)
        mask_dist = torch.as_tensor(self.mask_dist, device=traj.device)
        t_m = self.time[mask_traj]
        k_star = fitted_kernel(self.time, t_m)  # (N, M), a cross-covariance: no White
        L = torch.linalg.cholesky(add_diagonal(fitted_kernel(t_m, t_m), gp.noise_var_))
        disp = target_distribution[mask_dist] - source_distribution[mask_dist]
        self.training_traj = traj + k_star @ cho_solve_lower(L, disp)

        # refit the time GP on the conditioned trajectory
        self.gp = GaussianProcess(kernel, n_restarts_optimizer=self.n_restarts, seed=self.seed)
        self.gp.fit(self.time, self.training_traj)

        cov = fitted_kernel(self.time, self.time) - k_star @ cho_solve_lower(L, k_star.T)
        self.transportation_cov = cov
        self.transportation_std = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
        return self

    def predict(self, X, return_std: bool = False):
        mean = self.gp.predict(self.time)
        if return_std:
            return mean, self.transportation_std[:, None].expand(mean.shape)
        return mean

    def samples(self, X, n_samples: int = 10, generator: Optional[torch.Generator] = None):
        """(n_samples, N, P) draws around the conditioned trajectory with the
        transportation covariance; the normals come from ``generator`` (on
        the trajectory's device; seed ``seed + 1`` when None)."""
        mean = self.gp.predict(self.time)
        if generator is None:
            generator = torch.Generator(device=mean.device).manual_seed(self.seed + 1)
        L = torch.linalg.cholesky(add_diagonal(self.transportation_cov, 1e-8))
        eps = torch.randn((n_samples,) + tuple(mean.shape), generator=generator,
                          dtype=mean.dtype, device=mean.device)
        return mean[None] + torch.einsum("ij,sjp->sip", L, eps)
