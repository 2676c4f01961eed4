"""Diffeomorphism-aware GP transportation.

Port of ``gaussian_process_transportation_tpu/transport/diffeo.py`` (the
original project's diffeomorphic transport):

* the source and target distributions saved to and loaded from an npz file;
* ``check_invertibility``: the inverse delta map fitted on (target, −delta)
  and the forward∘inverse residual Σ‖Ψ(γ(x)) + Ψ⁻¹(Φ(x))‖ over the
  trajectory;
* ``diffeomorphism_error`` / ``optimize_diffeomorphism``: a log-spaced sweep
  of the RBF's largest lengthscale bound, refitting the transport at each
  candidate, for the bound of the smallest residual.

The sweep is the JAX package's: n_trials refits one after the other on the
host.  With ``jit_fit=True`` in ``gp_kwargs`` each refit is one
``exact_gp.fit_jit``, its restarts lanes of one L-BFGS (kernel #2 on the
card).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import kernels as K
from ..models import affine as affine_core
from ..models.gp_regressor import GaussianProcess
from .core import PolicyTransport
from .gpt import GaussianProcessTransportation


def _numpy(value) -> np.ndarray:
    return torch.as_tensor(value).detach().cpu().numpy()


class GaussianProcessTransportationDiffeo(GaussianProcessTransportation):
    def __init__(self, kernel_transport: Optional[K.Kernel] = None, device="cuda", **gp_kwargs):
        super().__init__(kernel_transport=kernel_transport, device=device, **gp_kwargs)
        self.kernel_transport = kernel_transport
        self.gp_kwargs = gp_kwargs

    # ---- persistence (npz) -------------------------------------------------
    def save_distributions(self, directory: str = "distributions"):
        os.makedirs(directory, exist_ok=True)
        np.savez(os.path.join(directory, "distributions.npz"),
                 source=_numpy(self.source_distribution),
                 target=_numpy(self.target_distribution))

    def load_distributions(self, directory: str = "distributions"):
        path = os.path.join(directory, "distributions.npz")
        try:
            data = np.load(path)
            self.source_distribution = data["source"]
            self.target_distribution = data["target"]
        except (FileNotFoundError, OSError):
            print("No distributions saved")

    # ---- invertibility -----------------------------------------------------
    def _forward_inverse_residual(self) -> float:
        """Ψ and the inverse map Ψ⁻¹ fitted on (S1, −delta) with the delta
        map's initial kernel; the residual of Ψ(γ(X)) + Ψ⁻¹(Φ(X)) summed
        over the trajectory."""
        method = self.method.delta_map
        traj_rot = affine_core.predict(self.method.affine, self._tensor(self.training_traj))
        delta_mean, _ = method.predict(traj_rot, return_std=True)
        traj_target = traj_rot + delta_mean
        gp_inv = GaussianProcess(kernel=method.kernel, optimizer=None)
        gp_inv.fit(self._tensor(self.target_distribution), -self.method.delta_distribution)
        delta_inv = gp_inv.predict(traj_target)
        self.traj_rotated_inv = traj_target + delta_inv
        return torch.linalg.norm(delta_mean + delta_inv, dim=1).sum().item()

    def check_invertibility(self) -> float:
        return self._forward_inverse_residual()

    def diffeomorphism_error(self, max_lengthscale: float) -> float:
        d = np.shape(self.source_distribution)[1]
        ls = 2.0 * torch.ones(d, dtype=torch.float64, device=self.device)
        kernel = (K.Constant(0.1) * K.RBF(ls, bounds=(0.1, float(max_lengthscale)))
                  + K.White(1e-4))
        self.method = PolicyTransport(GaussianProcess(kernel=kernel, **self.gp_kwargs))
        self.fit_transportation()
        return self._forward_inverse_residual()

    def optimize_diffeomorphism(self, n_trials: int = 20, low: float = 2.0,
                                high: float = 20.0) -> float:
        """Log-spaced sweep over the largest-lengthscale bound; refits at the
        best candidate and returns it.  The bound moves the fit only when
        hyperparameters are optimized (the default): with ``optimizer=None``
        the sweep is vacuous, as in the original workflow."""
        candidates = np.exp(np.linspace(np.log(low), np.log(high), n_trials))
        errors = [self.diffeomorphism_error(c) for c in candidates]
        best = float(candidates[int(np.argmin(errors))])
        self.best_max_lengthscale = best
        self.diffeo_errors = dict(zip(map(float, candidates), map(float, errors)))
        self.diffeomorphism_error(best)  # refit at the optimum
        return best
