"""Model-agnostic policy transportation: Φ(x) = γ(x) + Ψ(γ(x)).

Port of ``gaussian_process_transportation_tpu/transport/core.py``: ``fit``
(Kabsch γ on (S, S1), then the delta map Ψ on (γ(S), S1 − γ(S))),
``transport`` (positions and std), ``transport_velocity`` (push-forward
through J_Φ = J_γ + J_Ψ J_γ with the variance J_Ψvar (J_γ v)²),
``transport_orientation`` (3-D) and ``sample_transportation``.  Ψ is
duck-typed (``fit``, ``predict``, ``derivative``, ``samples``).  The
diffeomorphism check is kept as ``is_diffeomorphic``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from ..models import affine as affine_core
from ..ops import quaternion as quat


class PolicyTransport:
    def __init__(self, delta_model: Any):
        self.delta_map = delta_model
        self.affine: Optional[affine_core.AffineParams] = None
        self.is_diffeomorphic: Optional[bool] = None

    def fit(self, source_distribution: Tensor, target_distribution: Tensor, do_scale=False,
            do_rotation=True):
        self.affine = affine_core.fit(source_distribution, target_distribution,
                                      do_scale=do_scale, do_rotation=do_rotation)
        source_aligned = affine_core.predict(self.affine, source_distribution)
        self.delta_distribution = target_distribution - source_aligned
        self.delta_map.fit(source_aligned, self.delta_distribution)
        return self

    def transport(self, pos: Tensor, return_std: bool = True):
        pos_aligned = affine_core.predict(self.affine, pos)
        if return_std:
            mean, std = self.delta_map.predict(pos_aligned, return_std=True)
            return pos_aligned + mean, std
        return pos_aligned + self.delta_map.predict(pos_aligned), None

    def _jacobian_phi(self, pos: Tensor, return_var: bool):
        pos_aligned = affine_core.predict(self.affine, pos)
        J_gamma = affine_core.derivative(self.affine, pos)  # (N, D, D)
        if return_var:
            J_psi, J_psi_var = self.delta_map.derivative(pos_aligned, return_var=True)
        else:
            J_psi, J_psi_var = self.delta_map.derivative(pos_aligned, return_var=False), None
        J_phi = J_gamma + J_psi @ J_gamma
        self.is_diffeomorphic = bool((torch.linalg.det(J_phi).abs() > 0).all())
        return J_gamma, J_phi, J_psi_var

    def transport_velocity(self, pos: Tensor, vel: Tensor, return_var: bool = True):
        J_gamma, J_phi, J_psi_var = self._jacobian_phi(pos, return_var)
        v = vel[:, :, None]
        vel_transported = (J_phi @ v)[:, :, 0]
        if not return_var:
            return vel_transported, None
        return vel_transported, (J_psi_var @ (J_gamma @ v) ** 2)[:, :, 0]

    def transport_orientation(self, pos: Tensor, ori: Tensor):
        _, J_phi, _ = self._jacobian_phi(pos, return_var=False)
        if J_phi.shape[-1] != 3:
            raise ValueError(
                f"Orientation transport requires a 3-D map; J_Φ is {tuple(J_phi.shape[-2:])}")
        return quat.multiply(quat.from_rotation_matrix(J_phi), ori)

    def sample_transportation(self, pos: Tensor):
        pos_aligned = affine_core.predict(self.affine, pos)
        return pos_aligned[None] + self.delta_map.samples(pos_aligned)
