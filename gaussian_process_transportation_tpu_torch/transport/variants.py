"""Transport variants: one wrapper per delta-map model family.

Port of the first part of
``gaussian_process_transportation_tpu/transport/variants.py``.  Each
follows the original project's attribute protocol: set
``source_distribution``, ``target_distribution``, ``training_traj`` and
optionally ``training_delta`` (and ``training_ori`` for the affine one),
then call ``fit_transportation()``, ``apply_transportation()`` and
``sample_transportation()``.  The attributes are moved to ``device`` (the
card unless the caller asks for the CPU) in their own dtype.

* ``AffineTransportation``: the affine map alone;
* ``KMPTransport``: affine alignment, then KMP conditioning;
* ``LaplacianEditingTransport``: affine alignment, then Laplacian editing.

The learned delta maps of the JAX module (MLP, random forest, flows, SVGP,
GMR) wait for their models.
"""
from __future__ import annotations

import torch
from torch import Tensor

from ..models.affine import AffineTransform
from ..models.kmp import KMP
from ..models.laplacian_editing import LaplacianEditing
from ..ops import quaternion as quat


def finite_difference_jacobian(traj_new: Tensor, traj_old: Tensor) -> Tensor:
    """Per-step finite-difference Jacobian J_i = Δtraj_new_i · pinv(Δtraj_old_i),
    the last row repeated: the velocity transport of the KMP and Laplacian
    variants."""
    dn = (traj_new[1:] - traj_new[:-1])[:, :, None]  # (N-1, D, 1)
    do = (traj_old[1:] - traj_old[:-1])[:, :, None]
    J = dn @ torch.linalg.pinv(do)
    return torch.cat([J, J[-1:]], 0)


class _Attributes:
    """The protocol's attributes as tensors on the transport's device."""

    def _tensor(self, value) -> Tensor:
        return torch.as_tensor(value, device=self.device)


class _FDVelocityMixin(_Attributes):
    """apply_transportation's finite-difference velocity push-forward."""

    def _apply_fd_velocity(self):
        if getattr(self, "training_delta", None) is not None:
            J = finite_difference_jacobian(self._tensor(self.training_traj),
                                           self._tensor(self.training_traj_old))
            self.training_delta = (J @ self._tensor(self.training_delta)[:, :, None])[:, :, 0]


class AffineTransportation(_Attributes):
    """The affine map alone: positions, velocities and orientations through
    γ, a zero std and velocity variance."""

    def __init__(self, do_scale: bool = False, do_rotation: bool = True, device="cuda"):
        self.device = torch.device(device)
        self.affine_transform = AffineTransform(do_scale=do_scale, do_rotation=do_rotation,
                                                device=self.device)

    def fit_transportation(self, do_scale=None, do_rotation=None):
        if do_scale is not None or do_rotation is not None:
            self.affine_transform = AffineTransform(
                do_scale=bool(do_scale),
                do_rotation=True if do_rotation is None else bool(do_rotation),
                device=self.device)
        self.affine_transform.fit(self._tensor(self.source_distribution),
                                  self._tensor(self.target_distribution))

    def apply_transportation(self):
        self.training_traj_old = self._tensor(self.training_traj)
        self.training_traj = self.affine_transform.predict(self.training_traj_old)
        self.std = torch.zeros_like(self.training_traj)
        if getattr(self, "training_delta", None) is not None:
            J = self.affine_transform.derivative(self.training_traj_old)
            self.training_delta = (J @ self._tensor(self.training_delta)[:, :, None])[:, :, 0]
            self.var_vel_transported = torch.zeros_like(self.training_delta)
        if getattr(self, "training_ori", None) is not None:
            q_aff = quat.from_rotation_matrix(self.affine_transform.rotation_matrix)
            self.training_ori = quat.multiply(q_aff[None], self._tensor(self.training_ori))

    def sample_transportation(self):
        return self.training_traj[None]


class KMPTransport(_FDVelocityMixin):
    def __init__(self, kernel=None, do_scale: bool = False, do_rotation: bool = True,
                 device="cuda"):
        self.device = torch.device(device)
        self.affine_transform = AffineTransform(do_scale=do_scale, do_rotation=do_rotation,
                                                device=self.device)
        self.transportation = KMP(kernel=kernel, device=self.device)

    def fit_transportation(self):
        source = self._tensor(self.source_distribution)
        target = self._tensor(self.target_distribution)
        traj = self._tensor(self.training_traj)
        self.transportation.mask_traj, self.transportation.mask_dist = (
            self.transportation.find_matching_waypoints(source, traj))
        self.affine_transform.fit(source, target)
        source_aligned = self.affine_transform.predict(source)
        self.training_traj = self.affine_transform.predict(traj)
        self.transportation.fit(source_aligned, target, self.training_traj)

    def apply_transportation(self):
        self.training_traj_old = self._tensor(self.training_traj)
        self.traj_rotated = self.affine_transform.predict(self.training_traj_old)
        self.training_traj, self.std = self.transportation.predict(self.traj_rotated,
                                                                   return_std=True)
        self._apply_fd_velocity()

    def sample_transportation(self):
        return self.transportation.samples(self.traj_rotated)


class LaplacianEditingTransport(_FDVelocityMixin):
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.affine_transform = AffineTransform(do_scale=True, do_rotation=True,
                                                device=self.device)
        self.transportation = LaplacianEditing()

    def fit_transportation(self):
        source = self._tensor(self.source_distribution)
        target = self._tensor(self.target_distribution)
        self.affine_transform.fit(source, target)
        source_aligned = self.affine_transform.predict(source)
        self.training_traj = self.affine_transform.predict(self._tensor(self.training_traj))
        self.transportation.fit(source_aligned, target, self.training_traj)

    def apply_transportation(self):
        self.training_traj_old = self._tensor(self.training_traj)
        self.traj_rotated = self.affine_transform.predict(self.training_traj_old)
        self.training_traj, self.std = self.transportation.predict(self.traj_rotated,
                                                                   return_std=True)
        self._apply_fd_velocity()

    def sample_transportation(self):
        return self.transportation.samples(self.traj_rotated)
