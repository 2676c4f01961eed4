"""Transport variants: one wrapper per delta-map model family.

Port of ``gaussian_process_transportation_tpu/transport/variants.py``.  Each
follows the original project's attribute protocol: set
``source_distribution``, ``target_distribution``, ``training_traj`` and
optionally ``training_delta`` (and ``training_ori`` for the affine and SVGP
ones), then call ``fit_transportation()``, ``apply_transportation()`` and
``sample_transportation()``.  The attributes are moved to ``device`` (the
card unless the caller asks for the CPU) in their own dtype.

* ``AffineTransportation``: the affine map alone;
* ``KMPTransport``: affine alignment, then KMP conditioning;
* ``LaplacianEditingTransport``: affine alignment, then Laplacian editing;
* ``MLPTransport``, ``RandomForestTransport``: affine alignment, then a
  learned residual (an MLP ensemble, a random forest), velocities by the
  finite-difference Jacobian;
* ``NeuralTransport``, ``EnsembleNeuralTransport``: an MLP (ensemble)
  residual, velocities through J_Φ = J_γ + J_Ψ J_γ (and its variance);
* ``BijectiveTransport``, ``EnsembleBijectiveTransport``: a RealNVP flow
  (ensemble) fitted to Φ itself, velocities through its exact Jacobian;
* ``GMRTransport``: a joint GMM over (γ(S), S1) whose conditional mean maps
  the trajectory, velocities through the analytic GMR Jacobian;
* ``SVGPTransport``: a sparse variational GP residual with derivative
  posteriors, turning orientations by the closest rotation to I + J_Ψ.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..models.affine import AffineTransform
from ..models.flows import BijectiveNetwork, EnsembleBijectiveNetwork
from ..models.gmr import GMR
from ..models.kmp import KMP
from ..models.laplacian_editing import LaplacianEditing
from ..models.mlp import MLP, EnsembleMLP
from ..models.random_forest import EnsembleRandomForest
from ..models.svgp import StochasticVariationalGaussianProcess
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


class _DeltaMapTransport(_FDVelocityMixin):
    """Affine alignment, a learned residual delta map, and the
    finite-difference velocity transport."""

    def _fit_delta(self, model, do_scale=False, do_rotation=True):
        self.affine_transform = AffineTransform(do_scale=do_scale, do_rotation=do_rotation,
                                                device=self.device)
        source = self._tensor(self.source_distribution)
        self.affine_transform.fit(source, self._tensor(self.target_distribution))
        source_aligned = self.affine_transform.predict(source)
        self.delta_distribution = self._tensor(self.target_distribution) - source_aligned
        self.delta_map = model
        return source_aligned

    def _apply_delta(self):
        self.training_traj_old = self._tensor(self.training_traj)
        self.traj_rotated = self.affine_transform.predict(self.training_traj_old)
        mean, self.std = self.delta_map.predict(self.traj_rotated, return_std=True)
        self.training_traj = self.traj_rotated + mean

    def apply_transportation(self):
        self._apply_delta()
        self._apply_fd_velocity()

    def sample_transportation(self):
        return self.traj_rotated[None] + self.delta_map.samples(self.traj_rotated)


class MLPTransport(_DeltaMapTransport):
    def __init__(self, n_estimators: int = 10, device="cuda", **mlp_kw):
        self.n_estimators = n_estimators
        self.mlp_kw = mlp_kw
        self.device = torch.device(device)

    def fit_transportation(self):
        src = self._fit_delta(EnsembleMLP(n_estimators=self.n_estimators, device=self.device))
        self.delta_map.fit(src, self.delta_distribution, **self.mlp_kw)


class RandomForestTransport(_DeltaMapTransport):
    def __init__(self, n_estimators: int = 50, max_depth: int = 5, device="cuda"):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.device = torch.device(device)

    def fit_transportation(self):
        src = self._fit_delta(EnsembleRandomForest(n_estimators=self.n_estimators,
                                                   max_depth=self.max_depth, device=self.device))
        self.delta_map.fit(src, self.delta_distribution)


class NeuralTransport(_DeltaMapTransport):
    """One MLP residual, velocities through its exact Jacobian."""

    def __init__(self, device="cuda", **mlp_kw):
        self.mlp_kw = mlp_kw
        self.device = torch.device(device)

    def fit_transportation(self, num_epochs: int = 200):
        src = self._fit_delta(MLP(device=self.device, **self.mlp_kw))
        self.delta_map.fit(src, self.delta_distribution, num_epochs=num_epochs)

    def apply_transportation(self):
        self._apply_delta()
        if getattr(self, "training_delta", None) is not None:
            J_psi = self.delta_map.derivative(self.traj_rotated)
            J_gamma = self.affine_transform.derivative(self.training_traj_old)
            J_phi = J_gamma + J_psi @ J_gamma
            self.training_delta = (J_phi @ self._tensor(self.training_delta)[:, :, None])[:, :, 0]


class EnsembleNeuralTransport(_DeltaMapTransport):
    """An MLP-ensemble residual; the velocities' variance from the
    variance of the members' Jacobians."""

    def __init__(self, n_estimators: int = 10, device="cuda", **mlp_kw):
        self.n_estimators = n_estimators
        self.mlp_kw = mlp_kw
        self.device = torch.device(device)

    def fit_transportation(self, num_epochs: int = 200):
        src = self._fit_delta(EnsembleMLP(n_estimators=self.n_estimators, device=self.device))
        self.delta_map.fit(src, self.delta_distribution, num_epochs=num_epochs, **self.mlp_kw)

    def apply_transportation(self):
        self._apply_delta()
        if getattr(self, "training_delta", None) is not None:
            J_psi, J_psi_var = self.delta_map.derivative(self.traj_rotated, return_var=True)
            J_gamma = self.affine_transform.derivative(self.training_traj_old)
            J_phi = J_gamma + J_psi @ J_gamma
            v = self._tensor(self.training_delta)[:, :, None]
            self.var_vel_transported = (J_psi_var @ (J_gamma @ v) ** 2)[:, :, 0]
            self.training_delta = (J_phi @ v)[:, :, 0]


class BijectiveTransport(_Attributes):
    """A flow fitted to Φ directly, source → target: the trajectory becomes
    Φ(traj), velocities go through the flow's exact Jacobian."""

    def __init__(self, num_blocks: int = 4, num_hidden: int = 20, seed: int = 0, device="cuda"):
        self.num_blocks = num_blocks
        self.num_hidden = num_hidden
        self.seed = seed
        self.device = torch.device(device)

    def fit_transportation(self, num_epochs: int = 200):
        self.model = BijectiveNetwork(
            self._tensor(self.source_distribution), self._tensor(self.target_distribution),
            num_blocks=self.num_blocks, num_hidden=self.num_hidden, seed=self.seed,
            device=self.device)
        self.model.fit(num_epochs=num_epochs)

    def apply_transportation(self):
        self.training_traj_old = self._tensor(self.training_traj)
        self.training_traj = self.model.predict(self.training_traj_old)
        self.std = torch.zeros_like(self.training_traj)
        if getattr(self, "training_delta", None) is not None:
            J = self.model.derivative(self.training_traj_old)
            self.training_delta = (J @ self._tensor(self.training_delta)[:, :, None])[:, :, 0]

    def sample_transportation(self):
        return self.training_traj[None]


class EnsembleBijectiveTransport(_Attributes):
    """A flow ensemble fitted to Φ: the members' mean and std, and the
    velocities' variance from the variance of their Jacobians."""

    def __init__(self, n_estimators: int = 10, num_blocks: int = 4, num_hidden: int = 20,
                 seed: int = 0, device="cuda"):
        self.n_estimators = n_estimators
        self.num_blocks = num_blocks
        self.num_hidden = num_hidden
        self.seed = seed
        self.device = torch.device(device)

    def fit_transportation(self, num_epochs: int = 200):
        self.model = EnsembleBijectiveNetwork(
            self._tensor(self.source_distribution), self._tensor(self.target_distribution),
            n_estimators=self.n_estimators, num_blocks=self.num_blocks,
            num_hidden=self.num_hidden, seed=self.seed, device=self.device)
        self.model.fit(num_epochs=num_epochs)

    def apply_transportation(self):
        self.training_traj_old = self._tensor(self.training_traj)
        self.training_traj, self.std = self.model.predict(self.training_traj_old,
                                                          return_std=True)
        if getattr(self, "training_delta", None) is not None:
            J, J_var = self.model.derivative(self.training_traj_old, return_var=True)
            v = self._tensor(self.training_delta)[:, :, None]
            self.var_vel_transported = (J_var @ v**2)[:, :, 0]
            self.training_delta = (J @ v)[:, :, 0]

    def sample_transportation(self):
        return self.model.samples(self.training_traj_old)


class GMRTransport(_Attributes):
    """Affine alignment, then a joint GMM over (γ(S), S1) whose conditional
    mean maps the trajectory directly; velocities through the analytic GMR
    Jacobian, J_Φ = J_GMR J_γ."""

    def __init__(self, n_components: int = 10, n_iter: int = 100, seed: int = 0,
                 do_scale: bool = False, do_rotation: bool = True, device="cuda"):
        self.n_components = n_components
        self.n_iter = n_iter
        self.seed = seed
        self.do_scale = do_scale
        self.do_rotation = do_rotation
        self.device = torch.device(device)

    def fit_transportation(self):
        self.affine_transform = AffineTransform(do_scale=self.do_scale,
                                                do_rotation=self.do_rotation, device=self.device)
        source = self._tensor(self.source_distribution)
        target = self._tensor(self.target_distribution)
        self.affine_transform.fit(source, target)
        self.gmr = GMR(n_components=self.n_components, n_iter=self.n_iter, seed=self.seed,
                       device=self.device)
        self.gmr.fit(self.affine_transform.predict(source), target)

    def apply_transportation(self):
        self.training_traj_old = self._tensor(self.training_traj)
        self.traj_rotated = self.affine_transform.predict(self.training_traj_old)
        self.training_traj, self.std = self.gmr.predict(self.traj_rotated, return_std=True)
        if getattr(self, "training_delta", None) is not None:
            J_phi = (self.gmr.derivative(self.traj_rotated)
                     @ self.affine_transform.derivative(self.training_traj_old))
            self.training_delta = (J_phi @ self._tensor(self.training_delta)[:, :, None])[:, :, 0]

    def sample_transportation(self):
        return self.gmr.samples(self.traj_rotated)


class SVGPTransport(_Attributes):
    """Affine alignment, then a sparse variational GP residual with
    derivative posteriors: velocities through (I + J_Ψ) J_γ with the
    variance of J_Ψ, orientations turned by the closest rotation to I + J_Ψ
    after the affine rotation."""

    def __init__(self, seed: int = 0, device="cuda"):
        self.seed = seed
        self.device = torch.device(device)

    def fit_transportation(self, num_epochs: int = 20, num_inducing: int = 100, **fit_kw):
        arrays = (np.ndarray, Tensor)
        if not (isinstance(self.target_distribution, arrays)
                and isinstance(self.source_distribution, arrays)):
            if type(self.target_distribution) != type(self.source_distribution):
                raise TypeError("Both distributions must be arrays.")
            self.convert_distribution_to_array()  # a sensor adapter's hook
        self.affine_transform = AffineTransform(device=self.device)
        source = self._tensor(self.source_distribution)
        target = self._tensor(self.target_distribution)
        self.affine_transform.fit(source, target)
        source_aligned = self.affine_transform.predict(source)
        self.gp_delta_map = StochasticVariationalGaussianProcess(
            source_aligned, target - source_aligned, num_inducing=num_inducing, seed=self.seed,
            device=self.device)
        self.gp_delta_map.fit(num_epochs=num_epochs, **fit_kw)

    def apply_transportation(self):
        self.training_traj_old = self._tensor(self.training_traj)
        self.traj_rotated = self.affine_transform.predict(self.training_traj_old)
        mean, self.std = self.gp_delta_map.predict(self.traj_rotated, return_std=True)
        self.training_traj = self.traj_rotated + mean

        has_delta = getattr(self, "training_delta", None) is not None
        has_ori = getattr(self, "training_ori", None) is not None
        if has_delta or has_ori:
            J_psi, J_psi_var = self.gp_delta_map.derivative(self.traj_rotated, return_var=True)
            eye = torch.eye(J_psi.shape[-1], dtype=J_psi.dtype, device=J_psi.device)
            rot_gp = eye + J_psi  # I + J_Ψ
            J_gamma = self.affine_transform.derivative(self.training_traj_old)
        if has_delta:
            v_rot = J_gamma @ self._tensor(self.training_delta)[:, :, None]
            self.var_vel_transported = (J_psi_var @ v_rot**2)[:, :, 0]
            self.training_delta = (rot_gp @ v_rot)[:, :, 0]
        if has_ori:
            q_aff = quat.from_rotation_matrix(self.affine_transform.rotation_matrix)
            q_gp = quat.from_rotation_matrix(rot_gp)
            self.training_ori = quat.multiply(
                q_gp, quat.multiply(q_aff[None], self._tensor(self.training_ori)))

    def sample_transportation(self):
        return self.traj_rotated[None] + self.gp_delta_map.samples(self.traj_rotated)
