"""Obstacle geometry: Γ distance functions and modulation bases.

Port of ``gaussian_process_transportation_tpu/avoidance/geometry.py``.
Obstacles are a dataclass of (K, …) tensors, and every Γ and basis is
evaluated for all K obstacles and N agents at once by broadcasting over a
(K, N) grid, where the JAX package maps over the obstacles.  Mixed scenes
blend the ellipse's and the cuboid's Γ by the ``is_ellipse`` mask,
is_ell·Γ_ell + (1 − is_ell)·Γ_cub, exactly as JAX does: where one of the
two is not finite the blend is NaN in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor


@dataclass(frozen=True)
class Obstacles:
    """K 2-D obstacles, one row each.

    ``is_ellipse``: 1.0 for an ellipse, 0.0 for a cuboid, a float mask so
    mixed scenes stay one broadcast (both Γs are computed and blended)."""

    center: Tensor  # (K, 2)
    reference_point: Tensor  # (K, 2) in the obstacle frame
    axis_length: Tensor  # (K, 2) full axis lengths (d1, d2)
    orientation: Tensor  # (K,) degrees
    margin: Tensor  # (K,)
    repulsion_coeff: Tensor  # (K,)
    linear_velocity: Tensor  # (K, 2)
    angular_velocity: Tensor  # (K,) rad/s (0 = none)
    is_ellipse: Tensor  # (K,) 1.0 ellipse / 0.0 cuboid

    @staticmethod
    def from_dicts(obstacles: list, dtype: torch.dtype = torch.float64,
                   device="cuda") -> "Obstacles":
        """From the original project's list-of-dicts format (keys center,
        axis_length and optionally reference_point, orientation, margin,
        repulsion_coeff, linear_velocity, angular_velocity, shape), as
        ``dtype`` tensors on ``device``."""

        def get(o, k, d):
            v = o.get(k, d)
            return d if v is None else v

        def vec(key, default):
            return np.stack([np.asarray(get(o, key, default), float) for o in obstacles])

        def scalars(key, default):
            return np.asarray([float(get(o, key, default)) for o in obstacles])

        arrays = dict(
            center=vec("center", None),
            reference_point=vec("reference_point", np.zeros(2)),
            axis_length=vec("axis_length", None),
            orientation=scalars("orientation", 0.0),
            margin=scalars("margin", 0.0),
            repulsion_coeff=scalars("repulsion_coeff", 1.0),
            linear_velocity=vec("linear_velocity", np.zeros(2)),
            angular_velocity=scalars("angular_velocity", 0.0),
            is_ellipse=np.asarray([1.0 if o.get("shape", "ellipse") == "ellipse" else 0.0
                                   for o in obstacles]),
        )
        return Obstacles(**{k: torch.as_tensor(v, dtype=dtype, device=device)
                            for k, v in arrays.items()})

    def to(self, device=None, dtype=None) -> "Obstacles":
        """The same obstacles with every field moved by ``Tensor.to``."""
        return Obstacles(**{f.name: getattr(self, f.name).to(device=device, dtype=dtype)
                            for f in dataclasses.fields(self)})


def rotation2d(angle_rad: Tensor) -> Tensor:
    """(..., 2, 2) rotations by the angles (...)."""
    c, s = torch.cos(angle_rad), torch.sin(angle_rad)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _point(v: Tensor) -> Tensor:
    """A per-obstacle vector (..., 2) shaped against agents (..., N, 2)."""
    return v[..., None, :]


def _to_obstacle_frame(obs_center: Tensor, orientation_deg: Tensor, x: Tensor) -> Tensor:
    """x (N, 2) in the world → (..., N, 2) in each obstacle's frame."""
    R = rotation2d(orientation_deg * (math.pi / 180.0))
    return (x - _point(obs_center)) @ R  # == Rᵀ (x − c) row by row


def gamma_ellipse(x: Tensor, center: Tensor, axis_length: Tensor, orientation_deg: Tensor,
                  margin: Tensor) -> Tensor:
    """Γ of ellipses: ‖ζ − surface point‖ + 1 outside, ‖ζ‖/‖surface‖
    inside.  x (N, 2) and obstacles (..., 2), (...) → (..., N)."""
    z = _to_obstacle_frame(center, orientation_deg, x)
    semi = axis_length / 2.0
    circ = z / (_point(semi) + margin[..., None, None])
    pos_norm = torch.linalg.vector_norm(circ, dim=-1)
    safe = torch.clamp(pos_norm, min=1e-12)
    surface = z / safe[..., None]
    dist_surface = torch.linalg.vector_norm(surface, dim=-1)
    dist_z = torch.linalg.vector_norm(z, dim=-1)
    outside = dist_z > dist_surface
    d = torch.where(outside, torch.linalg.vector_norm(z - surface, dim=-1),
                    dist_z / torch.clamp(dist_surface, min=1e-12) - 1.0)
    return d + 1.0


def gamma_cuboid(x: Tensor, center: Tensor, axis_length: Tensor, orientation_deg: Tensor,
                 margin: Tensor) -> Tensor:
    """Γ of cuboids (rectangles) with a rounded margin: x (N, 2) and
    obstacles (..., 2), (...) → (..., N)."""
    z = _to_obstacle_frame(center, orientation_deg, x)
    semi = axis_length / 2.0
    margin = margin[..., None]
    rel = torch.abs(z) - _point(semi)  # (..., N, 2)
    any_out = (rel > 0).any(-1)
    dist_out = torch.linalg.vector_norm(torch.clamp(rel, min=0.0), dim=-1)
    surf_out = torch.where(dist_out > margin, dist_out - margin, margin - dist_out)
    d_in = margin - rel.max(-1).values
    z_norm = torch.linalg.vector_norm(z, dim=-1)
    surf_in = -(d_in / torch.clamp(z_norm + d_in, min=1e-12))
    dist_surface = torch.where(any_out, surf_out, surf_in)
    gamma_out = dist_surface + 1.0
    gamma_in = z_norm / torch.clamp(z_norm - dist_surface, min=1e-12)
    return torch.where(dist_surface < 0, gamma_in, gamma_out)


def _blend(is_ell: Tensor, ge: Tensor, gc: Tensor) -> Tensor:
    """is_ell·ge + (1 − is_ell)·gc with the per-obstacle mask (K,)."""
    is_ell = is_ell[:, None]
    return is_ell * ge + (1.0 - is_ell) * gc


def gamma(obs: Obstacles, x: Tensor) -> Tensor:
    """Γ for every obstacle and agent: (K, N)."""
    args = (x, obs.center, obs.axis_length, obs.orientation, obs.margin)
    return _blend(obs.is_ellipse, gamma_ellipse(*args), gamma_cuboid(*args))


def modulation_bases(obs: Obstacles, x: Tensor):
    """E (reference-direction basis), E_ortho (normal basis) and Γ for every
    (obstacle, agent): (K, N, 2, 2), (K, N, 2, 2), (K, N).

    Column 0 of E is r̂ (the direction from the reference point), column 1
    the tangent e = n × ẑ; E_ortho has n̂ in column 0."""
    R = rotation2d(obs.orientation * (math.pi / 180.0))  # (K, 2, 2)
    ref_world = (R @ obs.reference_point[:, :, None])[:, :, 0] + obs.center
    r = x - _point(ref_world)  # (K, N, 2)
    r_norm = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    r_hat = torch.where(r_norm > 0, r / torch.clamp(r_norm, min=1e-12),
                        torch.full_like(r, 0.5))

    z = (x - _point(obs.center)) @ R  # obstacle frame
    is_ell = obs.is_ellipse[:, None, None]
    # the ellipse's normal: the gradient of its level-set function
    d = _point(obs.axis_length + 2.0 * obs.margin[:, None])
    n_ell = 2.0 * z / d**2
    # the cuboid's normal: the offset beyond the face
    semi = _point(obs.axis_length / 2.0)
    n_cub = torch.where(torch.abs(z) > semi, z - semi * torch.sign(z), torch.zeros_like(z))
    n_vec = is_ell * n_ell + (1.0 - is_ell) * n_cub
    n_norm = torch.linalg.vector_norm(n_vec, dim=-1, keepdim=True)
    e_x = torch.tensor([1.0, 0.0], dtype=x.dtype, device=x.device)
    n_unit = torch.where(n_norm > 0, n_vec / torch.clamp(n_norm, min=1e-12), e_x)
    n_world = n_unit @ R.transpose(-1, -2)  # back to the world frame

    # tangent: e = n × ẑ in 2-D → (n_y, −n_x)
    e = torch.stack([n_world[..., 1], -n_world[..., 0]], -1)
    E_ortho = torch.stack([n_world, e], -1)  # columns [n, e]
    E = torch.stack([r_hat, e], -1)  # columns [r̂, e]
    return E, E_ortho, gamma(obs, x)


def obstacle_weights(gammas: Tensor) -> Tensor:
    """Multi-obstacle weights ω_k = Π_{i≠k}(Γ_i − 1) / Σ_j Π_{i≠j}(Γ_i − 1):
    gammas (K, N) → (K, N)."""
    K = gammas.shape[0]
    gm1 = gammas - 1.0
    others = ~torch.eye(K, dtype=torch.bool, device=gammas.device)  # [k, i]: i ≠ k
    numerators = torch.where(others[:, :, None], gm1[None], torch.ones_like(gm1)[None]).prod(1)
    denom = numerators.sum(0)
    return numerators / torch.clamp(denom, min=1e-30)
