"""Dynamical-system modulation for obstacle avoidance.

Port of ``gaussian_process_transportation_tpu/avoidance/modulation.py``,
every function batched over agents (and obstacles):

* ``modulation_matrix_spherical`` / ``modulation_matrix_elliptic``: the
  closed-form single-obstacle matrices of the original project's 2-D
  examples;
* ``modulate_multiple``: the combined modulation M = Π_k E_k D_k E_k⁻¹
  with ω-weighted eigenvalues, the product taken in obstacle order;
* ``avoid``: the interpolation-moving avoidance (the obstacles' relative
  velocity, per-obstacle stretching with tangent repulsion, the
  directional weighted average, the magnitude reassembled), for every
  agent and obstacle at once;
* ``rollout``: the Euler rollout x ← x + M(x) f(x) dt into a preallocated
  (n_steps, N, 2) tensor.

The bases are 2×2, and they are inverted by their closed form (adjugate
over determinant), which like JAX's ``inv`` and ``solve`` never raises: a
singular basis gives non-finite entries.  ``torch.linalg.inv`` and
``solve`` would raise on the CPU and read an error flag back to the host
on the card.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from .directional import directional_weighted_sum
from .geometry import Obstacles, modulation_bases, obstacle_weights


def _inv2(E: Tensor) -> Tensor:
    """Inverses of (..., 2, 2) matrices by their closed form."""
    a, b, c, d = E[..., 0, 0], E[..., 0, 1], E[..., 1, 0], E[..., 1, 1]
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / (a * d - b * c)[..., None, None]


def _scale_columns(E: Tensor, lam1: Tensor, lam2: Tensor) -> Tensor:
    """E diag(λ₁, λ₂) for (..., 2, 2) E and (...) eigenvalues."""
    return E * torch.stack([lam1, lam2], -1)[..., None, :]


def modulation_matrix_spherical(state: Tensor, center: Tensor, radius: float) -> Tensor:
    """(N, 2, 2): M = E diag(1 ∓ (r/d)²) Eᵀ around a circle."""
    q = state - center.reshape(1, 2)
    d = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    n = q / torch.clamp(d, min=1e-12)
    e = torch.stack([-n[:, 1], n[:, 0]], -1)
    E = torch.stack([n, e], -1)  # (N, 2, 2)
    ratio = (radius / torch.clamp(d[:, 0], min=1e-12)) ** 2
    return _scale_columns(E, 1 - ratio, 1 + ratio) @ E.transpose(1, 2)


def modulation_matrix_elliptic(state: Tensor, center: Tensor, r1: float, r2: float,
                               m: int) -> Tensor:
    """(N, 2, 2) with Γ = (x/r1)^m + (y/r2)^m: the unnormalized-gradient
    basis and E⁻¹, as the original project has it.  At the exact center
    the gradient vanishes and E is singular: the identity there."""
    q = state - center.reshape(1, 2)
    gx = (m / r1**m) * q[:, 0] ** (m - 1)
    gy = (m / r2**m) * q[:, 1] ** (m - 1)
    n = torch.stack([gx, gy], -1)  # (N, 2) unnormalized
    e = torch.stack([n[:, 1], -n[:, 0]], -1)  # e = n × ẑ
    E = torch.stack([n, e], -1)
    d = torch.abs((q[:, 0] / r1) ** m + (q[:, 1] / r2) ** m)
    inv_d = 1.0 / torch.clamp(d, min=1e-12)
    M = _scale_columns(E, 1 - inv_d, 1 + inv_d) @ _inv2(E)
    singular = torch.linalg.vector_norm(n, dim=1) < 1e-12
    eye = torch.eye(2, dtype=M.dtype, device=M.device)
    return torch.where(singular[:, None, None], eye, M)


def modulate_multiple(obs: Obstacles, state: Tensor) -> Tensor:
    """(N, 2, 2) combined modulation M = Π_k E_k D_k E_k⁻¹ with
    λ = 1 ∓ ω_k/Γ_k, multiplied in obstacle order."""
    E, _, gammas = modulation_bases(obs, state)  # (K, N, 2, 2), (K, N)
    ratio = obstacle_weights(gammas) / gammas
    M_k = _scale_columns(E, 1.0 - ratio, 1.0 + ratio) @ _inv2(E)  # (K, N, 2, 2)
    M = torch.eye(2, dtype=state.dtype, device=state.device).expand_as(M_k[0])
    for k in range(M_k.shape[0]):
        M = M @ M_k[k]
    return M


def _relative_obstacle_velocity(obs: Obstacles, x: Tensor, E_ortho: Tensor, gammas: Tensor,
                                weights: Tensor) -> Tensor:
    """The weighted velocity of the obstacle field at each agent (N, 2):
    the rotation ω × (x − c) and the outward normal part of each
    obstacle's linear velocity, each fading with exp(−(Γ − 1))."""
    rel = x[None] - obs.center[:, None]  # (K, N, 2)
    xd_w = obs.angular_velocity[:, None, None] * torch.stack([-rel[..., 1], rel[..., 0]], -1)
    w_ang = torch.exp(-(torch.clamp(gammas, min=1.0) - 1.0))
    normal = E_ortho[..., :, 0]  # (K, N, 2)
    lin_local0 = (normal * obs.linear_velocity[:, None]).sum(-1)
    lin_proj = 1.3 * lin_local0[..., None] * normal  # along the outward normal
    linear_velocity = torch.where((lin_local0 >= 0)[..., None], lin_proj,
                                  torch.zeros_like(lin_proj))
    w_lin = torch.exp(-(torch.clamp(gammas, min=1.0) - 1.0))
    contrib = w_lin[..., None] * linear_velocity + w_ang[..., None] * xd_w
    return (weights[..., None] * contrib).sum(0)


def avoid(obs: Obstacles, state: Tensor, velocity: Tensor, cut_off_gamma: float = 1e6) -> Tensor:
    """Interpolation-moving avoidance: (N, 2) modulated velocities of the
    agents ``state`` (N, 2) moving at ``velocity`` (N, 2)."""
    E, E_ortho, gammas = modulation_bases(obs, state)  # (K, N, ...)
    omega = obstacle_weights(gammas)
    lam1 = 1.0 - 1.0 / gammas
    lam2 = 1.0 + 1.0 / gammas

    xd_obs = _relative_obstacle_velocity(obs, state, E_ortho, gammas, omega)
    rel_v = velocity - xd_obs  # (N, 2)
    rel_norm = torch.linalg.vector_norm(rel_v, dim=-1)

    # each obstacle's stretch of the relative velocity, in its basis E
    t = (_inv2(E) @ rel_v[None, :, :, None])[..., 0]  # (K, N, 2)
    s = torch.stack([lam1, lam2], -1) * t
    # tangent repulsion where λ₁ < 0 (the agent inside the margin)
    push = torch.where(lam1 < 0, -lam1 * torch.abs(t[..., 1]) * 2.0, torch.zeros_like(lam1))
    s = torch.stack([s[..., 0] + push, s[..., 1]], -1)
    v_hat = (E @ s[..., None])[..., 0]  # (K, N, 2)
    # repulsion_coeff > 1 with inward motion keeps the raw velocity
    inward = (E_ortho[..., :, 0] * rel_v[None]).sum(-1) < 0
    keep_raw = (obs.repulsion_coeff[:, None] > 1.0) & inward
    v_hat = torch.where(keep_raw[..., None], rel_v[None], v_hat)

    mag = torch.linalg.vector_norm(v_hat, dim=-1)  # (K, N)
    v_hat_n = torch.where(mag[..., None] > 0, v_hat / torch.clamp(mag, min=1e-12)[..., None],
                          torch.zeros_like(v_hat))
    w_active = torch.where(gammas < cut_off_gamma, omega, torch.zeros_like(omega))

    rel_dir = rel_v / torch.clamp(rel_norm, min=1e-12)[:, None]
    weighted_dir = directional_weighted_sum(rel_dir, v_hat_n.permute(1, 2, 0), w_active.T)
    final_mag = (mag * w_active).sum(0)
    out = final_mag[:, None] * weighted_dir + xd_obs
    return torch.where(rel_norm[:, None] > 0, out, xd_obs)


def rollout(
    velocity_fn: Callable[[Tensor], Tensor],
    modulation_fn: Callable[[Tensor], Tensor],
    x0: Tensor,
    n_steps: int,
    dt: float = 1.0,
) -> Tensor:
    """Euler rollout of the modulated DS, x ← x + M(x) f(x) dt, into a
    preallocated (n_steps, N, 2) tensor (the states after each step).

    velocity_fn: (N, 2) → (N, 2); modulation_fn: (N, 2) → (N, 2, 2)."""
    traj = x0.new_empty((n_steps,) + tuple(x0.shape))
    x = x0
    for i in range(n_steps):
        M = modulation_fn(x)
        v = velocity_fn(x)
        x = x + (M @ v[:, :, None])[:, :, 0] * dt
        traj[i] = x
    return traj
