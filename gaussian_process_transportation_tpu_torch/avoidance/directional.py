"""Directional-space algebra on the unit sphere, any dimension D.

Port of ``gaussian_process_transportation_tpu/avoidance/directional.py``.
Every function takes leading batch axes (one direction per agent, say),
where the JAX package takes one vector and maps over the batch:

* ``orthogonal_basis``: (..., D, D) orthonormal bases with the direction
  as column 0 (D = 2: the tangent (−v₁, v₀); D ≥ 3: a Householder
  completion);
* ``angle_from_vector`` / ``vector_from_angle``: the log and exp maps
  between a direction and its (D−1,) angle coordinates in a base's tangent
  space;
* ``invert_normal``: the angle coordinates of the same direction against
  the negated base (|a′| = π − |a|, the tangent flipped);
* ``transform_to_base``: re-express angle coordinates in another base,
  optionally keeping multi-revolution windup;
* ``directional_weighted_sum``: the weighted mean of directions in the
  tangent space of a null direction, mapped back by the exp map.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor


def _norm(v: Tensor, keepdim: bool = False) -> Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _unit_or_zero(v: Tensor) -> Tensor:
    """v/‖v‖ where ‖v‖ > 1e-12, else 0."""
    n = _norm(v, keepdim=True)
    return torch.where(n > 1e-12, v / torch.clamp(n, min=1e-12), torch.zeros_like(v))


def _matvec(M: Tensor, v: Tensor) -> Tensor:
    """M (..., R, C) times v (..., C) → (..., R)."""
    return (M @ v[..., None])[..., 0]


def orthogonal_basis(vector: Tensor) -> Tensor:
    """(..., D, D) orthonormal bases with the normalized vectors (..., D) as
    column 0 (the first axis where a vector is zero).

    D = 2 keeps the tangent convention (−v₁, v₀); D ≥ 3 takes the
    Householder reflection that maps e₁ to n, scaled so that column 0 is n:
    orthonormal by construction in any dimension."""
    d = vector.shape[-1]
    norm = _norm(vector, keepdim=True)
    e1 = torch.zeros(d, dtype=vector.dtype, device=vector.device)
    e1[0] = 1.0
    n = torch.where(norm > 1e-12, vector / torch.clamp(norm, min=1e-12), e1)
    if d == 1:
        return n[..., None, :]
    if d == 2:
        t = torch.stack([-n[..., 1], n[..., 0]], -1)
        return torch.stack([n, t], -1)
    # v = n + s·e₁ maps e₁ → −s·n under H = I − 2vvᵀ/‖v‖²; −s·H's column 0 is n
    s = torch.where(n[..., 0] >= 0, 1.0, -1.0).to(n.dtype)
    v = torch.cat([(n[..., 0] + s)[..., None], n[..., 1:]], -1)
    eye = torch.eye(d, dtype=n.dtype, device=n.device)
    H = eye - (2.0 / (v * v).sum(-1))[..., None, None] * (v[..., :, None] * v[..., None, :])
    return -s[..., None, None] * H


def angle_from_vector(direction: Tensor, base: Tensor, cos_margin: float = 1e-9) -> Tensor:
    """Log map: directions (..., D) → angle coordinates (..., D−1) in the
    bases (..., D, D): a = arccos(d·n̂) · t̂, t̂ the unit tangent
    coordinates of d."""
    d = direction / torch.clamp(_norm(direction, keepdim=True), min=1e-12)
    n = base[..., :, 0]
    Bt = base[..., :, 1:]
    cos_phi = torch.clamp((d * n).sum(-1), -1.0 + cos_margin, 1.0 - cos_margin)
    phi = torch.arccos(cos_phi)
    tang = _matvec(Bt.transpose(-1, -2), d)
    return phi[..., None] * _unit_or_zero(tang)


def vector_from_angle(angle: Tensor, base: Tensor) -> Tensor:
    """Exp map: angle coordinates (..., D−1) → unit vectors (..., D):
    v = cos|a|·n̂ + sin|a|·B_t â."""
    n = base[..., :, 0]
    Bt = base[..., :, 1:]
    a_norm = _norm(angle, keepdim=True)
    return torch.cos(a_norm) * n + torch.sin(a_norm) * _matvec(Bt, _unit_or_zero(angle))


def invert_normal(angle: Tensor) -> Tensor:
    """Angle coordinates (..., D−1) of the same directions against the
    negated bases (pair with base → −base): |a′| = π − |a|, the tangent
    coordinates' sign flipped; at |a| = 0, π along the first axis."""
    a_norm = _norm(angle, keepdim=True)
    scale = math.pi - a_norm
    center = torch.zeros_like(angle)
    center[..., 0] = math.pi
    return torch.where(a_norm > 1e-12, -_unit_or_zero(angle) * scale, center)


def transform_to_base(
    angle: Tensor,
    old_base: Tensor,
    new_base: Tensor,
    track_windup: bool = False,
    windup_max: int = 3,
) -> Tensor:
    """Re-express angle coordinates against another base.

    With ``track_windup=False`` the plain re-projection through the sphere:
    the principal representative (|a| ≤ π).  With ``track_windup=True``,
    when the rebased angle seems to have crossed the ±π cut (its distance
    to the old normal's image exceeds |angle| by more than π/2), the 2π·k
    windup along its direction (|k| ≤ ``windup_max``) nearest to the old
    normal's image: every candidate is the same direction, only the chart
    changes, so angle paths stay continuous across the cut."""
    v = vector_from_angle(angle, old_base)
    a_new = angle_from_vector(v, new_base)
    if not track_windup:
        return a_new
    normal_img = angle_from_vector(old_base[..., :, 0], new_base)
    dist = _norm(a_new - normal_img)
    crossed = (dist - _norm(angle)) > (math.pi / 2)
    a_norm = _norm(a_new, keepdim=True)
    nrm = _norm(normal_img, keepdim=True)
    unit = torch.where(a_norm > 1e-12, a_new / torch.clamp(a_norm, min=1e-12),
                       normal_img / torch.clamp(nrm, min=1e-12))
    ks = torch.arange(-windup_max, windup_max + 1, dtype=a_new.dtype, device=a_new.device)
    # the candidates (..., 2W+1, D−1)
    cands = unit[..., None, :] * (a_norm + 2.0 * math.pi * ks)[..., :, None]
    dists = _norm(cands - normal_img[..., None, :])
    best = torch.take_along_dim(cands, dists.argmin(-1)[..., None, None], dim=-2)[..., 0, :]
    return torch.where(crossed[..., None], best, a_new)


def directional_weighted_sum(null_direction: Tensor, directions: Tensor,
                             weights: Tensor) -> Tensor:
    """Weighted directional mean relative to ``null_direction`` (..., D),
    which need not be unit: directions (..., D, K) unit-ish columns,
    weights (..., K) non-negative → (..., D).  Zero-weight and zero-norm
    columns are ignored."""
    base = orthogonal_basis(null_direction)  # (..., D, D)
    n = base[..., :, 0]
    Bt = base[..., :, 1:]  # (..., D, D−1) tangent basis

    norms = torch.linalg.vector_norm(directions, dim=-2)  # (..., K)
    valid = (weights > 0) & (norms > 0)
    dirs = torch.where(valid[..., None, :],
                       directions / torch.clamp(norms, min=1e-12)[..., None, :],
                       torch.zeros_like(directions))
    w = torch.where(valid, weights, torch.zeros_like(weights))

    cos_phi = torch.clamp((dirs * n[..., :, None]).sum(-2), -1.0, 1.0)  # (..., K)
    phi = torch.arccos(cos_phi)
    tang = Bt.transpose(-1, -2) @ dirs  # (..., D−1, K)
    tang_norm = torch.linalg.vector_norm(tang, dim=-2)
    t_hat = torch.where(tang_norm[..., None, :] > 1e-12,
                        tang / torch.clamp(tang_norm, min=1e-12)[..., None, :],
                        torch.zeros_like(tang))
    angles = t_hat * phi[..., None, :]  # (..., D−1, K)
    return vector_from_angle(_matvec(angles, w), base)
