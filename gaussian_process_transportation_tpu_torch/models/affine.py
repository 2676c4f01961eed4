"""Kabsch/Procrustes affine alignment (γ in Φ = γ + Ψ∘γ).

Port of ``gaussian_process_transportation_tpu/models/affine.py``: centroid
alignment, SVD rotation with the reflection fix, optional uniform
least-squares scale, identity rotation when there are fewer points than
dimensions.  ``AffineParams`` fields may carry a leading ensemble axis E
(what ``fit_batched`` returns); ``predict`` and ``derivative`` broadcast
over it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor


@dataclass(frozen=True)
class AffineParams:
    rotation: Tensor  # (..., D, D)
    scale: Tensor  # (...)
    source_centroid: Tensor  # (..., D)
    target_centroid: Tensor  # (..., D)


def _kabsch_rotation(H: Tensor) -> Tensor:
    """The rotation in SO(D) that best maps Xc onto Yc, for H (..., D, D) =
    Xcᵀ Yc: R = V Uᵀ from the SVD, with V's last column flipped where
    det(V Uᵀ) < 0."""
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    R = V @ U.transpose(-1, -2)
    sign = torch.where(torch.linalg.det(R) < 0, -1.0, 1.0).to(H.dtype)
    V = torch.cat([V[..., :, :-1], V[..., :, -1:] * sign[..., None, None]], dim=-1)
    return V @ U.transpose(-1, -2)


def _ls_scale(Xc_rot: Tensor, Yc: Tensor) -> Tensor:
    return (Xc_rot * Yc).sum((-2, -1)) / (Xc_rot * Xc_rot).sum((-2, -1))


def fit(
    source_points: Tensor,
    target_points: Tensor,
    do_scale: bool = False,
    do_rotation: bool = True,
) -> AffineParams:
    if source_points.shape != target_points.shape:
        raise ValueError(
            f"source and target point sets must have matching shapes; got "
            f"{tuple(source_points.shape)} vs {tuple(target_points.shape)}"
        )
    n, d = source_points.shape
    cs = source_points.mean(0)
    ct = target_points.mean(0)
    Xc = source_points - cs
    Yc = target_points - ct
    if do_rotation and n >= d:
        R = _kabsch_rotation(Xc.T @ Yc)
    else:
        R = torch.eye(d, dtype=source_points.dtype, device=source_points.device)
    if do_scale:
        scale = _ls_scale(Xc @ R.T, Yc)
    else:
        scale = torch.ones((), dtype=source_points.dtype, device=source_points.device)
    return AffineParams(rotation=R, scale=scale, source_centroid=cs, target_centroid=ct)


def predict(params: AffineParams, x: Tensor) -> Tensor:
    """γ(x) = s·R(x − c_S) + c_T; x (Q, D) or (..., Q, D) → (..., Q, D)."""
    return (
        params.scale[..., None, None]
        * (x - params.source_centroid[..., None, :])
        @ params.rotation.transpose(-1, -2)
        + params.target_centroid[..., None, :]
    )


def derivative(params: AffineParams, x: Tensor) -> Tensor:
    """J_γ = s·R per query point, broadcast to (..., Q, D, D)."""
    J = params.scale[..., None, None] * params.rotation
    return J[..., None, :, :].expand(J.shape[:-2] + (x.shape[-2],) + J.shape[-2:])


def fit_batched(
    source_points: Tensor,
    target_points: Tensor,
    do_scale: bool = False,
    do_rotation: bool = True,
) -> AffineParams:
    """Kabsch fit of one source (n, D) against targets (E, n, D); every
    field of the result has a leading E axis.

    For D = 2 the SO(2) optimum is closed-form, the angle
    atan2(H01 − H10, H00 + H11), identical to the SVD with reflection fix.
    Other D take a batched SVD."""
    n, d = source_points.shape
    E = target_points.shape[0]
    cs = source_points.mean(0)  # (D,)
    ct = target_points.mean(1)  # (E, D)
    Xc = source_points - cs  # (n, D)
    Yc = target_points - ct[:, None, :]  # (E, n, D)
    H = torch.einsum("na,enb->eab", Xc, Yc)  # (E, D, D)
    if not do_rotation or n < d:
        R = torch.eye(d, dtype=H.dtype, device=H.device).expand(E, d, d).clone()
    elif d == 2:
        theta = torch.atan2(H[:, 0, 1] - H[:, 1, 0], H[:, 0, 0] + H[:, 1, 1])
        c, s = torch.cos(theta), torch.sin(theta)
        R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    else:
        R = _kabsch_rotation(H)
    if do_scale:
        scale = _ls_scale(torch.einsum("na,eba->enb", Xc, R), Yc)
    else:
        scale = H.new_ones(E)
    return AffineParams(
        rotation=R,
        scale=scale,
        source_centroid=cs.expand(E, d),
        target_centroid=ct,
    )
