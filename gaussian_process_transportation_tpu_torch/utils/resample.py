"""Arc-length uniform resampling of polylines.

Port of ``gaussian_process_transportation_tpu/utils/resample.py``: linear
interpolation at arc lengths ``k · total/(num_points-1)``.  torch has no
``interp``, so it is ``torch.searchsorted`` plus a lerp, with
``jnp.interp``'s rules at the ends and on zero-length segments.
"""
from __future__ import annotations

import torch
from torch import Tensor


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp(x, xp, fp)`` for 1-D sorted ``xp``; fp may carry
    trailing columns (interpolated independently)."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    eps = torch.finfo(xp.dtype).eps
    flat = dx.abs() <= eps * eps  # jnp.interp: |dx| <= spacing(eps)
    w = (x - x0) / torch.where(flat, torch.ones_like(dx), dx)
    if fp.dim() > 1:
        w, flat = w[:, None], flat[:, None]
        below, above = (x < xp[0])[:, None], (x > xp[-1])[:, None]
    else:
        below, above = x < xp[0], x > xp[-1]
    f = torch.where(flat, f0, f0 + w * (f1 - f0))
    f = torch.where(below, fp[0], f)
    return torch.where(above, fp[-1], f)


def resample(surface: Tensor, num_points: int = 20, planar_metric: bool = False) -> Tensor:
    """(M, D) polyline → (num_points, D) points evenly spaced in arc length.

    ``planar_metric`` measures length in the first two coordinates only,
    as the original project's ``distance`` helper does for ≥3-D curves."""
    metric_part = surface[:, :2] if planar_metric else surface
    seg = torch.linalg.vector_norm(torch.diff(metric_part, dim=0), dim=1)
    cum = torch.cat([seg.new_zeros(1), torch.cumsum(seg, dim=0)])
    targets = torch.linspace(0.0, 1.0, num_points, dtype=surface.dtype,
                             device=surface.device) * cum[-1]
    return interp(targets, cum, surface)
