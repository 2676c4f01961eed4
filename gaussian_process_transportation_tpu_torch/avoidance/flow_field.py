"""Obstacle flow-field warping.

Port of ``gaussian_process_transportation_tpu/avoidance/flow_field.py``:

* :func:`signed_distance` / :func:`sdf_gradient`: the polygon's signed
  distance (negative inside, by the winding number) and its normalized
  central-difference gradient, over (points × segments) at once;
* :func:`radial_project`: ray casting from the obstacle's center through
  each point onto the boundary;
* :func:`estimate_center_pca`: the PCA center and axes by an SVD;
* :class:`ObstacleFlowField`: a GP displacement field (the port's
  ``GaussianProcess``) pushing interior points to the boundary, the
  influence-limited space warp and the Jacobian velocity transform;
* the polygon samplers (numpy on the host, so both packages draw the same
  points from the same ``RandomState``) and two synthetic divergent flows.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from .. import kernels as K
from ..models.gp_regressor import GaussianProcess


# ---------------------------------------------------------------------------
# Polygon geometry
# ---------------------------------------------------------------------------

def _segments(boundary: Tensor) -> Tuple[Tensor, Tensor]:
    return boundary, torch.roll(boundary, -1, 0)


def signed_distance(boundary: Tensor, points: Tensor) -> Tensor:
    """(N,) signed distance of the points (N, 2) to the closed polygon
    ``boundary`` (S, 2), negative inside."""
    p1, p2 = _segments(boundary)
    seg = p2 - p1  # (S, 2)
    len_sq = torch.clamp((seg * seg).sum(1), min=1e-30)
    rel = points[:, None, :] - p1[None]  # (N, S, 2)
    t = torch.clamp((rel * seg[None]).sum(-1) / len_sq[None], 0.0, 1.0)
    proj = p1[None] + t[:, :, None] * seg[None]
    d = torch.linalg.vector_norm(points[:, None, :] - proj, dim=2).min(1).values

    # the sign: inside where the winding number is ±1
    v1 = p1[None] - points[:, None, :]
    v2 = p2[None] - points[:, None, :]
    dot = (v1 * v2).sum(2)
    det = v1[..., 0] * v2[..., 1] - v1[..., 1] * v2[..., 0]
    winding = torch.atan2(det, dot).sum(1)
    inside = torch.abs(torch.abs(winding) - 2 * math.pi) < 0.1
    return d * torch.where(inside, -1.0, 1.0).to(d.dtype)


def sdf_gradient(boundary: Tensor, points: Tensor, epsilon: float = 1e-6) -> Tensor:
    """Normalized central-difference gradient of the signed distance (N, 2)."""
    grads = []
    for i in range(points.shape[1]):
        off = torch.zeros_like(points)
        off[:, i] = epsilon
        grads.append((signed_distance(boundary, points + off)
                      - signed_distance(boundary, points - off)) / (2 * epsilon))
    g = torch.stack(grads, 1)
    n = torch.linalg.vector_norm(g, dim=1, keepdim=True)
    return torch.where(n > 1e-10, g / torch.clamp(n, min=1e-30), g)


def radial_project(boundary: Tensor, points: Tensor, center: Tensor) -> Tuple[Tensor, Tensor]:
    """Project the points onto the boundary along the ray center → point.

    Returns (projected (N, 2), ray distance (N,)); a point whose ray meets
    no segment stays where it is, at its distance from the center."""
    p1, p2 = _segments(boundary)
    seg = p2 - p1  # (S, 2)
    normal = torch.stack([-seg[:, 1], seg[:, 0]], 1)
    vec = points - center  # (N, 2)
    ray = vec / torch.clamp(torch.linalg.vector_norm(vec, dim=1, keepdim=True), min=1e-10)

    denom = ray @ normal.T  # (N, S)
    t_num = ((p1 - center) * normal).sum(1)  # (S,)
    t = t_num[None] / torch.where(torch.abs(denom) > 1e-10, denom,
                                  torch.full_like(denom, torch.inf))
    inter = center[None, None] + t[:, :, None] * ray[:, None, :]  # (N, S, 2)
    seg_t = ((inter - p1[None]) * seg[None]).sum(-1) / torch.clamp((seg * seg).sum(1),
                                                                   min=1e-30)[None]
    valid = (t > 0) & (seg_t >= 0) & (seg_t <= 1)
    t_masked = torch.where(valid, t, torch.full_like(t, torch.inf))
    best = t_masked.argmin(1)
    dist = torch.take_along_dim(t_masked, best[:, None], 1)[:, 0]
    proj = torch.take_along_dim(inter, best[:, None, None], 1)[:, 0]
    found = torch.isfinite(dist)
    proj = torch.where(found[:, None], proj, points)
    dist = torch.where(found, dist, torch.linalg.vector_norm(vec, dim=1))
    return proj, dist


def estimate_center_pca(boundary: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(center, components (2, 2) whose rows are the principal axes,
    dimensions (2,) the components' std lengths): PCA by an SVD of the
    centered boundary."""
    center = boundary.mean(0)
    _, S, Vt = torch.linalg.svd(boundary - center, full_matrices=False)
    return center, Vt, S / math.sqrt(boundary.shape[0])


# ---------------------------------------------------------------------------
# Flow field
# ---------------------------------------------------------------------------

class ObstacleFlowField:
    """GP displacement field pushing interior points to the boundary.

    A boundary (S, 2) that is a tensor stays where it is, in its dtype;
    one given as numpy or a list goes to ``device`` (the card unless the
    caller asks for the CPU) as float64.  The points given to the other
    methods go to the boundary's device in its dtype."""

    def __init__(
        self,
        boundary_points,
        kernel: Optional[K.Kernel] = None,
        alpha: float = 0.01,
        n_restarts: int = 2,
        device="cuda",
    ):
        if isinstance(boundary_points, Tensor):
            self.boundary = boundary_points
        else:
            self.boundary = torch.as_tensor(np.asarray(boundary_points), dtype=torch.float64,
                                            device=device)
        self.device = self.boundary.device
        self.center, self.components, self.dimensions = estimate_center_pca(self.boundary)
        if kernel is None:
            # fitted hyperparameters with the lengthscale bounded by the
            # obstacle's size: the displacement field flips sign across the
            # center, and with unbounded bounds the lengthscale collapses to
            # ~0 (interpolation), which kills the field's Jacobian off the data
            r = self.max_distance()
            r_val = float(r)
            kernel = (K.Constant(25.0) * K.RBF(r, bounds=(r_val / 4.0, 10.0 * r_val))
                      + K.White(0.01))
        self.gp = GaussianProcess(kernel=kernel, alpha=alpha, n_restarts_optimizer=n_restarts)

    def _tensor(self, value) -> Tensor:
        return torch.as_tensor(value, dtype=self.boundary.dtype, device=self.device)

    def project_using_sdf(self, points, max_iterations: int = 100,
                          tolerance: float = 1e-6) -> Tensor:
        """Newton steps p ← p − d(p)·∇d(p) on every point until all are
        within ``tolerance`` of the boundary or ``max_iterations`` steps
        ran; the host reads the "any not converged" flag once a step."""
        proj = self._tensor(points)
        self.project_iterations = 0
        for it in range(max_iterations):
            d = signed_distance(self.boundary, proj)
            if not bool((d.abs() >= tolerance).any()):
                break
            proj = proj - d[:, None] * sdf_gradient(self.boundary, proj)
            self.project_iterations = it + 1
        return proj

    def radial_projection(self, points) -> Tensor:
        return radial_project(self.boundary, self._tensor(points), self.center)[0]

    def learn_flow_field(self, points_inside):
        points_inside = self._tensor(points_inside)
        self.projected_boundary_points = self.radial_projection(points_inside)
        self.gp.fit(points_inside, self.projected_boundary_points - points_inside)
        return self

    def max_distance(self) -> Tensor:
        return torch.linalg.vector_norm(self.boundary - self.center, dim=1).max()

    def transform_space(self, points) -> Tuple[Tensor, Tensor]:
        """Warp the points near the obstacle by the learned displacement
        field, its influence limited to twice the obstacle's radius:
        (warped points, their std, 0 outside the influence)."""
        points = self._tensor(points)
        mask = torch.linalg.vector_norm(points - self.center, dim=1) <= self.max_distance() * 2.0
        disp, std = self.gp.predict(points, return_std=True)
        transformed = torch.where(mask[:, None], points + disp, points)
        uncertainties = torch.where(mask[:, None], std, torch.zeros_like(std))
        self.transformed_points = transformed
        return transformed, uncertainties

    def transform_velocity(self, points, velocities) -> Tensor:
        """v ← v + s(d)·J_Ψ v with a Gaussian radial influence s(d) =
        exp(−1.5 (d/σ)²), σ half the obstacle's radius, d measured from
        the warped points of the last ``transform_space`` (else these)."""
        points = self._tensor(points)
        velocities = self._tensor(velocities)
        J = self.gp.derivative(points)  # (N, P, D)
        max_dist = self.max_distance()
        ref_pts = getattr(self, "transformed_points", points)
        distances = torch.linalg.vector_norm(ref_pts - self.center, dim=1)
        near = distances <= max_dist * 2.0
        scale = torch.exp(-1.5 * (distances / (0.5 * max_dist)) ** 2)
        delta = (J @ velocities[:, :, None])[:, :, 0]
        return torch.where(near[:, None], velocities + scale[:, None] * delta, velocities)


# ---------------------------------------------------------------------------
# Samplers and synthetic flows
# ---------------------------------------------------------------------------

def sample_in_polygon(boundary: np.ndarray, num_samples: int, rng=None) -> np.ndarray:
    """Area-weighted triangle sampling through a Delaunay triangulation, on
    the host in numpy."""
    from scipy.spatial import Delaunay

    rng = rng or np.random.RandomState(0)
    pts = np.asarray(boundary)
    tri = Delaunay(pts)
    triangles = pts[tri.simplices]
    e1 = triangles[:, 1] - triangles[:, 0]
    e2 = triangles[:, 2] - triangles[:, 0]
    areas = np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) / 2
    counts = rng.multinomial(num_samples, areas / areas.sum())
    out = []
    for t, n in zip(triangles, counts):
        if n == 0:
            continue
        r1, r2 = rng.random(n), rng.random(n)
        s = np.sqrt(r1)
        bary = np.column_stack([1 - s, s * (1 - r2), s * r2])
        out.append(bary @ t)
    return np.vstack(out)


def sample_in_polygon_convex(boundary: np.ndarray, num_samples: int, rng=None) -> np.ndarray:
    rng = rng or np.random.RandomState(0)
    pts = np.asarray(boundary)
    w = rng.random((num_samples, len(pts)))
    w = w / w.sum(axis=1, keepdims=True)
    return w @ pts


def divergent_rotational_flow(boundary: Tensor, points_inside: Tensor) -> Tensor:
    """Half-radial, half-rotational flow decaying from the center."""
    center, _, _ = estimate_center_pca(boundary)
    v = points_inside - center
    d = torch.linalg.vector_norm(v, dim=1)
    radial = v / (d[:, None] + 1e-10)
    rot = torch.stack([-radial[:, 1], radial[:, 0]], 1)
    return (0.5 * radial + 0.5 * rot) * torch.exp(-0.1 * d)[:, None]


def shaped_divergent_flow(boundary: Tensor, points_inside: Tensor) -> Tensor:
    """Shape-aware divergent flow weighted by the PCA axes."""
    center, components, dims = estimate_center_pca(boundary)
    v = points_inside - center
    proj = torch.zeros_like(v)
    scaled_d2 = torch.zeros_like(v[:, 0])
    for i in range(2):
        c = components[i]
        coef = (v @ c) / dims[i]
        proj = proj + coef[:, None] * c[None, :]
        scaled_d2 = scaled_d2 + coef**2
    radial = proj / (torch.linalg.vector_norm(proj, dim=1, keepdim=True) + 1e-10)
    rot = torch.stack([-radial[:, 1], radial[:, 0]], 1)
    rw = 0.2 + 0.3 * dims.min() / dims.max()
    return (rw * radial + (1 - rw) * rot) * torch.exp(-0.5 * torch.sqrt(scaled_d2))[:, None]
