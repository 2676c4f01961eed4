"""Trajectory and distribution quality metrics on tensors.

Port of ``gaussian_process_transportation_tpu/utils/metrics.py``.  Every
function takes tensors on any device and returns a 0-d tensor there.

The two dynamic programs, DTW and the discrete Fréchet distance, fill the
(n, m) table of accumulated costs acc[i, j] = d_ij ⊕ min(acc[i, j−1],
acc[i−1, j], acc[i−1, j−1]) (⊕ is + for DTW and max for Fréchet), with the
first row the running sum (running max) of d_0j.  The JAX package sweeps
it row by row in nested ``lax.scan``s; cell by cell on the card that would
be n·m launches.  Here it is swept by anti-diagonals: cells with the same
i + j depend only on the two diagonals before them, so the table is
n + m − 1 vector steps, each a few launches over one diagonal.  Each cell
does the same arithmetic as the row sweep (min is exact), so on the same
distances the result is bitwise the row sweep's.
"""
from __future__ import annotations

import torch
from torch import Tensor


def _pairwise_dist(A: Tensor, B: Tensor) -> Tensor:
    """(n, m) Euclidean distances by the ‖a‖² + ‖b‖² − 2a·b expansion, as
    the JAX package computes them.  a·b is summed from the coordinates'
    products, not by a matrix product, whose fused multiply-adds round
    differently from the squares: a curve against itself gets distances of
    exactly 0, as in JAX, and not √ε."""
    ab = ((2.0 * A)[:, None, :] * B[None, :, :]).sum(-1)
    d2 = (A * A).sum(-1)[:, None] + (B * B).sum(-1)[None, :] - ab
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _skewed(D: Tensor) -> Tensor:
    """(n + m − 1, n) anti-diagonals of D: row k holds D[i, k − i] at column
    i, and inf where k − i is outside [0, m)."""
    n, m = D.shape
    i = torch.arange(n, device=D.device)
    j = torch.arange(n + m - 1, device=D.device)[:, None] - i[None, :]
    valid = (j >= 0) & (j < m)
    vals = D[i[None, :].expand_as(j), j.clamp(0, m - 1)]
    return torch.where(valid, vals, torch.full_like(vals, torch.inf))


def _wavefront(D: Tensor, first_row: Tensor, combine) -> Tensor:
    """acc[n − 1, m − 1] of the table whose first row is ``first_row`` and
    whose other cells are combine(d_ij, min(left, up, diag)), filled one
    anti-diagonal at a time."""
    n, m = D.shape
    steps = n + m - 1
    inf = torch.full((1,), torch.inf, dtype=D.dtype, device=D.device)
    Dk = _skewed(D)
    row0 = torch.cat([first_row, inf.expand(n - 1)])  # acc[0, k] on diagonal k
    prev2 = inf.expand(n)  # diagonal k − 2, indexed by the row i
    prev = inf.expand(n)  # diagonal k − 1
    for k in range(steps):
        # left = acc[i, j−1] = prev[i], up = acc[i−1, j] = prev[i−1],
        # diag = acc[i−1, j−1] = prev2[i−1]
        rest = combine(Dk[k, 1:], torch.minimum(torch.minimum(prev[1:], prev[:-1]), prev2[:-1]))
        prev2, prev = prev, torch.cat([row0[k:k + 1], rest])
    return prev[n - 1]


def dtw_distance(A: Tensor, B: Tensor) -> Tensor:
    """Dynamic time warping distance (sum of matched costs)."""
    D = _pairwise_dist(A, B)
    return _wavefront(D, torch.cumsum(D[0], 0), torch.add)


def frechet_distance(A: Tensor, B: Tensor) -> Tensor:
    """Discrete Fréchet distance (max of matched costs, minimized)."""
    D = _pairwise_dist(A, B)
    return _wavefront(D, torch.cummax(D[0], 0).values, torch.maximum)


def area_between_curves(A: Tensor, B: Tensor) -> Tensor:
    """Sum of the ribbon's triangle areas between two 2-D curves, both cut
    to their common length: triangles (A_i, A_i+1, B_i) and (B_i, B_i+1,
    A_i+1) for every step i."""
    m = min(A.shape[0], B.shape[0])
    A, B = A[:m], B[:m]

    def tri_area(p, q, r):
        return 0.5 * torch.abs((q[:, 0] - p[:, 0]) * (r[:, 1] - p[:, 1])
                               - (r[:, 0] - p[:, 0]) * (q[:, 1] - p[:, 1]))

    return (tri_area(A[:-1], A[1:], B[:-1]) + tri_area(B[:-1], B[1:], A[1:])).sum()


def final_position_error(A: Tensor, B: Tensor) -> Tensor:
    return torch.linalg.vector_norm(A[-1] - B[-1])


def final_angle_error(A: Tensor, B: Tensor) -> Tensor:
    """Angle between the final segment directions (the reference's FDA
    metric)."""
    a = A[-1] - A[-2]
    b = B[-1] - B[-2]
    norms = torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)
    cos = torch.dot(a, b) / torch.clamp(norms, min=1e-12)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def hausdorff_distance(A: Tensor, B: Tensor) -> Tensor:
    D = _pairwise_dist(A, B)
    return torch.maximum(D.min(1).values.max(), D.min(0).values.max())


def chamfer_distance(A: Tensor, B: Tensor) -> Tensor:
    D = _pairwise_dist(A, B)
    return D.min(1).values.mean() + D.min(0).values.mean()


def euclidean_distance(A: Tensor, B: Tensor) -> Tensor:
    """Mean pointwise distance between equal-length trajectories."""
    return torch.linalg.vector_norm(A - B, dim=1).mean()


def gaussian_kl_divergence(mean_p: Tensor, std_p: Tensor, mean_q: Tensor,
                           std_q: Tensor) -> Tensor:
    """Pointwise independent-Gaussian KL, summed: the comparison suite's
    trajectory-distribution divergence."""
    var_p = std_p**2 + 1e-12
    var_q = std_q**2 + 1e-12
    kl = 0.5 * (torch.log(var_q / var_p) + (var_p + (mean_p - mean_q) ** 2) / var_q - 1.0)
    return kl.sum()


def weighted_distribution_distance(mean_p: Tensor, std_p: Tensor, mean_q: Tensor,
                                   std_q: Tensor) -> Tensor:
    """The comparison suite's ``compute_distance``: per point
    sqrt(Σ_d Δ_d²/σ1_d² + Δ_d²/σ2_d²), averaged over the trajectory."""
    d2 = (mean_p - mean_q) ** 2
    return torch.sqrt((d2 / std_p**2 + d2 / std_q**2).sum(1)).mean()


def comparison_euclidean_distance(mean_p: Tensor, mean_q: Tensor) -> Tensor:
    """The comparison suite's ``compute_distance_euclidean``, which doubles
    the squared difference: √2 · mean ‖Δ‖."""
    d2 = (mean_p - mean_q) ** 2
    return torch.sqrt((2.0 * d2).sum(1)).mean()
