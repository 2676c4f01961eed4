"""Laplacian trajectory editing.

Port of ``gaussian_process_transportation_tpu/models/laplacian_editing.py``
(the original project's Laplacian editing): the path- or cycle-graph
Laplacian of the trajectory (a cycle when its ends are closer than 5× its
longest segment), waypoints matched to distribution points, and the
soft-constrained system

    [L ]        [L X                        ]
    [P̂ ] P_s =  [X + Δ at matched waypoints]

solved in least squares: local differential coordinates are kept while
the matched waypoints move by (target − source).  Deterministic;
``predict`` returns the edited trajectory with a std of 1e-6.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from ..ops.assignment import match_waypoints


def is_cycle(training_traj: Tensor, factor: float = 5.0) -> bool:
    seg = torch.linalg.norm(training_traj[1:] - training_traj[:-1], dim=1)
    thr = factor * seg.max()
    return bool(torch.linalg.norm(training_traj[0] - training_traj[-1]) < thr)


def graph_laplacian(n: int, cycle: bool, dtype: torch.dtype = torch.float64,
                    device=None) -> Tensor:
    """The path or cycle graph's Laplacian, a dense (n, n) tensor."""
    main = torch.full((n,), 2.0, dtype=dtype, device=device)
    if not cycle:
        main[0] = main[-1] = 1.0
    off = torch.ones(n - 1, dtype=dtype, device=device)
    L = torch.diag(main) - torch.diag(off, 1) - torch.diag(off, -1)
    if cycle:
        L[0, -1] -= 1.0
        L[-1, 0] -= 1.0
    return L


def edit(training_traj: Tensor, source_distribution: Tensor, target_distribution: Tensor,
         mask_traj: Optional[np.ndarray] = None, mask_dist: Optional[np.ndarray] = None) -> Tensor:
    """The Laplacian-editing least-squares solution P_s (N, D)."""
    traj = training_traj
    n = traj.shape[0]
    L = graph_laplacian(n, is_cycle(traj), traj.dtype, traj.device)
    if mask_traj is None:
        mask_traj, mask_dist = match_waypoints(traj, source_distribution)
    mt = torch.as_tensor(mask_traj, device=traj.device)
    md = torch.as_tensor(mask_dist, device=traj.device)
    constraint = torch.zeros_like(traj)
    constraint[mt] = traj[mt] + target_distribution[md] - source_distribution[md]
    vect = torch.zeros(n, dtype=traj.dtype, device=traj.device)
    vect[mt] = 1.0
    A = torch.cat([L, torch.diag(vect)])
    B = torch.cat([L @ traj, constraint])
    return torch.linalg.lstsq(A, B).solution


class LaplacianEditing:
    """The original project's model interface over :func:`edit`."""

    def __init__(self):
        self.P_s: Optional[Tensor] = None

    def fit(self, source_distribution: Tensor, target_distribution: Tensor,
            training_traj: Tensor):
        self.training_traj = training_traj
        self.P_s = edit(training_traj, source_distribution, target_distribution)
        return self

    def predict(self, X, return_std: bool = False):
        mean = self.P_s
        if return_std:
            return mean, torch.full_like(mean, 1e-6)
        return mean

    def samples(self, X, n_samples: int = 10):
        return self.predict(X)[None].expand((n_samples,) + tuple(self.P_s.shape))
