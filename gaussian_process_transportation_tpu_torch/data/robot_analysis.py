"""Offline analysis of recorded robot experiments.

Port of ``gaussian_process_transportation_tpu/data/robot_analysis.py``:
given recorded target distributions (point clouds over repetitions of a
task), the pairwise generalization matrices (Hausdorff, Chamfer, max
squared error and PCA-aligned distances) and force-norm traces from
recorded wrenches.  The recordings are read from a results directory
(pickles of arrays); the metrics run on ``device`` (the card unless the
caller asks for the CPU) through :mod:`..utils.metrics`.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils import metrics


def load_recorded_distributions(directory: str) -> List[np.ndarray]:
    """The point sets ``source.pkl`` and ``target_0.pkl``, ``target_1.pkl``,
    … of a results directory, in that order."""
    out = []
    src = os.path.join(directory, "source.pkl")
    if os.path.exists(src):
        with open(src, "rb") as f:
            out.append(np.asarray(pickle.load(f)))
    i = 0
    while True:
        path = os.path.join(directory, f"target_{i}.pkl")
        if not os.path.exists(path):
            break
        with open(path, "rb") as f:
            out.append(np.asarray(pickle.load(f)))
        i += 1
    return out


def _pca_align(p: torch.Tensor) -> torch.Tensor:
    c = p - p.mean(0)
    _, _, Vt = torch.linalg.svd(c, full_matrices=False)
    return c @ Vt.T


def distribution_distance_matrices(point_sets: Sequence[np.ndarray],
                                   device="cuda") -> Dict[str, np.ndarray]:
    """Pairwise Hausdorff, Chamfer, max-squared-error and PCA matrices of
    the point sets, in float64 on ``device``; the last two are NaN for sets
    of different shapes."""
    n = len(point_sets)
    sets = [torch.as_tensor(np.asarray(p, dtype=np.float64), device=device) for p in point_sets]
    out = {key: np.zeros((n, n)) for key in ("hausdorff", "chamfer", "max_mse", "pca")}
    for i in range(n):
        for j in range(n):
            a, b = sets[i], sets[j]
            out["hausdorff"][i, j] = float(metrics.hausdorff_distance(a, b))
            out["chamfer"][i, j] = float(metrics.chamfer_distance(a, b))
            if a.shape == b.shape:
                out["max_mse"][i, j] = float(((a - b) ** 2).sum(1).max())
                pa, pb = _pca_align(a), _pca_align(b)
                out["pca"][i, j] = float(((pa - pb) ** 2).sum(1).mean())
            else:
                out["max_mse"][i, j] = np.nan
                out["pca"][i, j] = np.nan
    return out


def force_norm_trace(recording: Dict[str, np.ndarray], rate_hz: float = 20.0):
    """(time, ‖F‖) from a recorded wrench array (``recorded_force_torque``
    with rows Fx, Fy, Fz, …, or those columns)."""
    ft = np.asarray(recording["recorded_force_torque"])
    force = ft[:3] if ft.shape[0] in (3, 6) else ft[:, :3].T
    norm = np.linalg.norm(force, axis=0)
    t = np.arange(len(norm)) / rate_hz
    return t, norm
