"""Surfaces comparison harness.

Port of ``gaussian_process_transportation_tpu/benchmarks/comparison.py``:
every transport method runs on the same drawing, and the three
cross-method matrices of the original project's tables come out (KL
divergence, the weighted distribution distance and the Euclidean
distance).  The transports and the metrics run on ``device`` (the card
unless the caller asks for the CPU) in the drawing's dtype; the results
come back as numpy, as JAX's do.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import kernels as K
from ..transport import (
    EnsembleBijectiveTransport,
    GaussianProcessTransportation,
    KMPTransport,
    LaplacianEditingTransport,
    MLPTransport,
    RandomForestTransport,
)
from ..utils import metrics
from ..utils.resample import resample


def default_methods(device="cuda") -> Dict[str, object]:
    """The original project's six methods with its kernel settings, on
    ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    k_transport = (
        K.Constant(math.sqrt(0.1), bounds=(0.1, 2.0))
        * K.RBF(10.0 * torch.ones(2, **f64), bounds=(5.0, 500.0))
        + K.White(1e-4)
    )
    k_kmp = (
        K.Constant(0.1, bounds=(0.1, 2.0))
        * K.RBF(torch.tensor([0.1], **f64), bounds=(0.05, 0.1))
        + K.White(1e-5, bounds=(1e-5, 0.1))
    )
    return {
        "Kernelized Movement Primitives": KMPTransport(kernel=k_kmp, device=device),
        "Ensemble Random Forest": RandomForestTransport(device=device),
        "Ensemble Neural Network": MLPTransport(device=device),
        "Laplacian Editing": LaplacianEditingTransport(device=device),
        "Ensemble Neural Flows": EnsembleBijectiveTransport(device=device),
        "Gaussian Process Regression": GaussianProcessTransportation(
            kernel_transport=k_transport, device=device),
    }


def run_comparison(
    demo: np.ndarray,
    source: np.ndarray,
    target: np.ndarray,
    methods: Optional[Dict[str, object]] = None,
    n_traj: int = 100,
    n_dist: int = 100,
    device="cuda",
) -> Dict[str, object]:
    """Fit and apply every method (``default_methods(device)`` when None)
    on the demo and the source and target surfaces, each resampled by arc
    length; returns the trajectories, the stds (floored at 1e-6) and the
    three cross-method matrices."""
    put = lambda a: torch.as_tensor(np.asarray(a), device=device)
    X = resample(put(demo), num_points=n_traj)
    S = resample(put(source), num_points=n_dist)
    S1 = resample(put(target), num_points=n_dist)
    dX = torch.zeros_like(X)
    dX[:-1] = torch.diff(X, dim=0)

    methods = methods or default_methods(device)
    trajs, stds = {}, {}
    for name, tr in methods.items():
        tr.source_distribution = S
        tr.target_distribution = S1
        tr.training_traj = X.clone()
        tr.training_delta = dX.clone()
        tr.fit_transportation()
        tr.apply_transportation()
        trajs[name] = torch.as_tensor(tr.training_traj)
        stds[name] = torch.clamp(torch.as_tensor(tr.std), min=1e-6)

    names = list(methods)
    n = len(names)
    divergence = np.zeros((n, n))
    distribution_distance = np.zeros((n, n))
    euclidean = np.zeros((n, n))
    for i, a in enumerate(names):
        for j, b in enumerate(names):
            divergence[i, j] = float(
                metrics.gaussian_kl_divergence(trajs[a], stds[a], trajs[b], stds[b]))
            distribution_distance[i, j] = float(
                metrics.weighted_distribution_distance(trajs[a], stds[a], trajs[b], stds[b]))
            euclidean[i, j] = float(metrics.comparison_euclidean_distance(trajs[a], trajs[b]))
    return {
        "names": names,
        "trajectories": {k: v.cpu().numpy() for k, v in trajs.items()},
        "stds": {k: v.cpu().numpy() for k, v in stds.items()},
        "divergence": divergence,
        "distribution_distance": distribution_distance,
        "euclidean_distance": euclidean,
    }


def save_array_as_latex(array: np.ndarray, path: str, names: Optional[List[str]] = None):
    """The matrix as a LaTeX tabular, one row a method."""
    with open(path, "w") as f:
        f.write("\\begin{tabular}{" + "c" * (array.shape[1] + 1) + "}\n")
        for i, row in enumerate(array):
            label = names[i] if names else str(i)
            f.write(label + " & " + " & ".join(f"{v:.2f}" for v in row) + " \\\\\n")
        f.write("\\end{tabular}\n")
