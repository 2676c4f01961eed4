"""Multi-reference-frame benchmark (the paper's quantitative study).

Port of ``gaussian_process_transportation_tpu/benchmarks/multi_frame.py``:
each method reproduces demo i under the frame configuration of demo k,
scored by the Fréchet distance, the area between the curves, DTW, and the
final position and angle errors in the goal frame; plus an
out-of-distribution study on randomly perturbed frames.

The transports and the metrics run on ``device`` (the card unless the
caller asks for the CPU) in the dataset's float64; the (source, target)
sweep is a host loop, and the results come back as numpy, as JAX's do.
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, Optional

import numpy as np
import torch

from .. import kernels as K
from ..data.datasets import (
    distribution_from_frames,
    generate_frame_orientation,
    load_reach_target,
)
from ..transport.gpt import GaussianProcessTransportation
from ..utils import metrics


def default_mrf_kernel(device="cuda") -> K.Kernel:
    """C(√10)·RBF(20, bounds [10, 50]) + White(0.01, bounds ~fixed), its
    lengthscale on ``device``."""
    return (
        K.Constant(math.sqrt(10.0))
        * K.RBF(20.0 * torch.ones(1, dtype=torch.float64, device=device), bounds=(10.0, 50.0))
        + K.White(0.01, bounds=(1e-7, 1e-6))
    )


class _FrameDataset:
    """The reach-target demonstrations, their frames, their 10-point frame
    distributions and each demo's final position and heading in its goal
    frame."""

    def load_dataset(self, path: Optional[str] = None):
        d = load_reach_target(path)
        self.demos_x = d["x"]
        self.demos_A = d["A"]
        self.demos_b = d["b"]
        self.distribution_training_set = distribution_from_frames(d["A"], d["b"])
        n = len(self.demos_x)
        self.final_distance = np.zeros((n, 2))
        self.final_orientation = np.zeros(n)
        for i in range(n):
            A1 = np.asarray(self.demos_A[i][0][1])
            b1 = np.asarray(self.demos_b[i][0][1])
            self.final_distance[i] = np.linalg.inv(A1) @ (self.demos_x[i][-1] - b1)
            fd = np.linalg.inv(A1) @ (self.demos_x[i][-1] - self.demos_x[i][-2])
            self.final_orientation[i] = np.arctan2(fd[1], fd[0])

    def _final_errors(self, X1: np.ndarray, A1, b1, index: int):
        """The final position and angle errors of X1 in the frame (A1, b1)
        against demo ``index``'s."""
        A1_inv = np.linalg.inv(np.asarray(A1))
        fd = A1_inv @ (X1[-1] - np.asarray(b1))
        fde = float(np.linalg.norm(self.final_distance[index] - fd))
        fv = A1_inv @ (X1[-1] - X1[-5])
        fda = float(np.abs(np.arctan2(fv[1], fv[0]) - self.final_orientation[index]))
        return fde, fda

    def _metrics(self, X1, index_target: int):
        """(Fréchet, area, DTW, final position error, final angle error) of
        the reproduction X1 against demo ``index_target``."""
        ref = torch.as_tensor(np.asarray(self.demos_x[index_target]), device=self.device)
        got = torch.as_tensor(X1, dtype=ref.dtype, device=self.device)
        df = float(metrics.frechet_distance(ref, got))
        area = float(metrics.area_between_curves(ref, got))
        dtw = float(metrics.dtw_distance(ref, got))
        fde, fda = self._final_errors(np.asarray(X1), self.demos_A[index_target][0][1],
                                      self.demos_b[index_target][0][1], index_target)
        return df, area, dtw, fde, fda


class MultipleReferenceFramesGPT(_FrameDataset):
    def __init__(self, kernel: Optional[K.Kernel] = None, device="cuda", **gp_kwargs):
        self.device = torch.device(device)
        self.kernel = kernel if kernel is not None else default_mrf_kernel(self.device)
        self.gp_kwargs = gp_kwargs

    def load_test_dataset(self, test_A, test_b):
        self.distribution_test_set = distribution_from_frames(test_A, test_b)
        self.test_A = test_A
        self.test_b = test_b

    def _transport(self, X, source_dist, target_dist):
        tr = GaussianProcessTransportation(kernel_transport=self.kernel, device=self.device,
                                           **self.gp_kwargs)
        tr.source_distribution = source_dist
        tr.target_distribution = target_dist
        tr.training_traj = X
        tr.fit_transportation(do_scale=True, do_rotation=True)
        tr.apply_transportation()
        return tr.training_traj.cpu().numpy(), tr.std.cpu().numpy()

    def reproduce(self, index_source: int, index_target: int, compute_metrics: bool = True):
        X1, std = self._transport(
            self.demos_x[index_source],
            self.distribution_training_set[index_source],
            self.distribution_training_set[index_target],
        )
        if not compute_metrics:
            return X1, std
        return self._metrics(X1, index_target)

    def generalize(self, index_source: int, index_target: int, compute_metrics: bool = True):
        """Transport onto an out-of-distribution frame configuration; the
        metrics are the frame-relative final position and angle errors
        (there is no ground-truth trajectory)."""
        X1, std = self._transport(
            self.demos_x[index_source],
            self.distribution_training_set[index_source],
            self.distribution_test_set[index_target],
        )
        if not compute_metrics:
            return X1, std
        return self._final_errors(X1, self.test_A[index_target][0][1],
                                  self.test_b[index_target][0][1], index_source)


def ablation_study(
    policy: Optional[MultipleReferenceFramesGPT] = None,
    number_repetitions: int = 20,
    path: Optional[str] = None,
    seed: int = 0,
    ood: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """The ablation protocol: for each repetition a random source demo
    reproduced onto every other demo's frames, then (``ood``) onto randomly
    perturbed frames.  ``device`` places the default policy."""
    rng = np.random.RandomState(seed)
    policy = policy or MultipleReferenceFramesGPT(optimizer=None, device=device)
    policy.load_dataset(path)
    n = len(policy.demos_x)

    rows = {k: [] for k in ("df", "area", "dtw", "fde", "fda")}
    for _ in range(number_repetitions):
        i = rng.randint(n)
        for k in (j for j in range(n) if j != i):
            for key, v in zip(rows, policy.reproduce(i, k)):
                rows[key].append(v)

    out = {k: np.asarray(v) for k, v in rows.items()}
    if ood:
        fde_o, fda_o = [], []
        for _ in range(number_repetitions):
            A_new, b_new = generate_frame_orientation(policy.demos_A, policy.demos_b, rng)
            i = rng.randint(n)
            policy.load_test_dataset(A_new, b_new)
            for k in range(len(A_new)):
                fde, fda = policy.generalize(i, k)
                fde_o.append(fde)
                fda_o.append(fda)
        out["fde_ood"] = np.asarray(fde_o)
        out["fda_ood"] = np.asarray(fda_o)
    return out


_METRIC_TITLES = (
    ("df", "Frechet Distance"),
    ("area", "Area btw curves"),
    ("dtw", "Dynamic Time Warping"),
    ("fde", "Final Position Error"),
    ("fda", "Final Orientation Error"),
)


def compare_methods(
    methods: Optional[Dict[str, object]] = None,
    number_repetitions: int = 5,
    path: Optional[str] = None,
    seed: int = 0,
    device="cuda",
) -> Dict[str, Dict[str, np.ndarray]]:
    """Cross-method reproduction metrics on the reach-target dataset: the
    same (source, target) pairs for every method.

    Returns metric title → (method name → samples), ready for
    ``statistics.ranking_report`` and ``statistics.ranked_boxplot``.
    ``methods`` defaults to GPT and the DMP, TP-GMM and HMM baselines on
    ``device`` (each exposes ``load_dataset``, optionally ``fit``, and
    ``reproduce``)."""
    if methods is None:
        from .baselines import (
            MultipleReferenceFramesDMP,
            MultipleReferenceFramesHMM,
            MultipleReferenceFramesTPGMM,
        )

        methods = {
            "GPT": MultipleReferenceFramesGPT(optimizer=None, device=device),
            "DMP": MultipleReferenceFramesDMP(device=device),
            "TPGMM": MultipleReferenceFramesTPGMM(device=device),
            "HMM": MultipleReferenceFramesHMM(device=device),
        }
    rng = np.random.RandomState(seed)
    samples = {title: {name: [] for name in methods} for _, title in _METRIC_TITLES}
    pairs = None
    for name, policy in methods.items():
        policy.load_dataset(path)
        if hasattr(policy, "fit"):
            policy.fit()
        n = len(policy.demos_x)
        if pairs is None:
            pairs = [(rng.randint(n), k) for _ in range(number_repetitions) for k in range(n)]
        takes_source = "index_source" in inspect.signature(policy.reproduce).parameters
        for i, k in pairs:
            if i == k:
                continue
            # the generative baselines (TP-GMM, HMM-LQR) reproduce for a frame
            # configuration, from no source demo
            vals = policy.reproduce(i, k) if takes_source else policy.reproduce(k)
            for (_, title), v in zip(_METRIC_TITLES, vals):
                samples[title][name].append(float(v))
    return {title: {name: np.asarray(v) for name, v in per.items()}
            for title, per in samples.items()}
