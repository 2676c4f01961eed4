"""Baseline policies for the multi-reference-frame benchmark.

Port of ``gaussian_process_transportation_tpu/benchmarks/baselines.py``,
on the port's ``models/tpgmm.py``, ``models/hmm_lqr.py`` and
``transport/variants.py``:

* ``MultipleReferenceFramesDMP``: the frame-blending affine baseline,
  per-frame affine transports of the demo (start frame, goal frame),
  uniformly scaled and blended with a sigmoid;
* ``MultipleReferenceFramesTPGMM``: TP-GMM with GMR on time;
* ``MultipleReferenceFramesHMM``: HMM with LQR tracking;
* ``MultipleReferenceFramesKMP`` and ``MultipleReferenceFramesLE``: the
  KMP and Laplacian-editing transports on 4-point frame distributions.

All share the metric protocol of
:class:`..benchmarks.multi_frame.MultipleReferenceFramesGPT` and run on
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels as K
from ..models.hmm_lqr import HMMLQR
from ..models.tpgmm import TPGMM
from ..transport.variants import (
    AffineTransportation,
    KMPTransport,
    LaplacianEditingTransport,
)
from .multi_frame import _FrameDataset


class _Baseline(_FrameDataset):
    """The demos' first-order differences beside the dataset, and each
    demo's 4-point frame distribution: both frame origins and the y-axis
    tips."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def load_dataset(self, path: Optional[str] = None):
        super().load_dataset(path)
        self.demos_dx = [np.vstack([np.diff(x, axis=0), np.zeros((1, x.shape[1]))])
                         for x in self.demos_x]

    def _frame_points(self, A, b, i):
        fd = 5.0
        A0, A1 = np.asarray(A[i][0][0]), np.asarray(A[i][0][1])
        b0, b1 = np.asarray(b[i][0][0]), np.asarray(b[i][0][1])
        return np.stack([b0, b0 + A0 @ [0, fd], b1, b1 + A1 @ [0, -fd]])

    def _target_frames(self, index_target: int):
        A_new = [np.asarray(self.demos_A[index_target][0][f]) for f in range(2)]
        b_new = [np.asarray(self.demos_b[index_target][0][f]) for f in range(2)]
        return A_new, b_new


class MultipleReferenceFramesDMP(_Baseline):
    """Sigmoid blend of start-frame and goal-frame affine transports."""

    def _transport(self, X, src_pts, tgt_pts, do_scale=False):
        tr = AffineTransportation(device=self.device)
        tr.source_distribution = src_pts
        tr.target_distribution = tgt_pts
        tr.training_traj = X
        tr.fit_transportation(do_scale=do_scale)
        tr.apply_transportation()
        return tr.training_traj.cpu().numpy(), float(tr.affine_transform.scale)

    def _reproduce_to(self, X, src4, tgt4):
        _, scale = self._transport(X, src4, tgt4, do_scale=True)
        X_1, _ = self._transport(X, src4[0:2], tgt4[0:2])
        X_2, _ = self._transport(X, src4[2:4], tgt4[2:4])
        X_1 = X_1[0] + (X_1 - X_1[0]) * scale
        X_2 = X_2[-1] + (X_2 - X_2[-1]) * scale
        alpha = 1.0 / (1.0 + np.exp(-np.linspace(-5, 5, len(X_1))))
        return alpha[:, None] * X_2 + (1 - alpha[:, None]) * X_1

    def reproduce(self, index_source: int, index_target: int, compute_metrics: bool = True):
        src4 = self._frame_points(self.demos_A, self.demos_b, index_source)
        tgt4 = self._frame_points(self.demos_A, self.demos_b, index_target)
        X1 = self._reproduce_to(self.demos_x[index_source], src4, tgt4)
        if not compute_metrics:
            return X1, np.zeros_like(X1)
        return self._metrics(X1, index_target)


class MultipleReferenceFramesTPGMM(_Baseline):
    def __init__(self, n_states: int = 3, n_data: int = 40, device="cuda"):
        super().__init__(device)
        self.model = TPGMM(n_states=n_states, n_data=n_data, device=self.device)

    def fit(self, exclude: Optional[int] = None):
        idx = [i for i in range(len(self.demos_x)) if i != exclude]
        self.model.fit([self.demos_x[i] for i in idx], [self.demos_A[i] for i in idx],
                       [self.demos_b[i] for i in idx])
        return self

    def reproduce(self, index_target: int, compute_metrics: bool = True):
        A_new, b_new = self._target_frames(index_target)
        X1, _ = self.model.reproduce(A_new, b_new, n_points=len(self.demos_x[index_target]))
        if not compute_metrics:
            return X1
        return self._metrics(X1, index_target)


class MultipleReferenceFramesHMM(_Baseline):
    def __init__(self, n_states: int = 5, device="cuda"):
        super().__init__(device)
        self.model = HMMLQR(n_states=n_states, device=self.device)

    def fit(self, exclude: Optional[int] = None):
        idx = [i for i in range(len(self.demos_x)) if i != exclude]
        self.model.fit([self.demos_x[i] for i in idx], [self.demos_dx[i] for i in idx],
                       [self.demos_A[i] for i in idx], [self.demos_b[i] for i in idx])
        return self

    def reproduce(self, index_target: int, compute_metrics: bool = True):
        A_new, b_new = self._target_frames(index_target)
        X1 = self.model.reproduce(A_new, b_new, x0=self.demos_x[index_target][0],
                                  T=len(self.demos_x[index_target]))
        if not compute_metrics:
            return X1
        return self._metrics(X1, index_target)


class _TransportBaseline(_Baseline):
    """reproduce() of a transport variant on the 4-point frame
    distributions."""

    def _make_transport(self):
        raise NotImplementedError

    def reproduce(self, index_source: int, index_target: int, compute_metrics: bool = True):
        tr = self._make_transport()
        tr.source_distribution = self._frame_points(self.demos_A, self.demos_b, index_source)
        tr.target_distribution = self._frame_points(self.demos_A, self.demos_b, index_target)
        tr.training_traj = np.asarray(self.demos_x[index_source])
        tr.fit_transportation()
        tr.apply_transportation()
        X1 = tr.training_traj.cpu().numpy()
        if not compute_metrics:
            return X1, tr.std.cpu().numpy()
        return self._metrics(X1, index_target)


class MultipleReferenceFramesKMP(_TransportBaseline):
    def _make_transport(self):
        # do_scale and bounded hyperparameters, as the original KMP baseline
        kernel = (
            K.Constant(0.1, bounds=(0.1, 5.0))
            * K.RBF(torch.tensor([0.1], dtype=torch.float64, device=self.device),
                    bounds=(0.05, 0.2))
            + K.White(1e-5, bounds=(1e-5, 0.01))
        )
        return KMPTransport(kernel=kernel, do_scale=True, device=self.device)


class MultipleReferenceFramesLE(_TransportBaseline):
    def _make_transport(self):
        return LaplacianEditingTransport(device=self.device)
