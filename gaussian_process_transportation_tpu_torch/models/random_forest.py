"""Random-forest regression: a host CART fit, a gather descent on the device.

Port of ``gaussian_process_transportation_tpu/models/random_forest.py``.
Greedy CART split finding is sequential and data-dependent, so the trees
are grown on the host in numpy, with ``np.random.RandomState(seed)``
drawing the bootstrap samples exactly as the JAX package does, into
perfect-binary-tree arrays (a feature and a threshold per internal node,
a value per node).  The split search is the C++ routine ``csrc/cart.cpp``,
built with g++ at first use; :func:`_best_split` is its numpy twin, which
the tests hold it against.

Prediction is a fixed-depth descent on the device: every tree and every
query step down one level a round, by gathers.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..ops import _cuda
from ._training import DeviceInputs


@dataclass(frozen=True)
class ForestParams:
    feature: Tensor  # (E, n_internal) int64, -1 where a node is a leaf early
    threshold: Tensor  # (E, n_internal), inf where feature is -1
    value: Tensor  # (E, n_nodes, P) node means (the prediction at any depth)


def _fit_tree(X, y, depth, min_samples_split=2, best_split=None):
    """Grow one CART tree into perfect-tree arrays (numpy, host)."""
    best_split = _best_split_native if best_split is None else best_split
    n, d = X.shape
    P = y.shape[1]
    n_internal = 2**depth - 1
    n_nodes = 2 ** (depth + 1) - 1
    feature = np.full(n_internal, -1, dtype=np.int32)
    threshold = np.full(n_internal, np.inf)
    value = np.zeros((n_nodes, P))

    stack = [(0, np.arange(n))]
    while stack:
        node, idx = stack.pop()
        yn = y[idx]
        value[node] = yn.mean(axis=0) if len(idx) else 0.0
        if node >= n_internal:
            continue
        if len(idx) < min_samples_split or np.allclose(yn, yn[0]):
            # a leaf early: its descendants take its value, feature stays -1
            _propagate(value, node, n_nodes)
            continue
        best = best_split(X[idx], yn)
        if best is None:
            _propagate(value, node, n_nodes)
            continue
        f, thr = best
        feature[node] = f
        threshold[node] = thr
        mask = X[idx, f] <= thr
        stack.append((2 * node + 1, idx[mask]))
        stack.append((2 * node + 2, idx[~mask]))
    return feature, threshold, value


def _propagate(value, node, n_nodes):
    """Copy a leaf-early node's value to all its descendants."""
    frontier = [node]
    while frontier:
        m = frontier.pop()
        for child in (2 * m + 1, 2 * m + 2):
            if child < n_nodes:
                value[child] = value[node]
                frontier.append(child)


def _best_split(X, y) -> Optional[Tuple[int, float]]:
    """Best (feature, threshold) by variance reduction, vectorised numpy:
    the plain twin of :func:`_best_split_native`."""
    n, d = X.shape
    best_score, best = np.inf, None
    base_sum = y.sum(axis=0)
    base_sq = (y**2).sum(axis=0)
    for f in range(d):
        order = np.argsort(X[:, f], kind="stable")
        xs = X[order, f]
        ys = y[order]
        csum = np.cumsum(ys, axis=0)
        csq = np.cumsum(ys**2, axis=0)
        # a candidate split after position i (1..n-1), none inside a tie
        valid = xs[1:] > xs[:-1]
        if not valid.any():
            continue
        nl = np.arange(1, n).astype(float)
        nr = n - nl
        sl, ssl = csum[:-1], csq[:-1]
        sr, ssr = base_sum - sl, base_sq - ssl
        sse = (ssl - sl**2 / nl[:, None]).sum(axis=1) + (ssr - sr**2 / nr[:, None]).sum(axis=1)
        sse = np.where(valid, sse, np.inf)
        j = np.argmin(sse)
        if sse[j] < best_score:
            best_score = sse[j]
            best = (f, 0.5 * (xs[j] + xs[j + 1]))
    return best


def _cart_library() -> ctypes.CDLL:
    lib = _cuda.host_library("cart")
    lib.gpt_best_split.restype = ctypes.c_int
    lib.gpt_best_split.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def _best_split_native(X, y) -> Optional[Tuple[int, float]]:
    """:func:`_best_split` through ``csrc/cart.cpp``; None where no split
    separates two values."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n, d = X.shape
    out_f, out_t = ctypes.c_int64(-1), ctypes.c_double(0.0)
    dbl = ctypes.POINTER(ctypes.c_double)
    ok = _cart_library().gpt_best_split(X.ctypes.data_as(dbl), y.ctypes.data_as(dbl), n, d,
                                        y.shape[1], ctypes.byref(out_f), ctypes.byref(out_t))
    return (int(out_f.value), float(out_t.value)) if ok else None


def fit_forest_numpy(X, Y, n_estimators: int = 50, max_depth: int = 5, bootstrap: bool = True,
                     seed: int = 0, best_split=None):
    """The fitted (feature, threshold, value) arrays of every tree, stacked,
    in numpy: tree e on the bootstrap sample that ``RandomState(seed)``
    draws e-th."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    rng = np.random.RandomState(seed)
    trees = []
    n = len(X)
    for _ in range(n_estimators):
        idx = rng.randint(0, n, n) if bootstrap else np.arange(n)
        trees.append(_fit_tree(X[idx], Y[idx], max_depth, best_split=best_split))
    return tuple(np.stack(parts) for parts in zip(*trees))


def fit_forest(X, Y, n_estimators: int = 50, max_depth: int = 5, bootstrap: bool = True,
               seed: int = 0, dtype=torch.float64, device="cuda") -> ForestParams:
    """:func:`fit_forest_numpy`, its arrays put on ``device``."""
    feature, threshold, value = fit_forest_numpy(X, Y, n_estimators, max_depth, bootstrap, seed)
    return ForestParams(
        feature=torch.as_tensor(feature, dtype=torch.int64, device=device),
        threshold=torch.as_tensor(threshold, dtype=dtype, device=device),
        value=torch.as_tensor(value, dtype=dtype, device=device),
    )


def forest_member_predict(params: ForestParams, x: Tensor) -> Tensor:
    """(E, Nq, P): each tree's prediction at x (Nq, D), all trees and
    queries descending one level a round.  A node with feature −1 has an
    infinite threshold, so the descent goes left, into descendants that
    hold its value."""
    E, n_internal = params.feature.shape
    depth = int(np.log2(n_internal + 1))
    xs = x.to(params.threshold.dtype).expand(E, -1, -1)
    node = torch.zeros((E, x.shape[0]), dtype=torch.int64, device=x.device)
    for _ in range(depth):
        f = params.feature.gather(1, node)
        thr = params.threshold.gather(1, node)
        xf = xs.gather(2, f.clamp(min=0)[..., None])[..., 0]
        node = torch.where(xf <= thr, 2 * node + 1, 2 * node + 2)
    P = params.value.shape[-1]
    return params.value.gather(1, node[..., None].expand(-1, -1, P))


class EnsembleRandomForest(DeviceInputs):
    """The original project's interface: the mean and std (ddof 0) over the
    trees, and each tree's prediction as samples."""

    def __init__(self, n_estimators: int = 50, max_depth: int = 5, seed: int = 0, device="cuda"):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.seed = seed
        self.device = torch.device(device)
        self.params: Optional[ForestParams] = None

    def fit(self, X, Y):
        X = self._tensor(X)
        Y = self._tensor(Y)
        self.params = fit_forest(X.detach().cpu().numpy(), Y.detach().cpu().numpy(),
                                 n_estimators=self.n_estimators, max_depth=self.max_depth,
                                 seed=self.seed, dtype=X.dtype, device=X.device)
        return self

    def predict(self, x, return_std: bool = False):
        preds = self.samples(x)
        mean = preds.mean(0)
        return (mean, preds.std(0, correction=0)) if return_std else mean

    def samples(self, x):
        """(E, Nq, P): each tree's prediction."""
        return forest_member_predict(self.params, self._tensor(x))
