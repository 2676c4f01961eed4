"""The system's two root entry points, the port of ``__graft_entry__.py``.

``entry(device=None)``   — (fn, example_args): one forward step of the
                           flagship model, the uncertainty-aware GP policy
                           transport (``transport.gpt.fit_and_transport``) at
                           n = 16 points and a 64-point demo.
``dryrun_multichip(n)``  — one full sharded training step on n ranks
                           (``parallel.dryrun``).
"""
from __future__ import annotations

import numpy as np
import torch

from .parallel.dryrun import dryrun_multichip

__all__ = ["dryrun_multichip", "entry"]


def _example_problem(dtype, n_traj=64, n_dist=16):
    t = np.linspace(0, 1, n_traj, dtype=dtype)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], axis=1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    s = np.linspace(0, 1, n_dist, dtype=dtype)
    S = np.stack([10 * s, -2 + 0 * s], axis=1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], axis=1)
    return X, dX, S, S1


def entry(device=None):
    """(fn, args): ``fn(*args)`` is one full fit + transport forward pass
    (dense conditioning at n = 16, no hand kernel), float32, on the card
    unless ``device`` names another."""
    from . import kernels as K
    from .transport import gpt

    dev = dict(dtype=torch.float32, device=torch.device("cuda" if device is None else device))
    X, dX, S, S1 = _example_problem(np.float32)
    kernel = K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, **dev)) + K.White(0.01)

    def fn(kernel, S, S1, X, dX):
        return gpt.fit_and_transport(kernel, S, S1, X, dX)

    args = (kernel,) + tuple(torch.as_tensor(a, **dev) for a in (S, S1, X, dX))
    return fn, args
