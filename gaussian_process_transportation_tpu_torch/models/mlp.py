"""MLP regressors and their ensembles.

Port of ``gaussian_process_transportation_tpu/models/mlp.py``.  A network
is a list of (W, b) pairs; an ensemble is the same list with a leading
member axis on every tensor, W (E, n_in, n_out) and b (E, n_out), so that
E members apply as one batched matmul a layer and train together: one
backward pass and one AdamW step a minibatch for all of them, each member
on its own minibatch schedule (the JAX package ``vmap``s the members).

Random draws (He-initialised weights, the minibatch permutations) come
from a ``torch.Generator`` on the CPU seeded from ``seed`` and are moved
to the device afterwards, so a run on the card and one on the CPU with
the same seed start from the same numbers.  Each fit is the draw
(:func:`init_params`, :func:`schedule`) followed by the deterministic
:func:`train`, which takes the initial parameters and the index schedule.

The input Jacobian is the closed-form ReLU chain, propagated forward
through the layers (ReLU' = 1 where its input is > 0, else 0, as
``jax.nn.relu`` differentiates).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ._training import DeviceInputs, adam, as_2d, cpu_generator, schedule

Params = List[Tuple[Tensor, Tensor]]


def init_params(generator: torch.Generator, sizes: Sequence[int], members: Optional[int] = None,
                dtype=torch.float64, device="cuda") -> Params:
    """He-initialised (W, b) per layer, W ~ N(0, 2/n_in) and b = 0; with
    ``members`` every tensor has that leading axis."""
    lead = () if members is None else (members,)
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        W = torch.randn(lead + (n_in, n_out), generator=generator, dtype=torch.float64)
        W = (W * math.sqrt(2.0 / n_in)).to(dtype=dtype, device=device)
        params.append((W, torch.zeros(lead + (n_out,), dtype=dtype, device=device)))
    return params


def apply(params: Params, x: Tensor) -> Tensor:
    """The network at x (..., N, n_in): ReLU hidden layers, a linear output.
    Stacked parameters give (E, N, n_out) for shared x (N, n_in) or for
    per-member x (E, N, n_in)."""
    h = x
    for W, b in params[:-1]:
        h = torch.relu(h @ W + b.unsqueeze(-2))
    W, b = params[-1]
    return h @ W + b.unsqueeze(-2)


def train(params: Params, X: Tensor, Y: Tensor, sched: Tensor, learning_rate: float = 1e-3,
          weight_decay: float = 1e-4):
    """AdamW on the mean squared error over the schedule's minibatches:
    the deterministic part of the fit (JAX's ``train`` closure).  ``sched``
    is (steps, B), or (E, steps, B) for stacked parameters.  Returns (the
    trained parameters, the losses (steps,) or (steps, E))."""
    flat = [t for layer in params for t in layer]

    def loss(p, idx):
        pred = apply(list(zip(p[0::2], p[1::2])), X[idx])
        return ((pred - Y[idx]) ** 2).mean(dim=(-2, -1))

    out, losses = adam(flat, loss, sched, learning_rate, weight_decay=weight_decay)
    return list(zip(out[0::2], out[1::2])), losses


def fit_params(params: Params, X: Tensor, Y: Tensor, num_epochs: int = 200, batch_size: int = 32,
               learning_rate: float = 1e-3, weight_decay: float = 1e-4,
               generator: Optional[torch.Generator] = None):
    """The schedule drawn from ``generator`` (seed 0 by default), then
    :func:`train`; stacked parameters draw one schedule a member."""
    generator = cpu_generator(0) if generator is None else generator
    members = params[0][0].shape[0] if params[0][0].dim() == 3 else None
    sched = schedule(generator, X.shape[0], num_epochs, batch_size, members, X.device)
    return train(params, X, Y, sched, learning_rate, weight_decay)


def jacobian_fn(params: Params, x: Tensor) -> Tensor:
    """The exact input Jacobian (..., Nq, P, D) at x (Nq, D): the ReLU
    chain carried forward as ∂h/∂x (..., Nq, D, width)."""
    D = x.shape[-1]
    M = torch.eye(D, dtype=x.dtype, device=x.device)
    h = x
    for W, b in params[:-1]:
        z = h @ W + b.unsqueeze(-2)
        M = (M @ W.unsqueeze(-3)) * (z > 0).to(x.dtype).unsqueeze(-2)
        h = torch.relu(z)
    M = M @ params[-1][0].unsqueeze(-3)
    return M.transpose(-1, -2)


class MLP(DeviceInputs):
    """One network, the original project's interface: ``fit``,
    ``predict``, ``derivative`` and (deterministic) ``samples``."""

    def __init__(self, hidden=(100, 100, 100, 100), seed: int = 0, device="cuda"):
        self.hidden = tuple(hidden)
        self.seed = seed
        self.device = torch.device(device)
        self.params: Optional[Params] = None

    def fit(self, X, Y, num_epochs: int = 200, **kw):
        X = self._tensor(X)
        Y = as_2d(self._tensor(Y))
        sizes = (X.shape[1],) + self.hidden + (Y.shape[1],)
        self.params = init_params(cpu_generator(self.seed), sizes, dtype=X.dtype,
                                  device=X.device)
        self.params, _ = fit_params(self.params, X, Y, num_epochs=num_epochs,
                                    generator=cpu_generator(self.seed + 1), **kw)
        return self

    def predict(self, x, return_std: bool = False):
        y = apply(self.params, self._tensor(x))
        return (y, torch.zeros_like(y)) if return_std else y

    def derivative(self, x, return_var: bool = False):
        J = jacobian_fn(self.params, self._tensor(x))
        return (J, torch.zeros_like(J)) if return_var else J

    def samples(self, x, n_samples: int = 10):
        """The prediction repeated: the model is deterministic."""
        y = self.predict(x)
        return y[None].repeat((n_samples,) + (1,) * y.dim())


class EnsembleMLP(DeviceInputs):
    """E networks trained together: mean and std (ddof 0) of the members'
    predictions, mean and variance (ddof 0) of their Jacobians, and the
    members' predictions as samples."""

    def __init__(self, n_estimators: int = 10, hidden=(100, 100, 100, 100), seed: int = 0,
                 device="cuda"):
        self.n_estimators = n_estimators
        self.hidden = tuple(hidden)
        self.seed = seed
        self.device = torch.device(device)
        self.params: Optional[Params] = None

    def fit(self, X, Y, num_epochs: int = 200, batch_size: int = 32,
            learning_rate: float = 1e-3, weight_decay: float = 1e-4):
        X = self._tensor(X)
        Y = as_2d(self._tensor(Y))
        sizes = (X.shape[1],) + self.hidden + (Y.shape[1],)
        params = init_params(cpu_generator(self.seed), sizes, self.n_estimators,
                             dtype=X.dtype, device=X.device)
        self.params, _ = fit_params(params, X, Y, num_epochs=num_epochs, batch_size=batch_size,
                                    learning_rate=learning_rate, weight_decay=weight_decay,
                                    generator=cpu_generator(self.seed + 1))
        return self

    def predict(self, x, return_std: bool = False):
        preds = self.samples(x)
        mean = preds.mean(0)
        return (mean, preds.std(0, correction=0)) if return_std else mean

    def derivative(self, x, return_var: bool = False):
        Js = jacobian_fn(self.params, self._tensor(x))  # (E, Nq, P, D)
        mean = Js.mean(0)
        return (mean, Js.var(0, correction=0)) if return_var else mean

    def samples(self, x):
        """(E, Nq, P): each member's prediction."""
        return apply(self.params, self._tensor(x))
