"""Invertible RealNVP coupling flows with exact Jacobians.

Port of ``gaussian_process_transportation_tpu/models/flows.py``: a stack of
alternating-mask coupling layers, each with a scale net and a translate
net, identity at initialisation, trained by Huber (δ = 1) regression of
the flow itself onto source → target.

A net is a :class:`CouplingNet`, its (W, b) layers and its ``kind``:
``fcnn`` (two ELU hidden layers) or ``rffn`` (fixed random cos features and
a trained readout).  The RFF coefficients and offsets are buffers: they
are never trained, as the JAX package stops their gradient.  Flows of an
ensemble carry a leading member axis on every tensor and apply and train
as one batched program, each member on its own minibatch schedule.

The log-scales are soft-capped at ±4 (4·tanh(s/4)), which keeps exp(s)
bounded far outside the training support.  The exact Jacobian is forward
mode (``torch.func.jacfwd``) through the whole stack, one query point at a
time under ``torch.func.vmap``.

Random draws come from a ``torch.Generator`` on the CPU seeded from
``seed``; each fit is the draw (:func:`init_flow`, the schedule) followed
by the deterministic :func:`train_flow`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from ._training import DeviceInputs, adam, cpu_generator, schedule


@dataclass(frozen=True)
class CouplingNet:
    """One scale or translate net: ((W, b), ...) and its kind."""

    layers: tuple
    kind: str = "fcnn"

    def trainable(self) -> List[Tensor]:
        """The trained tensors: every layer's of an fcnn, the readout's of
        an rffn (its coefficients and offsets are buffers)."""
        layers = self.layers[1:] if self.kind == "rffn" else self.layers
        return [t for layer in layers for t in layer]

    def with_trainable(self, tensors: List[Tensor]) -> "CouplingNet":
        pairs = tuple(zip(tensors[0::2], tensors[1::2]))
        return CouplingNet(self.layers[:1] + pairs if self.kind == "rffn" else pairs, self.kind)


class CouplingParams(NamedTuple):
    """The two nets of one coupling layer; its alternating mask follows
    from the layer's index."""

    s_net: CouplingNet
    t_net: CouplingNet


def _init_net(generator, sizes, kind, sigma, members, dtype, device) -> CouplingNet:
    lead = () if members is None else (members,)
    put = lambda t: t.to(dtype=dtype, device=device)
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=dtype, device=device)
    if kind == "rffn":
        in_dim, n_feat, out_dim = sizes[0], sizes[1], sizes[-1]
        coeff = torch.randn(lead + (in_dim, n_feat), generator=generator,
                            dtype=torch.float64) / sigma
        offset = 2.0 * math.pi * torch.rand(lead + (n_feat,), generator=generator,
                                            dtype=torch.float64)
        # the readout starts at zero: the identity flow
        return CouplingNet(((put(coeff), put(offset)), (zeros(n_feat, out_dim), zeros(out_dim))),
                           "rffn")
    layers = []
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        if i == len(sizes) - 2:
            W = zeros(n_in, n_out)  # identity at initialisation
        else:
            # uniform ±1/√fan_in, torch.nn.Linear's default
            bound = 1.0 / math.sqrt(n_in)
            U = torch.rand(lead + (n_in, n_out), generator=generator, dtype=torch.float64)
            W = put(U * (2.0 * bound) - bound)
        layers.append((W, zeros(n_out)))
    return CouplingNet(tuple(layers), "fcnn")


def init_flow(generator: torch.Generator, num_dims: int, num_blocks: int = 4,
              num_hidden: int = 20, kind: str = "fcnn", sigma: float = 0.45,
              members: Optional[int] = None, dtype=torch.float64, device="cuda") -> list:
    """The coupling stack at identity, ``members`` flows stacked if given."""
    sizes = (num_dims, num_hidden, num_hidden, num_dims)
    return [CouplingParams(_init_net(generator, sizes, kind, sigma, members, dtype, device),
                           _init_net(generator, sizes, kind, sigma, members, dtype, device))
            for _ in range(num_blocks)]


def _net_apply(net: CouplingNet, x: Tensor) -> Tensor:
    if net.kind == "rffn":
        coeff, offset = net.layers[0]
        feats = torch.cos(x @ coeff + offset.unsqueeze(-2))
        W, b = net.layers[1]
        return feats @ W + b.unsqueeze(-2)
    h = x
    for W, b in net.layers[:-1]:
        h = F.elu(h @ W + b.unsqueeze(-2))
    W, b = net.layers[-1]
    return h @ W + b.unsqueeze(-2)


def _layer_mask(num_dims: int, i: int, like: Tensor) -> Tensor:
    """Layer i's pass-through mask; it alternates between layers."""
    return ((torch.arange(num_dims, device=like.device) + i) % 2).to(like.dtype)


_S_CAP = 4.0  # the soft cap on the log-scales


def _scale_shift(p: CouplingParams, mask: Tensor, xm: Tensor):
    s = _S_CAP * torch.tanh(_net_apply(p.s_net, xm) / _S_CAP) * (1.0 - mask)
    t = _net_apply(p.t_net, xm) * (1.0 - mask)
    return s, t


def flow_forward(layers: list, x: Tensor) -> Tensor:
    """Φ(x) for x (..., N, D); stacked flows give (E, N, D)."""
    d = x.shape[-1]
    for i, p in enumerate(layers):
        mask = _layer_mask(d, i, x)
        xm = x * mask
        s, t = _scale_shift(p, mask, xm)
        x = xm + (1.0 - mask) * (x * torch.exp(s) + t)
    return x


def flow_inverse(layers: list, y: Tensor) -> Tensor:
    """Φ⁻¹(y), layer by layer in reverse."""
    d = y.shape[-1]
    for i in reversed(range(len(layers))):
        mask = _layer_mask(d, i, y)
        ym = y * mask
        s, t = _scale_shift(layers[i], mask, ym)
        y = ym + (1.0 - mask) * ((y - t) * torch.exp(-s))
    return y


def flow_jacobian(layers: list, x: Tensor) -> Tensor:
    """The exact ∂Φ/∂x at x (N, D): (N, D, D), or (E, N, D, D) for
    stacked flows."""
    from torch.func import jacfwd, vmap

    J = vmap(jacfwd(lambda xi: flow_forward(layers, xi[None])[..., 0, :]))(x)
    return J.transpose(0, 1) if J.dim() == 4 else J


def huber(pred: Tensor, target: Tensor, delta: float = 1.0) -> Tensor:
    """optax's Huber loss per entry: ½q² + δ(|e| − q), q = min(|e|, δ)."""
    err = torch.abs(pred - target)
    quad = torch.minimum(err, torch.full_like(err, delta))
    return 0.5 * quad * quad + delta * (err - quad)


def train_flow(layers: list, X: Tensor, Y: Tensor, sched: Tensor, learning_rate: float = 1e-3):
    """Adam on the Huber loss (mean over every entry of a minibatch) over
    the schedule (steps, B), or (E, steps, B) for stacked flows: the
    deterministic part of the fit.  Returns (the trained layers, the
    losses)."""
    nets = [net for p in layers for net in p]
    counts = [len(net.trainable()) for net in nets]

    def rebuild(tensors):
        out, pos = [], 0
        for net, n in zip(nets, counts):
            out.append(net.with_trainable(tensors[pos:pos + n]))
            pos += n
        return [CouplingParams(s, t) for s, t in zip(out[0::2], out[1::2])]

    def loss(tensors, idx):
        return huber(flow_forward(rebuild(tensors), X[idx]), Y[idx]).mean(dim=(-2, -1))

    flat = [t for net in nets for t in net.trainable()]
    out, losses = adam(flat, loss, sched, learning_rate)
    return rebuild(out), losses


def fit_flow(layers: list, X: Tensor, Y: Tensor, num_epochs: int = 200, batch_size: int = 32,
             learning_rate: float = 1e-3, generator: Optional[torch.Generator] = None):
    """The schedule drawn from ``generator`` (seed 0 by default; one a
    member for stacked flows), then :func:`train_flow`."""
    generator = cpu_generator(0) if generator is None else generator
    W0 = layers[0].s_net.layers[0][0]
    members = W0.shape[0] if W0.dim() == 3 else None
    sched = schedule(generator, X.shape[0], num_epochs, batch_size, members, X.device)
    return train_flow(layers, X, Y, sched, learning_rate)


def _shared_standardizer(X: Tensor, Y: Tensor):
    """Mean and one isotropic scale over X ∪ Y, so that the identity flow
    stays the identity after normalising both sides; a scalar scale, since
    a per-dimension one blows up thin bands (a floor's σ_y ≈ 0)."""
    both = torch.cat([X, Y], 0)
    mu = both.mean(0)
    sd = torch.sqrt(((both - mu) ** 2).sum(1).mean()) + 1e-8
    return mu, sd.expand(X.shape[1]).clone()


class _Standardized(DeviceInputs):
    def _setup(self, X, Y, device):
        self.device = torch.device(device)
        self.X = self._tensor(X)
        self.Y = self._tensor(Y)
        self.mu, self.sd = _shared_standardizer(self.X, self.Y)

    def _norm(self, x):
        return (self._tensor(x) - self.mu) / self.sd

    def _denorm(self, z):
        return z * self.sd + self.mu

    def _jacobian(self, x):
        # Φ = denorm ∘ f ∘ norm: J_Φ = diag(sd) J_f diag(1/sd)
        J = flow_jacobian(self.layers, self._norm(x))
        return self.sd[:, None] * J / self.sd[None, :]


class BijectiveNetwork(_Standardized):
    """The original project's interface: a flow fitted to Φ itself on
    (X = source, Y = target)."""

    def __init__(self, X, Y, num_blocks: int = 4, num_hidden: int = 20, seed: int = 0,
                 kind: str = "fcnn", sigma: float = 0.45, device="cuda"):
        self._setup(X, Y, device)
        self.seed = seed
        self.layers = init_flow(cpu_generator(seed), self.X.shape[1], num_blocks, num_hidden,
                                kind, sigma, dtype=self.X.dtype, device=self.X.device)

    def fit(self, num_epochs: int = 200, **kw):
        self.layers, _ = fit_flow(self.layers, self._norm(self.X), self._norm(self.Y),
                                  num_epochs=num_epochs, generator=cpu_generator(self.seed + 1),
                                  **kw)
        return self

    def predict(self, x):
        return self._denorm(flow_forward(self.layers, self._norm(x)))

    def inverse(self, y):
        return self._denorm(flow_inverse(self.layers, self._norm(y)))

    def derivative(self, x):
        return self._jacobian(x)


class EnsembleBijectiveNetwork(_Standardized):
    """E flows trained together: mean and std (ddof 0) of the members'
    predictions, mean and variance (ddof 0) of their Jacobians, and the
    members' predictions as samples."""

    def __init__(self, X, Y, n_estimators: int = 10, num_blocks: int = 4, num_hidden: int = 20,
                 seed: int = 0, kind: str = "fcnn", sigma: float = 0.45, device="cuda"):
        self._setup(X, Y, device)
        self.n_estimators = n_estimators
        self.seed = seed
        self.layers = init_flow(cpu_generator(seed), self.X.shape[1], num_blocks, num_hidden,
                                kind, sigma, members=n_estimators, dtype=self.X.dtype,
                                device=self.X.device)

    def fit(self, num_epochs: int = 200, **kw):
        self.layers, _ = fit_flow(self.layers, self._norm(self.X), self._norm(self.Y),
                                  num_epochs=num_epochs, generator=cpu_generator(self.seed + 1),
                                  **kw)
        return self

    def predict(self, x, return_std: bool = False):
        preds = self.samples(x)
        mean = preds.mean(0)
        return (mean, preds.std(0, correction=0)) if return_std else mean

    def derivative(self, x, return_var: bool = False):
        Js = self._jacobian(x)  # (E, N, D, D)
        mean = Js.mean(0)
        return (mean, Js.var(0, correction=0)) if return_var else mean

    def samples(self, x):
        """(E, N, D): each member's prediction."""
        return self._denorm(flow_forward(self.layers, self._norm(x)))
