"""What the learned models share: their random draws, their minibatch
schedules and their Adam(W) loop.

Every draw comes from a ``torch.Generator`` on the CPU seeded from the
model's ``seed`` and is moved to the device afterwards, so that a run on
the card and one on the CPU with the same seed draw the same numbers.

:func:`adam` is the port's counterpart of the ``optax.adam`` and
``optax.adamw`` loops that the JAX package's learned models run inside one
``lax.scan`` (``models/mlp.py``, ``models/flows.py``, ``models/svgp.py``).  The step is
optax's, in its order of operations: the moments as (1 − β)·g + β·m, the
bias corrections from the step count, the update m̂/(√v̂ + ε), plus the
decayed weights for AdamW, times −lr.

The parameters are packed into one flat tensor and handed to the loss as
views of it, so a step is one backward pass and a handful of elementwise
launches whatever the number of parameter tensors, and no step reads a
value back to the host: the losses stay on the device.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import Tensor


def cpu_generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed``."""
    return torch.Generator().manual_seed(int(seed))


def schedule(generator: torch.Generator, N: int, num_epochs: int, batch_size: int,
             members: Optional[int] = None, device="cuda") -> Tensor:
    """Minibatch indices (steps, B), or (E, steps, B) with ``members``: a
    fresh permutation of the N points each epoch, cut to whole batches of
    min(batch_size, N)."""
    batch_size = min(batch_size, N)
    per_epoch = max(N // batch_size, 1)
    rows = []
    for _ in range(1 if members is None else members):
        perms = [torch.randperm(N, generator=generator)[: per_epoch * batch_size]
                 for _ in range(num_epochs)]
        rows.append(torch.stack(perms).reshape(-1, batch_size))
    sched = rows[0] if members is None else torch.stack(rows)
    return sched.to(device)


# optax's Adam constants
B1, B2, EPS = 0.9, 0.999, 1e-8


def as_2d(Y: Tensor) -> Tensor:
    """Targets as columns: (N,) becomes (N, 1)."""
    return Y if Y.dim() == 2 else Y[:, None]


class DeviceInputs:
    """Inputs that are not tensors (numpy arrays, lists) go to the model's
    ``device``; tensors stay where they are."""

    def _tensor(self, x) -> Tensor:
        return x if isinstance(x, Tensor) else torch.as_tensor(x, device=self.device)


def unflatten(flat: Tensor, shapes: Sequence[torch.Size]) -> List[Tensor]:
    """Views of ``flat`` with the given shapes, in order."""
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    return [part.view(s) for part, s in zip(torch.split(flat, sizes), shapes)]


def adam(
    params: Sequence[Tensor],
    loss_fn: Callable[[List[Tensor], Tensor], Tensor],
    sched: Tensor,
    learning_rate: float,
    weight_decay: float = 0.0,
    skip_nonfinite: bool = False,
    loss_state: Sequence[Tensor] = (),
):
    """Adam (AdamW with ``weight_decay``) from ``params`` over the schedule
    ``sched`` (..., steps, B): step t hands ``loss_fn`` the parameters and
    ``sched[..., t, :]`` and descends the sum of the loss it returns (a
    scalar, or one loss per ensemble member).  With ``skip_nonfinite``, a
    step whose loss is not finite zeroes the whole gradient and a
    non-finite gradient entry is zeroed, and the step still runs, as the
    JAX package's SVGP fit does.  Returns (the trained parameters, the
    losses (steps, ...)).

    A step updates the parameters and moments in place, and ``loss_fn``
    must update any state of its own in place too (``loss_state`` names
    those tensors).  On the card the step is captured once as a CUDA graph
    and replayed for every minibatch, its index and bias corrections
    copied into the graph's inputs first: a few launches a step instead of
    the hundreds of its forward, backward and update kernels, which are
    the same kernels in the same order as an eager step's.  Before the
    capture one step runs on a side stream, as CUDA graphs need, and the
    state it changed is put back."""
    shapes = [p.shape for p in params]
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    mu = torch.zeros_like(flat)
    nu = torch.zeros_like(flat)
    steps = sched.shape[-2]
    count = torch.arange(1, steps + 1, dtype=torch.float64)
    bias1 = (1.0 - B1**count).to(flat)
    bias2 = (1.0 - B2**count).to(flat)
    idx, c1, c2 = sched[..., 0, :].clone(), bias1[0].clone(), bias2[0].clone()

    def step():
        x = flat.detach().requires_grad_(True)
        loss = loss_fn(unflatten(x, shapes), idx)
        (g,) = torch.autograd.grad(loss.sum(), x)
        if skip_nonfinite:
            g = torch.where(torch.isfinite(loss).all() & torch.isfinite(g), g,
                            torch.zeros_like(g))
        mu.copy_((1.0 - B1) * g + B1 * mu)
        nu.copy_((1.0 - B2) * (g * g) + B2 * nu)
        update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
        if weight_decay:
            update = update + weight_decay * flat
        flat.copy_(flat + (-learning_rate) * update)
        return loss.detach()

    graph = None
    if flat.is_cuda and steps:
        state = (flat, mu, nu, *loss_state)
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream(device=flat.device)
        side.wait_stream(torch.cuda.current_stream(flat.device))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(flat.device).wait_stream(side)
        for t, v in zip(state, saved):
            t.copy_(v)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            graph_loss = step()
    losses = []
    for t in range(steps):
        idx.copy_(sched[..., t, :])
        c1.copy_(bias1[t])
        c2.copy_(bias2[t])
        if graph is None:
            losses.append(step())
        else:
            graph.replay()
            losses.append(graph_loss.clone())
    out = unflatten(flat, shapes)
    return out, (torch.stack(losses) if losses else flat.new_zeros(0))
