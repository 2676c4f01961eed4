"""Plain reference of the per-member hyperparameter fit.

A member's data are the Kabsch-aligned source points and their residuals
(``transport.kabsch``); its log marginal likelihood under the covariance
``cov`` (a ``cov_<family>`` module) plus (noise + jitter)·I, summed over the
P outputs, is

    −½ Σ_p y_pᵀ K⁻¹ y_p − P Σ_i log L_ii − ½ P n log 2π.

``fit`` maximises it for many lanes at once by Adam on θ = log(amp, ℓ,
noise), each lane held inside its box by θ = lo + (hi − lo)·sigmoid(z).
It is a plain optimiser, not the program's: it is there to say how high
each member's likelihood can go.  ``gram`` rounds the Gram before its
factor and ``member_data``'s ``mm`` takes its products (the control's
lower precision); the check leaves both alone.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import Tensor

from .transport import kabsch


def member_data(S: Tensor, T: Tensor, dtype=torch.float64, mm=torch.matmul):
    """(X (B, n, D), Y (B, n, D)): the aligned source and the residuals."""
    S, T = S.to(dtype), T.to(dtype)
    R, cs, ct = kabsch(S, T, mm)
    X = mm((S - cs)[None].expand(T.shape), R.transpose(-1, -2)) + ct[:, None]
    return X, T - X


def lml(theta: Tensor, X: Tensor, Y: Tensor, jitter: float, cov,
        gram: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """The log marginal likelihood of each lane: θ (B, 2 + D), X (B, n, D),
    Y (B, n, P)."""
    B, n, D = X.shape
    P = Y.shape[-1]
    p = torch.exp(theta)
    amp, ls, noise = p[:, 0], p[:, 1:1 + D], p[:, -1]
    K = cov.k(X, X, amp, ls)
    K = K + (noise + jitter)[:, None, None] * torch.eye(n, dtype=X.dtype, device=X.device)
    if gram is not None:
        K = gram(K)
    L, info = torch.linalg.cholesky_ex(K)
    alpha = torch.cholesky_solve(Y, L)
    logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    val = -0.5 * (Y * alpha).sum((-2, -1)) - P * logdet - 0.5 * P * n * math.log(2 * math.pi)
    return torch.where(info == 0, val, torch.full_like(val, -math.inf))


def fit(X: Tensor, Y: Tensor, starts: Tensor, lo: Tensor, hi: Tensor, jitter: float, cov,
        steps: int = 600, lr: float = 0.1, gram: Optional[Callable[[Tensor], Tensor]] = None):
    """The best log marginal likelihood each member reaches from its starts,
    and the θ that reached it: X, Y (B, n, ·), starts (B, R, T) inside
    [lo, hi] (T,); returns ((B,), (B, T))."""
    B, R, T = starts.shape
    Xr = X.repeat_interleave(R, 0)
    Yr = Y.repeat_interleave(R, 0)
    u = ((starts.reshape(B * R, T) - lo) / (hi - lo)).clamp(1e-6, 1 - 1e-6)
    z = torch.log(u / (1 - u)).detach().requires_grad_(True)
    opt = torch.optim.Adam([z], lr=lr)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, steps, eta_min=lr / 100)
    best = torch.full((B * R,), -math.inf, dtype=X.dtype, device=X.device)
    arg = starts.reshape(B * R, T).clone()

    def keep(theta, val):
        nonlocal best
        better = val > best
        best = torch.where(better, val, best)
        arg[better] = theta[better]

    for _ in range(steps):
        opt.zero_grad()
        theta = lo + (hi - lo) * torch.sigmoid(z)
        val = lml(theta, Xr, Yr, jitter, cov, gram)
        keep(theta.detach(), val.detach())
        (-torch.where(torch.isfinite(val), val, torch.zeros_like(val)).sum()).backward()
        opt.step()
        sched.step()
    with torch.no_grad():
        theta = lo + (hi - lo) * torch.sigmoid(z)
        keep(theta, lml(theta, Xr, Yr, jitter, cov, gram))
    best, arg = best.reshape(B, R), arg.reshape(B, R, T)
    pick = best.argmax(1)
    return best.amax(1), arg[torch.arange(B, device=X.device), pick]
