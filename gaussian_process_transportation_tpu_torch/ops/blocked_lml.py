"""The exact large-N log-marginal likelihood and its closed-form gradient,
through the blocked panel Cholesky: GP hyperparameter fits at the original
project's active-learning scale (N up to 20 000).

Port of ``gaussian_process_transportation_tpu/ops/blocked_lml.py``.  One
evaluation builds the Gram's lower panels (``stationary_gram_panels``: one
launch of the Gram kernel for a CUDA X), factors them
(``cholesky_panels``: one ``factor_panel`` kernel call a panel) and solves
for α with iterative refinement; the gradient needs no autograd through
the factorization:

* :func:`tri_inverse_panels`: L⁻¹ in panel form, a row-block recurrence
  seeded with the diagonal-block inverses L_kk⁻¹ that ``factor_panel``
  left in the ``BlockedCholesky``;
* :func:`kinv_panels`: K⁻¹ = L⁻ᵀL⁻¹ in panel form, one product per
  (column panel, row chunk);
* :func:`blocked_lml_value_and_grad`: the trace identity
  ``∂LML/∂θ = ½⟨ααᵀ − P·K⁻¹, ∂K/∂θ⟩`` panel by panel, with ∂K/∂θ rebuilt
  elementwise from X, so the gradient costs 2·N³/3 product flops whatever
  the number of hyperparameters;
* :func:`make_blocked_lml`: the LML as a ``torch.autograd.Function`` whose
  backward is that gradient.

θ = (log amplitude, log ℓ (one or D), log noise) of the
C·stationary(+White) family, stationary ∈ {rbf, matern12, matern32,
matern52}.  The products run at ``precision`` (``ops.linalg``'s mapping,
JAX's argument, "highest" by default): full float32 ``torch.matmul`` (TF32
stays off, see the package ``__init__``), or bfloat16 passes on parts that
are split once each (the factor's panels and L_kk⁻¹ by
``cholesky_panels``, L and each finished block row of L⁻¹ here); α's
residuals and the ααᵀ blocks stay in full float32, as in JAX.  On the card
the work is float32, as the kernels take it; CPU tensors keep their dtype,
and there every precision is that dtype's product.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from .blocked_chol import (
    BlockedCholesky,
    cholesky_panels,
    refine_steps,
    stationary_from_sqdist,
    stationary_gram_panels,
)
from .linalg import Split, check_precision, matmul_at, operand, reduced

__all__ = [
    "blocked_lml_value", "blocked_lml_value_and_grad", "kinv_panels", "make_blocked_lml",
    "stationary_dk_dd2", "tri_inverse_panels",
]

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def stationary_dk_dd2(d2: Tensor, family: str) -> Tensor:
    """∂k/∂(d²) of the unit-amplitude stationary profile on ℓ-scaled inputs
    (the partner of ``stationary_from_sqdist``): ∂K/∂log ℓ_d = amp·k'(d²)·
    (−2Δ_d²/ℓ_d²).  matern12 is not differentiable at d = 0; its 1/d is
    guarded and the Δ_d² beside it vanishes faster, so the product is 0."""
    if family == "rbf":
        return -0.5 * torch.exp(-0.5 * d2)
    d = torch.sqrt(d2 + 1e-36)
    if family == "matern12":
        return -torch.exp(-d) / (2.0 * torch.clamp(d, min=1e-18))
    if family == "matern32":
        return -1.5 * torch.exp(-_SQRT3 * d)
    if family == "matern52":
        s = _SQRT5 * d
        return -(5.0 / 6.0) * (1.0 + s) * torch.exp(-s)
    raise ValueError(f"unknown stationary family {family!r}")


def _dense_lower(panels: Sequence[Tensor]) -> Tensor:
    """The dense (Np, Np) lower-triangular matrix of column panels."""
    B, Np = panels[0].shape[1], panels[0].shape[0]
    out = panels[0].new_zeros(Np, Np)
    for k, p in enumerate(panels):
        out[k * B:, k * B:(k + 1) * B] = p
    return out


def _chunk_bounds(start: int, count: int, chunks: int) -> List[int]:
    C = min(chunks, count)
    return [start + round(count * t / C) for t in range(C + 1)]


def _tri_inverse_dense(chol: BlockedCholesky, chunks: int, precision: str):
    """L⁻¹ as a dense (Np, Np) lower-triangular matrix T: block row i is
    −L_ii⁻¹·(L[i, :iB] @ T[:iB, :iB]), the product cut into ``chunks``
    column ranges that each start at their first nonzero row of T.
    Returns T and its product operand at ``precision`` (T itself, or its
    parts, each block row split once as it is finished)."""
    B, P, Np = chol.block, len(chol.panels), chol.padded_n
    Ld = _dense_lower(chol.panels)
    L_op = operand(Ld, precision)
    linvs = chol.operands(precision)[1]
    T = Ld.new_zeros(Np, Np)
    T_op = Split.zeros((Np, Np), precision, Ld.device) if reduced(Ld, precision) else T
    T[:B, :B] = chol.linvs[0]
    for i in range(P):
        rows = slice(i * B, (i + 1) * B)
        if i:
            Lrow = L_op[rows, : i * B]
            bounds = _chunk_bounds(0, i, chunks)
            acc = torch.cat([matmul_at(Lrow[:, c0 * B:], T_op[c0 * B:i * B, c0 * B:c1 * B],
                                       precision)
                             for c0, c1 in zip(bounds[:-1], bounds[1:]) if c1 > c0], dim=1)
            T[rows, : i * B] = -matmul_at(linvs[i], acc, precision)
            T[rows, rows] = chol.linvs[i]
        if T_op is not T:
            T_op.put((rows, slice(0, (i + 1) * B)), T[rows, : (i + 1) * B])
    return T, T_op


def _panels_of(dense: Tensor, B: int) -> List[Tensor]:
    return [dense[s * B:, s * B:(s + 1) * B] for s in range(dense.shape[0] // B)]


def tri_inverse_panels(chol: BlockedCholesky, precision: str = "highest",
                       chunks: int = 6) -> List[Tensor]:
    """L⁻¹ as lower-triangle column panels, the layout of ``chol.panels``
    (views of one dense (Np, Np) buffer); the products at ``precision``."""
    check_precision(precision)
    return _panels_of(_tri_inverse_dense(chol, chunks, precision)[0], chol.block)


def _kinv_from_dense(T_op, B: int, chunks: int, precision: str) -> List[Tensor]:
    P = T_op.shape[0] // B
    out = []
    for s in range(P):
        bounds = _chunk_bounds(s, P - s, chunks)
        out.append(torch.cat([matmul_at(T_op[r0 * B:, r0 * B:r1 * B].T,
                                        T_op[r0 * B:, s * B:(s + 1) * B], precision)
                              for r0, r1 in zip(bounds[:-1], bounds[1:]) if r1 > r0], dim=0))
    return out


def kinv_panels(chol: BlockedCholesky, precision: str = "highest",
                tinv: Optional[Sequence[Tensor]] = None, chunks: int = 6) -> List[Tensor]:
    """K⁻¹ = L⁻ᵀL⁻¹ as lower-triangle column panels: column panel s, rows
    [r0·B, r1·B) of a chunk, is T[r0B:, r0B:r1B]ᵀ @ T[r0B:, sB:(s+1)B]
    (the rows of T above r0·B are zero in those columns), at ``precision``.
    ``tinv``: the panels of :func:`tri_inverse_panels`, computed here when
    None."""
    check_precision(precision)
    if tinv is None:
        T_op = _tri_inverse_dense(chol, chunks, precision)[1]
    else:
        T_op = operand(_dense_lower(tinv), precision)
    return _kinv_from_dense(T_op, chol.block, chunks, precision)


def _pad_z(X: Tensor, ls: Tensor, Np: int) -> Tensor:
    """The ℓ-scaled points padded to Np with the far pseudo-points of
    ``stationary_gram_panels`` (row n + j at 10⁶·(1 + j) on every axis)."""
    n, D = X.shape
    Z = X / ls
    if Np > n:
        far = 1e6 * (1.0 + torch.arange(Np - n, dtype=Z.dtype, device=Z.device))[:, None]
        Z = torch.cat([Z, far.expand(Np - n, D)], 0)
    return Z


def _lml_forward(X: Tensor, Y2: Tensor, family: str, amp: Tensor, ls: Tensor, noise: Tensor,
                 jitter: float, block: int, refine_iters: Optional[int], precision: str):
    """Panels → factor → α with guarded refinement
    (``BlockedCholesky.refined_solve``) → LML; returns (value, chol, α)."""
    check_precision(precision)
    n, p = X.shape[0], Y2.shape[1]
    panels, _ = stationary_gram_panels(X, ls, amp, noise + jitter, block, family)
    chol = cholesky_panels(panels, n, precision)
    Yf = Y2.to(panels[0].dtype)
    alpha = chol.refined_solve(panels, Yf, refine_steps(len(panels), refine_iters), precision)
    val = -0.5 * (Yf * alpha).sum() - p * (0.5 * chol.logdet() + 0.5 * n * _LOG_2PI)
    return val, chol, alpha


def _lml_gradient(X: Tensor, family: str, amp: Tensor, ls: Tensor, noise: Tensor,
                  chol: BlockedCholesky, alpha: Tensor, p_out: int, precision: str,
                  chunks: int = 6) -> Tuple[Tensor, Tensor, Tensor]:
    """(∂LML/∂log amp, ∂LML/∂log ℓ (D,), ∂LML/∂log σ²) by the trace identity.

    W = ½(ααᵀ − P·K⁻¹) is formed panel by panel, weighted 2 on the blocks
    below the diagonal (stored once, counted twice) and 0 on padding; ∂K/∂θ
    is rebuilt elementwise per panel from the padded scaled points."""
    n, D = X.shape
    B, P, Np = chol.block, len(chol.panels), chol.padded_n
    kinv = kinv_panels(chol, precision, chunks=chunks)
    Z = _pad_z(X, ls, Np)
    a_p = alpha.to(Z.dtype)
    if Np > n:
        a_p = torch.cat([a_p, a_p.new_zeros(Np - n, a_p.shape[1])], 0)
    idx = torch.arange(Np, device=X.device)
    g_amp = Z.new_zeros(())
    g_ls = Z.new_zeros(D)
    g_noise = Z.new_zeros(())
    for k in range(P):
        rows = idx[k * B:, None]
        cols = idx[None, k * B:(k + 1) * B]
        w = torch.where(rows < (k + 1) * B, 1.0, 2.0).to(Z.dtype)
        w = torch.where((rows < n) & (cols < n), w, torch.zeros_like(w))
        Gk = a_p[k * B:] @ a_p[k * B:(k + 1) * B].T
        Wk = 0.5 * (Gk - p_out * kinv[k]) * w
        diffs = Z[k * B:, None, :] - Z[None, k * B:(k + 1) * B, :]  # (H, B, D)
        sq = diffs * diffs
        d2 = sq.sum(-1)
        g_amp = g_amp + (Wk * (amp * stationary_from_sqdist(d2, family))).sum()
        Wdk = Wk * (amp * stationary_dk_dd2(d2, family))
        g_ls = g_ls + (Wdk[..., None] * (-2.0 * sq)).sum((0, 1))
        g_noise = g_noise + noise * torch.diagonal(Wk[:B]).sum()
    return g_amp, g_ls, g_noise


def _hyper(log_amp, log_ls, log_noise, like: Tensor):
    """(amp, ℓ (1 or D,), noise) as tensors of ``like``'s dtype and device,
    outside autograd (the gradient is the closed form's)."""
    f = dict(dtype=like.dtype, device=like.device)
    return (torch.exp(torch.as_tensor(log_amp, **f).detach()),
            torch.exp(torch.as_tensor(log_ls, **f).detach()).reshape(-1),
            torch.exp(torch.as_tensor(log_noise, **f).detach()))


def blocked_lml_value_and_grad(X: Tensor, Y: Tensor, family: str, log_amp, log_ls, log_noise,
                               jitter: float = 1e-6, block: int = 512, precision: str = "highest",
                               refine_iters: Optional[int] = None):
    """(LML, (∂/∂log amp, ∂/∂log ℓ (D,), ∂/∂log σ²)) of the
    C·stationary(+White) GP on X (N, D), Y (N,) or (N, P), all blocked: about
    3·N³/3 product flops whatever the number of hyperparameters, plus
    O(N²·D) elementwise work.  The ℓ gradient is per input axis even for
    one shared ℓ (sum it for the shared one).  The products at
    ``precision``.  ``refine_iters`` None takes
    ``blocked_chol.refine_steps``'s rule
    (1 below 32 panels, 2 from 32)."""
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    amp, ls, noise = _hyper(log_amp, log_ls, log_noise, X)
    val, chol, alpha = _lml_forward(X, Y2, family, amp, ls, noise, jitter, block, refine_iters,
                                    precision)
    return val, _lml_gradient(X, family, amp, ls, noise, chol, alpha, Y2.shape[1], precision)


def blocked_lml_value(X: Tensor, Y: Tensor, family: str, log_amp, log_ls, log_noise,
                      jitter: float = 1e-6, block: int = 512, precision: str = "highest",
                      refine_iters: Optional[int] = None) -> Tensor:
    """The value of :func:`blocked_lml_value_and_grad` alone (the same bits):
    the Gram's panels, the factor and the refined solve, no K⁻¹."""
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    amp, ls, noise = _hyper(log_amp, log_ls, log_noise, X)
    return _lml_forward(X, Y2, family, amp, ls, noise, jitter, block, refine_iters,
                        precision)[0]


class _BlockedLML(torch.autograd.Function):
    """LML(log amp, log ℓ, log noise; X, Y) with the closed-form backward
    of :func:`_lml_gradient`; X gets no gradient, Y gets −α."""

    @staticmethod
    def forward(ctx, log_amp, log_ls, log_noise, X, Y, config):
        family, jitter, block, refine_iters, precision = config
        Y2 = Y[:, None] if Y.dim() == 1 else Y
        amp, ls, noise = _hyper(log_amp, log_ls, log_noise, X)
        val, chol, alpha = _lml_forward(X, Y2, family, amp, ls, noise, jitter, block,
                                        refine_iters, precision)
        ctx.family, ctx.chol, ctx.p_out, ctx.precision = family, chol, Y2.shape[1], precision
        ctx.ls_shape, ctx.y_shape = log_ls.shape, Y.shape
        ctx.save_for_backward(log_amp, log_ls, log_noise, X, alpha)
        return val

    @staticmethod
    def backward(ctx, g):
        log_amp, log_ls, log_noise, X, alpha = ctx.saved_tensors
        amp, ls, noise = _hyper(log_amp, log_ls, log_noise, X)
        g_amp, g_ls, g_noise = _lml_gradient(X, ctx.family, amp, ls, noise, ctx.chol, alpha,
                                             ctx.p_out, ctx.precision)
        if log_ls.numel() == 1 and g_ls.shape[0] > 1:  # one ℓ shared by the D axes
            g_ls = g_ls.sum()
        gY = (-alpha * g).reshape(ctx.y_shape)
        return ((g_amp * g).to(log_amp.dtype), (g_ls * g).reshape(ctx.ls_shape).to(log_ls.dtype),
                (g_noise * g).to(log_noise.dtype), None, gY, None)


def make_blocked_lml(family: str, jitter: float = 1e-6, block: int = 512,
                     precision: str = "highest", refine_iters: Optional[int] = None):
    """``lml(theta, X, Y) -> ()`` whose backward is the closed-form gradient
    (no autograd through the factorization), the products at
    ``precision``.  ``theta`` is the dict
    ``{'log_amp': (), 'log_ls': () or (D,), 'log_noise': ()}`` of tensors."""
    config = (family, jitter, block, refine_iters, check_precision(precision))

    def lml(theta, X: Tensor, Y: Tensor) -> Tensor:
        return _BlockedLML.apply(theta["log_amp"], theta["log_ls"], theta["log_noise"], X, Y,
                                 config)

    return lml
