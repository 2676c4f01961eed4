"""The exact LML and its hyperparameter gradient, distributed over a mesh axis.

Port of ``gaussian_process_transportation_tpu/parallel/sharded_lml.py``:
the panel LML of ``ops/blocked_lml.py`` on the block-cyclic factor of
``parallel/sharded_chol.py``, for GP hyperparameter fits past one card's
memory.  Every O(N²) object (Gram, factor, L⁻¹) lives in the ranks' own
panels; X and Y are replicated.

* **T = L⁻¹, block-cyclic** (:func:`_tri_inverse`): over the P global
  steps, the owner broadcasts its factored panel and its L_kk⁻¹ (one
  broadcast pair a step), and every rank advances the forward
  substitution of the T column panels it owns, in place.
* **Trace-identity gradient** (:func:`_trace_gradient`):
  ∂LML/∂θ = ½⟨ααᵀ − p·K⁻¹, ∂K/∂θ⟩ block pair by block pair: for column
  panel s the owner broadcasts T's panel s, and the owner of each column
  panel i ≥ s forms K⁻¹(i, s) = T(:, i)ᵀ T(:, s) as one product; ∂K is
  rebuilt elementwise from the replicated inputs
  (``ops.blocked_lml.stationary_dk_dd2``).  The three sums end in one
  ``all_reduce``.
* α, log det and the value come from the distributed substitution and
  log det of ``sharded_chol``; as in JAX there is no refinement of α.

θ = (log amplitude, log ℓ (one or D), log noise) of the
C·stationary(+White) family, stationary ∈ {rbf, matern12, matern32,
matern52}.  The products run at ``precision`` (``ops.linalg``'s mapping,
"highest" by default, as in JAX), each broadcast panel and each owned slot
of T split once.  ``mesh`` None runs the same algorithm in this process
alone.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import Tensor

from ..ops.blocked_lml import _hyper, stationary_dk_dd2
from ..ops.linalg import Split, check_precision, matmul_at, operand
from ..ops.pallas_gram import stationary_from_sqdist
from .mesh import MeshAxis, axis_of
from .sharded_chol import ShardedBlockedCholesky, _factor_gram, _own, _pad_rows

__all__ = ["fit_sharded", "make_sharded_lml", "sharded_lml_value", "sharded_lml_value_and_grad"]

_LOG_2PI = math.log(2.0 * math.pi)


def _tri_inverse(chol: ShardedBlockedCholesky, precision: str) -> List[Tensor]:
    """T = L⁻¹ in the factor's layout: this rank's column panel s of T is
    (Np − s·B, B), rows s·B… (T is zero above them)."""
    ax, B = chol._ax, chol.block
    P = chol.padded_n // B
    T = []
    for Lj in chol.panels:
        t = torch.zeros_like(Lj)
        t[:B].diagonal().fill_(1.0)  # the identity columns, solved for in place
        T.append(t)
    for k in range(P):
        owner, jk = k % ax.size, k // ax.size
        if owner == ax.index:
            Lk, linv = chol.panels[jk], chol.linvs[jk]
        else:
            Lk = T[0].new_empty(chol.padded_n - k * B, B)
            linv = T[0].new_empty(B, B)
        ax.broadcast(Lk, owner)
        ax.broadcast(linv, owner)
        Lk_op, linv_op = operand(Lk, precision), operand(linv, precision)
        for j, s in enumerate(_own(ax, P)):
            if s > k:
                break
            r = (k - s) * B  # panel k's rows in T's column panel s
            yk = matmul_at(linv_op, T[j][r:r + B], precision)
            T[j][r:r + B] = yk
            if Lk.shape[0] > B:
                if isinstance(Lk_op, Split):
                    T[j][r + B:].sub_(matmul_at(Lk_op[B:], yk, precision))
                else:
                    T[j][r + B:].addmm_(Lk[B:], yk, alpha=-1.0)
    return T


def _trace_gradient(T: List[Tensor], alpha: Tensor, Z: Tensor, ax: MeshAxis, block: int, n: int,
                    p_out: int, amp: Tensor, noise: Tensor, family: str,
                    precision: str) -> Tensor:
    """(∂/∂log amp, ∂/∂log σ², ∂/∂log ℓ (D,)) as one vector, summed over the
    axis.  ``alpha`` (Np, p) and ``Z`` (Np, D), the ℓ-scaled padded points,
    are replicated; the K⁻¹ blocks' products at ``precision``."""
    B, (Np, nd) = block, Z.shape
    P = Np // B
    g = Z.new_zeros(2 + nd)
    idx = torch.arange(B, device=Z.device)
    T_ops = [operand(t, precision) for t in T]
    for s in range(P):
        owner, js = s % ax.size, s // ax.size
        Ts = T[js] if owner == ax.index else T[0].new_empty(Np - s * B, B)
        ax.broadcast(Ts, owner)
        Ts_op = T_ops[js] if owner == ax.index else operand(Ts, precision)
        a_s, cols = alpha[s * B:(s + 1) * B], Z[s * B:(s + 1) * B]
        for j, i in enumerate(_own(ax, P)):
            if i < s:
                continue
            r = (i - s) * B
            # K⁻¹(i, s): rows of panel i, columns of panel s
            kinv = matmul_at(T_ops[j].T, Ts_op[r:], precision)
            a_i = alpha[i * B:(i + 1) * B]
            real = ((i * B + idx)[:, None] < n) & ((s * B + idx)[None, :] < n)
            W = 0.5 * (a_i @ a_s.T - p_out * kinv) * (1.0 if i == s else 2.0)
            W = torch.where(real, W, torch.zeros_like(W))
            sq = (Z[i * B:(i + 1) * B, None, :] - cols[None, :, :]) ** 2  # (B, B, D)
            d2 = sq.sum(-1)
            g[0] += (W * (amp * stationary_from_sqdist(d2, family))).sum()
            if i == s:
                g[1] += noise * torch.diagonal(W).sum()
            Wdk = W * (amp * stationary_dk_dd2(d2, family))
            g[2:] += (Wdk[..., None] * (-2.0 * sq)).sum((0, 1))
    return ax.all_reduce(g)


def _value(X: Tensor, Y2: Tensor, family: str, amp: Tensor, ls: Tensor, noise: Tensor,
           jitter: float, mesh, axis: str, block: int, precision: str):
    """Panels → distributed factor → α → LML; (value, factor, α (Np, p), Z)."""
    n, p = X.shape[0], Y2.shape[1]
    chol, Z = _factor_gram(X, ls, amp, noise + jitter, mesh, axis, block, family, precision)
    Yp = _pad_rows(Y2.to(Z.dtype), chol.padded_n)
    alpha = chol.solve_padded(Yp, precision)
    val = -0.5 * (Yp * alpha).sum() - p * (0.5 * chol.logdet() + 0.5 * n * _LOG_2PI)
    return val, chol, alpha, Z


def sharded_lml_value_and_grad(X: Tensor, Y: Tensor, family: str, log_amp, log_ls, log_noise,
                               mesh, axis: str = "data", block: int = 512,
                               jitter: float = 1e-6, precision: str = "highest"):
    """(LML, (∂/∂log amp, ∂/∂log ℓ (D,), ∂/∂log σ²)), distributed over
    ``axis``: X (n, D) and Y (n,) or (n, p) replicated, every rank of the
    axis calls it and gets the same result.  The ℓ gradient is per input
    axis even for one shared ℓ (sum it for the shared one).  The products
    at ``precision``."""
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    amp, ls, noise = _hyper(log_amp, log_ls, log_noise, X)
    val, chol, alpha, Z = _value(X, Y2, family, amp, ls, noise, jitter, mesh, axis, block,
                                 check_precision(precision))
    g = _trace_gradient(_tri_inverse(chol, precision), alpha, Z, chol._ax, block, X.shape[0],
                        Y2.shape[1], amp, noise, family, precision)
    return val, (g[0], g[2:], g[1])


def sharded_lml_value(X: Tensor, Y: Tensor, family: str, log_amp, log_ls, log_noise, mesh,
                      axis: str = "data", block: int = 512, jitter: float = 1e-6,
                      precision: str = "highest") -> Tensor:
    """The value of :func:`sharded_lml_value_and_grad` alone (the same
    bits): the factor, α and log det, no L⁻¹."""
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    amp, ls, noise = _hyper(log_amp, log_ls, log_noise, X)
    return _value(X, Y2, family, amp, ls, noise, jitter, mesh, axis, block,
                  check_precision(precision))[0]


class _ShardedLML(torch.autograd.Function):
    """LML(log amp, log ℓ, log noise; X, Y) whose forward computes the value
    and the gradient together (at multi-device N the factor is too large to
    keep for a later backward) and whose backward scales the saved
    gradient; X gets no gradient, Y gets −α."""

    @staticmethod
    def forward(ctx, log_amp, log_ls, log_noise, X, Y, config):
        family, mesh, axis, block, jitter, precision = config
        Y2 = Y[:, None] if Y.dim() == 1 else Y
        amp, ls, noise = _hyper(log_amp, log_ls, log_noise, X)
        val, chol, alpha, Z = _value(X, Y2, family, amp, ls, noise, jitter, mesh, axis, block,
                                     precision)
        g = _trace_gradient(_tri_inverse(chol, precision), alpha, Z, chol._ax, block,
                            X.shape[0], Y2.shape[1], amp, noise, family, precision)
        ctx.ls_shape, ctx.y_shape = log_ls.shape, Y.shape
        ctx.save_for_backward(g, alpha[: X.shape[0]], log_amp, log_ls, log_noise)
        return val

    @staticmethod
    def backward(ctx, gv):
        g, alpha, log_amp, log_ls, log_noise = ctx.saved_tensors
        g_ls = g[2:]
        if log_ls.numel() == 1 and g_ls.shape[0] > 1:  # one ℓ shared by the D axes
            g_ls = g_ls.sum()
        return ((g[0] * gv).to(log_amp.dtype), (g_ls * gv).reshape(ctx.ls_shape).to(log_ls.dtype),
                (g[1] * gv).to(log_noise.dtype), None, (-alpha * gv).reshape(ctx.y_shape), None)


def make_sharded_lml(family: str, mesh, axis: str = "data", block: int = 512,
                     jitter: float = 1e-6, precision: str = "highest"):
    """``lml(theta, X, Y) -> ()`` with the closed-form gradient, distributed:
    ``make_blocked_lml``'s contract (``theta`` the dict of ``log_amp``,
    ``log_ls`` () or (D,), ``log_noise``), every rank of ``axis`` calling
    it.  The forward computes the gradient as well (JAX's custom VJP
    recomputes it; either way one factorization an evaluation)."""
    config = (family, mesh, axis, block, jitter, check_precision(precision))

    def lml(theta, X: Tensor, Y: Tensor) -> Tensor:
        return _ShardedLML.apply(theta["log_amp"], theta["log_ls"], theta["log_noise"], X, Y,
                                 config)

    return lml


def fit_sharded(kernel, X: Tensor, Y: Tensor, mesh, axis: str = "data", maxiter: int = 30,
                block: int = 512, jitter: float = 1e-10, precision=None):
    """Distributed hyperparameter fit; returns (the fitted kernel, θ as the
    dict of ``log_amp``, ``log_ls`` (D,), ``log_noise``, the negative LML
    at the start of each iteration (maxiter,)).  Conditioning at the
    optimum is the caller's: :func:`sharded_gram_cholesky_solve` or, on
    one card, ``models.exact_gp.condition_blocked``.

    Mirrors ``models.exact_gp.fit_blocked``: ``maxiter`` iterations of
    optax's L-BFGS and zoom line search (``models._lbfgs.lbfgs_minimize``,
    one lane, every candidate a :func:`sharded_lml_value_and_grad`), as the
    JAX package's ``fit_sharded`` runs them, over the negative sharded LML;
    θ in float32 clipped to the log-bounds of the kernel's nodes after each
    step, a non-finite value read as 1e25 (its gradient NaN where the Gram
    does not factor), an iteration's first gradient with its non-finite
    entries set to 0, rows with NaN targets dropped.  Every rank computes
    the same values bit for bit, so every rank takes the same steps and
    reads the same end of each line search.  ``precision`` None is
    "highest", the JAX package's choice on every platform but a TPU.  The fitted kernel is
    Constant·base + White at the fitted values with the input nodes'
    bounds."""
    from ..kernels import Constant, Matern, RBF, White
    from ..kernels.stationary import DEFAULT_BOUNDS
    from ..models._lbfgs import lbfgs_minimize, negated_lml
    from ..models.exact_gp import (_eff_jitter, _family_nodes, _filter_nan_rows,
                                   stationary_family_params, white_noise_level)

    parts = stationary_family_params(kernel)
    if parts is None:
        raise ValueError("fit_sharded requires a C*stationary(+White) kernel; got "
                         f"{type(kernel).__name__}")
    fam, amp0, ls0 = parts
    const_node, base_node, white_node = _family_nodes(kernel)
    Xd, Y2 = _filter_nan_rows(X, Y)
    f32 = dict(dtype=torch.float32, device=X.device)
    Xd, Y2 = Xd.to(**f32), Y2.to(**f32)
    D = Xd.shape[1]

    def log_bounds(node):
        b = node.bounds if node is not None else DEFAULT_BOUNDS
        return math.log(b[0]), math.log(b[1])

    noise0 = torch.as_tensor(white_noise_level(kernel), **f32)
    x0 = torch.cat([torch.log(torch.as_tensor(amp0, **f32)).reshape(1),
                    torch.log(torch.as_tensor(ls0, **f32)).reshape(-1).expand(D),
                    torch.log(torch.clamp(noise0, min=1e-8)).reshape(1)])[:, None]
    rows = [log_bounds(const_node)] + [log_bounds(base_node)] * D + [log_bounds(white_node)]
    lo, hi = torch.tensor(rows, **f32).T[:, :, None]
    lml_kw = dict(mesh=mesh, axis=axis, block=block, jitter=_eff_jitter(torch.float32, jitter),
                  precision=check_precision("highest" if precision is None else precision))

    def nll_and_grad(x: Tensor):
        th = x[:, 0]
        val, (g_amp, g_ls, g_noise) = sharded_lml_value_and_grad(
            Xd, Y2, fam, th[0], th[1:1 + D], th[1 + D], **lml_kw)
        return negated_lml(val.reshape(1),
                           torch.cat([g_amp.reshape(1), g_ls, g_noise.reshape(1)])[:, None])

    x, vals, _ = lbfgs_minimize(nll_and_grad, x0, lo, hi, maxiter)
    vals = vals[:, 0]
    th = x[:, 0]
    theta = {"log_amp": th[0], "log_ls": th[1:1 + D], "log_noise": th[1 + D]}
    base_bounds = base_node.bounds if base_node is not None else DEFAULT_BOUNDS
    ls_fit = torch.exp(th[1:1 + D])
    base = (Matern(ls_fit, nu=base_node.nu, bounds=base_bounds) if isinstance(base_node, Matern)
            else RBF(ls_fit, bounds=base_bounds))
    fitted = Constant(torch.exp(th[0]), bounds=(const_node.bounds if const_node is not None
                                                else DEFAULT_BOUNDS)) * base + \
        White(torch.exp(th[1 + D]), bounds=(white_node.bounds if white_node is not None
                                            else DEFAULT_BOUNDS))
    return fitted, theta, vals
