"""Exact Gaussian-process regression on torch tensors.

Port of ``gaussian_process_transportation_tpu/models/exact_gp.py``: the
posterior state ``ExactGP``, dense conditioning with an optional cached
K⁻¹, large-N conditioning through the blocked Cholesky
(``condition_blocked``), the posterior mean and epistemic std (with the
fused dense-grid kernels of ``ops/pallas_gram.py`` on the card), the full
posterior covariance and samples, the Jacobian posterior and the gradient
of the predictive variance; and the hyperparameter fits: the log marginal
likelihood with its analytic gradient, ``fit`` (scipy L-BFGS-B with
restarts), ``fit_ensemble_fused`` (per-lane projected L-BFGS over the
fused small-LML kernel of ``ops/fused_lml.py``, one launch per candidate),
``fit_jit`` (the restarts of one dataset as lanes of optax's L-BFGS and
zoom line search, ``models/_lbfgs.py``) and ``fit_blocked`` (the large-N
fit, that L-BFGS over the blocked LML of ``ops/blocked_lml.py``).

Conventions follow the original project's sklearn wrapper: the std may
exclude the White-noise level (``epistemic_only``), and the Jacobian
variance is ``k''_dd(x, x) − dk K⁻¹ dkᵀ`` per direction d.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from ..kernels import DEFAULT_BOUNDS, Constant, Kernel, Matern, Product, RBF, Sum, White
from ..ops import fused_lml, pallas_gram
from ..ops.blocked_chol import BlockedCholesky, gram_cholesky_solve
from ..ops.linalg import (add_diagonal, check_precision, cho_solve_lower, log_det_from_chol,
                          tri_solve_lower)
from ..utils.logging_utils import span, spans_on, tally
from ._lbfgs import lbfgs_minimize, negated_lml

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class ExactGP:
    """Posterior state p(f | X, Y, kernel).  Tensors may carry a leading
    ensemble axis (one GP per member, as the batched transport builds).

    Exactly one of ``L`` (dense lower Cholesky) and ``chol`` (the panel
    form of ``condition_blocked``, one GP, no ensemble axis) is set."""

    kernel: Kernel
    X: Tensor  # (..., N, D) training inputs
    Y: Tensor  # (..., N, P) training targets
    alpha: Tensor  # (..., N, P) = K⁻¹ Y
    L: Optional[Tensor] = None  # (..., N, N) lower Cholesky of K + jitter·I
    chol: Optional[BlockedCholesky] = None  # panel factor (large N)
    K_inv: Optional[Tensor] = None  # (..., N, N) cached K⁻¹
    jitter: float = 1e-10


def _solve_lower_any(gp: ExactGP, B: Tensor) -> Tensor:
    """L⁻¹ B through whichever factor the GP carries."""
    if gp.chol is not None:
        return gp.chol.solve_lower(B)
    return tri_solve_lower(gp.L, B)


def _cho_solve_any(gp: ExactGP, B: Tensor) -> Tensor:
    """K⁻¹ B = L⁻ᵀ L⁻¹ B through whichever factor the GP carries."""
    if gp.chol is not None:
        return gp.chol.solve(B)
    return cho_solve_lower(gp.L, B)


def _eff_jitter(dtype: torch.dtype, jitter: float) -> float:
    """float32 Cholesky of dense-curve Grams needs ~1e-6 diagonal jitter
    even with a White term; float64 keeps the request."""
    if dtype == torch.float32:
        return max(jitter, 1e-6)
    return jitter


# condition() takes the blocked Cholesky from this N, for float32 CUDA
# tensors and a C·stationary(+White) kernel; below it, it takes
# torch.linalg.cholesky.  On an NVIDIA H100 80GB HBM3 (700 W, SM clock 1980
# MHz), with the many-CTA factor_panel of 0.26 ms and the Gram's panels in
# one launch, chip_smoke.py and scripts/time_port_routes.py --what chol
# timed the blocked solve (CUDA-event ms) slower at N=4096 (4.6-6.0 vs
# 4.1-4.2), either way at N=6144 (8.3 and 10.0 vs 9.0 and 8.8), and faster
# in every reading at N=8192 (13.07-13.23 vs 14.76-14.95, seven pairs over
# two calls), N=10240 (19.4-19.7 vs 22.0-22.2) and N=20480 (92.9 vs
# 106.8): the smallest N measured from which it always wins.
BLOCKED_CHOL_MIN_N = 8192


def condition(
    kernel: Kernel,
    X: Tensor,
    Y: Tensor,
    jitter: float = 1e-10,
    cache_k_inv: bool = False,
) -> ExactGP:
    """The GP posterior for fixed hyperparameters; ``cache_k_inv`` also
    stores the symmetrised K⁻¹ so variance queries become matmuls.

    A float32 CUDA X (N, D) with N ≥ ``BLOCKED_CHOL_MIN_N`` and a
    C·stationary(+White) kernel goes through :func:`condition_blocked`;
    the route follows X's device, not a process-wide default."""
    Y2 = Y if Y.dim() == 2 else Y[:, None]
    if (
        X.device.type == "cuda"
        and X.dim() == 2
        and X.shape[0] >= BLOCKED_CHOL_MIN_N
        and X.dtype == torch.float32
        and stationary_family_params(kernel) is not None
    ):
        return condition_blocked(kernel, X, Y2, jitter=jitter, cache_k_inv=cache_k_inv)
    K = add_diagonal(kernel(X), _eff_jitter(X.dtype, jitter))
    L = torch.linalg.cholesky(K)
    alpha = cho_solve_lower(L, Y2)
    K_inv = None
    if cache_k_inv:
        eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        K_inv = cho_solve_lower(L, eye)
        K_inv = 0.5 * (K_inv + K_inv.T)
    return ExactGP(kernel=kernel, X=X, Y=Y2, alpha=alpha, L=L, K_inv=K_inv, jitter=jitter)


def condition_blocked(
    kernel: Kernel,
    X: Tensor,
    Y: Tensor,
    jitter: float = 1e-10,
    cache_k_inv: bool = False,
    block: int = 512,
) -> ExactGP:
    """Large-N conditioning through the blocked Cholesky
    (``ops/blocked_chol.py``): the Gram is built in panels, factored panel
    by panel, and the GP carries the factor in panel form (``chol``); the
    dense (N, N) L is never formed, and every later variance query solves
    by blocked products.  Needs a C·stationary(+White) kernel."""
    Y2 = Y if Y.dim() == 2 else Y[:, None]
    params = stationary_family_params(kernel)
    if params is None:
        raise ValueError("condition_blocked needs a C·stationary(+White) kernel")
    fam, amp, ls = params
    noise = white_noise_level(kernel) + _eff_jitter(X.dtype, jitter)
    alpha, ch = gram_cholesky_solve(X, Y2, ls, amp, noise, block=block, family=fam)
    K_inv = None
    if cache_k_inv:
        K_inv = ch.solve(torch.eye(X.shape[0], dtype=alpha.dtype, device=X.device))
        K_inv = 0.5 * (K_inv + K_inv.T)
    return ExactGP(kernel=kernel, X=X, Y=Y2, alpha=alpha, chol=ch, K_inv=K_inv, jitter=jitter)


def white_noise_level(kernel: Kernel) -> Union[float, Tensor]:
    """Total additive White-noise level of a kernel expression (noise
    inside a Product is not additive and counts as 0)."""
    if isinstance(kernel, White):
        return kernel.noise_level
    if isinstance(kernel, Sum):
        return white_noise_level(kernel.k1) + white_noise_level(kernel.k2)
    return 0.0


def rbf_family_params(kernel: Kernel):
    """(amplitude, lengthscale) when the kernel is C·RBF(+White), the
    original project's transport kernel; None otherwise (the JAX package's
    older form of :func:`stationary_family_params`)."""
    params = stationary_family_params(kernel)
    if params is None or params[0] != "rbf" or isinstance(_family_nodes(kernel)[1], Matern):
        return None
    return params[1], params[2]


def rbf_hyperparameters(kernel: Kernel):
    """(amplitude, lengthscale, noise) of a C·RBF(+White) kernel, each as
    the kernel holds it: a number or a tensor, shared or per member (the
    amplitude 1.0 without a Constant, the noise 0.0 without a White).  None
    for any other kernel, a Matérn of ν = ∞ included."""
    if stationary_family_params(kernel) is None:
        return None
    const, base, _ = _family_nodes(kernel)
    if type(base) is not RBF:
        return None
    amplitude = 1.0 if const is None else const.constant_value
    return amplitude, base.lengthscale, white_noise_level(kernel)


_MATERN_FAMILY = {0.5: "matern12", 1.5: "matern32", 2.5: "matern52", math.inf: "rbf"}


def _base_stationary_family(kernel: Kernel) -> Optional[str]:
    if isinstance(kernel, RBF):
        return "rbf"
    if isinstance(kernel, Matern):
        return _MATERN_FAMILY.get(kernel.nu)
    return None


def stationary_family_params(kernel: Kernel):
    """(family, amplitude, lengthscale) when the kernel is C·stationary
    (+White) with an RBF or Matérn(ν ∈ {½, 3⁄2, 5⁄2}) base; None otherwise.
    White adds nothing to cross-covariances and is ignored."""
    if isinstance(kernel, Sum):
        if isinstance(kernel.k2, White):
            return stationary_family_params(kernel.k1)
        if isinstance(kernel.k1, White):
            return stationary_family_params(kernel.k2)
        return None
    if isinstance(kernel, Product):
        if isinstance(kernel.k1, Constant):
            const, base = kernel.k1, kernel.k2
        elif isinstance(kernel.k2, Constant):
            const, base = kernel.k2, kernel.k1
        else:
            return None
        fam = _base_stationary_family(base)
        if fam is None:
            return None
        return fam, const.constant_value, torch.as_tensor(base.lengthscale).reshape(-1)
    fam = _base_stationary_family(kernel)
    if fam is None:
        return None
    return fam, 1.0, torch.as_tensor(kernel.lengthscale).reshape(-1)


def _noise_std(kernel: Kernel, like: Tensor) -> Tensor:
    """sqrt of the White-noise level, shaped against a std (E, …, Q) when
    the kernel carries one noise level per member."""
    noise = torch.as_tensor(white_noise_level(kernel), dtype=like.dtype, device=like.device)
    if noise.dim():
        noise = noise.reshape(noise.shape + (1,) * (like.dim() - noise.dim()))
    return torch.sqrt(noise)


# predict() takes the fused mean kernel when the (Nq, N) Gram would have
# FUSED_PREDICT_MIN_ELEMS elements or more.  scripts/time_port_routes.py
# --what route timed predict() both ways on an NVIDIA H100 80GB HBM3,
# 700 W, SM clock 1980 MHz, at Nq·N from 2,048 to 2.05·10⁷ (Nq = 10⁴ with
# N = 1 … 2048, N = 2048 with Nq = 1 … 4096), four readings a size over two
# calls: the kernel won at every size, by device time (0.0121 against
# 0.0205–0.0206 ms at Nq = 1, N = 2048; 0.0227 against 0.7915–0.7932 at
# Nq = 10⁴, N = 2048) and by CUDA-event time of the call (0.1649–0.2684
# against 0.3413–0.5328 ms; 0.1412–0.2412 against 0.8480–1.0000): two
# launches and no (Nq, N) Gram against the dense path's five.  Smaller
# Gram sizes were not timed.  The JAX package's threshold was 2²¹.
#
# The mean-and-variance kernel is taken from FUSED_MEAN_VAR_MIN_ELEMS (the
# JAX package's threshold) up to N = FUSED_MEAN_VAR_MAX_N: the largest
# training size at which chip_smoke.py measured the kernel no slower than
# the dense path (k K⁻¹ through cuBLAS) at Nq = 10⁴ on the same card.
# It took 0.55 of the dense path's time at N = 512 and 0.90 at N = 2048,
# and lost at N = 4096 (1.08): cuBLAS's product runs faster than the
# kernel's, and the dense path's other passes weigh less as N grows.
FUSED_PREDICT_MIN_ELEMS = 2**11
FUSED_MEAN_VAR_MIN_ELEMS = 2**21
FUSED_MEAN_VAR_MAX_N = 2048


def fused_predict_route(device_type: str, x_dtype: torch.dtype, alpha_dtype: torch.dtype,
                        Nq: int, N: int, D: int, P: int, has_k_inv: bool,
                        return_std: bool) -> Optional[str]:
    """Which fused kernel predict() takes for 2-D queries (Nq, D) on N
    training points with P outputs: "mean", "mean_var", or None for the
    dense path.  The kernels take float32 CUDA tensors, D ≤ ``MAX_D`` and
    P ≤ ``MAX_P``; the mean pays from Nq·N ≥ ``FUSED_PREDICT_MIN_ELEMS``,
    the std from Nq·N ≥ ``FUSED_MEAN_VAR_MIN_ELEMS`` with a cached K⁻¹ and
    N ≤ ``FUSED_MEAN_VAR_MAX_N``."""
    if device_type != "cuda" or x_dtype != torch.float32 or alpha_dtype != torch.float32:
        return None
    if D > pallas_gram.MAX_D or P > pallas_gram.MAX_P:
        return None
    if not return_std:
        return "mean" if Nq * N >= FUSED_PREDICT_MIN_ELEMS else None
    if Nq * N < FUSED_MEAN_VAR_MIN_ELEMS or not has_k_inv or N > FUSED_MEAN_VAR_MAX_N:
        return None
    return "mean_var"


def _fused_predict_params(gp: ExactGP, x: Tensor, return_std: bool = False):
    """(route, family, amplitude, lengthscale) when predict() should take a
    fused kernel (:func:`fused_predict_route`, 2-D x and X, a
    C·stationary(+White) kernel); None otherwise."""
    if x.dim() != 2 or gp.X.dim() != 2:
        return None
    route = fused_predict_route(x.device.type, x.dtype, gp.alpha.dtype, x.shape[0],
                                gp.X.shape[0], x.shape[1], gp.alpha.shape[1],
                                gp.K_inv is not None, return_std)
    params = None if route is None else stationary_family_params(gp.kernel)
    return None if params is None else (route, *params)


def predict(
    gp: ExactGP,
    x: Tensor,
    return_std: bool = False,
    epistemic_only: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Posterior mean (and std) at query points x (Nq, D) → (Nq, P).

    The std includes the White-noise level (sklearn's convention) unless
    ``epistemic_only``, which subtracts sqrt(noise_level) as the original
    project does, and clamps the difference at 0: the variance is at least
    the noise level in exact arithmetic, and float32 cancellation near the
    training points can take it below (a float32 GP of 20,000 points with
    noise 8.4e-5 read −1.72e-3 on an H100 where float64 reads 7.4e-5; the
    JAX package keeps the negative value).

    Dense grids on the card (see :func:`fused_predict_route`) take the
    fused kernels, which never write the (Nq, N) Gram: the mean kernel, or
    with ``return_std`` and a cached K⁻¹ the mean-and-variance kernel."""
    fused = _fused_predict_params(gp, x, return_std)
    if fused is not None:
        route, fam, amp, ls = fused
        if route == "mean":
            return pallas_gram.fused_gp_predict_mean(x, gp.X, gp.alpha, ls, amp, family=fam)
        prior = amp + white_noise_level(gp.kernel)
        mean, var = pallas_gram.fused_gp_predict_mean_var(
            x, gp.X, gp.alpha, gp.K_inv, ls, amp, prior, family=fam)
        std = torch.sqrt(var)
        if epistemic_only:
            std = torch.clamp(std - _noise_std(gp.kernel, std), min=0.0)
        return mean, std[:, None].expand(mean.shape)

    k_star = gp.kernel(x, gp.X)  # cross-covariance: White contributes zeros
    mean = k_star @ gp.alpha
    if not return_std:
        return mean
    if gp.K_inv is not None:
        var = gp.kernel.diag(x) - ((k_star @ gp.K_inv) * k_star).sum(-1)
    else:
        V = _solve_lower_any(gp, k_star.transpose(-1, -2))  # (N, Nq)
        var = gp.kernel.diag(x) - (V * V).sum(-2)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    if epistemic_only:
        std = torch.clamp(std - _noise_std(gp.kernel, std), min=0.0)
    return mean, std[..., None].expand(mean.shape)


def predict_cov(gp: ExactGP, x: Tensor) -> Tuple[Tensor, Tensor]:
    """Posterior mean (Nq, P) and full covariance (Nq, Nq), shared across
    outputs."""
    k_star = gp.kernel(x, gp.X)
    mean = k_star @ gp.alpha
    V = _solve_lower_any(gp, k_star.transpose(-1, -2))
    return mean, gp.kernel(x) - V.transpose(-1, -2) @ V


def sample_y(
    gp: ExactGP, x: Tensor, generator: Optional[torch.Generator] = None, n_samples: int = 10
) -> Tensor:
    """Posterior function samples at x, samples first: (n_samples, Nq, P).
    The standard normals come from ``generator`` (on x's device)."""
    mean, cov = predict_cov(gp, x)
    L = torch.linalg.cholesky(add_diagonal(cov, 1e-8))
    eps = torch.randn((n_samples,) + tuple(mean.shape), generator=generator,
                      dtype=mean.dtype, device=mean.device)
    return mean[None] + torch.einsum("ij,sjp->sip", L, eps)


def jacobian(
    gp: ExactGP, x: Tensor, return_var: bool = False
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Posterior mean (and per-entry variance) of ∂f/∂x at x (Nq, D).

    Mean (Nq, P, D) with entry [i, p, d] = ∂f_p/∂x_d at x_i; the variance
    has the same shape and is shared across outputs p."""
    dk = gp.kernel.dx(x, gp.X)  # (Nq, N, D)
    mean = torch.einsum("qnd,np->qpd", dk, gp.alpha)
    if not return_var:
        return mean
    prior = gp.kernel.dxdz_diag(x)  # (Nq, D)
    if gp.K_inv is not None:
        dkKi = torch.einsum("qnd,nm->qmd", dk, gp.K_inv)
        quad = torch.einsum("qmd,qmd->qd", dkKi, dk)
    elif gp.chol is not None:
        # one blocked forward substitution for all D directions: an
        # (N, Nq·D) right-hand side keeps the products large
        Nq, N, D = dk.shape
        V = gp.chol.solve_lower(dk.permute(1, 0, 2).reshape(N, Nq * D))
        quad = (V * V).reshape(N, Nq, D).sum(0)
    else:
        V = tri_solve_lower(gp.L, dk.permute(2, 1, 0))  # (D, N, Nq)
        quad = (V * V).sum(1).T
    var = prior - quad
    return mean, var[:, None, :].expand(mean.shape)


def variance_gradient(gp: ExactGP, x: Tensor) -> Tensor:
    """∂σ²(x)/∂x of the predictive variance, (Nq, D):
    dσ²/dx_d = −2 Σ_nm ∂k(x, X_n)/∂x_d [K⁻¹]_nm k(X_m, x)."""
    k_star = gp.kernel(x, gp.X)  # (Nq, N)
    dk = gp.kernel.dx(x, gp.X)  # (Nq, N, D)
    if gp.K_inv is not None:
        Kinv_k = gp.K_inv @ k_star.T  # (N, Nq)
    else:
        Kinv_k = _cho_solve_any(gp, k_star.T)
    return -2.0 * torch.einsum("qnd,nq->qd", dk, Kinv_k)


# ---------------------------------------------------------------------------
# Marginal likelihood and hyperparameter fitting
# ---------------------------------------------------------------------------


class _SmallLML(torch.autograd.Function):
    """log p(Y | K) of a Gram K (..., N, N) and targets Y (..., N, P), with
    the analytic backward dLML/dK = ½(ααᵀ − P·K⁻¹) and dLML/dY = −α: no
    autograd through the factorization; the caller's autograd pulls dK back
    through the Gram build.  A K that is not positive definite gives NaN.
    ``apply`` returns (LML, L, α), the last two not differentiable; the
    forward is written for ``torch.func`` too (``vmap`` over chains,
    ``grad``: the generic route of ``parallel.samplers``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(K, Y2):
        n, p = K.shape[-1], Y2.shape[-1]
        L, info = torch.linalg.cholesky_ex(K)
        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        L = torch.where((info != 0)[..., None, None], eye, L)  # keeps the solves finite
        alpha = torch.cholesky_solve(Y2, L)
        val = -0.5 * (Y2 * alpha).sum((-2, -1)) - p * (0.5 * log_det_from_chol(L)
                                                       + 0.5 * n * _LOG_2PI)
        return torch.where(info != 0, torch.full_like(val, math.nan), val), L, alpha

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, L, alpha = output
        ctx.mark_non_differentiable(L, alpha)
        ctx.save_for_backward(L, alpha)

    @staticmethod
    def backward(ctx, g, _g_L, _g_alpha):
        L, alpha = ctx.saved_tensors
        p = alpha.shape[-1]
        W = 0.5 * (alpha @ alpha.transpose(-1, -2) - p * torch.cholesky_inverse(L))
        g = g[..., None, None]
        return W * g, -alpha * g


def log_marginal_likelihood(kernel: Kernel, X: Tensor, Y: Tensor, jitter: float = 1e-10) -> Tensor:
    """log p(Y | X, kernel), summed over output columns (sklearn semantics).

    X (..., N, D) and Y (..., N, P) or (..., N) may carry leading ensemble
    axes, and the kernel per-member hyperparameters; the result is then
    (...,).  For N ≤ 64 the gradient is the analytic trace identity of
    :class:`_SmallLML` (the JAX package's ``_lml_small`` custom VJP),
    pulled back through the Gram build only; larger N differentiate
    through the Cholesky.  A Gram that is not positive definite gives NaN,
    as XLA's Cholesky does, so a fit's lanes can read it as a bad value."""
    Y2 = Y[..., None] if Y.dim() == X.dim() - 1 else Y
    K = add_diagonal(kernel(X), jitter)
    n, p = X.shape[-2], Y2.shape[-1]
    if n <= 64:
        return _SmallLML.apply(K, Y2)[0]
    L, info = torch.linalg.cholesky_ex(K)
    alpha = cho_solve_lower(L, Y2)
    val = -0.5 * (Y2 * alpha).sum((-2, -1)) - p * (0.5 * log_det_from_chol(L)
                                                   + 0.5 * n * _LOG_2PI)
    return torch.where(info != 0, torch.full_like(val, math.nan), val)


def _filter_nan_rows(X: Tensor, Y: Tensor) -> Tuple[Tensor, Tensor]:
    """Drop the rows whose targets hold a NaN (the original project's GP
    wrapper does so before fitting)."""
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    keep = ~torch.isnan(Y2).any(dim=1)
    if bool(keep.all()):
        return X, Y2
    return X[keep], Y2[keep]


def small_lml_theta_layout(kernel: Kernel):
    """(family, n_ls, has_noise, perm) when ``kernel.theta`` maps onto the
    canonical fused-LML layout ``[log amp, log ℓ…, log noise]``
    (``ops/fused_lml.py``); None otherwise.  ``perm[i]`` is the
    ``kernel.theta`` index of canonical row ``i``."""
    info = stationary_family_params(kernel)
    if info is None:
        return None
    pos = {}
    off = 0
    for leaf in kernel._leaves():
        if isinstance(leaf, Constant):
            key, size = "amp", 1
        elif isinstance(leaf, White):
            key, size = "noise", 1
        elif _base_stationary_family(leaf) is not None:
            key, size = "ls", torch.as_tensor(leaf.lengthscale).numel()
        else:
            return None
        if key in pos:
            return None  # two amplitudes, noises or lengthscales
        pos[key] = (off, size)
        off += size
    if "amp" not in pos or "ls" not in pos:
        return None
    n_ls = pos["ls"][1]
    perm = [pos["amp"][0], *range(pos["ls"][0], pos["ls"][0] + n_ls)]
    if "noise" in pos:
        perm.append(pos["noise"][0])
    if len(perm) != off:
        return None
    return info[0], n_ls, "noise" in pos, np.asarray(perm)


def fit(
    kernel: Kernel,
    X: Tensor,
    Y: Tensor,
    n_restarts: int = 5,
    generator: Optional[torch.Generator] = None,
    jitter: float = 1e-10,
    maxiter: int = 200,
) -> ExactGP:
    """sklearn-parity hyperparameter fit: scipy's L-BFGS-B over the negative
    log marginal likelihood and its gradient (evaluated in X's dtype on
    X's device), from ``kernel.theta`` and ``n_restarts`` starts uniform in
    the log-space bounds, then conditioning at the best.  Rows with NaN
    targets are dropped first; a non-finite value counts as 1e25.  The
    restarts are drawn from ``generator`` (a CPU generator; seed 0 when
    None)."""
    from scipy.optimize import minimize

    Xd, Yd = _filter_nan_rows(X, Y)
    theta0 = kernel.theta.detach().double().cpu().numpy()
    if theta0.size == 0:
        return condition(kernel, Xd, Yd, jitter)
    bounds = kernel.theta_bounds.numpy()

    def obj(theta_np):
        theta = torch.tensor(theta_np, dtype=torch.float64, device=Xd.device, requires_grad=True)
        v = -log_marginal_likelihood(kernel.with_theta(theta), Xd, Yd, jitter)
        v.backward()
        val = v.item()
        g = theta.grad.cpu().numpy()
        if not np.isfinite(val) or not np.all(np.isfinite(g)):
            return 1e25, np.zeros_like(g)
        return val, g

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    starts = [theta0]
    if n_restarts > 0:
        u = torch.rand((n_restarts, theta0.size), generator=generator, dtype=torch.float64)
        starts.extend(bounds[:, 0] + u.numpy() * (bounds[:, 1] - bounds[:, 0]))
    best_val, best_theta = np.inf, theta0
    for s0 in starts:
        res = minimize(obj, s0, jac=True, method="L-BFGS-B", bounds=list(map(tuple, bounds)),
                       options={"maxiter": maxiter})
        if res.fun < best_val:
            best_val, best_theta = res.fun, res.x
    fitted = kernel.with_theta(torch.as_tensor(best_theta, device=Xd.device))
    return condition(fitted, Xd, Yd, jitter)


def _lbfgs_elast(
    value_and_grad_b: Callable[[Tensor], Tuple[Tensor, Tensor]],
    x0: Tensor,
    lower: Tensor,
    upper: Tensor,
    maxiter: int,
    m: int = 8,
    armijo_c: float = 1e-4,
    max_backtrack: int = 6,
    value_b: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """Per-lane projected L-BFGS (minimization) on (T, L) parameters.

    Every lane optimizes on its own: the two-loop recursion's inner
    products are per-lane sums over the T rows, the histories are (m, T, L)
    buffers with ρ = 0 marking empty or degenerate slots, and the Armijo
    backtracking halves each lane's step by itself.  One batched call per
    candidate: 1 + maxiter·(max_backtrack + 1) in all, of which the
    maxiter·max_backtrack Armijo candidates, whose gradient is not used, go
    to ``value_b`` (values only; by default the value of
    ``value_and_grad_b``).  ``value_b`` must give the values
    ``value_and_grad_b`` gives, bit for bit, or the path changes.  No host
    read.  Returns (x, value).  The JAX package runs it for
    ``fit_ensemble_fused`` only, as the port does.

    While spans are on (``utils.logging_utils``) each iteration's
    direction, search and update are spans on the host's clock alone (on an
    H100 host a span with CUDA events took ~40 µs, one without ~3 µs, and
    a fit of 30 iterations opens 91), and two
    tallies go to ``collect()``: ``exact_gp.lbfgs.candidate_lanes``, the
    lanes times the candidates, and ``exact_gp.lbfgs.useful_candidate_lanes``,
    the lane-candidates evaluated before the lane met the Armijo test, the
    one that met it included (a lane that has met it evaluates the same
    point again).  A lane that met it at candidate j keeps t = 2⁻ʲ, one
    that never did ends at 2^-max_backtrack, so the steps' exponents give
    the count after the loop, with no read inside it."""
    if value_b is None:
        def value_b(x):
            return value_and_grad_b(x)[0]
    T, L = x0.shape
    steps = [] if spans_on() else None  # each iteration's t, for the tally

    def dot(a, b):
        return (a * b).sum(0)

    def clip(x):
        return torch.minimum(torch.maximum(x, lower), upper)

    x = x0
    with span("exact_gp.lbfgs.update"):
        v, g = value_and_grad_b(x0)
        S = x0.new_zeros((m, T, L))
        Yh = x0.new_zeros((m, T, L))
        rho = x0.new_zeros((m, L))
    for _ in range(maxiter):
        with span("exact_gp.lbfgs.direction"):
            q = g
            alphas = []
            for kk in range(m):
                a = rho[kk] * dot(S[kk], q)
                q = q - a[None, :] * Yh[kk]
                alphas.append(a)
            gamma = torch.where(rho[0] > 0.0,
                                dot(S[0], Yh[0]) / torch.clamp(dot(Yh[0], Yh[0]), min=1e-30),
                                torch.ones_like(rho[0]))
            r = gamma[None, :] * q
            for kk in reversed(range(m)):
                b = rho[kk] * dot(Yh[kk], r)
                r = r + S[kk] * (alphas[kk] - b)[None, :]
            d = -r
            d = torch.where((dot(d, g) < 0.0)[None, :], d, -g)  # else steepest descent
            dg = torch.clamp(dot(d, g), max=-1e-30)
        with span("exact_gp.lbfgs.search"):
            t = x0.new_ones(L)
            for _ in range(max_backtrack):
                v_try = value_b(clip(x + t[None, :] * d))
                ok = v_try <= v + armijo_c * t * dg
                t = torch.where(ok, t, 0.5 * t)
            if steps is not None:
                steps.append(t)
        with span("exact_gp.lbfgs.update"):
            x_new = clip(x + t[None, :] * d)
            v_new, g_new = value_and_grad_b(x_new)
            # keep only steps that decreased (the last halving was not checked)
            good = v_new <= v
            x_new = torch.where(good[None, :], x_new, x)
            g_new = torch.where(good[None, :], g_new, g)
            v_new = torch.where(good, v_new, v)
            s, yv = x_new - x, g_new - g
            sy = dot(s, yv)
            rho_new = torch.where(sy > 1e-12,
                                  1.0 / torch.where(sy > 1e-12, sy, torch.ones_like(sy)),
                                  torch.zeros_like(sy))
            S = torch.cat([s[None], S[:-1]], 0)
            Yh = torch.cat([yv[None], Yh[:-1]], 0)
            rho = torch.cat([rho_new[None], rho[:-1]], 0)
            x, v, g = x_new, v_new, g_new
    if steps:  # t = 2^-j has frexp's exponent 1 - j: j + 1 candidates, at most max_backtrack
        useful = torch.clamp(2 - torch.frexp(torch.stack(steps)).exponent, max=max_backtrack)
        tally("exact_gp.lbfgs.useful_candidate_lanes", useful.sum())  # held until collect()
        tally("exact_gp.lbfgs.candidate_lanes", useful.numel() * max_backtrack)
    return x, v


def fit_ensemble_fused(
    kernel: Kernel,
    Xe: Tensor,
    Ye: Tensor,
    n_restarts: int = 6,
    generator: Optional[torch.Generator] = None,
    jitter: float = 1e-10,
    maxiter: int = 40,
) -> Tuple[Tensor, Tensor]:
    """Batched multi-restart hyperparameter fits: member e fits its own
    dataset (Xe[e] (n, D), Ye[e] (n, p)); all members × (1 + n_restarts)
    starts optimize as lanes of one :func:`_lbfgs_elast`, whose value and
    gradient is one call of ``ops.fused_lml.small_lml_value_grad_md`` per
    candidate (the Armijo candidates' values alone from its value-only
    twin ``_small_lml_value_md``, the same bits): the kernels for CUDA
    tensors, their plain twins for CPU ones.

    The first start of each member is ``kernel.theta``, the others uniform
    in the log-space bounds, drawn from ``generator`` (on Xe's device;
    seed 0 when None).  Work is in float32, as in the kernel.  Returns
    (thetas (E, n_theta) in ``kernel.theta`` order, LML (E,)).  Needs the
    C·stationary(+White) family and n ≤ 32."""
    with span("exact_gp.fit_ensemble", Xe.device):
        layout = small_lml_theta_layout(kernel)
        if layout is None:
            raise ValueError("fit_ensemble_fused needs the C·stationary(+White) family")
        family, n_ls, has_noise, perm_np = layout
        E, n, D = Xe.shape
        Ye3 = Ye[:, :, None] if Ye.dim() == 2 else Ye
        device = Xe.device
        perm = torch.as_tensor(perm_np, device=device)
        inv_perm = torch.as_tensor(np.argsort(perm_np), device=device)
        f32 = dict(dtype=torch.float32, device=device)
        bounds = kernel.theta_bounds.to(**f32)
        lo, hi = bounds[:, 0], bounds[:, 1]
        T = lo.shape[0]
        R = n_restarts + 1
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        u = torch.rand((E, n_restarts, T), generator=generator, **f32)
        starts = torch.cat([kernel.theta.to(**f32).expand(E, 1, T), lo + u * (hi - lo)], 1)
        x0 = starts.reshape(E * R, T)[:, perm].T.contiguous()  # (T, L), member-major lanes

        Xe_t = Xe.to(torch.float32).repeat_interleave(R, 0).contiguous()
        Ye_t = Ye3.to(torch.float32).repeat_interleave(R, 0).contiguous()

        lml_kw = dict(family=family, n_ls=n_ls, has_noise=has_noise, jitter=jitter)

        def nll(val):
            v = -val
            bad = ~torch.isfinite(v)
            return torch.where(bad, torch.full_like(v, 1e25), v), bad

        def nll_b(th):
            val, grad = fused_lml.small_lml_value_grad_md(Xe_t, Ye_t, th.contiguous(), **lml_kw)
            v, bad = nll(val)
            g = torch.where(torch.isfinite(grad) & ~bad[None, :], -grad, torch.zeros_like(grad))
            return v, g

        def nll_value_b(th):  # the line search's candidates: the same values, no gradient
            return nll(fused_lml._small_lml_value_md(Xe_t, Ye_t, th.contiguous(), **lml_kw))[0]

        x, v = _lbfgs_elast(nll_b, x0, lo[perm][:, None], hi[perm][:, None], maxiter,
                            value_b=nll_value_b)
        v_er = v.reshape(E, R)
        best = v_er.argmin(1)
        x_er = x.T.reshape(E, R, T)
        th_best = x_er[torch.arange(E, device=device), best]
        return th_best[:, inv_perm], -v_er[torch.arange(E, device=device), best]


def fit_jit(
    kernel: Kernel,
    X: Tensor,
    Y: Tensor,
    n_restarts: int = 5,
    generator: Optional[torch.Generator] = None,
    jitter: float = 1e-10,
    maxiter: int = 100,
) -> ExactGP:
    """Multi-restart fit with every restart a lane of optax's L-BFGS and
    zoom line search (:func:`._lbfgs.lbfgs_minimize`, ``maxiter``
    iterations, θ clipped to the log-space bounds after each), as the JAX
    package's ``fit_jit`` runs them under ``vmap``; then conditioning at
    the lane of the lowest negative LML at its final θ.

    The starts are ``kernel.theta`` (clipped to the log-space bounds) and
    ``n_restarts`` draws uniform in them from ``generator`` (a CPU
    generator, so that every device starts from the same points; seed 0
    when None).  All lanes share (X, Y), so their value and gradient is
    one batched call a line-search candidate:

    * fused, for a kernel of the fused family (:func:`small_lml_theta_layout`)
      and n ≤ ``fused_lml.MAX_N``: ``ops.fused_lml.small_lml_value_grad``,
      kernel #2 for float32 CUDA tensors (one launch a candidate), its plain
      twin in X's dtype for CPU ones;
    * otherwise (a float64 CUDA X too) ``torch.func.vmap`` of the LML's
      gradient over the lanes, in X's dtype, for any kernel.

    A non-finite value reads 1e25, its gradient 0·∂ (NaN where the Gram
    does not factor, which the line search reads as outside the domain),
    and an iteration's first gradient has its non-finite entries set to 0.
    The fit conditions on the best lane whose Gram factors (the next best
    where a float32 Gram at the noise floor does not; JAX's would give
    NaN).  Rows with NaN targets are dropped first."""
    Xd, Y2 = _filter_nan_rows(X, Y)
    theta0 = kernel.theta
    if theta0.numel() == 0:
        return condition(kernel, Xd, Y2, jitter)
    device, dtype = Xd.device, Xd.dtype
    layout = small_lml_theta_layout(kernel)
    use_fused = (layout is not None and Xd.shape[0] <= fused_lml.MAX_N
                 and (device.type == "cpu" or dtype == torch.float32))
    bounds = kernel.theta_bounds.to(dtype=dtype, device=device)
    lo, hi = bounds[:, 0], bounds[:, 1]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    u = torch.rand((max(n_restarts, 0), lo.shape[0]), generator=generator, dtype=torch.float64)
    u = u.to(dtype=dtype, device=device)
    starts = torch.cat([theta0.to(dtype=dtype, device=device)[None], lo + u * (hi - lo)])
    starts = torch.minimum(torch.maximum(starts, lo), hi)  # every lane inside the bounds

    if use_fused:
        family, n_ls, has_noise, perm_np = layout
        perm = torch.as_tensor(perm_np, device=device)
        inv_perm = torch.as_tensor(np.argsort(perm_np), device=device)
        Xc, Yc = Xd.contiguous(), Y2.to(dtype).contiguous()

        def lml_lanes(th: Tensor) -> Tuple[Tensor, Tensor]:
            val, grad = fused_lml.small_lml_value_grad(
                Xc, Yc, th[perm].contiguous(), family=family, n_ls=n_ls, has_noise=has_noise,
                jitter=jitter)
            return val, grad[inv_perm]
    else:
        from torch.func import grad_and_value, vmap

        Yc = Y2.to(dtype)
        lanes = vmap(grad_and_value(
            lambda th: log_marginal_likelihood(kernel.with_theta(th), Xd, Yc, jitter)))

        def lml_lanes(th: Tensor) -> Tuple[Tensor, Tensor]:
            grad, val = lanes(th.T)
            return val, grad.T

    def nll_b(th: Tensor) -> Tuple[Tensor, Tensor]:
        return negated_lml(*lml_lanes(th))

    x, _, v = lbfgs_minimize(nll_b, starts.T.contiguous(), lo[:, None], hi[:, None], maxiter,
                             final_value=True)
    # the best lane whose Gram factors in X's dtype: a float32 fit at its
    # noise floor can reach a Gram that condition()'s Cholesky refuses
    for lane in torch.argsort(v, stable=True).tolist():
        try:
            return condition(kernel.with_theta(x[:, lane]), Xd, Y2, jitter)
        except torch.linalg.LinAlgError:
            continue
    raise torch.linalg.LinAlgError("fit_jit: no lane's Gram is positive definite")


def _family_nodes(kernel: Kernel):
    """(Constant, stationary base, White) nodes of a C·stationary(+White)
    kernel tree; a missing one is None."""
    nodes = {"const": None, "base": None, "white": None}

    def walk(k):
        if isinstance(k, (Sum, Product)):
            walk(k.k1)
            walk(k.k2)
        elif isinstance(k, Constant):
            nodes["const"] = k
        elif isinstance(k, White):
            nodes["white"] = k
        elif isinstance(k, (RBF, Matern)):
            nodes["base"] = k

    walk(kernel)
    return nodes["const"], nodes["base"], nodes["white"]


def fit_blocked(
    kernel: Kernel,
    X: Tensor,
    Y: Tensor,
    maxiter: int = 40,
    jitter: float = 1e-10,
    block: int = 512,
    precision: Optional[str] = None,
    refine_iters: Optional[int] = None,
) -> ExactGP:
    """Large-N hyperparameter fit through the blocked panel Cholesky.

    ``maxiter`` iterations of optax's L-BFGS and zoom line search
    (:func:`._lbfgs.lbfgs_minimize`, one lane), as the JAX package's
    ``fit_blocked`` runs them, over the negative blocked LML of
    ``ops/blocked_lml.py``.  Every line-search candidate is a value and
    gradient: one Gram-panel launch and one ``factor_panel`` call a panel
    for a CUDA X, the gradient by the trace identity, never autograd
    through the factorization and never a dense (N, N) Gram.  θ is (log
    amplitude, log ℓ per input axis, log noise) in float32, clipped to the
    log-bounds of the kernel's nodes after each step; a non-finite value
    reads 1e25 and its gradient NaN where the Gram does not factor (the
    line search's outside-domain reading); an iteration's first gradient
    has its non-finite entries set to 0.  Rows with NaN targets are dropped
    first.  ``refine_iters`` None takes ``blocked_lml.refine_steps``'s
    rule.  ``precision`` sets the evaluations' products (``ops.linalg``'s
    mapping); None is "highest", the JAX package's choice on every
    platform but a TPU.  The conditioning at the optimum is at "highest",
    as JAX's ``condition_blocked``.

    Needs the C·stationary(+White) family (``ValueError`` otherwise).
    Returns :func:`condition_blocked` at the optimum, with the kernel
    rebuilt as Constant·base + White at the fitted values and the input
    nodes' bounds."""
    from ..ops.blocked_lml import blocked_lml_value_and_grad

    parts = stationary_family_params(kernel)
    if parts is None:
        raise ValueError(
            "fit_blocked requires a C*stationary(+White) kernel (RBF or Matern nu in "
            f"{{0.5, 1.5, 2.5}}); got {type(kernel).__name__}. Use fit for other kernels.")
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
    eff_jitter = _eff_jitter(torch.float32, jitter)

    lml_kw = dict(jitter=eff_jitter, block=block, refine_iters=refine_iters,
                  precision=check_precision("highest" if precision is None else precision))

    def nll_and_grad(x: Tensor):
        th = x[:, 0]
        val, (g_amp, g_ls, g_noise) = blocked_lml_value_and_grad(
            Xd, Y2, fam, th[0], th[1:1 + D], th[1 + D], **lml_kw)
        return negated_lml(val.reshape(1),
                           torch.cat([g_amp.reshape(1), g_ls, g_noise.reshape(1)])[:, None])

    x, _, _ = lbfgs_minimize(nll_and_grad, x0, lo, hi, maxiter)
    th = x[:, 0]
    base_bounds = base_node.bounds if base_node is not None else DEFAULT_BOUNDS
    ls_fit = torch.exp(th[1:1 + D])
    base = (Matern(ls_fit, nu=base_node.nu, bounds=base_bounds) if isinstance(base_node, Matern)
            else RBF(ls_fit, bounds=base_bounds))
    fitted = Constant(torch.exp(th[0]), bounds=(const_node.bounds if const_node is not None
                                                else DEFAULT_BOUNDS)) * base + \
        White(torch.exp(th[1 + D]), bounds=(white_node.bounds if white_node is not None
                                            else DEFAULT_BOUNDS))
    return condition_blocked(fitted, Xd, Y2, jitter=jitter, block=block)
