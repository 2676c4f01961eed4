"""Exact Gaussian-process regression on torch tensors.

Port of ``gaussian_process_transportation_tpu/models/exact_gp.py``: the
posterior state ``ExactGP``, dense conditioning with an optional cached
K⁻¹, large-N conditioning through the blocked Cholesky
(``condition_blocked``), the posterior mean and epistemic std (with the
fused dense-grid kernels of ``ops/pallas_gram.py`` on the card), the full
posterior covariance and samples, the Jacobian posterior and the gradient
of the predictive variance.  Hyperparameter fitting belongs to a later
part of the port.

Conventions follow the original project's sklearn wrapper: the std may
exclude the White-noise level (``epistemic_only``), and the Jacobian
variance is ``k''_dd(x, x) − dk K⁻¹ dkᵀ`` per direction d.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from ..kernels import Constant, Kernel, Matern, Product, RBF, Sum, White
from ..ops import pallas_gram
from ..ops.blocked_chol import BlockedCholesky, gram_cholesky_solve
from ..ops.linalg import add_diagonal, cho_solve_lower, tri_solve_lower


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
# tensors and a C·stationary(+White) kernel.  The value is the JAX
# package's; the card's own crossover against torch.linalg.cholesky is
# measured by chip_smoke.py (PERF.md) and not re-derived yet.
BLOCKED_CHOL_MIN_N = 4096


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
    noise = white_noise_level(kernel)
    return torch.sqrt(torch.as_tensor(noise, dtype=like.dtype, device=like.device))


# predict() takes the fused kernels when the (Nq, N) Gram would have this
# many elements or more (the JAX package's threshold).
FUSED_PREDICT_MIN_ELEMS = 2**21


def _fused_predict_params(gp: ExactGP, x: Tensor):
    """(family, amplitude, lengthscale) when predict() should take the
    fused kernels: float32 CUDA tensors, 2-D x and X, a C·stationary(+White)
    kernel and Nq·N ≥ ``FUSED_PREDICT_MIN_ELEMS``; None otherwise."""
    if x.device.type != "cuda" or x.dim() != 2 or gp.X.dim() != 2:
        return None
    if x.dtype != torch.float32 or gp.alpha.dtype != torch.float32:
        return None
    if x.shape[0] * gp.X.shape[0] < FUSED_PREDICT_MIN_ELEMS:
        return None
    if x.shape[1] > pallas_gram.MAX_D or gp.alpha.shape[1] > pallas_gram.MAX_P:
        return None
    return stationary_family_params(gp.kernel)


def predict(
    gp: ExactGP,
    x: Tensor,
    return_std: bool = False,
    epistemic_only: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Posterior mean (and std) at query points x (Nq, D) → (Nq, P).

    The std includes the White-noise level (sklearn's convention) unless
    ``epistemic_only``, which subtracts sqrt(noise_level) as the original
    project does.

    Dense grids on the card (see :func:`_fused_predict_params`) take the
    fused kernels, which never write the (Nq, N) Gram: the mean kernel, or
    with ``return_std`` and a cached K⁻¹ the mean-and-variance kernel."""
    params = _fused_predict_params(gp, x)
    if params is not None and not return_std:
        fam, amp, ls = params
        return pallas_gram.fused_gp_predict_mean(x, gp.X, gp.alpha, ls, amp, family=fam)
    if params is not None and gp.K_inv is not None:
        fam, amp, ls = params
        prior = amp + white_noise_level(gp.kernel)
        mean, var = pallas_gram.fused_gp_predict_mean_var(
            x, gp.X, gp.alpha, gp.K_inv, ls, amp, prior, family=fam)
        std = torch.sqrt(var)
        if epistemic_only:
            std = std - _noise_std(gp.kernel, std)
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
        std = std - _noise_std(gp.kernel, std)
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
