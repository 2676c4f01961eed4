"""Exact Gaussian-process regression on torch tensors, dense part.

Port of ``gaussian_process_transportation_tpu/models/exact_gp.py``: the
posterior state ``ExactGP``, dense conditioning with an optional cached
K⁻¹, the posterior mean and epistemic std, the full posterior covariance
and samples, and the Jacobian posterior.
The blocked large-N factor (``condition_blocked``) and hyperparameter
fitting belong to later parts of the port.

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
from ..ops.linalg import add_diagonal, cho_solve_lower, tri_solve_lower


@dataclass(frozen=True)
class ExactGP:
    """Posterior state p(f | X, Y, kernel).  Tensors may carry a leading
    ensemble axis (one GP per member, as the batched transport builds)."""

    kernel: Kernel
    X: Tensor  # (..., N, D) training inputs
    Y: Tensor  # (..., N, P) training targets
    alpha: Tensor  # (..., N, P) = K⁻¹ Y
    L: Optional[Tensor] = None  # (..., N, N) lower Cholesky of K + jitter·I
    K_inv: Optional[Tensor] = None  # (..., N, N) cached K⁻¹
    jitter: float = 1e-10


def _eff_jitter(dtype: torch.dtype, jitter: float) -> float:
    """float32 Cholesky of dense-curve Grams needs ~1e-6 diagonal jitter
    even with a White term; float64 keeps the request."""
    if dtype == torch.float32:
        return max(jitter, 1e-6)
    return jitter


def condition(
    kernel: Kernel,
    X: Tensor,
    Y: Tensor,
    jitter: float = 1e-10,
    cache_k_inv: bool = False,
) -> ExactGP:
    """The GP posterior for fixed hyperparameters; ``cache_k_inv`` also
    stores the symmetrised K⁻¹ so variance queries become matmuls."""
    Y2 = Y if Y.dim() == 2 else Y[:, None]
    K = add_diagonal(kernel(X), _eff_jitter(X.dtype, jitter))
    L = torch.linalg.cholesky(K)
    alpha = cho_solve_lower(L, Y2)
    K_inv = None
    if cache_k_inv:
        eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        K_inv = cho_solve_lower(L, eye)
        K_inv = 0.5 * (K_inv + K_inv.T)
    return ExactGP(kernel=kernel, X=X, Y=Y2, alpha=alpha, L=L, K_inv=K_inv, jitter=jitter)


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


def predict(
    gp: ExactGP,
    x: Tensor,
    return_std: bool = False,
    epistemic_only: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Posterior mean (and std) at query points x (Nq, D) → (Nq, P).

    The std includes the White-noise level (sklearn's convention) unless
    ``epistemic_only``, which subtracts sqrt(noise_level) as the original
    project does."""
    k_star = gp.kernel(x, gp.X)  # cross-covariance: White contributes zeros
    mean = k_star @ gp.alpha
    if not return_std:
        return mean
    if gp.K_inv is not None:
        var = gp.kernel.diag(x) - ((k_star @ gp.K_inv) * k_star).sum(-1)
    else:
        V = tri_solve_lower(gp.L, k_star.transpose(-1, -2))  # (N, Nq)
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
    V = tri_solve_lower(gp.L, k_star.transpose(-1, -2))
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
    else:
        V = tri_solve_lower(gp.L, dk.permute(2, 1, 0))  # (D, N, Nq)
        quad = (V * V).sum(1).T
    var = prior - quad
    return mean, var[:, None, :].expand(mean.shape)
