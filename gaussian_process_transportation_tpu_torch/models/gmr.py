"""Gaussian mixture regression (GMR) delta map.

Port of ``gaussian_process_transportation_tpu/models/gmr.py``:

* the joint GMM over z = [x, y] is fitted by EM (:func:`fit_gmm`), every
  component at once: a batched Cholesky E-step and one einsum M-step an
  iteration, the iterations a loop on the device that never reads a value
  back to the host;
* regression conditions the mixture on x: responsibilities from the
  x-marginal, per-component conditional means μ_y + Σ_yx Σ_xx⁻¹(x − μ_x),
  the moment-matched predictive variance (:func:`gmr_predict`), and the
  analytic Jacobian of the conditional mean (:func:`gmr_derivative`).

Random draws (the initial means, the sample's components and ε) come
from a ``torch.Generator`` on the CPU seeded from ``seed``; the fit is the
draw followed by the deterministic :func:`run_em` from its initial
parameters.  The sample's components are drawn as ``jax.random.categorical``
draws them, the argmax of the log-probabilities plus Gumbel noise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import Tensor

from ..ops.linalg import cholesky_with_jitter
from ._training import DeviceInputs, cpu_generator


@dataclass(frozen=True)
class GMMParams:
    log_weights: Tensor  # (K,)
    means: Tensor  # (K, D)
    covs: Tensor  # (K, D, D)


@dataclass(frozen=True)
class ConditionalParams:
    """The x-marginal and conditional factors of a joint GMM."""

    log_weights: Tensor  # (K,)
    mean_x: Tensor  # (K, Dx)
    mean_y: Tensor  # (K, Dy)
    chol_xx: Tensor  # (K, Dx, Dx)
    gain: Tensor  # (K, Dy, Dx) = Σ_yx Σ_xx⁻¹
    cond_cov: Tensor  # (K, Dy, Dy) = Σ_yy − Σ_yx Σ_xx⁻¹ Σ_xy


def _chol_logpdf(z: Tensor, means: Tensor, chols: Tensor) -> Tensor:
    """log N(z_n; μ_k, L_k L_kᵀ), (K, N), for z (N, D)."""
    d = z.shape[-1]
    diff = z[None] - means[:, None, :]  # (K, N, D)
    sol = torch.linalg.solve_triangular(chols, diff.transpose(-1, -2), upper=False)
    maha = (sol * sol).sum(-2)
    logdet = 2.0 * torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (maha + logdet[:, None] + d * math.log(2.0 * math.pi))


def _e_step(z: Tensor, params: GMMParams):
    log_joint = params.log_weights[:, None] + _chol_logpdf(
        z, params.means, cholesky_with_jitter(params.covs))
    log_norm = torch.logsumexp(log_joint, 0)
    return torch.exp(log_joint - log_norm[None]), log_norm  # resp (K, N)


def _m_step(z: Tensor, resp: Tensor, reg) -> GMMParams:
    n = z.shape[0]
    nk = resp.sum(1) + 1e-12
    means = (resp @ z) / nk[:, None]
    diff = z[None] - means[:, None, :]
    covs = torch.einsum("kn,knd,kne->kde", resp, diff, diff) / nk[:, None, None]
    covs = covs + reg * torch.eye(z.shape[1], dtype=z.dtype, device=z.device)
    return GMMParams(torch.log(nk / n), means, covs)


def init_gmm(z: Tensor, idx: Tensor, reg: float = 1e-6):
    """The initial mixture: the points z[idx] as means, the data
    covariance (ddof 1) plus the regulariser as every covariance, uniform
    weights.  The regulariser is ``reg`` times the mean data variance, so
    that curve-like point sets at any scale keep every covariance SPD;
    returns (the parameters, that absolute regulariser)."""
    n, d = z.shape
    K = idx.shape[0]
    data_cov = torch.cov(z.T).reshape(d, d)
    reg_abs = reg * torch.clamp(torch.trace(data_cov) / d, min=1e-30)
    data_cov = data_cov + reg_abs * torch.eye(d, dtype=z.dtype, device=z.device)
    params = GMMParams(torch.full((K,), -math.log(float(K)), dtype=z.dtype, device=z.device),
                       z[idx], data_cov.expand(K, d, d).clone())
    return params, reg_abs


def run_em(z: Tensor, params: GMMParams, n_iter: int, reg_abs):
    """``n_iter`` EM steps from ``params``: the deterministic part of
    :func:`fit_gmm`.  Returns (the parameters, each step's mean
    log-likelihood (n_iter,))."""
    trace = []
    for _ in range(n_iter):
        resp, log_norm = _e_step(z, params)
        params = _m_step(z, resp, reg_abs)
        trace.append(log_norm.mean())
    return params, (torch.stack(trace) if trace else z.new_zeros(0))


def fit_gmm(z: Tensor, n_components: int, n_iter: int = 100, reg: float = 1e-6,
            generator: Optional[torch.Generator] = None):
    """EM fit of a K-component full-covariance GMM on z (N, D), the initial
    means K distinct data points drawn from ``generator`` (sklearn's
    ``random_from_data``).  Returns (the parameters, the log-likelihood
    trace)."""
    generator = cpu_generator(0) if generator is None else generator
    idx = torch.randperm(z.shape[0], generator=generator)[:n_components].to(z.device)
    params, reg_abs = init_gmm(z, idx, reg)
    return run_em(z, params, n_iter, reg_abs)


def condition_on_x(params: GMMParams, dx: int) -> ConditionalParams:
    sxx = params.covs[:, :dx, :dx]
    sxy = params.covs[:, :dx, dx:]
    syy = params.covs[:, dx:, dx:]
    chol_xx = cholesky_with_jitter(sxx)
    gain = torch.cholesky_solve(sxy, chol_xx).transpose(-1, -2)  # (K, Dy, Dx)
    return ConditionalParams(params.log_weights, params.means[:, :dx], params.means[:, dx:],
                             chol_xx, gain, syy - gain @ sxy)


def _responsibilities(cp: ConditionalParams, x: Tensor) -> Tensor:
    logr = cp.log_weights[:, None] + _chol_logpdf(x, cp.mean_x, cp.chol_xx)
    return torch.exp(logr - torch.logsumexp(logr, 0)[None])  # (K, N)


def _component_means(cp: ConditionalParams, x: Tensor):
    diff = x[None] - cp.mean_x[:, None, :]  # (K, N, Dx)
    return diff, cp.mean_y[:, None, :] + torch.einsum("kyx,knx->kny", cp.gain, diff)


def gmr_predict(cp: ConditionalParams, x: Tensor):
    """The conditional mixture's mean and moment-matched variance diagonal
    at x (N, Dx): (N, Dy) each."""
    r = _responsibilities(cp, x)
    _, m_k = _component_means(cp, x)
    mean = torch.einsum("kn,kny->ny", r, m_k)
    cond_var = torch.diagonal(cp.cond_cov, dim1=1, dim2=2)
    second = torch.einsum("kn,kny->ny", r, cond_var[:, None, :] + m_k**2)
    return mean, torch.clamp(second - mean**2, min=0.0)


def gmr_derivative(cp: ConditionalParams, x: Tensor) -> Tensor:
    """The analytic Jacobian (N, Dy, Dx) of the conditional mean:
    Σ_k r_k [gain_k + m_k (g_k − ḡ)ᵀ], g_k = −Σ_xx⁻¹(x − μ_x) = ∇log N_k(x)
    and ḡ = Σ_k r_k g_k."""
    r = _responsibilities(cp, x)
    diff, m_k = _component_means(cp, x)
    g = -torch.cholesky_solve(diff.transpose(-1, -2), cp.chol_xx).transpose(-1, -2)
    g_bar = torch.einsum("kn,knx->nx", r, g)
    lin = torch.einsum("kn,kyx->nyx", r, cp.gain)
    return lin + torch.einsum("kn,kny,knx->nyx", r, m_k, g - g_bar[None])


class GMR(DeviceInputs):
    """A Gaussian mixture regressor with ``fit``, ``predict``,
    ``derivative`` and ``samples``."""

    def __init__(self, n_components: int = 10, n_iter: int = 100, reg: float = 1e-6,
                 seed: int = 0, device="cuda"):
        self.n_components = n_components
        self.n_iter = n_iter
        self.reg = reg
        self.seed = seed
        self.device = torch.device(device)

    def fit(self, X, Y):
        X = self._tensor(X)
        self.dx = X.shape[1]
        z = torch.cat([X, self._tensor(Y)], 1)
        k = min(self.n_components, z.shape[0])
        self.params, self.ll_trace = fit_gmm(z, k, self.n_iter, self.reg,
                                             cpu_generator(self.seed))
        self.conditional = condition_on_x(self.params, self.dx)
        return self

    def predict(self, X, return_std: bool = False):
        mean, var = gmr_predict(self.conditional, self._tensor(X))
        return (mean, torch.sqrt(var)) if return_std else mean

    def derivative(self, X) -> Tensor:
        return gmr_derivative(self.conditional, self._tensor(X))

    def samples(self, X, n_samples: int = 10, generator: Optional[torch.Generator] = None):
        """(n_samples, N, Dy) draws of the conditional mixture: a component
        by its responsibility, then its Gaussian."""
        generator = cpu_generator(self.seed + 1) if generator is None else generator
        x = self._tensor(X)
        cp = self.conditional
        r = _responsibilities(cp, x)
        _, m_k = _component_means(cp, x)
        chol_c = cholesky_with_jitter(cp.cond_cov, 1e-10)
        N, K, Dy = x.shape[0], r.shape[0], cp.mean_y.shape[1]
        u = torch.rand((n_samples, N, K), generator=generator, dtype=torch.float64)
        gumbel = (-torch.log(-torch.log(u))).to(dtype=x.dtype, device=x.device)
        comp = torch.argmax(torch.log(r.T + 1e-30)[None] + gumbel, -1)  # (S, N)
        eps = torch.randn((n_samples, N, Dy), generator=generator, dtype=torch.float64)
        eps = eps.to(dtype=x.dtype, device=x.device)
        means_sel = m_k.transpose(0, 1)[torch.arange(N, device=x.device)[None], comp]  # (S, N, Dy)
        return means_sel + torch.einsum("snde,sne->snd", chol_c[comp], eps)
