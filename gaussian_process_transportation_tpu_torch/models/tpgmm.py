"""Task-parameterized GMM with Gaussian mixture regression (TP-GMM/GMR).

Port of ``gaussian_process_transportation_tpu/models/tpgmm.py``, the
multi-reference-frame baseline:

* each mixture state k keeps a Gaussian per frame j over the features
  [t, x⁽ʲ⁾], x⁽ʲ⁾ the demonstration seen from frame j; the EM
  responsibilities multiply the frames' likelihoods.  Every state and
  frame is one batch axis of the E- and M-steps, and the iterations are a
  loop on the device;
* reproduction in a new frame configuration maps each state's Gaussians
  to the global frame (μ̂ = Aμ + b, Σ̂ = AΣAᵀ), takes their product over
  the frames, and conditions on time (GMR) for the trajectory and its
  per-step covariance.

The fit draws nothing: the states start from a uniform split of time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..ops.linalg import cholesky_with_jitter
from ..utils.resample import resample
from ._training import DeviceInputs


@dataclass(frozen=True)
class TPGMMParams:
    priors: Tensor  # (K,)
    mu: Tensor  # (F, K, D) per-frame state means over [t, x]
    sigma: Tensor  # (F, K, D, D)


def eigenvalue_floor(sigma: Tensor, floor_ratio: float) -> Tensor:
    """Each covariance with its eigenvalues raised to at least
    ``floor_ratio`` times its largest: few demonstrations leave per-frame
    covariances near-singular, and their spurious precision along the thin
    direction would dominate the product of the frames' Gaussians."""
    w, v = torch.linalg.eigh(sigma)
    w = torch.maximum(w, floor_ratio * w.amax(-1, keepdim=True))
    return torch.einsum("...ab,...b,...cb->...ac", v, w, v)


def gauss_logpdf(x: Tensor, mu: Tensor, sigma: Tensor) -> Tensor:
    """log N(x_n; μ, Σ) for x (..., N, D), μ (..., D), Σ (..., D, D): (..., N)."""
    d = x.shape[-1]
    L = cholesky_with_jitter(sigma)
    diff = torch.linalg.solve_triangular(L, (x - mu[..., None, :]).transpose(-1, -2),
                                         upper=False)
    return (-0.5 * (diff * diff).sum(-2)
            - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)[..., None]
            - 0.5 * d * math.log(2 * math.pi))


def _em_fit(data_f: Tensor, n_states: int, n_iter: int, reg: float,
            eig_floor: float = 0.05) -> TPGMMParams:
    """EM over data_f (F, N, D), the frame-local views of N datapoints."""
    F, N, D = data_f.shape
    eye = torch.eye(D, dtype=data_f.dtype, device=data_f.device)
    # the states start on a uniform split of the time-sorted points
    order = torch.argsort(data_f[0, :, 0], stable=True)
    segs = torch.tensor_split(order, n_states)
    mu = torch.stack([torch.stack([data_f[f][s].mean(0) for s in segs]) for f in range(F)])
    sigma = torch.stack([torch.stack([torch.cov(data_f[f][s].T) + reg * eye for s in segs])
                         for f in range(F)])
    priors = torch.full((n_states,), 1.0 / n_states, dtype=data_f.dtype, device=data_f.device)
    for _ in range(n_iter):
        # E-step: the frames' likelihoods multiply
        ll = gauss_logpdf(data_f[:, None], mu, sigma).sum(0)  # (K, N)
        log_r = torch.log(priors)[:, None] + ll
        r = torch.exp(log_r - torch.logsumexp(log_r, 0, keepdim=True))
        # M-step
        nk = r.sum(1) + 1e-10
        priors = nk / N
        mu = (r @ data_f) / nk[:, None]  # (F, K, D)
        diff = data_f[:, None] - mu[:, :, None]  # (F, K, N, D)
        cov = (torch.einsum("kn,fknd,fkne->fkde", r, diff, diff) / nk[:, None, None]
               + reg * eye)
        sigma = eigenvalue_floor(cov, eig_floor)
    return TPGMMParams(priors=priors, mu=mu, sigma=sigma)


def frame_product(mus: Tensor, sigmas: Tensor):
    """Each state's product of its frames' Gaussians, for mus (F, K, D)
    and sigmas (F, K, D, D): (K, D), (K, D, D)."""
    precisions = torch.linalg.inv(sigmas)
    S = torch.linalg.inv(precisions.sum(0))
    return (S @ (precisions @ mus[..., None]).sum(0))[..., 0], S


class TPGMM(DeviceInputs):
    """Task-parameterized GMM over [t, x] with per-frame views."""

    def __init__(self, n_states: int = 3, n_data: int = 40, n_iter: int = 30, reg: float = 1e-2,
                 eig_floor: float = 0.1, seed: int = 0, device="cuda"):
        self.n_states = n_states
        self.n_data = n_data
        self.n_iter = n_iter
        self.reg = reg
        self.eig_floor = eig_floor
        self.seed = seed
        self.device = torch.device(device)
        self.params: Optional[TPGMMParams] = None

    def fit(self, demos_x: List[np.ndarray], A: List, b: List):
        """demos_x: (T_i, d) trajectories; A[i][0][j] and b[i][0][j] the
        rotation and origin of frame j for demonstration i.  The views are
        formed in float64 on the host; the fit runs in the demonstrations'
        dtype on ``device``."""
        d = demos_x[0].shape[1]
        F = len(A[0][0])
        # one isotropic position scale, so that time (in [0, 1]) and the
        # positions are commensurate for the eigenvalue floor
        all_x = np.concatenate([np.asarray(X) for X in demos_x])
        self.x_scale = float(np.std(all_x)) + 1e-12
        t = np.linspace(0, 1, self.n_data)[:, None]
        views = []
        for f in range(F):
            rows = []
            for i, X in enumerate(demos_x):
                Xr = resample(torch.as_tensor(np.asarray(X, dtype=np.float64)),
                              num_points=self.n_data).numpy()
                A_f, b_f = np.asarray(A[i][0][f]), np.asarray(b[i][0][f])
                x_local = (np.linalg.inv(A_f) @ (Xr - b_f).T).T / self.x_scale
                rows.append(np.column_stack([t, x_local]))
            views.append(np.concatenate(rows, axis=0))
        self.dim = d
        self.n_frames = F
        dtype = torch.as_tensor(np.asarray(demos_x[0])).dtype
        data_f = torch.as_tensor(np.stack(views), dtype=dtype, device=self.device)  # (F, N, 1+d)
        self.params = _em_fit(data_f, self.n_states, self.n_iter, self.reg, self.eig_floor)
        return self

    def reproduce(self, A_new, b_new, n_points: Optional[int] = None) -> Tuple[np.ndarray,
                                                                               np.ndarray]:
        """The trajectory (n_points, d) and its per-step covariance
        (n_points, d, d) under a new frame configuration: per-frame (d, d)
        rotations and (d,) origins."""
        p = self.params
        d = self.dim
        n_points = n_points or self.n_data
        like = dict(dtype=p.mu.dtype, device=p.mu.device)
        # each frame's Gaussians in the global (position-scaled) frame; time
        # is untouched
        Tm = torch.zeros((self.n_frames, d + 1, d + 1), **like)
        Tm[:, 0, 0] = 1.0
        Tm[:, 1:, 1:] = torch.as_tensor(np.stack([np.asarray(a) for a in A_new]), **like)
        off = torch.zeros((self.n_frames, d + 1), **like)
        off[:, 1:] = torch.as_tensor(np.stack([np.asarray(v) for v in b_new]), **like) / self.x_scale
        mus = (Tm[:, None] @ p.mu[..., None])[..., 0] + off[:, None]
        sigmas = Tm[:, None] @ p.sigma @ Tm[:, None].transpose(-1, -2)
        mu_p, sigma_p = frame_product(mus, sigmas)  # (K, D), (K, D, D)

        # GMR on time
        ts = torch.linspace(0.0, 1.0, n_points, **like)[:, None]  # (n, 1)
        mu_t, var_t = mu_p[:, 0], sigma_p[:, 0, 0]
        log_h = (torch.log(p.priors) - 0.5 * (ts - mu_t) ** 2 / var_t
                 - 0.5 * torch.log(2 * math.pi * var_t))
        h = torch.exp(log_h - torch.logsumexp(log_h, -1, keepdim=True))  # (n, K)
        cross = sigma_p[:, 1:, 0]  # (K, d)
        cond_mu = mu_p[:, 1:] + (cross / var_t[:, None]) * (ts - mu_t)[..., None]  # (n, K, d)
        mean = (h[..., None] * cond_mu).sum(1)
        cond_cov = sigma_p[:, 1:, 1:] - cross[:, :, None] * cross[:, None, :] / var_t[:, None, None]
        dev = cond_mu - mean[:, None]
        cov = (h[..., None, None] * (cond_cov + dev[..., :, None] * dev[..., None, :])).sum(1)
        return ((mean * self.x_scale).cpu().numpy(),
                (cov * self.x_scale**2).cpu().numpy())
