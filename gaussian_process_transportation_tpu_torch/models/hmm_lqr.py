"""HMM over task-parameterized (x, ẋ) features with LQR reproduction.

Port of ``gaussian_process_transportation_tpu/models/hmm_lqr.py``, the
multi-reference-frame baseline after pbdlib's HMM and PoGLQR:

* emissions are per-state, per-frame Gaussians over ξ⁽ʲ⁾ = [x⁽ʲ⁾, ẋ⁽ʲ⁾],
  the frames' likelihoods multiplying as in TP-GMM;
* EM with the exact forward–backward recursions in log space
  (:func:`_forward_backward`), each recursion a loop over time on the
  device;
* reproduction maps each frame's Gaussians to a new frame configuration
  (Ã = blkdiag(A, A), b̃ = [b, 0]), takes their product per state, and
  tracks the deterministic state sequence with a discrete LQR on
  double-integrator dynamics (Q_t = Σ⁻¹ of the active state): a backward
  Riccati pass and a forward roll-out.

The fit draws nothing: the states start from a uniform split of each
demonstration's time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import Tensor

from ._training import DeviceInputs
from .tpgmm import eigenvalue_floor, frame_product, gauss_logpdf


@dataclass(frozen=True)
class HMMParams:
    init: Tensor  # (K,)
    trans: Tensor  # (K, K)
    mu: Tensor  # (F, K, D) per-frame emission means
    sigma: Tensor  # (F, K, D, D)


def _emission_loglik(params: HMMParams, seq: Tensor) -> Tensor:
    """seq (T, F, D) → (T, K): each state's log-likelihood summed over the
    frames."""
    x = seq.permute(1, 0, 2)[:, None]  # (F, 1, T, D)
    return gauss_logpdf(x, params.mu, params.sigma).sum(0).T


def _forward_backward(log_b: Tensor, init: Tensor, trans: Tensor):
    """The forward–backward recursions in log space for emissions log_b
    (T, K).  Returns (γ (T, K), ξ summed over time (K, K), the sequence's
    log-likelihood)."""
    T, K = log_b.shape
    log_init = torch.log(init + 1e-30)
    log_trans = torch.log(trans + 1e-30)

    alphas = [log_init + log_b[0]]
    for t in range(1, T):
        alphas.append(log_b[t] + torch.logsumexp(alphas[-1][:, None] + log_trans, 0))
    log_alphas = torch.stack(alphas)

    betas = [torch.zeros_like(log_init)]
    for t in range(T - 1, 0, -1):
        betas.append(torch.logsumexp(log_trans + (log_b[t] + betas[-1])[None, :], 1))
    log_betas = torch.stack(betas[::-1])

    loglik = torch.logsumexp(log_alphas[-1], 0)
    gamma = torch.exp(log_alphas + log_betas - loglik)
    log_xi = (log_alphas[:-1, :, None] + log_trans[None]
              + (log_b[1:] + log_betas[1:])[:, None, :] - loglik)
    xi_sum = torch.exp(torch.logsumexp(log_xi, 0))
    return gamma, xi_sum, loglik


def _frame_views(X, dX, A_i, b_i, F):
    views = []
    for f in range(F):
        Ainv = np.linalg.inv(np.asarray(A_i[0][f]))
        views.append(np.concatenate([(Ainv @ (X - np.asarray(b_i[0][f])).T).T,
                                     (Ainv @ dX.T).T], axis=1))
    return np.stack(views, axis=1)  # (T, F, 2d)


class HMMLQR(DeviceInputs):
    def __init__(self, n_states: int = 5, n_iter: int = 25, reg: float = 1e-2, dt: float = 1.0,
                 device="cuda"):
        self.n_states = n_states
        self.n_iter = n_iter
        self.reg = reg
        self.dt = dt
        self.device = torch.device(device)
        self.params: Optional[HMMParams] = None

    def fit(self, demos_x: List[np.ndarray], demos_dx: List[np.ndarray], A: List, b: List):
        """Per-frame views ξ⁽ʲ⁾ = A_j⁻¹[x − b_j ; ẋ] of each demonstration,
        formed in float64 on the host; the fit runs in the demonstrations'
        dtype on ``device``."""
        F = len(A[0][0])
        d = demos_x[0].shape[1]
        seqs_np = [_frame_views(np.asarray(demos_x[i]), np.asarray(demos_dx[i]), A[i], b[i], F)
                   for i in range(len(demos_x))]
        self.dim = d
        self.n_frames = F
        self.T_demo = seqs_np[0].shape[0]
        K, D = self.n_states, 2 * d

        # the states start on a uniform split of each demonstration's time
        all_np = np.concatenate(seqs_np, axis=0)
        all_seg = np.concatenate([np.minimum((np.arange(s.shape[0]) * K) // s.shape[0], K - 1)
                                  for s in seqs_np])
        mu0 = np.zeros((F, K, D))
        sigma0 = np.zeros((F, K, D, D))
        for f in range(F):
            for k in range(K):
                pts = all_np[all_seg == k][:, f, :]
                mu0[f, k] = pts.mean(0)
                sigma0[f, k] = np.cov(pts.T) + self.reg * np.eye(D)
        trans0 = 0.9 * np.eye(K) + 0.1 * np.eye(K, k=1)
        trans0[-1, -1] = 1.0
        trans0 = trans0 / trans0.sum(1, keepdims=True)
        init0 = np.ones(K)
        init0[0] = K
        dtype = torch.as_tensor(np.asarray(demos_x[0])).dtype
        put = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        params = HMMParams(init=put(init0 / (2 * K - 1)), trans=put(trans0), mu=put(mu0),
                           sigma=put(sigma0))
        seqs = [put(s) for s in seqs_np]
        concat = torch.cat(seqs, 0)  # (N, F, D)
        eye = torch.eye(D, dtype=dtype, device=self.device)
        for _ in range(self.n_iter):
            gammas, xi, init = [], 0.0, 0.0
            for s in seqs:
                g, x, _ = _forward_backward(_emission_loglik(params, s), params.init,
                                            params.trans)
                gammas.append(g)
                xi = xi + x
                init = init + g[0]
            gamma = torch.cat(gammas, 0)  # (N, K)
            trans = xi / torch.clamp(xi.sum(1, keepdim=True), min=1e-30)
            nk = gamma.sum(0) + 1e-10
            x = concat.permute(1, 0, 2)  # (F, N, D)
            mu = (gamma.T @ x) / nk[:, None]  # (F, K, D)
            diff = x[:, None] - mu[:, :, None]  # (F, K, N, D)
            cov = (torch.einsum("nk,fknd,fkne->fkde", gamma, diff, diff) / nk[:, None, None]
                   + self.reg * eye)
            # the few-demonstration covariances' spurious precision, floored
            params = HMMParams(init=init / len(seqs), trans=trans, mu=mu,
                               sigma=eigenvalue_floor(cov, 0.02))
        self.params = params
        return self

    def state_sequence(self, T: int) -> Tensor:
        """The most likely state at each step of the transition dynamics
        propagated without observations: the timeline the LQR tracks."""
        p = self.params
        prob = p.init
        seq = [torch.argmax(prob)]
        for _ in range(T - 1):
            prob = prob @ p.trans
            seq.append(torch.argmax(prob))
        return torch.stack(seq)

    def reproduce(self, A_new, b_new, x0: np.ndarray, T: Optional[int] = None) -> np.ndarray:
        """The LQR-tracked positions (T, d) from x0 under a new frame
        configuration."""
        p = self.params
        F, d = self.n_frames, self.dim
        D = 2 * d
        T = T or self.T_demo
        like = dict(dtype=p.mu.dtype, device=p.mu.device)
        eye_d = torch.eye(d, **like)
        Af = torch.as_tensor(np.stack([np.asarray(a) for a in A_new]), **like)
        Ax = torch.zeros((F, D, D), **like)
        Ax[:, :d, :d] = Af
        Ax[:, d:, d:] = Af
        off = torch.zeros((F, D), **like)
        off[:, :d] = torch.as_tensor(np.stack([np.asarray(v) for v in b_new]), **like)
        mus = (Ax[:, None] @ p.mu[..., None])[..., 0] + off[:, None]
        sigmas = Ax[:, None] @ p.sigma @ Ax[:, None].transpose(-1, -2)
        mu_p, sigma_p = frame_product(mus, sigmas)

        seq = self.state_sequence(T)
        targets = mu_p[seq]  # (T, D)
        Q = torch.linalg.inv(sigma_p)[seq]  # (T, D, D)
        A_sys = torch.eye(D, **like)
        A_sys[:d, d:] = self.dt * eye_d
        B_sys = torch.zeros((D, d), **like)
        B_sys[d:] = self.dt * eye_d
        R = 1e-2 * eye_d

        # backward Riccati pass around the time-varying targets
        P, v = Q[-1], Q[-1] @ targets[-1]
        gains = []
        for t in range(T - 2, -1, -1):
            BtP = B_sys.T @ P
            G = R + BtP @ B_sys
            Kgain = torch.linalg.solve(G, BtP @ A_sys)
            kff = torch.linalg.solve(G, B_sys.T @ v)
            Acl = A_sys - B_sys @ Kgain
            P = Q[t] + A_sys.T @ P @ Acl
            v = Q[t] @ targets[t] + Acl.T @ v
            gains.append((Kgain, kff))
        # forward roll-out
        xi = torch.cat([torch.as_tensor(np.asarray(x0), **like), torch.zeros(d, **like)])
        traj = [xi]
        for Kgain, kff in reversed(gains):
            xi = A_sys @ xi + B_sys @ (-Kgain @ xi + kff)
            traj.append(xi)
        return torch.stack(traj)[:, :d].cpu().numpy()
