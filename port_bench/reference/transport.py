"""Plain reference of the ensemble transport, written from the method's
equations and nothing of the program.

A demo (X, dX) is moved onto each target point set T_e by
Φ_e = γ_e + Ψ_e∘γ_e:

* γ_e is the Kabsch fit of the source S onto T_e (SVD, reflection fixed,
  no scale): γ(x) = R(x − c_S) + c_T;
* Ψ_e is the GP on the residuals T_e − γ_e(S) under the covariance
  ``cov`` (a ``cov_<family>`` module) plus noise·1[x is z], with ``jitter``
  on the Gram's diagonal;
* the outputs are the transported positions γ(X) + m(γ(X)), the epistemic
  std sqrt(k(x, x) + noise − k*ᵀK⁻¹k*) − sqrt(noise), the velocities
  J_Φ·(R dx) with J_Φ = R + J_Ψ R, their variance Σ_d var(∂Ψ/∂x_d)(R dx)_d²,
  and min over the demo of |det J_Φ|.

Quadratic forms go through triangular solves with the Cholesky factor.
Everything is computed in ``dtype``: float64 for the check.  Every product
of two arrays goes through ``mm`` (``torch.matmul``), so that a control can
take them in a lower precision.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor


@dataclass
class Transport:
    """Every output of a transport onto B targets."""

    traj: Tensor  # (B, Q, D)
    std: Tensor  # (B, Q, D)
    delta: Tensor  # (B, Q, D)
    delta_var: Tensor  # (B, Q, D)
    min_abs_det: Tensor  # (B,)


def kabsch(S: Tensor, T: Tensor, mm=torch.matmul):
    """(R (B, D, D), c_S (D,), c_T (B, D)): the rotation that best maps the
    centred S onto each centred T (B, n, D)."""
    cs = S.mean(0)
    ct = T.mean(1)
    H = mm((S - cs).transpose(0, 1)[None], T - ct[:, None])  # (B, D, D)
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    det = torch.linalg.det(mm(V, U.transpose(-1, -2)))
    V = torch.cat([V[..., :-1], V[..., -1:] * torch.sign(det)[:, None, None]], -1)
    return mm(V, U.transpose(-1, -2)), cs, ct


def transport(X: Tensor, dX: Tensor, S: Tensor, T: Tensor, amp: Tensor, ls: Tensor,
              noise: Tensor, jitter: float, cov, dtype=torch.float64, mm=torch.matmul) -> Transport:
    """The transport of the demo (X, dX) (Q, D) onto B targets T (B, n, D)
    from the source S (n, D), each member with its own amp (B,), ℓ (B, D)
    and noise (B,)."""
    X, dX, S, T, amp, ls, noise = (t.to(dtype) for t in (X, dX, S, T, amp, ls, noise))
    B, n, D = T.shape
    R, cs, ct = kabsch(S, T, mm)
    Rt = R.transpose(-1, -2)
    Sg = mm((S - cs)[None].expand(B, n, D), Rt) + ct[:, None]
    resid = T - Sg
    eye = torch.eye(n, dtype=dtype, device=T.device)
    Kxx = cov.k(Sg, Sg, amp, ls) + (noise + jitter)[:, None, None] * eye
    L, info = torch.linalg.cholesky_ex(Kxx)
    L = torch.where(info[:, None, None] == 0, L, torch.nan)  # no factor: every output NaN
    alpha = torch.cholesky_solve(resid, L)  # (B, n, D)

    pos = mm((X - cs)[None].expand(B, *X.shape), Rt) + ct[:, None]  # (B, Q, D)
    ks = cov.k(Sg, pos, amp, ls)  # (B, n, Q)
    traj = pos + mm(ks.transpose(-1, -2), alpha)
    V = torch.linalg.solve_triangular(L, ks, upper=False)
    var = (cov.prior_var(amp, ls) + noise)[:, None] - (V * V).sum(-2)  # (B, Q)
    std_q = torch.sqrt(torch.clamp(var, min=0.0)) - torch.sqrt(noise)[:, None]
    std = std_q[..., None].expand(traj.shape)

    dk = cov.dk(Sg, pos, amp, ls, ks)  # (B, D, n, Q)
    J_psi = mm(alpha.transpose(-1, -2)[:, None], dk)  # (B, D_dir, P, Q)
    J_psi = J_psi.permute(0, 3, 2, 1)  # (B, Q, P, D_dir)
    Vd = torch.linalg.solve_triangular(L[:, None], dk, upper=False)  # (B, D, n, Q)
    Jvar = cov.prior_grad_var(amp, ls)[..., None] - (Vd * Vd).sum(-2)  # (B, D, Q)

    J_phi = R[:, None] + mm(J_psi, R[:, None])  # (B, Q, P, D)
    det = torch.linalg.det(J_phi)
    w = mm(dX[None, :, None, :].expand(B, -1, -1, -1), Rt[:, None])[..., 0, :]  # (B, Q, D)
    delta = w + mm(J_psi, w[..., None])[..., 0]
    dvar = (Jvar.transpose(-1, -2) * w * w).sum(-1)  # (B, Q)
    return Transport(traj, std, delta, dvar[..., None].expand(traj.shape), det.abs().amin(-1))
