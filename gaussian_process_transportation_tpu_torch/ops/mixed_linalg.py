"""Mixed-precision blocked Cholesky and refined GP solves.

Port of ``gaussian_process_transportation_tpu/ops/mixed_linalg.py``, in
plain PyTorch:

* ``blocked_cholesky``: a right-looking blocked factorization whose
  trailing update (the O(N³/3) operations) runs at the precision the caller
  asks for, the diagonal blocks and panel solves at full precision;
* ``ir_solve``: fixed-point iterative refinement preconditioned by such a
  factor (for well-conditioned systems);
* ``pcg_solve``: conjugate gradients preconditioned by (L Lᵀ)⁻¹, which
  converges where the fixed-point sweep diverges (GP Grams of κ ~ 10³ with
  a bfloat16 factor);
* ``gram_chol_solve_mixed``: the Gram at full precision, the low-precision
  factor, the PCG solve, and its relative residual for the caller to gate
  on.

Precision names are the package's one mapping, ``ops.linalg.matmul_at``:
``"default"`` one bfloat16 pass, ``"high"`` three on a hi/lo split,
``"highest"`` float32, for float32 CUDA tensors; on the CPU, and in float64,
every product is taken in the operands' dtype, as the JAX package's CPU
backend ignores the precision.  ``emulate_bf16`` rounds the trailing
update's panel through bfloat16 first, so CPU runs see the card's error
profile.

The JAX package records this XLA-level blocked factor as slower than the
built-in Cholesky, so none of these functions is a route of
``models.exact_gp.condition``: the large-N path is
``ops.blocked_chol.gram_cholesky_solve``.  What they give is a solve whose
factor is approximate for any reason, refined to full working precision
and certified by its residual.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from .linalg import add_diagonal, cholesky_with_jitter, matmul_at


def blocked_cholesky(K: Tensor, block: int = 1024, syrk_precision: str = "default",
                     emulate_bf16: bool = False) -> Tensor:
    """Lower Cholesky factor of a positive-definite K (n, n), by blocks of
    ``block``: each diagonal block by ``torch.linalg`` at full precision
    (NaN where it is not definite), the panel by a triangular solve against
    it, the trailing update P·Pᵀ at ``syrk_precision``.  K is padded with
    the identity to a whole number of blocks."""
    n = K.shape[-1]
    if n <= block:
        return cholesky_with_jitter(K)
    nb = -(-n // block)
    n_p = nb * block
    A = torch.eye(n_p, dtype=K.dtype, device=K.device)
    A[:n, :n] = K
    L = torch.zeros_like(A)
    for kb in range(nb):
        s, e = kb * block, (kb + 1) * block
        Lkk = cholesky_with_jitter(A[s:e, s:e])
        L[s:e, s:e] = Lkk
        if e == n_p:
            break
        # the panel: L21 = A21 · L11⁻ᵀ
        L21 = torch.linalg.solve_triangular(Lkk, A[e:, s:e].T, upper=False).T
        L[e:, s:e] = L21
        P = L21.to(torch.bfloat16).to(L21.dtype) if emulate_bf16 else L21
        A[e:, e:] -= matmul_at(P, P.T, syrk_precision)
    return L[:n, :n]


def _cho(L: Tensor, B: Tensor) -> Tensor:
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)


def ir_solve(K: Tensor, L: Tensor, B: Tensor, sweeps: int = 3,
             residual_precision: str = "highest") -> Tuple[Tensor, Tensor]:
    """Solve K x = B by fixed-point refinement preconditioned by the
    (approximate) lower factor L; returns (x, ‖B − Kx‖_F / ‖B‖_F at x)."""
    x = _cho(L, B)
    for _ in range(sweeps):
        x = x + _cho(L, B - matmul_at(K, x, residual_precision))
    r = B - matmul_at(K, x, residual_precision)
    return x, torch.linalg.norm(r) / torch.clamp(torch.linalg.norm(B), min=1e-30)


def pcg_solve(K: Tensor, L: Tensor, B: Tensor, iters: int = 24,
              residual_precision: str = "highest") -> Tuple[Tensor, Tensor]:
    """Solve K x = B (columns independent) by conjugate gradients
    preconditioned with (L Lᵀ)⁻¹, a fixed ``iters`` steps (no host read);
    returns (x, the largest relative residual ‖B − Kx‖/‖B‖ over the
    columns).  A step costs one K·p product and two triangular solves."""
    x = torch.zeros_like(B)
    r = B
    z = _cho(L, r)
    p = z
    rz = (r * z).sum(0)
    for _ in range(iters):
        Kp = matmul_at(K, p, residual_precision)
        denom = (p * Kp).sum(0)
        # the guards' placeholders are 1, not a tiny literal that underflows in f32
        alpha = torch.where(denom > 0, rz / torch.where(denom > 0, denom, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Kp
        z = _cho(L, r)
        rz_new = (r * z).sum(0)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = z + beta * p
        rz = rz_new
    resid = B - matmul_at(K, x, residual_precision)
    rel = (torch.linalg.norm(resid, dim=0)
           / torch.clamp(torch.linalg.norm(B, dim=0), min=1e-30)).max()
    return x, rel


def gram_chol_solve_mixed(kernel, X: Tensor, Y: Tensor, jitter: float = 1e-6,
                          block: int = 1024, syrk_precision: str = "default", iters: int = 24,
                          emulate_bf16: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Large-N GP conditioning: the Gram at full precision, its
    mixed-precision blocked Cholesky, a PCG-refined solve.  Returns (α, L,
    relative residual); L is the low-precision factor, a preconditioner
    only, not fit for variances or log-determinants."""
    Km = add_diagonal(kernel(X), jitter)
    L = blocked_cholesky(Km, block=block, syrk_precision=syrk_precision,
                         emulate_bf16=emulate_bf16)
    alpha, rel = pcg_solve(Km, L, Y, iters=iters)
    return alpha, L, rel
