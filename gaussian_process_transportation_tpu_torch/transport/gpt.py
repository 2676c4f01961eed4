"""Gaussian-process transportation: the functional pipeline.

Port of ``gaussian_process_transportation_tpu/transport/gpt.py``.  A demo
(traj, delta) is moved by Φ = γ + Ψ∘γ, where γ is the Kabsch fit of a
source point set onto a target one and Ψ the GP on the residuals:

* ``fit_and_transport`` does it for one target;
* ``fit_and_transport_batched`` for E targets at once (the ensemble
  workload), with one Cholesky/inverse kernel launch for all E Grams.

``transport_apply`` accepts a GP and affine fit with or without a leading
ensemble axis, so both entry points share it.  The public shapes are the
JAX ones: every field is (Q, D), or (E, Q, D) batched, ``ori`` (…, Q, 4),
and ``min_abs_det`` is () or (E,).

Not here yet: the ``GaussianProcessTransportation`` façade and the
per-member hyperparameter fit (``fit_and_transport_batched_opt``), which
need the hyperparameter part of the port, and members of n ≥ 768 points,
which need the blocked Cholesky.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from .. import kernels as K
from ..models import affine as affine_core
from ..models import exact_gp as gp_core
from ..models.affine import AffineParams
from ..ops import quaternion as quat
from ..ops.batched_linalg import spd_inverse_elast_auto


def default_transport_kernel(
    d: int = 1, dtype: torch.dtype = torch.float32, device=None
) -> K.Kernel:
    """C(0.1)·RBF(0.1) + White(1e-4), the original project's default."""
    return K.Constant(0.1) * K.RBF(0.1 * torch.ones(d, dtype=dtype, device=device)) + K.White(1e-4)


class TransportResult(NamedTuple):
    traj: Tensor  # Φ(X)                      (..., Q, D)
    std: Tensor  # epistemic std of Ψ∘γ       (..., Q, D)
    delta: Tensor  # J_Φ · ΔX                 (..., Q, D)
    delta_var: Tensor  # J_Ψvar (J_γ ΔX)²     (..., Q, D)
    min_abs_det: Tensor  # diffeo diagnostic  (...)
    ori: Optional[Tensor] = None  # q(J_Φ)·q_demo (..., Q, 4), 3-D maps only


def fit_pipeline(
    kernel: K.Kernel,
    source_distribution: Tensor,
    target_distribution: Tensor,
    do_scale: bool = False,
    do_rotation: bool = True,
    jitter: float = 1e-10,
):
    """Fit γ and condition the Ψ GP with fixed hyperparameters; returns
    (AffineParams, ExactGP) with K⁻¹ cached for the variance queries."""
    aff = affine_core.fit(
        source_distribution, target_distribution, do_scale=do_scale, do_rotation=do_rotation
    )
    src_aligned = affine_core.predict(aff, source_distribution)
    delta = target_distribution - src_aligned
    gp = gp_core.condition(kernel, src_aligned, delta, jitter, cache_k_inv=True)
    return aff, gp


def _det_small(M: Tensor) -> Tensor:
    """det over the leading axes of (..., D, D), closed form for D ≤ 3."""
    d = M.shape[-1]
    if d == 1:
        return M[..., 0, 0]
    if d == 2:
        return M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    if d == 3:
        return (
            M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
        )
    return torch.linalg.det(M)


def transport_apply(
    aff: AffineParams,
    gp: gp_core.ExactGP,
    traj: Tensor,
    delta: Tensor,
    ori: Optional[Tensor] = None,
) -> TransportResult:
    """The uncertainty-aware transport of one demo (traj, delta) (Q, D):
    positions, epistemic std, velocities and their variance, min|det J_Φ|,
    and with ``ori`` (Q, 4) (3-D only) the orientations, rotated by the
    closest rotation to J_Φ.  ``aff`` and ``gp`` may carry a leading
    ensemble axis; the results then do too.  Needs ``gp.K_inv``.

    Intermediates are query-last, (…, N, Q) and (…, D, N, Q), so the
    contractions against K⁻¹ and α are batched matmuls over Q columns."""
    if gp.K_inv is None:
        raise ValueError("transport_apply needs a GP conditioned with cache_k_inv=True")
    kernel = gp.kernel
    pos = affine_core.predict(aff, traj)  # (..., Q, D)
    Jg = aff.scale[..., None, None] * aff.rotation  # J_γ = s·R, (..., D, D)

    # posterior mean and epistemic std
    kT = kernel(gp.X, pos)  # (..., N, Q)
    meanT = gp.alpha.transpose(-1, -2) @ kT  # (..., P, Q)
    var = kernel.diag(pos) - ((gp.K_inv @ kT) * kT).sum(-2)  # (..., Q)
    std_q = torch.sqrt(torch.clamp(var, min=0.0)) - gp_core._noise_std(kernel, var)
    traj_new = pos + meanT.transpose(-1, -2)
    std = std_q[..., None].expand(traj_new.shape)

    # Jacobian posterior
    dkT = kernel.dxT(pos, gp.X)  # (..., D, N, Q)
    JpsiT = torch.einsum("...np,...dnq->...pdq", gp.alpha, dkT)  # (..., P, D, Q)
    quadT = ((gp.K_inv[..., None, :, :] @ dkT) * dkT).sum(-2)  # (..., D, Q)
    JvarT = kernel.dxdz_diag(pos).transpose(-1, -2) - quadT  # (..., D, Q)

    # J_Φ = J_γ + J_Ψ J_γ, and the diffeomorphism diagnostic min|det J_Φ|
    JphiT = Jg[..., None] + torch.einsum("...peq,...ed->...pdq", JpsiT, Jg)
    Jphi = JphiT.movedim(-1, -3)  # (..., Q, P, D)
    min_abs_det = _det_small(Jphi).abs().amin(dim=-1)

    # velocity and velocity-variance push-forward
    wT = Jg @ delta.transpose(-1, -2)  # (..., D, Q) = (J_γ v)ᵀ
    delta_newT = wT + torch.einsum("...pdq,...dq->...pq", JpsiT, wT)
    dvar_q = (JvarT * wT**2).sum(-2)  # (..., Q), the same for every output
    delta_var = dvar_q[..., None].expand(traj_new.shape)

    ori_new = None
    if ori is not None:
        if Jphi.shape[-2:] != (3, 3):
            raise ValueError(
                f"Orientation transport requires a 3-D map; J_Φ is {tuple(Jphi.shape[-2:])}"
            )
        ori_new = quat.multiply(quat.from_rotation_matrix_iter(Jphi), ori)

    return TransportResult(traj_new, std, delta_newT.transpose(-1, -2), delta_var,
                           min_abs_det, ori_new)


def fit_and_transport(
    kernel: K.Kernel,
    source_distribution: Tensor,
    target_distribution: Tensor,
    traj: Tensor,
    delta: Tensor,
    do_scale: bool = False,
    do_rotation: bool = True,
    jitter: float = 1e-10,
    ori: Optional[Tensor] = None,
) -> TransportResult:
    """γ fit, Ψ conditioning and transport of (traj, delta) for one target."""
    aff, gp = fit_pipeline(
        kernel, source_distribution, target_distribution,
        do_scale=do_scale, do_rotation=do_rotation, jitter=jitter,
    )
    return transport_apply(aff, gp, traj, delta, ori=ori)


# Largest member size that the batched kernel route takes.
BATCHED_MAX_N = 64
# From this member size the JAX package conditions through its blocked
# Cholesky (stationary kernels only), which the port does not have yet.
BLOCKED_MIN_N = 768


def fit_and_transport_batched(
    kernel: K.Kernel,
    source_distribution: Tensor,
    target_distributions: Tensor,
    traj: Tensor,
    delta: Tensor,
    do_scale: bool = False,
    do_rotation: bool = True,
    jitter: float = 1e-10,
    ori: Optional[Tensor] = None,
) -> TransportResult:
    """One shared (source, traj, delta) transported onto E targets
    (E, n, D): the ensemble workload.  Same results as
    ``fit_and_transport`` for each target in turn.

    For n ≤ 64 all members go together: a batched Kabsch fit (closed form
    in 2-D), E Grams in one call, one launch of the Cholesky/inverse
    kernel over all of them (the plain twin for CPU tensors), and the
    batched ``transport_apply``.  Larger members are transported one by
    one; n ≥ 768 with a stationary kernel raises ``NotImplementedError``
    (the blocked Cholesky is not ported yet)."""
    n, d = source_distribution.shape
    if n > BATCHED_MAX_N:
        if n >= BLOCKED_MIN_N and gp_core.stationary_family_params(kernel) is not None:
            raise NotImplementedError(
                f"members of n={n} >= {BLOCKED_MIN_N} points need the blocked "
                "Cholesky, which the torch port does not have yet"
            )
        results = [
            fit_and_transport(
                kernel, source_distribution, tgt, traj, delta,
                do_scale=do_scale, do_rotation=do_rotation, jitter=jitter, ori=ori,
            )
            for tgt in target_distributions
        ]
        return TransportResult(*(
            None if field[0] is None else torch.stack(field) for field in zip(*results)
        ))

    aff_b = affine_core.fit_batched(
        source_distribution, target_distributions, do_scale=do_scale, do_rotation=do_rotation
    )
    src_al = affine_core.predict(aff_b, source_distribution)  # (E, n, d)
    delta_b = target_distributions - src_al

    eff = gp_core._eff_jitter(src_al.dtype, jitter)
    K_b = kernel(src_al) + eff * torch.eye(n, dtype=src_al.dtype, device=src_al.device)
    L_e, Kinv_e = spd_inverse_elast_auto(K_b.permute(1, 2, 0).contiguous())  # (n, n, E)
    L_b = L_e.permute(2, 0, 1)
    Kinv_b = Kinv_e.permute(2, 0, 1)
    alpha_b = Kinv_b @ delta_b

    gp = gp_core.ExactGP(
        kernel=kernel, X=src_al, Y=delta_b, alpha=alpha_b, L=L_b, K_inv=Kinv_b, jitter=jitter
    )
    return transport_apply(aff_b, gp, traj, delta, ori=ori)
