"""Gaussian-process transportation: the functional pipeline.

Port of ``gaussian_process_transportation_tpu/transport/gpt.py``.  A demo
(traj, delta) is moved by Φ = γ + Ψ∘γ, where γ is the Kabsch fit of a
source point set onto a target one and Ψ the GP on the residuals:

* ``fit_and_transport`` does it for one target;
* ``fit_and_transport_batched`` for E targets at once (the ensemble
  workload): members of n ≤ 64 points with one Cholesky/inverse kernel
  launch for all E Grams, members of n ≥ ``BLOCKED_MIN_N`` points
  (stationary kernels) one by one through the blocked Cholesky, the sizes
  between one by one through the dense path.

* ``fit_and_transport_batched_opt`` for E targets with each member's
  hyperparameters fitted to its own residuals first (the original
  project's refit-per-transport behaviour at ensemble scale), through
  ``models.exact_gp.fit_ensemble_fused``.

``transport_apply`` accepts a GP and affine fit with or without a leading
ensemble axis (and a kernel with per-member hyperparameters), so every
entry point shares it.  The public shapes are the JAX ones: every field is
(Q, D), or (E, Q, D) batched, ``ori`` (…, Q, 4), and ``min_abs_det`` is ()
or (E,).

``GaussianProcessTransportation`` is the original project's attribute
protocol over ``transport.core.PolicyTransport`` and
``models.gp_regressor.GaussianProcess``, on the card unless asked for the
CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from .. import kernels as K
from ..models import affine as affine_core
from ..models import exact_gp as gp_core
from ..models.affine import AffineParams
from ..models.gp_regressor import GaussianProcess
from ..ops import quaternion as quat
from ..ops.batched_linalg import spd_inverse_elast_auto
from ..ops.fused_lml import MAX_N as FUSED_LML_MAX_N
from ..ops import transport_apply as fused_apply
from ..ops.linalg import tri_solve_lower
from ..utils.logging_utils import span, spans_on, tally
from .core import PolicyTransport


def default_transport_kernel(
    d: int = 1, dtype: torch.dtype = torch.float32, device="cuda"
) -> K.Kernel:
    """C(0.1)·RBF(0.1) + White(1e-4), the original project's default, with
    its lengthscale on ``device`` (the card unless the caller asks for the
    CPU)."""
    return K.Constant(0.1) * K.RBF(0.1 * torch.ones(d, dtype=dtype, device=device)) + K.White(1e-4)


class GaussianProcessTransportation:
    """The original project's transport protocol: set
    ``source_distribution``, ``target_distribution``, ``training_traj`` and
    optionally ``training_delta`` / ``training_ori`` (numpy arrays or
    tensors), then ``fit_transportation()`` and ``apply_transportation()``,
    which replaces those attributes by their transported values and sets
    ``std`` and ``var_vel_transported``.

    Every attribute is moved to ``device`` (the card unless the caller asks
    for the CPU) in its own dtype.  ``gp_kwargs`` go to ``GaussianProcess``, whose default re-fits the
    residual GP's hyperparameters (L-BFGS-B, 5 restarts) on every fit."""

    def __init__(self, kernel_transport: Optional[K.Kernel] = None, device="cuda", **gp_kwargs):
        self.device = torch.device(device)
        kernel = kernel_transport
        if kernel is None:
            kernel = default_transport_kernel(device=self.device)
        self.method = PolicyTransport(GaussianProcess(kernel=kernel, **gp_kwargs))

    def _tensor(self, value) -> Tensor:
        return torch.as_tensor(value, device=self.device)

    def fit_transportation(self, do_scale: bool = False, do_rotation: bool = True):
        self.method.fit(self._tensor(self.source_distribution),
                        self._tensor(self.target_distribution),
                        do_scale=do_scale, do_rotation=do_rotation)

    def apply_transportation(self):
        self.training_traj_old = self._tensor(self.training_traj)
        self.training_traj, self.std = self.method.transport(self.training_traj_old)
        if getattr(self, "training_delta", None) is not None:
            self.training_delta, self.var_vel_transported = self.method.transport_velocity(
                self.training_traj_old, self._tensor(self.training_delta))
        if getattr(self, "training_ori", None) is not None:
            self.training_ori = self.method.transport_orientation(
                self.training_traj_old, self._tensor(self.training_ori))

    def sample_transportation(self):
        return self.method.sample_transportation(self.training_traj_old)


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


def fused_apply_inputs(aff: AffineParams, gp: gp_core.ExactGP, traj: Tensor, delta: Tensor,
                       ori: Optional[Tensor] = None) -> bool:
    """Whether ``transport_apply``'s inputs are those the fused kernel
    (``ops/transport_apply.py``) takes, on whatever device: float32
    throughout on one device; a GP with its factor L and a cached K⁻¹ (the
    batched route) of 1 ≤ n ≤ 64 points with D ∈ {2, 3}
    coordinates and one leading member axis or none, matched by the affine
    fit's fields; a demo (Q, D) with Q ≥ 1 and no orientations; a
    C·RBF(+White) kernel, ARD or isotropic, shared or per member."""
    X = gp.X
    if ori is not None or gp.K_inv is None or gp.L is None or X.dim() not in (2, 3):
        return False
    lead, (n, D) = tuple(X.shape[:-2]), X.shape[-2:]
    if (not 1 <= n <= fused_apply.MAX_N or D not in fused_apply.DIMS
            or traj.dim() != 2 or traj.shape[0] < 1 or traj.shape[1] != D
            or delta.shape != traj.shape):
        return False
    shapes = ((gp.alpha, (n, D)), (gp.L, (n, n)), (gp.K_inv, (n, n)), (aff.rotation, (D, D)),
              (aff.scale, ()), (aff.source_centroid, (D,)), (aff.target_centroid, (D,)))
    if any(tuple(t.shape) != lead + tail for t, tail in shapes):
        return False
    if any(t.dtype != torch.float32 or t.device != traj.device
           for t in (X, traj, delta, *(t for t, _ in shapes))):
        return False
    hyper = gp_core.rbf_hyperparameters(gp.kernel)
    E = lead[0] if lead else 1
    return hyper is not None and fused_apply.hyperparameters_fit(*hyper, E, D, traj.device)


def _transport_apply_fused(aff: AffineParams, gp: gp_core.ExactGP, traj: Tensor,
                           delta: Tensor) -> TransportResult:
    """``transport_apply`` in one launch of the fused kernel."""
    amplitude, lengthscale, noise = gp_core.rbf_hyperparameters(gp.kernel)
    one = gp.X.dim() == 2  # no member axis: a member of one

    def members(t):
        return t[None] if one else t

    out = fused_apply.transport_apply_rbf(
        members(gp.X), members(gp.alpha), members(gp.L), members(aff.rotation),
        members(aff.scale), members(aff.source_centroid), members(aff.target_centroid), traj,
        delta, amplitude, lengthscale, noise)
    traj_new, std_q, delta_new, dvar_q, min_abs_det = (t[0] for t in out) if one else out
    return TransportResult(traj_new, std_q[..., None].expand(traj_new.shape), delta_new,
                           dvar_q[..., None].expand(traj_new.shape), min_abs_det)


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
    ensemble axis; the results then do too.

    CUDA inputs that :func:`fused_apply_inputs` takes (the batched small-n
    route under C·RBF(+White), float32, no orientations) go through one
    launch of the fused kernel (``ops/transport_apply.py``), which keeps
    every intermediate on the chip.  Every other input takes the plain
    route below.

    On the plain route intermediates are query-last, (…, N, Q) and
    (…, D, N, Q), so the contractions against K⁻¹ and α are batched matmuls
    over Q columns.  Without a cached K⁻¹ the variances come from forward
    substitution with the GP's factor, dense or blocked; the blocked one
    takes the Jacobian's D directions as one (N, D·Q) right-hand side."""
    dev = traj.device
    with span("gpt.apply", dev):
        fused = dev.type == "cuda" and fused_apply_inputs(aff, gp, traj, delta, ori)
        if spans_on():
            members = gp.X[..., 0, 0].numel()
            tally("gpt.apply.members", members)
            tally("gpt.apply.fused_members", members if fused else 0)
        if fused:
            with span("gpt.apply.fused", dev):
                return _transport_apply_fused(aff, gp, traj, delta)
        kernel = gp.kernel
        with span("gpt.apply.posterior", dev):
            pos = affine_core.predict(aff, traj)  # (..., Q, D)
            Jg = aff.scale[..., None, None] * aff.rotation  # J_γ = s·R, (..., D, D)

            # posterior mean and epistemic std
            kT = kernel(gp.X, pos)  # (..., N, Q)
            meanT = gp.alpha.transpose(-1, -2) @ kT  # (..., P, Q)
            if gp.K_inv is not None:
                var = kernel.diag(pos) - ((gp.K_inv @ kT) * kT).sum(-2)  # (..., Q)
            else:
                V = gp_core._solve_lower_any(gp, kT)  # (..., N, Q)
                var = kernel.diag(pos) - (V * V).sum(-2)
            std_q = torch.sqrt(torch.clamp(var, min=0.0)) - gp_core._noise_std(kernel, var)
            traj_new = pos + meanT.transpose(-1, -2)
            std = std_q[..., None].expand(traj_new.shape)

        with span("gpt.apply.jacobian", dev):
            # Jacobian posterior
            dkT = kernel.dxT(pos, gp.X)  # (..., D, N, Q)
            JpsiT = torch.einsum("...np,...dnq->...pdq", gp.alpha, dkT)  # (..., P, D, Q)
            if gp.K_inv is not None:
                quadT = ((gp.K_inv[..., None, :, :] @ dkT) * dkT).sum(-2)  # (..., D, Q)
            elif gp.chol is not None:
                D_, N_, Q_ = dkT.shape
                Vd = gp.chol.solve_lower(dkT.transpose(0, 1).reshape(N_, D_ * Q_))  # (N, D·Q)
                quadT = (Vd * Vd).reshape(N_, D_, Q_).sum(0)
            else:
                Vd = tri_solve_lower(gp.L[..., None, :, :], dkT)  # (..., D, N, Q)
                quadT = (Vd * Vd).sum(-2)
            JvarT = kernel.dxdz_diag(pos).transpose(-1, -2) - quadT  # (..., D, Q)

        with span("gpt.apply.pushforward", dev):
            # J_Φ = J_γ + J_Ψ J_γ, and the diffeomorphism diagnostic min|det J_Φ|
            JphiT = Jg[..., None] + torch.einsum("...peq,...ed->...pdq", JpsiT, Jg)
            Jphi = JphiT.movedim(-1, -3)  # (..., Q, P, D)
            min_abs_det = fused_apply.det_small(Jphi).abs().amin(dim=-1)

            # velocity and velocity-variance push-forward
            wT = Jg @ delta.transpose(-1, -2)  # (..., D, Q) = (J_γ v)ᵀ
            delta_newT = wT + torch.einsum("...pdq,...dq->...pq", JpsiT, wT)
            dvar_q = (JvarT * wT**2).sum(-2)  # (..., Q), the same for every output
            delta_var = dvar_q[..., None].expand(traj_new.shape)

            ori_new = None
            if ori is not None:
                if Jphi.shape[-2:] != (3, 3):
                    raise ValueError("Orientation transport requires a 3-D map; "
                                     f"J_Φ is {tuple(Jphi.shape[-2:])}")
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
# From this member size (stationary kernels) each member is conditioned
# through the blocked Cholesky, below it through the dense route
# (torch.linalg.cholesky and K^-1).  On an NVIDIA H100 80GB HBM3 (700 W),
# with the many-CTA factor_panel, scripts/time_port_routes.py timed one 3-D
# member (Q=1000) both ways, in pairs: the dense route faster in every pair
# at n = 768 (4.3-5.0 vs 5.1-7.1 ms) and 1536 (5.2-6.5 vs 6.1-7.0 ms), the
# blocked one in every pair at n = 2500 (7.4-8.6 vs 8.1-9.1 ms) and 4096
# (9.7-12.2 vs 16.0-16.7 ms).  Re-timed with the Gram's panels in one launch
# (SM clock 1980 MHz): either way at n = 1536 (5.2 vs 5.1, 4.7 vs 7.0 ms),
# the blocked route in both pairs at n = 2500 (7.7 vs 8.5, 9.2 vs 9.6 ms).
# (The JAX package takes the blocked path from 768.)
BLOCKED_MIN_N = 2500
BLOCKED_PANEL = 512


def _affine_batched(source_distribution: Tensor, target_distributions: Tensor,
                    do_scale: bool, do_rotation: bool):
    """The batched Kabsch fit of the source onto each of E targets, the
    aligned sources (E, n, d) and the residuals the GP conditions on."""
    with span("gpt.affine", target_distributions.device):
        aff_b = affine_core.fit_batched(
            source_distribution, target_distributions, do_scale=do_scale, do_rotation=do_rotation
        )
        src_al = affine_core.predict(aff_b, source_distribution)  # (E, n, d)
        return aff_b, src_al, target_distributions - src_al


def _condition_batched(kernel: K.Kernel, src_al: Tensor, delta_b: Tensor,
                       jitter: float) -> gp_core.ExactGP:
    """E residual GPs of n ≤ 64 points each (a kernel with per-member
    hyperparameters or one shared): the E Grams with the jitter, one
    Cholesky/inverse launch over all of them, and α = K⁻¹Δ."""
    n = src_al.shape[-2]
    with span("gpt.condition", src_al.device):
        eff = gp_core._eff_jitter(src_al.dtype, jitter)
        K_b = kernel(src_al) + eff * torch.eye(n, dtype=src_al.dtype, device=src_al.device)
        L_e, Kinv_e = spd_inverse_elast_auto(K_b.permute(1, 2, 0).contiguous())  # (n, n, E)
        Kinv_b = Kinv_e.permute(2, 0, 1)
        return gp_core.ExactGP(
            kernel=kernel, X=src_al, Y=delta_b, alpha=Kinv_b @ delta_b, L=L_e.permute(2, 0, 1),
            K_inv=Kinv_b, jitter=jitter,
        )


def _transport_members(kernel, source_distribution, target_distributions, traj, delta,
                       do_scale, do_rotation, jitter, ori) -> TransportResult:
    """``fit_and_transport_batched`` above ``BATCHED_MAX_N``: one member at
    a time, through ``condition_blocked`` from ``BLOCKED_MIN_N`` with a
    stationary kernel, else through ``fit_and_transport``."""
    n = source_distribution.shape[0]
    blocked = n >= BLOCKED_MIN_N and gp_core.stationary_family_params(kernel) is not None

    def member(tgt):
        if not blocked:
            return fit_and_transport(
                kernel, source_distribution, tgt, traj, delta,
                do_scale=do_scale, do_rotation=do_rotation, jitter=jitter, ori=ori,
            )
        aff = affine_core.fit(source_distribution, tgt,
                              do_scale=do_scale, do_rotation=do_rotation)
        src_al = affine_core.predict(aff, source_distribution)
        gp = gp_core.condition_blocked(kernel, src_al, tgt - src_al, jitter=jitter,
                                       block=BLOCKED_PANEL)
        return transport_apply(aff, gp, traj, delta, ori=ori)

    results = [member(tgt) for tgt in target_distributions]
    return TransportResult(*(
        None if field[0] is None else torch.stack(field) for field in zip(*results)
    ))


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
    one: from n = ``BLOCKED_MIN_N`` with a stationary kernel each through
    ``condition_blocked`` (panels of 512, one ``factor_panel`` launch per
    panel on the card) and ``transport_apply`` without K⁻¹, below that
    through the dense ``fit_and_transport``."""
    n, d = source_distribution.shape
    with span("gpt.transport_batched", target_distributions.device):
        if n > BATCHED_MAX_N:
            return _transport_members(kernel, source_distribution, target_distributions, traj,
                                      delta, do_scale, do_rotation, jitter, ori)
        aff_b, src_al, delta_b = _affine_batched(source_distribution, target_distributions,
                                                 do_scale, do_rotation)
        gp = _condition_batched(kernel, src_al, delta_b, jitter)
        return transport_apply(aff_b, gp, traj, delta, ori=ori)


def fit_and_transport_batched_opt(
    kernel: K.Kernel,
    source_distribution: Tensor,
    target_distributions: Tensor,
    traj: Tensor,
    delta: Tensor,
    n_restarts: int = 6,
    maxiter: int = 30,
    generator: Optional[torch.Generator] = None,
    do_scale: bool = False,
    do_rotation: bool = True,
    jitter: float = 1e-10,
    ori: Optional[Tensor] = None,
) -> TransportResult:
    """Batched multi-target transport with per-member hyperparameter
    optimization: each member's residual dataset (γ_e(S), T_e − γ_e(S))
    gets its own multi-restart L-BFGS fit through
    ``models.exact_gp.fit_ensemble_fused`` (one launch of the fused-LML
    kernel per line-search candidate on the card), then the transport runs
    with the per-member kernels ``kernel.with_theta(thetas)`` through the
    same conditioning as :func:`fit_and_transport_batched`: E Grams, one
    launch of the Cholesky/inverse kernel, the batched ``transport_apply``.

    ``generator`` draws the restarts (on the targets' device).  Needs the
    C·stationary(+White) family and n ≤ 32 points per member."""
    n, d = source_distribution.shape
    if n > FUSED_LML_MAX_N:
        raise ValueError(
            "fit_and_transport_batched_opt needs n <= 32 distribution points (the fused "
            "small-LML fit)")
    with span("gpt.transport_batched_opt", target_distributions.device):
        aff_b, src_al, delta_b = _affine_batched(source_distribution, target_distributions,
                                                 do_scale, do_rotation)
        thetas, _ = gp_core.fit_ensemble_fused(kernel, src_al, delta_b, n_restarts=n_restarts,
                                               generator=generator, jitter=jitter, maxiter=maxiter)
        gp = _condition_batched(kernel.with_theta(thetas), src_al, delta_b, jitter)
        return transport_apply(aff_b, gp, traj, delta, ori=ori)
