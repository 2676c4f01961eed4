"""Fused small-N GP log marginal likelihood and its gradient, per lane.

Port of ``gaussian_process_transportation_tpu/ops/fused_lml.py``.  For E
lanes (HMC chains, L-BFGS restarts, ensemble members) of the
C·stationary(+White) family, each lane evaluates

* K = amp·φ(s) + (noise + jitter)·I, s = Σ_d Δ²_d / ℓ_d²,
* its Cholesky, α = K⁻¹Y, log|K| and the LML summed over the p columns,
* the trace-identity gradient ½⟨ααᵀ − p·K⁻¹, ∂K/∂θ⟩ in
  θ = [log amp, log ℓ (n_ls rows), log noise (if has_noise)].

The layouts are the JAX ones: theta (T, E) lane-last, results ((E,), (T, E)).
Two wrappers launch the kernels of ``csrc/fused_lml.cu`` for CUDA tensors
(float32, contiguous; anything else raises) and take the plain twins
defined beside them for CPU tensors:

* ``small_lml_value_grad``: one (X (n, D), Y (n, p)) shared by every lane
  (the HMC hyperposterior's chains);
* ``small_lml_value_grad_md``: lane e has its own (Xe[e], Ye[e]) (the
  per-member hyperparameter fits).

The module-private ``_small_lml_value_md`` gives the per-lane values
alone, bit for bit those of ``small_lml_value_grad_md``, from the kernel's
value-only instance, for callers that discard the gradient (the L-BFGS line
search of ``models/exact_gp.py::fit_ensemble_fused``).

Both count their launches in ``<wrapper>.launches`` (the value-only
launches in ``small_lml_value_grad_md``'s, and also in its
``value_only_launches``).  As in JAX, n ≤ 32
and nothing else is limited: the kernel takes any D (coordinates in
chunks of eight) and at most ``KERNEL_P`` columns of Y a launch, so a
wider Y is split into column chunks, one launch each, whose values and
gradients add up (the LML and its gradient are sums over Y's columns).
The twins compute in theta's dtype and give a lane whose Gram is not
positive definite a NaN value and gradient, as the kernels do.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from . import _cuda
from .pallas_gram import STATIONARY_FAMILIES, stationary_from_sqdist

MAX_N = 32
KERNEL_P = 8  # columns of Y one launch takes (kMaxP in csrc/fused_lml.cu)

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def _dphi(s: Tensor, family: str) -> Tensor:
    """∂φ/∂s, with the clamps that keep the diagonal finite (0·finite)."""
    if family == "rbf":
        return -0.5 * torch.exp(-0.5 * s)
    d = torch.sqrt(s + 1e-36)
    if family == "matern12":
        return -torch.exp(-d) / (2.0 * torch.clamp(d, min=1e-18))
    if family == "matern32":
        return -1.5 * torch.exp(-_SQRT3 * d)
    if family == "matern52":
        sd = _SQRT5 * d
        return -(5.0 / 6.0) * (1.0 + sd) * torch.exp(-sd)
    raise ValueError(f"unknown stationary family {family!r}")


def _check_layout(name: str, n: int, D: int, p: int, theta: Tensor, family: str, n_ls: int,
                  has_noise: bool) -> None:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: the fused small-LML kernel is for 1 <= n <= {MAX_N}, got {n}")
    if p < 1:
        raise ValueError(f"{name}: Y needs at least one column, got {p}")
    if family not in STATIONARY_FAMILIES:
        raise ValueError(f"{name}: unknown stationary family {family!r}")
    if n_ls not in (1, D):
        raise ValueError(f"{name}: n_ls must be 1 or D={D}, got {n_ls}")
    T = 1 + n_ls + int(has_noise)
    if theta.dim() != 2 or theta.shape[0] != T:
        raise ValueError(f"{name}: theta must be (T={T}, E), got {tuple(theta.shape)}")


# -- plain twins ------------------------------------------------------------


def _value_parts(Xe: Tensor, Ye: Tensor, theta: Tensor, family: str, n_ls: int,
                 has_noise: bool, jitter: float):
    """The value and what the gradient reuses, lanes first: Xe (E or 1, n,
    D), Ye (E or 1, n, p), theta (T, E).  The value-only and the full twin
    both take their value from here, so the two agree bit for bit."""
    dtype = theta.dtype
    Xe, Ye = Xe.to(dtype), Ye.to(dtype)
    E = theta.shape[1]
    n, D = Xe.shape[-2:]
    p = Ye.shape[-1]
    th = theta.T  # (E, T)
    amp = torch.exp(th[:, 0])
    inv_ls2 = torch.exp(-2.0 * th[:, 1:1 + n_ls]).expand(E, D)
    noise = torch.exp(th[:, 1 + n_ls]) if has_noise else th.new_zeros(E)

    diff = Xe[:, :, None, :] - Xe[:, None, :, :]
    d2 = diff * diff  # (E|1, n, n, D)
    s = (d2 * inv_ls2[:, None, None, :]).sum(-1)  # (E, n, n)
    ph = stationary_from_sqdist(s, family)
    eye = torch.eye(n, dtype=dtype, device=theta.device)
    K = amp[:, None, None] * ph + eye * (noise + jitter)[:, None, None]
    L, info = torch.linalg.cholesky_ex(K)
    bad = info != 0  # a Gram that is not positive definite: NaN in its lane only
    L = torch.where(bad[:, None, None], eye, L)
    Yb = Ye.expand(E, n, p)
    alpha = torch.cholesky_solve(Yb, L)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    quad = (alpha * Yb).sum((-2, -1))
    val = -0.5 * quad - p * (0.5 * logdet + 0.5 * n * _LOG_2PI)
    val = torch.where(bad, torch.full((), math.nan, dtype=dtype, device=theta.device), val)
    return val, dict(amp=amp, inv_ls2=inv_ls2, noise=noise, d2=d2, s=s, ph=ph, L=L, bad=bad,
                     alpha=alpha)


def _value_grad_plain(Xe: Tensor, Ye: Tensor, theta: Tensor, family: str, n_ls: int,
                      has_noise: bool, jitter: float) -> Tuple[Tensor, Tensor]:
    """Lanes first: Xe (E or 1, n, D), Ye (E or 1, n, p), theta (T, E)."""
    val, c = _value_parts(Xe, Ye, theta, family, n_ls, has_noise, jitter)
    amp, inv_ls2, noise, d2, s, ph = (c[k] for k in ("amp", "inv_ls2", "noise", "d2", "s", "ph"))
    alpha, p = c["alpha"], Ye.shape[-1]
    K_inv = torch.cholesky_inverse(c["L"])
    W = 0.5 * (alpha @ alpha.transpose(-1, -2) - p * K_inv)
    g_amp = (W * (amp[:, None, None] * ph)).sum((-2, -1))
    Wdk = W * (amp[:, None, None] * _dphi(s, family))
    g_ls = (Wdk[..., None] * d2).sum((1, 2)) * (-2.0 * inv_ls2)  # (E, D)
    if n_ls == 1:
        g_ls = g_ls.sum(1, keepdim=True)
    rows = [g_amp[:, None], g_ls]
    if has_noise:
        rows.append((noise * torch.diagonal(W, dim1=-2, dim2=-1).sum(-1))[:, None])
    grad = torch.cat(rows, 1).T
    nan = torch.full((), math.nan, dtype=theta.dtype, device=theta.device)
    return val, torch.where(c["bad"][None, :], nan, grad)


def small_lml_value_grad_ref(X: Tensor, Y: Tensor, theta: Tensor, family: str = "rbf",
                             n_ls: int = 1, has_noise: bool = True,
                             jitter: float = 1e-10) -> Tuple[Tensor, Tensor]:
    """Plain twin of :func:`small_lml_value_grad`: X (n, D), Y (n, p) or
    (n,), theta (T, E) → (values (E,), gradients (T, E))."""
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    return _value_grad_plain(X[None], Y2[None], theta, family, n_ls, has_noise, jitter)


def small_lml_value_grad_md_ref(Xe: Tensor, Ye: Tensor, theta: Tensor, family: str = "rbf",
                                n_ls: int = 1, has_noise: bool = True,
                                jitter: float = 1e-10) -> Tuple[Tensor, Tensor]:
    """Plain twin of :func:`small_lml_value_grad_md`: Xe (E, n, D), Ye
    (E, n, p) or (E, n), theta (T, E) → ((E,), (T, E))."""
    Ye3 = Ye[:, :, None] if Ye.dim() == 2 else Ye
    return _value_grad_plain(Xe, Ye3, theta, family, n_ls, has_noise, jitter)


def _small_lml_value_md_ref(Xe: Tensor, Ye: Tensor, theta: Tensor, family: str = "rbf",
                            n_ls: int = 1, has_noise: bool = True,
                            jitter: float = 1e-10) -> Tensor:
    """Plain twin of :func:`_small_lml_value_md`: the values (E,) of
    :func:`small_lml_value_grad_md_ref`, bit for bit, without the inverse
    and the gradient."""
    Ye3 = Ye[:, :, None] if Ye.dim() == 2 else Ye
    return _value_parts(Xe, Ye3, theta, family, n_ls, has_noise, jitter)[0]


# -- kernel wrappers --------------------------------------------------------

_COMMON = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
_ARGTYPES = {"small_lml_value_grad_f32": [ctypes.c_void_p] * 5 + _COMMON,
             "small_lml_value_grad_md_f32": [ctypes.c_void_p] * 5 + _COMMON,
             "small_lml_value_md_f32": [ctypes.c_void_p] * 4 + _COMMON}


@functools.lru_cache(maxsize=None)
def _entry(entry: str):
    fn = getattr(_cuda.library("fused_lml"), entry)
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return fn


def _on_card(*tensors: Tensor) -> bool:
    """True when any input lies on a CUDA device: the kernel's route, which
    then raises on inputs it does not take."""
    return any(t.device.type == "cuda" for t in tensors)


def _launch(name: str, entry: str, X: Tensor, Y: Tensor, theta: Tensor, family: str,
            n_ls: int, has_noise: bool, jitter: float,
            with_grad: bool = True) -> Tuple[Tensor, Optional[Tensor], int]:
    """Checks the card's inputs and launches ``entry`` once per chunk of
    ``KERNEL_P`` columns of Y, summing the chunks' values and gradients;
    returns (values, gradients or None, launches)."""
    device = theta.device
    for t in (X, Y, theta):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 on the card, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    n, D = X.shape[-2:]
    E, p = theta.shape[1], Y.shape[-1]
    if E == 0:
        return theta.new_empty(E), torch.empty_like(theta) if with_grad else None, 0
    fn = _entry(entry)
    val = grad = None
    launches = 0
    for c0 in range(0, p, KERNEL_P):
        Yc = Y if p <= KERNEL_P else Y[..., c0:c0 + KERNEL_P].contiguous()
        v = torch.empty(E, dtype=torch.float32, device=device)
        g = torch.empty(theta.shape, dtype=torch.float32, device=device) if with_grad else None
        outs = (v.data_ptr(), g.data_ptr()) if with_grad else (v.data_ptr(),)
        with torch.cuda.device(device):
            err = fn(X.data_ptr(), Yc.data_ptr(), theta.data_ptr(), *outs,
                     n, D, Yc.shape[-1], n_ls, int(has_noise),
                     STATIONARY_FAMILIES.index(family), float(jitter), E,
                     torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
        launches += 1
        if val is None:
            val, grad = v, g
        else:
            val = val + v
            grad = grad + g if with_grad else None
    return val, grad, launches


def small_lml_value_grad(X: Tensor, Y: Tensor, theta: Tensor, family: str = "rbf",
                         n_ls: int = 1, has_noise: bool = True,
                         jitter: float = 1e-10) -> Tuple[Tensor, Tensor]:
    """(LML values (E,), gradients (T, E)) of E lanes sharing X (n, D) and
    Y (n, p) or (n,), at theta (T, E) in the canonical layout.

    For CUDA tensors one launch of the kernel per eight columns of Y
    (float32, contiguous, n ≤ 32); for CPU tensors the plain twin."""
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    if X.dim() != 2 or Y2.dim() != 2 or Y2.shape[0] != X.shape[0]:
        raise ValueError(f"small_lml_value_grad: X (n, D) and Y (n, p), got "
                         f"{tuple(X.shape)} and {tuple(Y.shape)}")
    _check_layout("small_lml_value_grad", X.shape[0], X.shape[1], Y2.shape[1], theta, family,
                  n_ls, has_noise)
    if not _on_card(X, Y2, theta):
        return small_lml_value_grad_ref(X, Y2, theta, family, n_ls, has_noise, jitter)
    val, grad, launches = _launch("small_lml_value_grad", "small_lml_value_grad_f32", X, Y2,
                                  theta, family, n_ls, has_noise, jitter)
    small_lml_value_grad.launches += launches
    return val, grad


small_lml_value_grad.launches = 0


def _check_md(name: str, Xe: Tensor, Ye: Tensor, theta: Tensor, family: str, n_ls: int,
              has_noise: bool) -> Tensor:
    """The per-lane entries' checks; returns Ye as (E, n, p)."""
    Ye3 = Ye[:, :, None] if Ye.dim() == 2 else Ye
    if Xe.dim() != 3 or Ye3.dim() != 3 or Ye3.shape[:2] != Xe.shape[:2]:
        raise ValueError(f"{name}: Xe (E, n, D) and Ye (E, n, p), got "
                         f"{tuple(Xe.shape)} and {tuple(Ye.shape)}")
    _check_layout(name, Xe.shape[1], Xe.shape[2], Ye3.shape[2], theta, family, n_ls, has_noise)
    if theta.shape[1] != Xe.shape[0]:
        raise ValueError(f"{name}: theta has {theta.shape[1]} lanes, the data {Xe.shape[0]}")
    return Ye3


def small_lml_value_grad_md(Xe: Tensor, Ye: Tensor, theta: Tensor, family: str = "rbf",
                            n_ls: int = 1, has_noise: bool = True,
                            jitter: float = 1e-10) -> Tuple[Tensor, Tensor]:
    """(LML values (E,), gradients (T, E)) where lane e evaluates its own
    dataset (Xe[e] (n, D), Ye[e] (n, p)) at theta[:, e].

    For CUDA tensors one launch of the kernel per eight columns of Y
    (float32, contiguous, n ≤ 32); for CPU tensors the plain twin."""
    Ye3 = _check_md("small_lml_value_grad_md", Xe, Ye, theta, family, n_ls, has_noise)
    if not _on_card(Xe, Ye3, theta):
        return small_lml_value_grad_md_ref(Xe, Ye3, theta, family, n_ls, has_noise, jitter)
    val, grad, launches = _launch("small_lml_value_grad_md", "small_lml_value_grad_md_f32", Xe,
                                  Ye3, theta, family, n_ls, has_noise, jitter)
    small_lml_value_grad_md.launches += launches
    return val, grad


small_lml_value_grad_md.launches = 0
small_lml_value_grad_md.value_only_launches = 0


def _small_lml_value_md(Xe: Tensor, Ye: Tensor, theta: Tensor, family: str = "rbf",
                        n_ls: int = 1, has_noise: bool = True, jitter: float = 1e-10) -> Tensor:
    """The values (E,) of :func:`small_lml_value_grad_md`, bit for bit,
    without the inverse and the gradient: for callers that would discard
    the gradient (the line search's candidates).

    For CUDA tensors the kernel's value-only instance, one launch per eight
    columns of Y, counted in ``small_lml_value_grad_md.launches`` and in its
    ``value_only_launches``; for CPU tensors the plain twin."""
    Ye3 = _check_md("small_lml_value_grad_md", Xe, Ye, theta, family, n_ls, has_noise)
    if not _on_card(Xe, Ye3, theta):
        return _small_lml_value_md_ref(Xe, Ye3, theta, family, n_ls, has_noise, jitter)
    val, _, launches = _launch("small_lml_value_grad_md", "small_lml_value_md_f32", Xe, Ye3,
                               theta, family, n_ls, has_noise, jitter, with_grad=False)
    small_lml_value_grad_md.launches += launches
    small_lml_value_grad_md.value_only_launches += launches
    return val
