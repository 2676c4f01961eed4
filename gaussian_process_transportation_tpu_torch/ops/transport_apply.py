"""The batched transport apply of C·RBF(+White) residual GPs, in one launch.

For E members, each a Kabsch fit γ_e and a GP Ψ_e conditioned on n points
of D ∈ ``DIMS`` coordinates, and one demo of Q points with velocities,
``transport_apply_rbf`` returns the fields of
``transport/gpt.py::transport_apply``: the transported points (E, Q, D),
the epistemic std (E, Q), the pushed-forward velocities (E, Q, D), their
variance (E, Q) and min|det J_Φ| (E,).  The quadratic forms of the
variances are ‖L⁻¹k‖² through the GP's Cholesky factor L, a forward
substitution, not kᵀK⁻¹k through a cached inverse: in float32 on an H100
the floor cell's std and velocity variance came out within 4.1e-7 and
4.8e-6 of the float64 reference by L, 1.0e-3 and 5.1e-4 by K⁻¹ (``PERF.md``
§6).

* ``transport_apply_rbf_plain`` is the plain PyTorch twin, in the same
  float formulae;
* ``transport_apply_rbf`` launches the CUDA kernel
  (``csrc/transport_apply.cu``) for CUDA tensors and takes the twin for
  CPU tensors.

The kernel replaces no TPU kernel: the JAX package left apply to XLA.  It
exists because the port's plain route writes two (E, D, n, Q) tensors
to device memory and runs its 2-wide contractions as gemv launches
(``PERF.md`` §6).  It takes float32 only, n ≤ ``MAX_N``, and counts its
launches in ``transport_apply_rbf.launches``.

Hyperparameters: the amplitude and the noise are numbers, or tensors of one
value or of E (one a member); the lengthscale a number, or a tensor of one
value, of D (ARD), or of shape (E, 1) or (E, D) (per member).  The kernel
reads a tensor on the card where it lies and takes a number, or a CPU
tensor of shared values, by value: the launch copies nothing between host
and card.  Per-member values must lie on the card.
"""
from __future__ import annotations

import ctypes
import functools
from numbers import Real
from typing import Tuple

import torch
from torch import Tensor

from . import _cuda

MAX_N = 64
DIMS = (2, 3)


def _member_scalar(value, E: int, like: Tensor) -> Tensor:
    """A scalar hyperparameter as (E,) in ``like``'s dtype and device."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device).reshape(-1).expand(E)


def _member_lengthscale(value, E: int, D: int, like: Tensor) -> Tensor:
    """A lengthscale as (E, D) in ``like``'s dtype and device."""
    ls = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    ls = ls.reshape(1, -1) if ls.dim() < 2 else ls.reshape(-1, ls.shape[-1])
    return ls.expand(E, D)


def det_small(M: Tensor) -> Tensor:
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


def transport_apply_rbf_plain(
    X: Tensor, alpha: Tensor, L: Tensor, rotation: Tensor, scale: Tensor,
    source_centroid: Tensor, target_centroid: Tensor, traj: Tensor, delta: Tensor,
    amplitude, lengthscale, noise,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(traj (E, Q, D), std (E, Q), delta (E, Q, D), delta_var (E, Q),
    min_abs_det (E,)) of E members X (E, n, D), alpha (E, n, D), the lower
    Cholesky factors L (E, n, n) of their Grams, their affine maps (rotation
    (E, D, D), scale (E,), centroids (E, D)) and the demo traj, delta (Q, D)."""
    E, n, D = X.shape
    Q = traj.shape[0]
    amp = _member_scalar(amplitude, E, X)
    nz = _member_scalar(noise, E, X)
    ls = _member_lengthscale(lengthscale, E, D, X)
    pos = (scale[:, None, None] * (traj - source_centroid[:, None, :])
           @ rotation.transpose(-1, -2) + target_centroid[:, None, :])  # (E, Q, D)
    Jg = scale[:, None, None] * rotation
    diff = (X / ls[:, None, :])[:, :, None, :] - (pos / ls[:, None, :])[:, None, :, :]
    k = amp[:, None, None] * torch.exp(-0.5 * (diff * diff).sum(-1))  # (E, n, Q)
    dk = diff * (1.0 / ls)[:, None, None, :] * k[..., None]  # (E, n, Q, D)
    mean = torch.einsum("enp,enq->eqp", alpha, k)
    Jpsi = torch.einsum("enp,enqd->eqpd", alpha, dk)  # (E, Q, P, D)
    rhs = torch.cat([k[..., None], dk], -1).reshape(E, n, Q * (1 + D))
    V = torch.linalg.solve_triangular(L, rhs, upper=False)
    quad = (V * V).sum(1).reshape(E, Q, 1 + D)
    var = (amp + nz)[:, None] - quad[..., 0]
    std = torch.sqrt(torch.clamp(var, min=0.0)) - torch.sqrt(nz)[:, None]
    Jvar = (amp[:, None] * (1.0 / (ls * ls)))[:, None, :] - quad[..., 1:]  # (E, Q, D)
    Jphi = Jg[:, None] + Jpsi @ Jg[:, None]  # (E, Q, D, D)
    w = delta @ Jg.transpose(-1, -2)  # (E, Q, D) = J_γ v
    delta_new = w + (Jpsi @ w[..., None])[..., 0]
    return pos + mean, std, delta_new, (Jvar * w * w).sum(-1), det_small(Jphi).abs().amin(-1)


# -- kernel wrapper ----------------------------------------------------------

_P, _LL, _F, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int


class _Args(ctypes.Structure):
    """``ApplyArgs`` of ``csrc/transport_apply.cu``, field by field."""

    _fields_ = [
        ("X", _P), ("x_es", _LL), ("alpha", _P), ("a_es", _LL),
        ("L", _P), ("l_es", _LL), ("l_is", _LL), ("l_js", _LL),
        ("rot", _P), ("r_es", _LL), ("scale", _P), ("s_es", _LL),
        ("src_c", _P), ("sc_es", _LL), ("tgt_c", _P), ("tc_es", _LL),
        ("traj", _P), ("delta", _P),
        ("amp_dev", _P), ("amp_es", _LL), ("amp", _F),
        ("ls_dev", _P), ("ls_es", _LL), ("ls_ds", _LL), ("ls", _F * 3),
        ("noise_dev", _P), ("noise_es", _LL), ("noise", _F),
        ("traj_out", _P), ("std_out", _P), ("delta_out", _P), ("dvar_out", _P),
        ("min_det_out", _P),
        ("E", _I), ("n", _I), ("Q", _I), ("D", _I),
    ]


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _cuda.library("transport_apply")
    lib.transport_apply_args_bytes.restype = ctypes.c_int
    if lib.transport_apply_args_bytes() != ctypes.sizeof(_Args):
        raise RuntimeError("transport_apply: the kernel's ApplyArgs and the wrapper's _Args differ")
    fn = lib.transport_apply_f32
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hyperparameters_fit(amplitude, lengthscale, noise, E: int, D: int,
                        device: torch.device) -> bool:
    """Whether the kernel takes these hyperparameters for E members of D
    coordinates on ``device``: numbers, or tensors of the shapes the module
    docstring lists, on ``device``, or on the CPU where they are shared
    (one value, or the D of an ARD lengthscale)."""
    def fits(value, shared, shapes):
        if isinstance(value, Real):
            return True
        if not (isinstance(value, Tensor) and value.is_floating_point()):
            return False
        if value.device != device:
            return value.device.type == "cpu" and (value.numel() == 1
                                                   or tuple(value.shape) in shared)
        return value.numel() == 1 or tuple(value.shape) in shapes
    return (fits(amplitude, set(), {(E,)}) and fits(noise, set(), {(E,)})
            and fits(lengthscale, {(D,)}, {(D,), (E, 1), (E, D)}))


def _scalar_arg(value, E: int):
    """(tensor to keep alive, device pointer or None, member stride, value)
    of an amplitude or noise that ``hyperparameters_fit`` took."""
    if isinstance(value, Tensor) and value.device.type != "cpu":
        t = value.to(torch.float32).reshape(-1).expand(E)
        return t, t.data_ptr(), t.stride(0), 0.0
    return None, None, 0, float(value)


def _lengthscale_arg(value, E: int, D: int):
    """(tensor to keep alive, device pointer or None, member and dimension
    strides, D host values) of a lengthscale that ``hyperparameters_fit``
    took."""
    if isinstance(value, Tensor) and value.device.type != "cpu":
        t = value.to(torch.float32)
        t = t.reshape(1, -1) if t.dim() < 2 else t.reshape(-1, t.shape[-1])
        t = t.expand(E, D)
        return t, t.data_ptr(), t.stride(0), t.stride(1), (0.0,) * 3
    vals = torch.as_tensor(value, dtype=torch.float64).reshape(-1).tolist()
    vals = vals * D if len(vals) == 1 else vals
    return None, None, 0, 0, tuple(vals) + (0.0,) * (3 - D)


def _rows(t: Tensor) -> Tensor:
    """``t`` (E, ...) with each member's entries contiguous (a copy only
    where they are not)."""
    return t if t[0].is_contiguous() else t.contiguous()


def transport_apply_rbf(
    X: Tensor, alpha: Tensor, L: Tensor, rotation: Tensor, scale: Tensor,
    source_centroid: Tensor, target_centroid: Tensor, traj: Tensor, delta: Tensor,
    amplitude, lengthscale, noise,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """:func:`transport_apply_rbf_plain`'s fields, for CUDA tensors in one
    launch of the fused kernel (float32, 1 ≤ n ≤ ``MAX_N``, D ∈ ``DIMS``; L
    read through its strides, at any layout), for CPU tensors by the twin.
    Each launch adds one to ``transport_apply_rbf.launches``."""
    if X.device.type != "cuda":
        return transport_apply_rbf_plain(X, alpha, L, rotation, scale, source_centroid,
                                         target_centroid, traj, delta, amplitude, lengthscale,
                                         noise)
    E, n, D = X.shape
    Q = traj.shape[0]
    device = X.device
    tensors = (X, alpha, L, rotation, scale, source_centroid, target_centroid, traj, delta)
    if any(t.dtype != torch.float32 or t.device != device for t in tensors):
        raise TypeError("transport_apply_rbf takes float32 tensors on one card")
    if (D not in DIMS or not 1 <= n <= MAX_N or alpha.shape != X.shape
            or L.shape != (E, n, n) or rotation.shape != (E, D, D) or scale.shape != (E,)
            or source_centroid.shape != (E, D) or target_centroid.shape != (E, D)
            or traj.shape != (Q, D) or delta.shape != (Q, D)):
        raise ValueError(f"transport_apply_rbf: shapes X {tuple(X.shape)}, n <= {MAX_N}, "
                         f"D in {DIMS}, do not fit")
    if not hyperparameters_fit(amplitude, lengthscale, noise, E, D, device):
        raise ValueError("transport_apply_rbf: hyperparameters of shapes it does not take")
    traj_out = torch.empty(E, Q, D, dtype=torch.float32, device=device)
    delta_out = torch.empty_like(traj_out)
    std = torch.empty(E, Q, dtype=torch.float32, device=device)
    dvar = torch.empty_like(std)
    min_abs_det = torch.empty(E, dtype=torch.float32, device=device)
    if E == 0 or Q == 0:
        return traj_out, std, delta_out, dvar, min_abs_det.fill_(float("inf"))
    X, alpha, rotation, source_centroid, target_centroid = (
        _rows(t) for t in (X, alpha, rotation, source_centroid, target_centroid))
    traj, delta = traj.contiguous(), delta.contiguous()
    amp_keep, amp_ptr, amp_es, amp = _scalar_arg(amplitude, E)
    noise_keep, noise_ptr, noise_es, nz = _scalar_arg(noise, E)
    ls_keep, ls_ptr, ls_es, ls_ds, ls_vals = _lengthscale_arg(lengthscale, E, D)
    args = _Args(
        X.data_ptr(), X.stride(0), alpha.data_ptr(), alpha.stride(0),
        L.data_ptr(), *L.stride(),
        rotation.data_ptr(), rotation.stride(0), scale.data_ptr(), scale.stride(0),
        source_centroid.data_ptr(), source_centroid.stride(0),
        target_centroid.data_ptr(), target_centroid.stride(0),
        traj.data_ptr(), delta.data_ptr(),
        amp_ptr, amp_es, amp, ls_ptr, ls_es, ls_ds, (_F * 3)(*ls_vals), noise_ptr, noise_es, nz,
        traj_out.data_ptr(), std.data_ptr(), delta_out.data_ptr(), dvar.data_ptr(),
        min_abs_det.data_ptr(), E, n, Q, D,
    )
    with torch.cuda.device(device):
        err = _entry()(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transport_apply kernel launch failed: CUDA error {err}")
    transport_apply_rbf.launches += 1
    return traj_out, std, delta_out, dvar, min_abs_det


transport_apply_rbf.launches = 0
