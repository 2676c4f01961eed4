"""Stationary-kernel Gram tiles and the fused dense-grid GP predicts.

Port of ``gaussian_process_transportation_tpu/ops/pallas_gram.py``.  Three
wrappers launch the CUDA kernels of ``csrc/stationary_gram.cu`` (which
replace the TPU Pallas kernels) for CUDA tensors and take their plain
PyTorch twins, defined beside them, for CPU tensors:

* ``stationary_gram``: amp·φ(‖(x−z)/ℓ‖²), (N, M) — the Gram tile.  The
  same source's panel entry, whose wrapper is
  ``ops/blocked_chol.py::stationary_gram_panels``, writes every lower panel
  of a padded Gram with its noise in one launch, on the same tile body;
* ``fused_gp_predict_mean``: k(X*, X)·α without the (Nq, N) Gram in device
  memory (the original project's 100×100-grid vector fields);
* ``fused_gp_predict_mean_var``: the mean, and var = prior −
  diag(k K⁻¹ kᵀ) clamped at 0, from a cached dense K⁻¹.

φ is one of ``STATIONARY_FAMILIES`` on lengthscale-scaled points, with d²
summed from per-dimension differences.  The kernels take float32 only and
count their launches in ``<wrapper>.launches``; the twins take any dtype.

The JAX gates on these kernels (N ≤ 4096 for the mean-and-variance kernel,
a smaller ``tile_k`` past N = 2560) were TPU VMEM limits.  The CUDA kernels'
shared memory does not grow with N or Nq (at most about 56 KB a block), so
they have no such gate; their limits are D ≤ ``MAX_D`` and P ≤ ``MAX_P``,
the sizes of the kernels' coordinate and output arrays.
"""
from __future__ import annotations

import ctypes
import functools
import math
from numbers import Real
from typing import Tuple

import torch
from torch import Tensor

from . import _cuda

STATIONARY_FAMILIES = ("rbf", "matern12", "matern32", "matern52")
MAX_D = 16
MAX_P = 8
# K⁻¹ columns one block of the mean-and-variance kernel closes: the wrapper
# sizes the kernel's scratch of partial variances by it and hands it to the
# kernel, which refuses a width other than its own.
MEAN_VAR_TILE_B = 128
# Training points one block of the mean kernel sums (a chunk): the wrapper
# sizes the kernel's scratch of partial means by it, and the kernel refuses
# another width.
MEAN_CHUNK = 128
# The output tile one block of the Gram kernel writes (rows, columns): the
# wrappers hand it to the kernel, which refuses another tile, and the CPU
# tests' twin of the kernel's tile map reads it.
GRAM_TILE_ROWS, GRAM_TILE_COLS = 64, 128

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def stationary_from_sqdist(d2: Tensor, family: str) -> Tensor:
    """k(d²) for a unit-amplitude stationary family on ℓ-scaled inputs."""
    if family == "rbf":
        return torch.exp(-0.5 * d2)
    d = torch.sqrt(d2 + 1e-36)
    if family == "matern12":
        return torch.exp(-d)
    if family == "matern32":
        s = _SQRT3 * d
        return (1.0 + s) * torch.exp(-s)
    if family == "matern52":
        s = _SQRT5 * d
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise ValueError(f"unknown stationary family {family!r}")


def _scaled(X: Tensor, lengthscale) -> Tensor:
    """X / ℓ; a Python number divides directly (no host-to-device copy)."""
    if isinstance(lengthscale, Real):
        return X if lengthscale == 1 else X / lengthscale
    return X / torch.as_tensor(lengthscale, dtype=X.dtype, device=X.device).reshape(-1)


def _sqdist(A: Tensor, B: Tensor) -> Tensor:
    """(N, M) squared distances summed from per-dimension differences."""
    d2 = torch.zeros(A.shape[0], B.shape[0], dtype=A.dtype, device=A.device)
    for d in range(A.shape[1]):
        diff = A[:, d, None] - B[None, :, d]
        d2 = d2 + diff * diff
    return d2


# -- plain twins ------------------------------------------------------------


def stationary_gram_plain(X: Tensor, Z: Tensor, lengthscale, amplitude,
                          family: str = "rbf") -> Tensor:
    """Dense amp·φ(‖(x−z)/ℓ‖²), (N, M)."""
    return amplitude * stationary_from_sqdist(
        _sqdist(_scaled(X, lengthscale), _scaled(Z, lengthscale)), family)


def fused_gp_predict_mean_plain(Xq: Tensor, X: Tensor, alpha: Tensor, lengthscale, amplitude,
                                family: str = "rbf") -> Tensor:
    """k(X*, X) α through the dense Gram."""
    return stationary_gram_plain(Xq, X, lengthscale, amplitude, family) @ alpha


def fused_gp_predict_mean_var_plain(Xq: Tensor, X: Tensor, alpha: Tensor, K_inv: Tensor,
                                    lengthscale, amplitude, prior_diag,
                                    family: str = "rbf") -> Tuple[Tensor, Tensor]:
    """(k α, max(prior − diag(k K⁻¹ kᵀ), 0)) through the dense Gram."""
    k = stationary_gram_plain(Xq, X, lengthscale, amplitude, family)
    var = torch.clamp(prior_diag - ((k @ K_inv) * k).sum(-1), min=0.0)
    return k @ alpha, var


# -- kernel wrappers --------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_HOST_FLOATS = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = {
    "stationary_gram_f32": [_P, _P, _I, _I, _I, _P, _I, _HOST_FLOATS, _P, _F, _I, _P,
                            ctypes.c_longlong, _I, _I, _P],
    "stationary_gram_panels_f32": [_P, _I, _I, _I, _P, _I, _HOST_FLOATS, _P, _F, _P, _F, _I, _P,
                                   _I, _I, _P],
    "predict_mean_f32": [_P, _P, _P, _I, _I, _I, _I, _P, _F, _I, _P, _P, _I, _P],
    "predict_mean_var_f32": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P, _F, _P, _F,
                             _I, _P, _P, _P, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _entry(entry: str):
    fn = getattr(_cuda.library("stationary_gram"), entry)
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return fn


def _call(entry: str, device: torch.device, *args) -> None:
    fn = _entry(entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def _family_code(family: str) -> int:
    if family not in STATIONARY_FAMILIES:
        raise ValueError(f"unknown stationary family {family!r}")
    return STATIONARY_FAMILIES.index(family)


def _check_points(name: str, A: Tensor, B: Tensor, *rest: Tensor) -> torch.device:
    """Checks the kernels' inputs: point sets A (·, D) and B (·, D), then
    other 2-D operands, all float32 on one device; returns the device."""
    device = A.device
    for t in (A, B, *rest):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 on the card, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name}: expected 2-D tensors, got shape {tuple(t.shape)}")
    if not 1 <= A.shape[1] <= MAX_D or B.shape[1] != A.shape[1]:
        raise ValueError(f"{name}: points need the same 1 <= D <= {MAX_D}")
    return device


def _kernel_points(X: Tensor, lengthscale) -> Tensor:
    return _scaled(X, lengthscale).to(torch.float32).contiguous()


def gram_lengthscale_args(lengthscale, D: int, device: torch.device):
    """The Gram kernels' lengthscale arguments (device pointer, stride, host
    values) and the object that must outlive the launch: a CUDA tensor's
    float32 values in place (one value for every dimension: stride 0), else
    the D values as host floats.  No host read of card memory."""
    if isinstance(lengthscale, Tensor) and lengthscale.device.type == "cuda":
        if lengthscale.device != device:
            raise ValueError(f"lengthscale on {lengthscale.device}, points on {device}")
        ls = lengthscale.reshape(-1).to(torch.float32).contiguous()
        if ls.numel() not in (1, D):
            raise ValueError(f"lengthscale has {ls.numel()} values for D={D}")
        return ls, (ls.data_ptr(), int(ls.numel() > 1), None)
    vals = torch.as_tensor(lengthscale, dtype=torch.float64).reshape(-1).tolist()
    if len(vals) not in (1, D):
        raise ValueError(f"lengthscale has {len(vals)} values for D={D}")
    host = (ctypes.c_float * D)(*(vals * D if len(vals) == 1 else vals))
    return host, (None, 0, host)


def gram_scalar_args(value, device: torch.device, name: str):
    """An amplitude's or noise level's kernel arguments (device pointer,
    value) and the tensor that must outlive the launch: a one-element CUDA
    tensor is read by the kernel from device memory (no host sync), a
    number or a CPU tensor is passed by value."""
    if isinstance(value, Tensor) and value.device.type == "cuda":
        if value.device != device or value.numel() != 1:
            raise ValueError(f"{name} must be one value on {device}, got {tuple(value.shape)} "
                             f"on {value.device}")
        t = value.reshape(()).to(torch.float32)
        return t, (t.data_ptr(), 0.0)
    return None, (None, float(value))


def stationary_gram(X: Tensor, Z: Tensor, lengthscale, amplitude,
                    family: str = "rbf") -> Tensor:
    """amp·φ(‖(x−z)/ℓ‖²) of X (N, D) and Z (M, D): (N, M).

    For CUDA tensors one launch of the Gram kernel (float32 only, see
    :func:`stationary_gram_into`); for CPU tensors the plain twin."""
    if X.device.type != "cuda":
        return stationary_gram_plain(X, Z, lengthscale, amplitude, family)
    out = torch.empty(X.shape[0], Z.shape[0], dtype=torch.float32, device=X.device)
    return stationary_gram_into(out, X, Z, lengthscale, amplitude, family)


def rbf_gram(X: Tensor, Z: Tensor, lengthscale, amplitude) -> Tensor:
    """The JAX package's older name: :func:`stationary_gram` of the RBF."""
    return stationary_gram(X, Z, lengthscale, amplitude, "rbf")


def stationary_gram_into(out: Tensor, X: Tensor, Z: Tensor, lengthscale, amplitude,
                         family: str = "rbf") -> Tensor:
    """:func:`stationary_gram` written into ``out`` (N, M), which may have
    any row stride but unit column stride; returns ``out``.

    For a CUDA ``out`` one launch of the ``stationary_gram`` kernel (float32
    only), counted in ``stationary_gram.launches``: it divides the points
    by ℓ itself, and reads ℓ and the amplitude from device memory where they
    are CUDA tensors.  Rows whose start is 16-byte aligned get 16-byte
    stores; other strides and a ragged last column group are written a
    float at a time.  For a CPU ``out`` the twin, copied in."""
    if out.device.type != "cuda":
        return out.copy_(stationary_gram_plain(X, Z, lengthscale, amplitude, family))
    device = _check_points("stationary_gram", X, Z, out)
    (N, D), M = X.shape, Z.shape[0]
    if out.shape != (N, M) or (M > 1 and out.stride(1) != 1):
        raise ValueError(f"stationary_gram_into: out must be ({N}, {M}) with unit column "
                         f"stride, got {tuple(out.shape)} strides {out.stride()}")
    if N and M:
        Xc, Zc = X.contiguous(), Z.contiguous()
        ls_keep, ls_args = gram_lengthscale_args(lengthscale, D, device)
        amp_keep, amp_args = gram_scalar_args(amplitude, device, "amplitude")
        _call("stationary_gram_f32", device, Xc.data_ptr(), Zc.data_ptr(), N, M, D, *ls_args,
              *amp_args, _family_code(family), out.data_ptr(), out.stride(0), GRAM_TILE_ROWS,
              GRAM_TILE_COLS)
        stationary_gram.launches += 1
    return out


stationary_gram.launches = 0


def fused_gp_predict_mean(Xq: Tensor, X: Tensor, alpha: Tensor, lengthscale, amplitude,
                          family: str = "rbf") -> Tensor:
    """Posterior mean k(X*, X) α (Nq, P) of a C·stationary(+White) GP.

    For CUDA tensors one call of the fused kernel, which never writes the
    (Nq, N) Gram (its two CUDA launches: the partial sums of each chunk of
    ``MEAN_CHUNK`` training points, then their fixed-order sum; float32
    only, P ≤ MAX_P).  A one-element CUDA tensor amplitude is read by the
    kernel where it lies, so the call reads nothing back to the host.  For
    CPU tensors the twin."""
    if Xq.device.type != "cuda":
        return fused_gp_predict_mean_plain(Xq, X, alpha, lengthscale, amplitude, family)
    device = _check_points("fused_gp_predict_mean", Xq, X, alpha)
    (Nq, D), (N, P) = Xq.shape, alpha.shape
    if X.shape[0] != N or not 1 <= P <= MAX_P:
        raise ValueError(f"fused_gp_predict_mean: alpha must be (N, P), P <= {MAX_P}, "
                         f"got {tuple(alpha.shape)} for N={X.shape[0]}")
    mean = torch.empty(Nq, P, dtype=torch.float32, device=device)
    if Nq:
        partial = torch.empty(-(-N // MEAN_CHUNK), Nq, P, dtype=torch.float32, device=device)
        Xqs, Xs = _kernel_points(Xq, lengthscale), _kernel_points(X, lengthscale)
        a = alpha.contiguous()
        amp_keep, amp_args = gram_scalar_args(amplitude, device, "amplitude")
        _call("predict_mean_f32", device, Xqs.data_ptr(), Xs.data_ptr(), a.data_ptr(), Nq, N, D, P,
              *amp_args, _family_code(family), mean.data_ptr(), partial.data_ptr(), MEAN_CHUNK)
        fused_gp_predict_mean.launches += 1
    return mean


fused_gp_predict_mean.launches = 0


def fused_gp_predict_mean_var(Xq: Tensor, X: Tensor, alpha: Tensor, K_inv: Tensor, lengthscale,
                              amplitude, prior_diag,
                              family: str = "rbf") -> Tuple[Tensor, Tensor]:
    """(mean (Nq, P), var (Nq,)) of a C·stationary(+White) GP from its
    cached dense K⁻¹ (N, N); var = prior − diag(k K⁻¹ kᵀ), clamped at 0.

    For CUDA tensors one call of the fused kernel (its two CUDA launches:
    the tiles, then the fixed-order sum of their partial variances; float32
    only).  K⁻¹ is read in place when its columns have unit stride, at any
    row stride and alignment; another layout is copied first.  A one-element
    CUDA tensor amplitude or prior is read by the kernels where it lies, so
    the call reads nothing back to the host.  For CPU tensors the twin."""
    if Xq.device.type != "cuda":
        return fused_gp_predict_mean_var_plain(Xq, X, alpha, K_inv, lengthscale, amplitude,
                                               prior_diag, family)
    device = _check_points("fused_gp_predict_mean_var", Xq, X, alpha, K_inv)
    (Nq, D), (N, P) = Xq.shape, alpha.shape
    if X.shape[0] != N or not 1 <= P <= MAX_P or K_inv.shape != (N, N) or N == 0:
        raise ValueError("fused_gp_predict_mean_var: needs alpha (N, P) with P <= "
                         f"{MAX_P} and K_inv (N, N), N >= 1")
    mean = torch.empty(Nq, P, dtype=torch.float32, device=device)
    var = torch.empty(Nq, dtype=torch.float32, device=device)
    if Nq:
        partial = torch.empty(-(-N // MEAN_VAR_TILE_B), Nq, dtype=torch.float32, device=device)
        Xqs, Xs = _kernel_points(Xq, lengthscale), _kernel_points(X, lengthscale)
        a = alpha.contiguous()
        Ki = K_inv if K_inv.stride(1) == 1 else K_inv.contiguous()
        amp_keep, amp_args = gram_scalar_args(amplitude, device, "amplitude")
        prior_keep, prior_args = gram_scalar_args(prior_diag, device, "prior_diag")
        _call("predict_mean_var_f32", device, Xqs.data_ptr(), Xs.data_ptr(), a.data_ptr(),
              Ki.data_ptr(), Ki.stride(0), Nq, N, D, P, *amp_args, *prior_args,
              _family_code(family), mean.data_ptr(), var.data_ptr(), partial.data_ptr(),
              MEAN_VAR_TILE_B)
        fused_gp_predict_mean_var.launches += 1
    return mean, var


fused_gp_predict_mean_var.launches = 0
