"""Ensemble-last (E-last) linear algebra for large batches of tiny SPD
matrices.

Port of ``gaussian_process_transportation_tpu/ops/batched_linalg.py``.
Matrices are stacked as (n, n, E): entry (i, j) of member e sits at
``(i·n + j)·E + e``.

* ``cholesky_elast``, ``inv_lower_elast``, ``spd_inverse_elast`` and
  ``cho_solve_elast`` are the plain PyTorch twins, unrolled over the static
  n exactly as the JAX functions are.
* ``spd_inverse_elast_fused`` launches the CUDA kernel
  (``csrc/spd_inverse_elast.cu``) that replaces the TPU Pallas kernel
  ``_spd_inv_kernel``; it takes CUDA tensors only.
* ``spd_inverse_elast_auto`` sends a CUDA tensor to the kernel and a CPU
  tensor to the twin.
* ``small_cholesky`` and ``small_cho_solve`` factor and solve small SPD
  matrices over any leading batch axes (torch batches them as they are;
  the JAX package's ``custom_vmap`` rules, which re-lay a vmapped batch
  ensemble-last for the TPU, have nothing to do here).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch import Tensor

from . import _cuda


def cholesky_elast(K: Tensor) -> Tensor:
    """Lower Cholesky of K (n, n, E), left-looking, unrolled over n."""
    n = K.shape[0]
    cols = []  # cols[j]: (n, E) = column j of L, zeros above the diagonal
    for j in range(n):
        v = K[:, j]
        for k in range(j):
            v = v - cols[k][j][None, :] * cols[k]
        col = v * torch.rsqrt(v[j])[None, :]
        if j > 0:
            col = torch.cat([torch.zeros_like(col[:j]), col[j:]], dim=0)
        cols.append(col)
    return torch.stack(cols, dim=1)


def inv_lower_elast(L: Tensor) -> Tensor:
    """Inverse of lower-triangular L (n, n, E) by forward substitution
    (column j of L⁻¹ solves L x = e_j)."""
    n = L.shape[0]
    inv_diag = 1.0 / torch.diagonal(L, dim1=0, dim2=1).T  # (n, E)
    zero = torch.zeros_like(L[0, 0])
    cols = []
    for j in range(n):
        rows = [zero] * j
        rows.append(inv_diag[j])
        for i in range(j + 1, n):
            s = zero
            for k in range(j, i):
                s = s + L[i, k] * rows[k]
            rows.append(-s * inv_diag[i])
        cols.append(torch.stack(rows, dim=0))
    return torch.stack(cols, dim=1)


def spd_inverse_elast(K: Tensor) -> Tuple[Tensor, Tensor]:
    """(L, K⁻¹) of SPD K (n, n, E) with K⁻¹ = L⁻ᵀ L⁻¹, all E-last."""
    L = cholesky_elast(K)
    Li = inv_lower_elast(L)
    return L, torch.einsum("kie,kje->ije", Li, Li)


def cho_solve_elast(L: Tensor, B: Tensor) -> Tensor:
    """Solve (L Lᵀ) X = B for L (n, n, E), B (n, p, E), by forward then
    backward substitution, elementwise over E."""
    n = L.shape[0]
    inv_diag = 1.0 / torch.diagonal(L, dim1=0, dim2=1).T  # (n, E)
    z = []
    for i in range(n):
        s = B[i]
        for k in range(i):
            s = s - L[i, k][None, :] * z[k]
        z.append(s * inv_diag[i][None, :])
    x = [None] * n
    for i in reversed(range(n)):
        s = z[i]
        for k in range(i + 1, n):
            s = s - L[k, i][None, :] * x[k]
        x[i] = s * inv_diag[i][None, :]
    return torch.stack(x, dim=0)


def small_cholesky(K: Tensor) -> Tensor:
    """Lower Cholesky of small SPD matrices K (..., n, n); a matrix that is
    not positive definite gives NaN, as XLA's Cholesky does."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)


def small_cho_solve(L: Tensor, B: Tensor) -> Tensor:
    """(L Lᵀ)⁻¹ B for lower factors L (..., n, n) and B (..., n, p), by a
    forward then a backward triangular solve; batch axes broadcast."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


# The wrapper picks one of the kernel's instances from n and the dtype
# alone, before the launch (csrc/spd_inverse_elast.cu): float32 up to
# n = 32 takes the warp instance of the fewest register rows that hold n
# (two rows a lane, so a warp takes 32 / (rows / 2) members at once);
# float64, and float32 past 32, take the thread instance (one thread a
# member, whose register use does not grow with n).  Past FUSED_MAX_N the
# batched transport takes its per-member route (transport/gpt.py).
FUSED_MAX_N = 64
WARP_ROWS = (8, 16, 20, 24, 32)
SPD_INVERSE_INSTANCES = tuple(f"warp{r}" for r in WARP_ROWS) + ("thread",)

_THREAD_ENTRY = {torch.float32: "spd_inverse_elast_f32", torch.float64: "spd_inverse_elast_f64"}
_INT, _PTR, _LL = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = {"spd_inverse_elast_f32": [_PTR, _PTR, _PTR, _INT, _LL, _PTR],
             "spd_inverse_elast_f64": [_PTR, _PTR, _PTR, _INT, _LL, _PTR],
             "spd_inverse_elast_warp_f32": [_PTR, _PTR, _PTR, _INT, _LL, _INT, _PTR]}


def spd_inverse_instance(n: int, dtype: torch.dtype) -> str:
    """The kernel instance that ``spd_inverse_elast_fused`` launches for
    (n, n, E) matrices of ``dtype``: one of ``SPD_INVERSE_INSTANCES``."""
    if dtype == torch.float32:
        for rows in WARP_ROWS:
            if n <= rows:
                return f"warp{rows}"
    return "thread"


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_cuda.library("spd_inverse_elast"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(K: Tensor, instance: str) -> Tuple[Tensor, Tensor]:
    """One launch of ``instance`` on a checked K; counts nothing."""
    n, _, E = K.shape
    L = torch.empty_like(K)
    K_inv = torch.empty_like(K)
    if E == 0:
        return L, K_inv
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        ptrs = (K.data_ptr(), L.data_ptr(), K_inv.data_ptr(), n, E)
        if instance == "thread":
            err = _entry(_THREAD_ENTRY[K.dtype])(*ptrs, stream)
        else:
            err = _entry("spd_inverse_elast_warp_f32")(*ptrs, int(instance[4:]), stream)
    if err != 0:
        raise RuntimeError(f"spd_inverse_elast kernel ({instance}) launch failed: CUDA error {err}")
    return L, K_inv


def spd_inverse_elast_fused(K: Tensor) -> Tuple[Tensor, Tensor]:
    """(L, K⁻¹) of SPD K (n, n, E) on the card, in one CUDA kernel launch.

    K must be a contiguous float32 or float64 CUDA tensor with n ≤ 64.
    Same math as :func:`spd_inverse_elast` (a member whose factor meets a
    pivot that is not positive comes back NaN).  Each launch adds one to
    ``spd_inverse_elast_fused.launches`` and to its instance's entry of
    ``.instance_launches`` (:func:`spd_inverse_instance`)."""
    if K.device.type != "cuda":
        raise ValueError(f"spd_inverse_elast_fused needs a CUDA tensor, got {K.device}")
    if K.dtype not in _THREAD_ENTRY:
        raise TypeError(f"spd_inverse_elast_fused takes float32 or float64, got {K.dtype}")
    if K.dim() != 3 or K.shape[0] != K.shape[1]:
        raise ValueError(f"expected K of shape (n, n, E), got {tuple(K.shape)}")
    if not K.is_contiguous():
        raise ValueError("spd_inverse_elast_fused needs a contiguous K")
    if not 1 <= K.shape[0] <= FUSED_MAX_N:
        raise ValueError(f"spd_inverse_elast_fused takes 1 <= n <= {FUSED_MAX_N}, "
                         f"got {K.shape[0]}")
    instance = spd_inverse_instance(K.shape[0], K.dtype)
    out = _launch(K, instance)
    if K.shape[2]:
        spd_inverse_elast_fused.launches += 1
        spd_inverse_elast_fused.instance_launches[instance] += 1
    return out


spd_inverse_elast_fused.launches = 0
spd_inverse_elast_fused.instance_launches = dict.fromkeys(SPD_INVERSE_INSTANCES, 0)


def spd_inverse_elast_auto(K: Tensor) -> Tuple[Tensor, Tensor]:
    """(L, K⁻¹) of SPD K (n, n, E): the CUDA kernel for a CUDA tensor, the
    plain twin for a CPU tensor."""
    if K.device.type == "cuda":
        return spd_inverse_elast_fused(K)
    return spd_inverse_elast(K)
