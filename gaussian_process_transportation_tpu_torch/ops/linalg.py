"""Dense SPD linear-algebra helpers on ``torch.linalg``.

Port of ``gaussian_process_transportation_tpu/ops/linalg.py``; the JAX
package leaves these to XLA's own routines, so the port leaves them to
``torch.linalg``.  All take leading batch dimensions.
"""
from __future__ import annotations

import torch
from torch import Tensor


def add_diagonal(K: Tensor, value) -> Tensor:
    """K + value · I (out of place)."""
    n = K.shape[-1]
    return K + value * torch.eye(n, dtype=K.dtype, device=K.device)


def tri_solve_lower(L: Tensor, B: Tensor) -> Tensor:
    """Solve L x = B with L lower triangular."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def cho_solve_lower(L: Tensor, B: Tensor) -> Tensor:
    """Solve (L Lᵀ) x = B given the lower Cholesky factor L."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def log_det_from_chol(L: Tensor) -> Tensor:
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
