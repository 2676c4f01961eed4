"""Quaternion algebra on torch tensors (scalar-first [w, x, y, z]).

Port of ``gaussian_process_transportation_tpu/ops/quaternion.py``.  The
closest unit quaternion to a 3×3 matrix that need not be orthogonal (the
Bar-Itzhack method) is what the orientation transport needs, since
J_Φ = J_γ + J_Ψ J_γ is generally not a rotation.  Everything broadcasts
over leading dimensions.
"""
from __future__ import annotations

import torch
from torch import Tensor


def multiply(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product, scalar-first; broadcasts over leading dims."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def conjugate(q: Tensor) -> Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _profile_matrix(m: Tensor) -> Tensor:
    """Bar-Itzhack symmetric 4×4 profile matrix of 3×3 matrices:
    (..., 3, 3) → (..., 4, 4) in the (x, y, z, w) basis, scaled by 1/3."""
    r = lambda i, j: m[..., i, j]
    rows = [
        [r(0, 0) - r(1, 1) - r(2, 2), r(0, 1) + r(1, 0),
         r(0, 2) + r(2, 0), r(2, 1) - r(1, 2)],
        [r(0, 1) + r(1, 0), r(1, 1) - r(0, 0) - r(2, 2),
         r(1, 2) + r(2, 1), r(0, 2) - r(2, 0)],
        [r(0, 2) + r(2, 0), r(1, 2) + r(2, 1),
         r(2, 2) - r(0, 0) - r(1, 1), r(1, 0) - r(0, 1)],
        [r(2, 1) - r(1, 2), r(0, 2) - r(2, 0),
         r(1, 0) - r(0, 1), r(0, 0) + r(1, 1) + r(2, 2)],
    ]
    return torch.stack([torch.stack(row, -1) for row in rows], -2) / 3.0


def _xyzw_to_wxyz_positive(v: Tensor) -> Tensor:
    """(x, y, z, w) vectors → scalar-first quaternions with w ≥ 0."""
    q = torch.stack([v[..., 3], v[..., 0], v[..., 1], v[..., 2]], dim=-1)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)


def from_rotation_matrix(R: Tensor) -> Tensor:
    """Closest unit quaternion(s) to R (..., 3, 3): the unit eigenvector of
    the profile matrix's largest eigenvalue, through ``torch.linalg.eigh``."""
    _, vecs = torch.linalg.eigh(_profile_matrix(R))
    return _xyzw_to_wxyz_positive(vecs[..., :, -1])  # eigh sorts ascending


def from_rotation_matrix_iter(R: Tensor, squarings: int = 12) -> Tensor:
    """Closest unit quaternion(s) to R (..., 3, 3) by repeated squaring of
    the shifted profile matrix B = K + 2I, with no eigensolver.

    K's spectrum lies in [−1, 1] with λmax → 1 for near-rotations, so B's
    dominant eigenvalue is strictly the largest in magnitude; 12 squarings
    (renormalised against overflow) raise B to the power 4096, and the
    largest column of the result is the dominant eigenvector."""
    B = _profile_matrix(R) + 2.0 * torch.eye(4, dtype=R.dtype, device=R.device)
    for _ in range(squarings):
        B = B @ B
        B = B / B.abs().amax(dim=(-2, -1), keepdim=True)
    norms = torch.linalg.vector_norm(B, dim=-2)  # (..., 4) column norms
    pick = norms.argmax(dim=-1)  # (...)
    v = torch.take_along_dim(B, pick[..., None, None], dim=-1)[..., 0]
    return _xyzw_to_wxyz_positive(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))


def to_rotation_matrix(q: Tensor) -> Tensor:
    """Unit quaternion(s) → rotation matrix/matrices."""
    w, x, y, z = normalize(q).unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(row, -1) for row in rows], -2)
