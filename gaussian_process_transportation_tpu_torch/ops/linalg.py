"""Dense SPD linear-algebra helpers on ``torch.linalg``, and the package's
one mapping of matrix-product precisions.

Port of ``gaussian_process_transportation_tpu/ops/linalg.py``; the JAX
package leaves these to XLA's own routines, so the port leaves them to
``torch.linalg``.  All take leading batch dimensions.

Precision names (the JAX package's ``jax.lax.Precision`` of its TPU matrix
passes) map onto the card per call, never through process-wide flags
(``torch.backends.cuda.matmul.*`` and the float32 matmul precision stay as
the package ``__init__`` sets them):

* ``"highest"``: float32;
* ``"high"``: three bfloat16 passes on a hi/lo split of each operand
  (hi·hi + hi·lo + lo·hi), products in float32, about 16 bits of each
  operand, as the TPU's HIGH;
* ``"default"``: one bfloat16 pass, the product kept in float32.

They apply to float32 CUDA tensors.  On the CPU, and in float64, every
product is taken in the operands' dtype, as the JAX package's CPU backend
ignores the precision.
"""
from __future__ import annotations

import math
from typing import Union

import torch
from torch import Tensor

PRECISIONS = ("default", "high", "highest")


def add_diagonal(K: Tensor, value) -> Tensor:
    """K + value · I (out of place)."""
    n = K.shape[-1]
    return K + value * torch.eye(n, dtype=K.dtype, device=K.device)


def cholesky_with_jitter(K: Tensor, jitter: float = 0.0) -> Tensor:
    """Lower Cholesky factor of K (+ jitter·I).  A K that is not positive
    definite gives NaN (as XLA's factor does, where the optimisation path
    reads NaN as a likelihood of −∞), not an exception."""
    if jitter:
        K = add_diagonal(K, jitter)
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, math.nan), L)


def tri_solve_lower(L: Tensor, B: Tensor) -> Tensor:
    """Solve L x = B with L lower triangular."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def cho_solve_lower(L: Tensor, B: Tensor) -> Tensor:
    """Solve (L Lᵀ) x = B given the lower Cholesky factor L."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def log_det_from_chol(L: Tensor) -> Tensor:
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision


def reduced(a: Tensor, precision: str) -> bool:
    """Whether products of ``a`` at ``precision`` take bfloat16 passes: a
    float32 CUDA tensor at "default" or "high"."""
    return (check_precision(precision) != "highest" and a.device.type == "cuda"
            and a.dtype == torch.float32)


class Split:
    """A float32 matrix as its bfloat16 parts: (hi,) for "default", (hi, lo)
    for "high", lo = bf16(a − hi).  Slicing and ``.T`` act on every part
    (views), so a factor split once, when it is final, serves every later
    product without being split again."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    @classmethod
    def of(cls, a: Tensor, precision: str) -> "Split":
        hi = a.to(torch.bfloat16)
        if check_precision(precision) == "default":
            return cls((hi,))
        return cls((hi, (a - hi.to(a.dtype)).to(torch.bfloat16)))

    @classmethod
    def zeros(cls, shape, precision: str, device) -> "Split":
        """Zero parts of ``shape``, to be written block by block (:meth:`put`)."""
        n = 1 if check_precision(precision) == "default" else 2
        return cls(torch.zeros(shape, dtype=torch.bfloat16, device=device) for _ in range(n))

    @property
    def precision(self) -> str:
        return "default" if len(self.parts) == 1 else "high"

    def put(self, index, a: Tensor) -> None:
        """Writes the parts of the float32 block ``a`` at ``index``."""
        for dst, src in zip(self.parts, Split.of(a, self.precision).parts):
            dst[index] = src

    @property
    def T(self) -> "Split":
        return Split(p.T for p in self.parts)

    @property
    def shape(self):
        return self.parts[0].shape

    def __getitem__(self, index) -> "Split":
        return Split(p[index] for p in self.parts)


def _mm_f32(a: Tensor, b: Tensor) -> Tensor:
    """a·b of bfloat16 operands with the product in float32: one tensor-core
    pass on the card; on the CPU (where the split's arithmetic is held to
    float64 in tests) the operands widened to float32, where the product of
    two bfloat16 values is exact, as on the card."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def split_product(a: Split, b: Split) -> Tensor:
    """The float32 product of two split operands: hi·hi, plus hi·lo + lo·hi
    where both carry their lo parts (the "high" passes; lo·lo is dropped)."""
    out = _mm_f32(a.parts[0], b.parts[0])
    if len(a.parts) > 1 and len(b.parts) > 1:
        out = out + _mm_f32(a.parts[0], b.parts[1]) + _mm_f32(a.parts[1], b.parts[0])
    return out


Operand = Union[Tensor, Split]


def operand(a: Tensor, precision: str) -> Operand:
    """``a`` as it enters products at ``precision``: its :class:`Split`
    where they are reduced (:func:`reduced`), else ``a`` itself."""
    return Split.of(a, precision) if reduced(a, precision) else a


def matmul_at(a: Operand, b: Operand, precision: str = "highest") -> Tensor:
    """a·b of 2-D operands at ``precision``.  A :class:`Split` operand (split
    once by its owner) is used as it is and a tensor beside it is split
    here; two tensors are split where the products are reduced, and
    otherwise give ``a @ b`` in their dtype, bit for bit."""
    if isinstance(a, Split) or isinstance(b, Split) or reduced(a, precision):
        a = a if isinstance(a, Split) else Split.of(a, precision)
        b = b if isinstance(b, Split) else Split.of(b, precision)
        return split_product(a, b)
    return a @ b


def split_once(cache: dict, precision: str, *groups):
    """Each group of tensors (a factor's panels, its diagonal blocks'
    inverses) as it enters products at ``precision``: the tensors
    themselves, or their :class:`Split` parts, made at the first reduced
    call and kept in ``cache``."""
    if not reduced(groups[0][0], precision):
        return groups
    if precision not in cache:
        cache[precision] = tuple([Split.of(t, precision) for t in g] for g in groups)
    return cache[precision]
