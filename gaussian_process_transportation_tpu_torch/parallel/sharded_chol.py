"""Multi-device blocked Cholesky: column panels block-cyclic over a mesh axis.

Port of ``gaussian_process_transportation_tpu/parallel/sharded_chol.py``.
The large-N exact GP's Gram is built, factored and solved distributed over
the D ranks of one mesh axis: no rank ever holds the whole (N, N), and the
solution comes back replicated.

* **Layout** (JAX's): N is padded to Np, a multiple of B·D, with far-away
  pseudo-points; lower column panel k (rows k·B … Np of columns k·B …
  (k+1)·B) belongs to rank k mod D as its slot k // D, stored with its
  diagonal block at row 0 and its exact trapezoid height Np − k·B.
* **Factor step k** (right-looking): the owner's up-to-date panel goes to
  every rank by one broadcast; every rank factors its (B, B) diagonal
  block with ``ops.blocked_chol.factor_panel`` (kernel #4 on the card:
  L_kk and L_kk⁻¹) and forms ``below = G[B:] @ L_kk⁻ᵀ``; each rank then
  updates only its own later slots, ``work[j] −= below[r:] @ below[r:r+B]ᵀ``
  at the slot's row offset r.  Redundant panel work on every rank spares
  a second broadcast, as in JAX.
* **Solve**: blocked forward and backward substitution with the retained
  L_kk⁻¹; per step the owner computes its contribution and broadcasts it,
  so the right-hand side stays replicated and needs no gather.
* **log det**: each rank's sum of log-diagonals, summed by ``all_reduce``.

JAX's ``fori_loop``, ``lax.switch`` and ``lax.cond`` (static shapes for
one compiled program) become plain loops over the real heights.  The
matrix products run at ``precision`` (``ops.linalg``'s mapping, JAX's
argument, "highest" by default): full float32 on the card (TF32 is off,
see the package ``__init__``), or bfloat16 passes on parts split once
each (a step's ``below`` for every trailing update, a slot and its
L_kk⁻¹ for every solve); CPU tensors keep their dtype, and there every
precision is that dtype's product.
``mesh`` None runs the same algorithm in this process alone.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import Tensor

from ..ops.blocked_chol import factor_panel
from ..ops.linalg import Split, check_precision, matmul_at, operand, split_once
from ..ops.blocked_lml import _pad_z
from ..ops.pallas_gram import stationary_gram_plain
from .mesh import MeshAxis, axis_of

__all__ = ["ShardedBlockedCholesky", "sharded_gram_cholesky_solve"]


def _plan(n: int, block: int, D: int) -> Tuple[int, int]:
    """(Np, P): n padded to a multiple of block·D, and the panel count."""
    group = block * D
    Np = -(-n // group) * group
    return Np, Np // block


def _own(ax: MeshAxis, P: int) -> range:
    """The global panels this rank owns, slot j being the j-th."""
    return range(ax.index, P, ax.size)


def _local_gram_panels(Z: Tensor, ax: MeshAxis, block: int, P: int, amp, noise,
                       family: str) -> List[Tensor]:
    """This rank's Gram panels of the ℓ-scaled padded points Z (Np, D),
    each (Np − k·B, B) with its diagonal block at row 0 and the noise on
    that block's diagonal."""
    panels = []
    for k in _own(ax, P):
        p = stationary_gram_plain(Z[k * block:], Z[k * block:(k + 1) * block], 1.0, amp,
                                  family)
        p[:block].diagonal().add_(noise)
        panels.append(p)
    return panels


def _factor(work: List[Tensor], ax: MeshAxis, block: int, P: int, Np: int, precision: str):
    """Right-looking factorization of the block-cyclic panels, in place:
    ``work`` becomes this rank's slots of L; returns them and their L_kk⁻¹.
    The products at ``precision``, ``below`` split once a step."""
    D, d, B = ax.size, ax.index, block
    linvs = []
    for k in range(P):
        owner, jk = k % D, k // D
        G = work[jk] if owner == d else work[0].new_empty(Np - k * B, B)
        ax.broadcast(G, owner)
        Lkk, Linv = factor_panel(G[:B])
        below = matmul_at(G[B:], Linv.T, precision)  # the triangular solve as a product
        below_op = operand(below, precision)
        if owner == d:
            G[:B].copy_(Lkk)
            G[B:].copy_(below)
            linvs.append(Linv.contiguous())  # the plain twin's is column-major
        for j in range(len(work)):
            r = (j * D + d - k) * B  # the slot's first row in panel k
            if r > 0:
                Lb = below_op[r - B:]
                if isinstance(Lb, Split):
                    work[j].sub_(matmul_at(Lb, Lb[:B].T, precision))
                else:
                    work[j].addmm_(Lb, Lb[:B].T, alpha=-1.0)
    return work, linvs


class ShardedBlockedCholesky:
    """One rank's part of a distributed lower Cholesky factor.

    ``panels[j]`` is global panel k = j·D + index (D the axis size, index
    this rank's place on it), (Np − k·B, B) with its diagonal block at row
    0; ``linvs[j]`` its diagonal block's inverse.  ``n`` is the logical
    size, ``block`` the panel width.  :meth:`solve` and :meth:`logdet` are
    collective: every rank of the axis calls them and gets the replicated
    result."""

    def __init__(self, panels: Sequence[Tensor], linvs: Sequence[Tensor], n: int, block: int,
                 mesh, axis: str):
        self.panels = list(panels)
        self.linvs = list(linvs)
        self.n = n
        self.block = block
        self.mesh = mesh
        self.axis = axis
        self._ax = axis_of(mesh, axis)
        self._operands = {}  # precision -> the slots' and L_kk⁻¹'s Splits

    def operands(self, precision: str):
        """(slots, L_kk⁻¹ list) as they enter products at ``precision``: the
        tensors, or their parts, split once at the first reduced solve."""
        return split_once(self._operands, precision, self.panels, self.linvs)

    @property
    def n_shards(self) -> int:
        return self._ax.size

    @property
    def padded_n(self) -> int:
        return _plan(self.n, self.block, self.n_shards)[0]

    def logdet(self) -> Tensor:
        """log det K = 2 Σ log diag(L) over the real (row < n) entries."""
        B, ax = self.block, self._ax
        p0 = self.panels[0]
        total = p0.new_zeros(())
        rows = torch.arange(B, device=p0.device)
        for j, p in enumerate(self.panels):
            k = j * ax.size + ax.index
            logs = torch.log(torch.clamp(torch.diagonal(p[:B]), min=1e-30))
            total = total + torch.where(k * B + rows < self.n, logs, torch.zeros_like(logs)).sum()
        return 2.0 * ax.all_reduce(total)

    def _forward(self, b: Tensor, precision: str) -> Tensor:
        """y = L⁻¹ b for a replicated (Np, nrhs) b; one broadcast a panel."""
        ax, B = self._ax, self.block
        panels, linvs = self.operands(precision)
        Np, P = b.shape[0], b.shape[0] // B
        rest, y = b.clone(), torch.empty_like(b)
        for k in range(P):
            owner, jk = k % ax.size, k // ax.size
            if owner == ax.index:
                yk = matmul_at(linvs[jk], rest[k * B:(k + 1) * B], precision)
                contrib = torch.cat([yk, matmul_at(panels[jk][B:], yk, precision)])
            else:
                contrib = b.new_empty(Np - k * B, b.shape[1])
            ax.broadcast(contrib, owner)
            y[k * B:(k + 1) * B] = contrib[:B]
            rest[(k + 1) * B:] -= contrib[B:]
        return y

    def _backward(self, y: Tensor, precision: str) -> Tensor:
        """x = L⁻ᵀ y, replicated; one broadcast a panel."""
        ax, B = self._ax, self.block
        panels, linvs = self.operands(precision)
        P = y.shape[0] // B
        x = torch.zeros_like(y)
        for k in reversed(range(P)):
            owner, jk = k % ax.size, k // ax.size
            if owner == ax.index:
                s = y[k * B:(k + 1) * B] - matmul_at(panels[jk][B:].T, x[(k + 1) * B:],
                                                     precision)
                xk = matmul_at(linvs[jk].T, s, precision)
            else:
                xk = y.new_empty(B, y.shape[1])
            ax.broadcast(xk, owner)
            x[k * B:(k + 1) * B] = xk
        return x

    def solve_padded(self, b: Tensor, precision: str = "highest") -> Tensor:
        """(L Lᵀ)⁻¹ b for a replicated (Np, nrhs) b, (Np, nrhs), the products
        at ``precision``."""
        return self._backward(self._forward(b, precision), precision)

    def solve(self, b: Tensor, precision: str = "highest") -> Tensor:
        """(L Lᵀ)⁻¹ b for b (n,) or (n, nrhs): distributed blocked
        substitution at ``precision``, replicated result."""
        squeeze = b.dim() == 1
        b2 = (b[:, None] if squeeze else b).to(self.panels[0].dtype)
        x = self.solve_padded(_pad_rows(b2, self.padded_n), precision)[: self.n]
        return x[:, 0] if squeeze else x


def _pad_rows(x: Tensor, rows: int) -> Tensor:
    """Zero rows appended up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


def _factor_gram(X: Tensor, ls: Tensor, amp, noise, mesh, axis: str, block: int,
                 family: str, precision: str) -> Tuple[ShardedBlockedCholesky, Tensor]:
    """The distributed factor of amp·k(X, X) + noise·I; returns it and the
    ℓ-scaled padded points."""
    ax = axis_of(mesh, axis)
    n = X.shape[0]
    Np, P = _plan(n, block, ax.size)
    Z = _pad_z(X, ls, Np)
    work = _local_gram_panels(Z, ax, block, P, amp, noise, family)
    L, linvs = _factor(work, ax, block, P, Np, check_precision(precision))
    return ShardedBlockedCholesky(L, linvs, n, block, mesh, axis), Z


def sharded_gram_cholesky_solve(
    X: Tensor,
    Y: Tensor,
    lengthscale,
    amplitude,
    noise,
    mesh,
    axis: str = "data",
    block: int = 512,
    family: str = "rbf",
    precision: str = "highest",
) -> Tuple[Tensor, ShardedBlockedCholesky]:
    """K = amp·k(X, X) + noise·I → distributed blocked Cholesky → α = K⁻¹Y.

    X (n, D) and Y (n,) or (n, p) are replicated: every rank of ``axis``
    passes the same.  Each rank builds only its own Gram panels (about
    Np²/(2D) entries), the factorization runs block-cyclically over the
    axis and α comes back on every rank.  The factor is returned for
    further solves and log det.  The factor's and the solve's products run
    at ``precision``, with no refinement, as JAX's.  On the card X is
    float32 (kernel #4 takes it); CPU tensors keep their dtype.  ``block``
    is a multiple of 128."""
    ls = torch.as_tensor(lengthscale, dtype=X.dtype, device=X.device).reshape(-1)
    chol, _ = _factor_gram(X, ls, amplitude, noise, mesh, axis, block, family, precision)
    return chol.solve(Y, precision), chol
