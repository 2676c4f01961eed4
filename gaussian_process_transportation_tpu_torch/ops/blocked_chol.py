"""Blocked Cholesky on a hand-written panel kernel: the large-N exact GP.

Port of ``gaussian_process_transportation_tpu/ops/blocked_chol.py``.  A
symmetric positive-definite K (N, N) is held as lower-triangle column
panels, ``panels[k]`` (Np − k·B, B), Np = N rounded up to the block B.
Each panel's (B, B) diagonal block is factored by ``factor_panel``, which
returns L_kk **and** L_kk⁻¹ — the CUDA kernel ``csrc/factor_panel.cu`` for
a CUDA tensor, the plain twin ``factor_panel_plain`` for a CPU one.  With
the inverses in hand everything else is a matrix product:

* the history correction of panel k, one (Np−kB, kB)·(kB, B) product;
* the sub-diagonal part of panel k (a triangular solve), one product
  against L_kk⁻ᵀ;
* forward and backward substitution, one product per panel and sweep.

The products run at ``precision`` (``ops.linalg``'s mapping, JAX's
argument; "highest" by default, as in JAX): "highest" is ``torch.matmul`` in
full float32 (TF32 stays off, see the package ``__init__``), "high" three
bfloat16 passes on a hi/lo split and "default" one, for float32 CUDA
tensors.  A factor is split into its bfloat16 parts once, panel by panel as
each becomes final, and so is each L_kk⁻¹: the history products read the
parts and never split them again.  Residuals are always taken at
"highest", as in JAX.  The kernels take float32; the twins (hence CPU runs)
keep the dtype they are given, and there every precision is that dtype's
product, as the JAX package's CPU backend ignores its ``precision``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
from torch import Tensor

from . import _cuda
from . import pallas_gram as pg
from .linalg import Split, check_precision, matmul_at, operand, reduced, split_once
from .pallas_gram import STATIONARY_FAMILIES, stationary_from_sqdist

__all__ = [
    "BlockedCholesky", "STATIONARY_FAMILIES", "blocked_cholesky", "cholesky_panels",
    "factor_panel", "factor_panel_plain", "gram_cholesky_solve", "panel_offsets", "panel_views",
    "rbf_gram_panels", "refine_steps", "stationary_from_sqdist", "stationary_gram_panels", "stationary_gram_panels_into",
    "stationary_gram_panels_plain", "symmetric_matvec_panels",
]

SUB_BLOCK = 128  # factor_panel's sub-block edge; a panel is a multiple of it


def factor_panel_plain(A: Tensor) -> Tuple[Tensor, Tensor]:
    """(L, L⁻¹) of one SPD block by ``torch.linalg``; any dtype.  A block
    that is not positive definite gives NaN, as the kernel's square root
    does, not an exception (a fit's trial step may leave the definite
    region; its value then reads as non-finite)."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where(info != 0, torch.full_like(L, float("nan")), L)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _cuda.library("factor_panel").factor_panel_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def factor_panel(A: Tensor) -> Tuple[Tensor, Tensor]:
    """(L, L⁻¹) of one (B, B) SPD block, B a multiple of 128.

    A CUDA tensor goes to the panel kernels of ``csrc/factor_panel.cu``
    (float32 only): a short sequence of launches on the current stream
    (15 at B = 512), counted as one in ``factor_panel.launches``; both
    outputs are exactly lower-triangular.  A CPU tensor goes to
    :func:`factor_panel_plain`."""
    if A.dim() != 2 or A.shape[0] != A.shape[1] or A.shape[0] % SUB_BLOCK or not A.shape[0]:
        raise ValueError(f"factor_panel takes a (B, B) block, B a positive multiple of "
                         f"{SUB_BLOCK}, got {tuple(A.shape)}")
    if A.device.type != "cuda":
        return factor_panel_plain(A)
    if A.dtype != torch.float32:
        raise TypeError(f"factor_panel takes float32 on the card, got {A.dtype}")
    A = A.contiguous()
    B = A.shape[0]
    L = torch.empty_like(A)
    Linv = torch.empty_like(A)
    scratch = torch.empty(B * B // 4, dtype=A.dtype, device=A.device)  # the doubling's T
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _entry()(A.data_ptr(), L.data_ptr(), Linv.data_ptr(), scratch.data_ptr(), B,
                       stream)
    if err != 0:
        raise RuntimeError(f"factor_panel kernel launch failed: CUDA error {err}")
    factor_panel.launches += 1
    return L, Linv


factor_panel.launches = 0


class BlockedCholesky:
    """Lower Cholesky factor as column panels plus diagonal-block inverses.

    ``panels[k]`` is the (Np − k·B, B) slice of L below and including the
    k-th diagonal block; ``linvs`` (P, B, B) holds L_kk⁻¹.  ``n`` is the
    logical dimension: rows past it factor a padding block and are dropped
    by the solves."""

    def __init__(self, panels: Sequence[Tensor], linvs: Tensor, n: int, splits=None):
        self.panels = tuple(panels)
        self.linvs = linvs
        self.n = n
        # precision -> (the panels' and the L_kk⁻¹'s product operands)
        self._operands = dict(splits or {})

    def operands(self, precision: str):
        """(panels, L_kk⁻¹) as they enter products at ``precision``: the
        float32 tensors, or their :class:`~.linalg.Split` parts, split once
        (by :func:`cholesky_panels` as it went, or at the first
        reduced-precision solve) and kept."""
        return split_once(self._operands, precision, self.panels, self.linvs)

    @property
    def block(self) -> int:
        return self.panels[0].shape[1]

    @property
    def padded_n(self) -> int:
        return self.panels[0].shape[0]

    def dense(self) -> Tensor:
        """The dense (n, n) lower factor (tests and small N only)."""
        Np, B = self.padded_n, self.block
        p0 = self.panels[0]
        L = torch.zeros(Np, Np, dtype=p0.dtype, device=p0.device)
        for k, p in enumerate(self.panels):
            L[k * B:, k * B:(k + 1) * B] = p
        return L[: self.n, : self.n]

    def logdet(self) -> Tensor:
        """log det K = 2 Σ log diag(L), padding excluded."""
        B = self.block
        diag = torch.cat([torch.diagonal(p[:B]) for p in self.panels])[: self.n]
        return 2.0 * torch.log(diag).sum()

    def _pad_rhs(self, b: Tensor) -> Tuple[Tensor, bool]:
        squeeze = b.dim() == 1
        if squeeze:
            b = b[:, None]
        pad = self.padded_n - b.shape[0]
        if pad:
            b = torch.cat([b, b.new_zeros(pad, b.shape[1])], dim=0)
        return b.to(self.linvs.dtype), squeeze

    def _forward(self, b: Tensor, precision: str) -> List[Tensor]:
        """y = L⁻¹ b, right-looking: one shrinking product per panel."""
        B = self.block
        panels, linvs = self.operands(precision)
        ys = []
        rest = b
        for k, p in enumerate(panels):
            yk = matmul_at(linvs[k], rest[:B], precision)
            ys.append(yk)
            if p.shape[0] > B:
                rest = rest[B:] - matmul_at(p[B:], yk, precision)
        return ys

    def solve(self, b: Tensor, precision: str = "highest") -> Tensor:
        """(L Lᵀ)⁻¹ b by blocked substitution, 2P products at ``precision``."""
        B = self.block
        b, squeeze = self._pad_rhs(b)
        ys = self._forward(b, precision)
        panels, linvs = self.operands(precision)
        below = b.new_zeros(0, b.shape[1])
        for j in reversed(range(len(panels))):
            s = ys[j]
            if below.shape[0]:
                s = s - matmul_at(panels[j][B:].T, below, precision)
            below = torch.cat([matmul_at(linvs[j].T, s, precision), below], dim=0)
        x = below[: self.n]
        return x[:, 0] if squeeze else x

    def solve_lower(self, b: Tensor, precision: str = "highest") -> Tensor:
        """L⁻¹ b (forward substitution only) at ``precision``."""
        b, squeeze = self._pad_rhs(b)
        y = torch.cat(self._forward(b, precision), dim=0)[: self.n]
        return y[:, 0] if squeeze else y

    def refined_solve(self, panels: Sequence[Tensor], Y: Tensor, steps: int,
                      precision: str = "highest") -> Tensor:
        """α = K⁻¹Y for Y (n, p), K the Gram whose lower ``panels`` this
        factor factors, with up to ``steps`` steps of iterative refinement
        α ← α + K⁻¹(Y − Kα): the solves at ``precision``, the residual from
        the panels always at "highest" (as JAX's).  A column keeps a step
        only where it lowers that column's residual norm: once κ·ε of the
        dtype passes about 1 the steps diverge, each one multiplying the
        residual (a float32 Gram at N = 20,000 with noise 8.4e-5 on an
        H100: 6.6e-5, then 1.6e-3 and 4.7e-2), and the solve keeps its best
        iterate.  Where every step lowers the residual, α is the plain
        refinement's, bit for bit."""
        alpha = self.solve(Y, precision)
        if not steps:
            return alpha
        resid = Y - symmetric_matvec_panels(panels, alpha, self.n)
        for _ in range(steps):
            step = alpha + self.solve(resid, precision)
            step_resid = Y - symmetric_matvec_panels(panels, step, self.n)
            keep = (torch.linalg.vector_norm(step_resid, dim=0)
                    < torch.linalg.vector_norm(resid, dim=0))
            alpha = torch.where(keep, step, alpha)
            resid = torch.where(keep, step_resid, resid)
        return alpha


def _split_panels(K: Tensor, B: int, n: int, diag_pad: float = 1.0) -> List[Tensor]:
    """Lower column panels of K padded to a multiple of B; the padding is
    ``diag_pad`` times the identity, so it never couples to real rows."""
    Np = -(-n // B) * B
    pad = Np - n
    if pad:
        Kp = K.new_zeros(Np, Np)
        Kp[:n, :n] = K
        idx = torch.arange(n, Np, device=K.device)
        Kp[idx, idx] = diag_pad
        K = Kp
    return [K[k * B:, k * B:(k + 1) * B] for k in range(Np // B)]


def cholesky_panels(panels: Sequence[Tensor], n: int, precision: str = "highest",
                    group=None) -> BlockedCholesky:
    """Left-looking blocked Cholesky over lower-triangle column panels.

    Each panel applies its whole history correction as one product against
    the dense lower factor accumulated so far, then ``factor_panel`` on its
    diagonal block and one product against L_kk⁻ᵀ for the rest; the
    products at ``precision``, the panel factor always in full float32 (as
    JAX's).  Where the products are reduced, each panel is split into its
    bfloat16 parts once, as it becomes final, into dense part buffers that
    the later history products read (the three passes as three
    float32-output products of the parts, not one of K-tripled copies:
    those copies of the whole history would cost as many bytes as the
    parts themselves), and each L_kk⁻¹ likewise; the factor keeps them for
    its solves.

    ``group`` is accepted and ignored: the JAX package's grouped form
    (``cholesky_panels_grouped``) exists only to bound the TPU compiler's
    per-call-site cost, which a CUDA kernel launched from Python does not
    have."""
    B = panels[0].shape[1]
    P = len(panels)
    Np = panels[0].shape[0]
    p0 = panels[0]
    # One preallocated (Np, Np) accumulator of the finished panels, written
    # in place slice by slice; the history products read from it (or from
    # its parts), and the returned panels are views of it.
    Ldense = torch.zeros(Np, Np, dtype=p0.dtype, device=p0.device)
    parts = Split.zeros((Np, Np), precision, p0.device) if reduced(p0, precision) else None
    L_panels: List[Tensor] = []
    linvs: List[Tensor] = []
    linv_ops = []
    for k in range(P):
        pk = panels[k]
        if k:
            hist = (parts if parts is not None else Ldense)[k * B:, : k * B]
            pk = pk - matmul_at(hist, hist[:B].T, precision)
        Lkk, Linv = factor_panel(pk[:B])
        linvs.append(Linv)
        linv_ops.append(operand(Linv, precision))
        Lk = Ldense[k * B:, k * B:(k + 1) * B]
        Lk[:B] = Lkk
        if pk.shape[0] > B:
            # the triangular solve as a product
            Lk[B:] = matmul_at(pk[B:], linv_ops[-1].T, precision)
        if parts is not None:
            parts.put((slice(k * B, None), slice(k * B, (k + 1) * B)), Lk)
        L_panels.append(Lk)
    splits = None
    if parts is not None:
        splits = {precision: ([parts[k * B:, k * B:(k + 1) * B] for k in range(P)], linv_ops)}
    return BlockedCholesky(L_panels, torch.stack(linvs), n, splits)


def blocked_cholesky(K: Tensor, block: int = 512, precision: str = "highest") -> BlockedCholesky:
    """Blocked Cholesky of a dense SPD K (N, N); N need not divide block;
    the products at ``precision``."""
    n = K.shape[0]
    B = min(block, -(-n // SUB_BLOCK) * SUB_BLOCK)
    return cholesky_panels(_split_panels(K, B, n), n, precision)


def panel_offsets(n: int, block: int) -> List[int]:
    """Where the lower column panels of an n-point Gram padded to P = ⌈n/B⌉
    blocks lie in one buffer: panel k, (Np − k·B, B) row-major, at float
    B²·(k·P − k(k−1)/2); the last entry (k = P) is the buffer's size,
    B²·P(P+1)/2."""
    if block < 1:
        raise ValueError(f"panels need a block of at least 1, got {block}")
    P = -(-n // block)
    return [block * block * (k * P - k * (k - 1) // 2) for k in range(P + 1)]


def panel_views(buf: Tensor, n: int, block: int) -> List[Tensor]:
    """The panels of an n-point Gram in blocks of ``block`` as views of the
    flat buffer ``buf`` (:func:`panel_offsets`)."""
    offsets = panel_offsets(n, block)
    Np = (len(offsets) - 1) * block
    return [buf[a:b].view(Np - k * block, block)
            for k, (a, b) in enumerate(zip(offsets[:-1], offsets[1:]))]


def _fill_panels_plain(buf: Tensor, X: Tensor, lengthscale, amplitude, noise, block: int,
                       family: str) -> List[Tensor]:
    n, D = X.shape
    panels = panel_views(buf, n, block)
    Np = len(panels) * block
    ls = torch.as_tensor(lengthscale, dtype=X.dtype, device=X.device).reshape(-1)
    Z = X / ls
    if Np > n:
        far = 1e6 * (1.0 + torch.arange(Np - n, dtype=X.dtype, device=X.device))[:, None]
        Z = torch.cat([Z, far.expand(Np - n, D)], 0)
    for k, p in enumerate(panels):
        p.copy_(pg.stationary_gram_plain(Z[k * block:], Z[k * block:(k + 1) * block], 1.0,
                                         amplitude, family))
        p[:block].diagonal().add_(noise)
    return panels


def stationary_gram_panels_plain(X: Tensor, lengthscale, amplitude, noise, block: int,
                                 family: str = "rbf") -> Tuple[List[Tensor], int]:
    """:func:`stationary_gram_panels` in plain torch ops, in X's dtype and on
    its device: the points divided by ℓ and padded with the far
    pseudo-points, each panel from ``stationary_gram_plain``, the noise
    added to its diagonal block; the panels are views of one buffer laid
    out as the kernel's (:func:`panel_offsets`)."""
    buf = X.new_empty(panel_offsets(X.shape[0], block)[-1])
    return _fill_panels_plain(buf, X, lengthscale, amplitude, noise, block, family), X.shape[0]


def stationary_gram_panels(X: Tensor, lengthscale, amplitude, noise, block: int,
                           family: str = "rbf") -> Tuple[List[Tensor], int]:
    """Lower-triangle column panels of amp·k((x−x′)/ℓ) + noise·I, n padded
    to P = ⌈n/B⌉ blocks of B = ``block``; the full (N, N) Gram is never
    formed.  Returns (panels, n): panel k is (Np − k·B, B), and all are views
    of one buffer (:func:`panel_offsets`).

    Padding rows are far-away pseudo-points, so their kernel values with
    every other point underflow to 0 and their diagonal is amp + noise: a
    positive block that the factorization consumes and the solves drop.

    For a CUDA X one launch of the panel kernel writes every panel
    (:func:`stationary_gram_panels_into`); for a CPU X the plain twin."""
    buf = X.new_empty(panel_offsets(X.shape[0], block)[-1])
    return stationary_gram_panels_into(buf, X, lengthscale, amplitude, noise, block,
                                       family), X.shape[0]


def rbf_gram_panels(X: Tensor, lengthscale, amplitude, noise,
                    block: int) -> Tuple[List[Tensor], int]:
    """The JAX package's older name: :func:`stationary_gram_panels` of the
    RBF."""
    return stationary_gram_panels(X, lengthscale, amplitude, noise, block, "rbf")


def stationary_gram_panels_into(buf: Tensor, X: Tensor, lengthscale, amplitude, noise,
                                block: int, family: str = "rbf") -> List[Tensor]:
    """Writes the panels of :func:`stationary_gram_panels` into the flat
    buffer ``buf`` of ``panel_offsets(n, block)[-1]`` entries; returns the
    panels, views of it.

    A CUDA ``buf`` takes one launch of ``stationary_gram_panels_f32``
    (``csrc/stationary_gram.cu``; float32 only), counted in
    ``stationary_gram_panels.launches``: the kernel divides the points by ℓ,
    makes the padding points from their row index, and adds the noise where
    the global row equals the column; ℓ, the amplitude and the noise are
    read from device memory where they are CUDA tensors, so nothing waits
    on the card.  A CPU ``buf`` is filled by the plain twin."""
    if buf.device.type != "cuda":
        return _fill_panels_plain(buf, X, lengthscale, amplitude, noise, block, family)
    device = pg._check_points("stationary_gram_panels", X, X)
    n, D = X.shape
    size = panel_offsets(n, block)[-1]
    if buf.device != device or buf.dtype != torch.float32 or buf.shape != (size,) or \
            not buf.is_contiguous():
        raise ValueError(f"stationary_gram_panels: needs a contiguous float32 buffer of {size} "
                         f"entries on {device}, got {tuple(buf.shape)} {buf.dtype} on "
                         f"{buf.device}")
    if -(-n // block) * block >= 2**31:
        raise ValueError(f"stationary_gram_panels: n={n} padded to blocks of {block} passes 2^31")
    if n:
        Xc = X.contiguous()
        ls_keep, ls_args = pg.gram_lengthscale_args(lengthscale, D, device)
        amp_keep, amp_args = pg.gram_scalar_args(amplitude, device, "amplitude")
        noise_keep, noise_args = pg.gram_scalar_args(noise, device, "noise")
        pg._call("stationary_gram_panels_f32", device, Xc.data_ptr(), n, D, block, *ls_args,
                 *amp_args, *noise_args, pg._family_code(family), buf.data_ptr(),
                 pg.GRAM_TILE_ROWS, pg.GRAM_TILE_COLS)
        stationary_gram_panels.launches += 1
    return panel_views(buf, n, block)


stationary_gram_panels.launches = 0


def symmetric_matvec_panels(panels: Sequence[Tensor], x: Tensor, n: int,
                            precision: str = "highest") -> Tensor:
    """K @ x from the lower-triangle column panels of a symmetric K: panel
    k adds P_k·x_k to rows k·B… and its mirrored upper part P_k[B:]ᵀ·x_below
    to the rows of block k; the products at ``precision`` (each panel split
    at each call where they are reduced)."""
    B = panels[0].shape[1]
    Np = panels[0].shape[0]
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    pad = Np - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros(pad, x.shape[1])], dim=0)
    x = x.to(panels[0].dtype)
    y = torch.zeros_like(x)
    for k, p in enumerate(panels):
        p = operand(p, precision)
        y[k * B:] += matmul_at(p, x[k * B:(k + 1) * B], precision)
        if p.shape[0] > B:
            y[k * B:(k + 1) * B] += matmul_at(p[B:].T, x[(k + 1) * B:], precision)
    y = y[:n]
    return y[:, 0] if squeeze else y


# From this many panels the refinement takes two steps (the JAX rule: the
# error of the left-looking history product grows with its depth).
_TWO_REFINE_MIN_PANELS = 32


def refine_steps(n_panels: int, refine_iters=None) -> int:
    """Steps of iterative refinement of α: ``refine_iters``, or for None 1
    below 32 panels and 2 from 32 up (the JAX package's rule for its solve;
    its blocked LML takes 1 at any size)."""
    if refine_iters is not None:
        return refine_iters
    return 1 if n_panels < _TWO_REFINE_MIN_PANELS else 2


def gram_cholesky_solve(X: Tensor, Y: Tensor, lengthscale, amplitude, noise,
                        block: int = 512, precision: str = "highest", refine_iters=None,
                        family: str = "rbf", group=None) -> Tuple[Tensor, BlockedCholesky]:
    """K = amp·k(X, X) + noise·I → blocked Cholesky → α = K⁻¹Y, the factor's
    and the solves' products at ``precision``, followed by up to
    ``refine_iters`` guarded steps of iterative refinement
    (:meth:`BlockedCholesky.refined_solve`: the residual at "highest"; None:
    1 below 32 panels, 2 from 32 up).  ``group`` is ignored, as in
    :func:`cholesky_panels`.  The Gram's panels take no precision: they are
    formed elementwise, with no product (JAX's accept one and leave it
    unused)."""
    check_precision(precision)
    panels, n = stationary_gram_panels(X, lengthscale, amplitude, noise, block, family)
    chol = cholesky_panels(panels, n, precision)
    squeeze = Y.dim() == 1
    Y2 = (Y[:, None] if squeeze else Y).to(panels[0].dtype)
    alpha = chol.refined_solve(panels, Y2, refine_steps(len(panels), refine_iters), precision)
    return (alpha[:, 0] if squeeze else alpha), chol
