"""Stationary covariance kernels on torch tensors.

Port of ``gaussian_process_transportation_tpu/kernels/stationary.py``.  A
kernel is a small frozen dataclass; its hyperparameters are Python floats
or tensors.  Every method evaluates in the dtype and on the device of its
input points (tensor hyperparameters are moved there), and accepts leading
batch dimensions on the points, so one call builds E Grams at once.

Shapes, for points x (..., N, D) and Z (..., M, D):

* ``k(X, Z)`` → (..., N, M); ``k(X)`` is the self-Gram (White adds its
  noise only there);
* ``diag(X)`` → (..., N);
* ``dx(x, Z)`` → (..., N, M, D) = ∂k(x_i, Z_j)/∂x_i;
* ``dxT(x, Z)`` → (..., D, M, N), the same values query-last;
* ``dxdz_diag(x)`` → (..., N, D) = ∂²k(a, b)/∂a_d∂b_d at a = b = x_i;
* ``pairwise(a, b)`` → () = k(a, b) of two single points (D,), White 0.

Each leaf has closed-form derivatives.  The base class builds ``dx``,
``dxT`` and ``dxdz_diag`` on ``pairwise`` with ``torch.func`` (forward
mode over a row of Z, reverse over forward for the mixed second
derivative), for points (N, D) and (M, D) and hyperparameters shared by
all points.  ``Product.dxdz_diag`` is the product rule on its factors'
closed forms, exact for every stationary factor; the JAX package takes
the autodiff form for two non-constant factors, which a Matérn factor
makes wrong at a = b.

Hyperparameters with a leading ensemble axis give one kernel for E
members: a scalar hyperparameter (amplitude, noise) of shape (E,) and a
lengthscale of shape (E, D) or (E, 1) are per member, and the kernel then
evaluates points (E, …, N, D) as E separate kernels would (points (N, D)
without the E axis are shared by the members).  A 0-d scalar and a 1-D
lengthscale are shared by every member.

The hyperparameter vector follows the JAX package: ``theta`` is the log
of the leaves in declaration order (Sum/Product: ``k1`` then ``k2``), an
ARD lengthscale contributing one entry per dimension; ``with_theta``
rebuilds the tree from such a vector, or from (E, T) of them for a
per-member kernel; ``theta_bounds`` is (T, 2) in log space from each
leaf's ``bounds``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

Param = Union[float, Tensor]

DEFAULT_BOUNDS = (1e-5, 1e5)


def _ls(value: Param, like: Tensor) -> Tensor:
    """A lengthscale in the dtype and on the device of points ``like``
    ((E, …, N, D), or (N, D) shared by every member), shaped to divide
    them: (D,) when shared, (E, 1, …, 1, D) when per member."""
    ls = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    if ls.dim() >= 2:
        lead = ls.shape[:-1]
        return ls.reshape(lead + (1,) * max(like.dim() - ls.dim(), 1) + ls.shape[-1:])
    return ls.reshape(-1)


def _ls_dim(value: Param, like: Tensor) -> Tensor:
    """The same lengthscale shaped against a derivative (E, …, D, M, N) of
    points ``like``: (D, 1, 1) when shared, (E, 1, …, D, 1, 1) when per
    member."""
    ls = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    if ls.dim() >= 2:
        lead = ls.shape[:-1]
        pad = max(like.dim() - 2 - len(lead), 0)
        return ls.reshape(lead + (1,) * pad + ls.shape[-1:] + (1, 1))
    return ls.reshape(-1)[:, None, None]


def _scalar(value: Param, like: Tensor, rank: int, point_axes: int) -> Param:
    """A scalar hyperparameter ready to multiply a result of ``rank`` axes,
    the last ``point_axes`` of them over points: a float stays a float, a
    tensor moves to ``like``'s dtype and device, and a per-member (E,) one
    is shaped (E, 1, …, 1) to lead the result."""
    if isinstance(value, Tensor):
        value = value.to(dtype=like.dtype, device=like.device)
        if value.dim():
            return value.reshape(value.shape + (1,) * max(rank - value.dim(), point_axes))
    return value


def _point_param(value: Param, a: Tensor) -> Tensor:
    """A hyperparameter as a tensor in the dtype and on the device of the
    point ``a`` (``pairwise``)."""
    return torch.as_tensor(value, dtype=a.dtype, device=a.device)


def _flat_log(value: Param, dtype, device) -> Tensor:
    """log of a leaf as a flat vector."""
    return torch.log(torch.as_tensor(value, dtype=dtype, device=device).reshape(-1))


def _cross_shape(X: Tensor, Z: Tensor) -> tuple:
    batch = torch.broadcast_shapes(X.shape[:-2], Z.shape[:-2])
    return tuple(batch) + (X.shape[-2], Z.shape[-2])


def _sqdist(X: Tensor, Z: Tensor) -> Tensor:
    """Pairwise squared distances (..., N, M).

    For D ≤ 8 it sums per-dimension differences, which is exact: the
    ‖x‖²+‖z‖²−2x·z expansion (what ``torch.cdist`` uses) cancels badly in
    float32 at workspace-scale coordinates and can cost the Gram its
    positive-definiteness.  Larger D takes the expansion, clamped at 0."""
    D = X.shape[-1]
    if D <= 8:
        d2 = None
        for d in range(D):
            diff = X[..., :, None, d] - Z[..., None, :, d]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        return d2
    xx = (X * X).sum(-1)[..., :, None]
    zz = (Z * Z).sum(-1)[..., None, :]
    xz = torch.matmul(X, Z.transpose(-1, -2))
    return torch.clamp(xx + zz - 2.0 * xz, min=0.0)


class Kernel:
    """Base: ``+``/``*`` composition; subclasses implement the methods."""

    def __add__(self, other):
        return Sum(self, _as_kernel(other))

    def __radd__(self, other):
        return Sum(_as_kernel(other), self)

    def __mul__(self, other):
        return Product(self, _as_kernel(other))

    def __rmul__(self, other):
        return Product(_as_kernel(other), self)

    def __call__(self, X: Tensor, Z: Optional[Tensor] = None) -> Tensor:
        raise NotImplementedError

    def diag(self, X: Tensor) -> Tensor:
        raise NotImplementedError(f"{type(self).__name__}.diag")

    def pairwise(self, a: Tensor, b: Tensor) -> Tensor:
        """k(a, b) of single points a, b (D,) as a 0-d tensor, written with
        explicit differences so that autodiff is exact at a = b;
        cross-covariance semantics (White gives 0)."""
        raise NotImplementedError(f"{type(self).__name__}.pairwise")

    def dx(self, x: Tensor, Z: Tensor) -> Tensor:
        """∂k(x_i, Z_j)/∂x_i, (N, M, D): forward mode through
        :meth:`pairwise`, one Jacobian of a row of Z per query point."""
        from torch.func import jacfwd, vmap

        def row(xi):
            return vmap(lambda zj: self.pairwise(xi, zj))(Z)

        return vmap(jacfwd(row))(x)

    def dxT(self, x: Tensor, Z: Tensor) -> Tensor:
        """:meth:`dx` query-last, (D, M, N)."""
        return self.dx(x, Z).permute(2, 1, 0)

    def dxdz_diag(self, x: Tensor) -> Tensor:
        """diag_d ∂²k(a, b)/∂a_d∂b_d at a = b = x_i, (N, D): forward over
        reverse mode through :meth:`pairwise`; a kernel without a second
        derivative at a = b raises (:meth:`_check_twice_differentiable`)."""
        from torch.func import jacfwd, jacrev, vmap

        self._check_twice_differentiable()

        def at_point(xi):
            return torch.diagonal(jacfwd(jacrev(self.pairwise, argnums=0), argnums=1)(xi, xi))

        return vmap(at_point)(x)

    def _check_twice_differentiable(self) -> None:
        """Raises where k(a, b) has no mixed second derivative at a = b."""

    # ---- the flat log-space hyperparameter vector ------------------------
    def _leaves(self) -> List["Kernel"]:
        """The hyperparameter-carrying nodes in declaration order."""
        return [self]

    def _leaf_value(self) -> Param:
        raise NotImplementedError

    def _with_leaf_value(self, value: Tensor) -> "Kernel":
        raise NotImplementedError

    def _leaf_sizes(self) -> List[int]:
        return [torch.as_tensor(leaf._leaf_value()).numel() for leaf in self._leaves()]

    def _theta_like(self):
        """(dtype, device) of the vector: the first tensor leaf's, else
        float64 on the CPU."""
        for leaf in self._leaves():
            v = leaf._leaf_value()
            if isinstance(v, Tensor):
                return v.dtype, v.device
        return torch.float64, torch.device("cpu")

    @property
    def theta(self) -> Tensor:
        """log of the hyperparameters, (T,)."""
        dtype, device = self._theta_like()
        parts = [_flat_log(leaf._leaf_value(), dtype, device) for leaf in self._leaves()]
        return torch.cat(parts) if parts else torch.zeros(0, dtype=dtype, device=device)

    @property
    def n_theta(self) -> int:
        return sum(self._leaf_sizes())

    @property
    def theta_bounds(self) -> Tensor:
        """(T, 2) log-space bounds, one row per entry of ``theta``."""
        rows = []
        for leaf, size in zip(self._leaves(), self._leaf_sizes()):
            rows.extend([leaf.bounds] * size)
        return torch.log(torch.tensor(rows, dtype=torch.float64).reshape(-1, 2))

    def with_theta(self, theta: Tensor) -> "Kernel":
        """The kernel at exp(theta): theta (T,) gives leaves of the original
        shapes; theta (E, T) gives per-member leaves, scalars (E,) and
        lengthscales (E, size).  Leaves are placed on theta's device, in the
        dtype of a tensor leaf or else theta's."""
        out, used = self._rebuild(theta, 0)
        if used != theta.shape[-1]:
            raise ValueError(f"theta has {theta.shape[-1]} entries, the kernel {used}")
        return out

    def _rebuild(self, theta: Tensor, offset: int):
        old = self._leaf_value()
        shape = tuple(torch.as_tensor(old).shape)
        size = math.prod(shape)
        seg = torch.exp(theta[..., offset:offset + size])
        dtype = old.dtype if isinstance(old, Tensor) else theta.dtype
        if theta.dim() == 1:
            seg = seg.reshape(shape)
        elif not isinstance(self, (RBF, Matern)):
            seg = seg[..., 0]  # a per-member scalar: (E,)
        return self._with_leaf_value(seg.to(dtype)), offset + size


def _as_kernel(x) -> Kernel:
    return x if isinstance(x, Kernel) else Constant(x)


@dataclass(frozen=True)
class Constant(Kernel):
    constant_value: Param = 1.0
    bounds: Tuple[float, float] = DEFAULT_BOUNDS

    def __call__(self, X, Z=None):
        Z = X if Z is None else Z
        shape = _cross_shape(X, Z)
        return X.new_full(shape, 1.0) * _scalar(self.constant_value, X, len(shape), 2)

    def diag(self, X):
        return X.new_full(X.shape[:-1], 1.0) * _scalar(self.constant_value, X, X.dim() - 1, 1)

    def _leaf_value(self):
        return self.constant_value

    def _with_leaf_value(self, value):
        return replace(self, constant_value=value)

    def pairwise(self, a, b):
        return _point_param(self.constant_value, a) * 1.0

    def dx(self, x, Z):
        return x.new_zeros(_cross_shape(x, Z) + (x.shape[-1],))

    def dxT(self, x, Z):
        shape = _cross_shape(Z, x)
        return x.new_zeros(shape[:-2] + (x.shape[-1],) + shape[-2:])

    def dxdz_diag(self, x):
        return torch.zeros_like(x)


@dataclass(frozen=True)
class White(Kernel):
    """k(x, z) = noise_level · 1[x is z]: the self-Gram carries the noise
    diagonal, a cross-covariance k(X, Z) with Z given is zero."""

    noise_level: Param = 1.0
    bounds: Tuple[float, float] = DEFAULT_BOUNDS

    def __call__(self, X, Z=None):
        noise = _scalar(self.noise_level, X, X.dim() if Z is None else len(_cross_shape(X, Z)), 2)
        if Z is None:
            n = X.shape[-2]
            eye = torch.eye(n, dtype=X.dtype, device=X.device)
            return eye.expand(X.shape[:-2] + (n, n)) * noise
        return X.new_zeros(_cross_shape(X, Z)) * noise

    def diag(self, X):
        return X.new_full(X.shape[:-1], 1.0) * _scalar(self.noise_level, X, X.dim() - 1, 1)

    def _leaf_value(self):
        return self.noise_level

    def _with_leaf_value(self, value):
        return replace(self, noise_level=value)

    def pairwise(self, a, b):
        return _point_param(self.noise_level, a) * 0.0

    def dx(self, x, Z):
        return x.new_zeros(_cross_shape(x, Z) + (x.shape[-1],))

    def dxT(self, x, Z):
        shape = _cross_shape(Z, x)
        return x.new_zeros(shape[:-2] + (x.shape[-1],) + shape[-2:])

    def dxdz_diag(self, x):
        return torch.zeros_like(x)


@dataclass(frozen=True)
class RBF(Kernel):
    """Squared exponential with ARD lengthscales."""

    lengthscale: Param = 1.0
    bounds: Tuple[float, float] = DEFAULT_BOUNDS

    def __call__(self, X, Z=None):
        Z = X if Z is None else Z
        ls = _ls(self.lengthscale, X)
        return torch.exp(-0.5 * _sqdist(X / ls, Z / ls))

    def diag(self, X):
        return X.new_ones(X.shape[:-1])

    def dx(self, x, Z):
        # ∂k/∂x_d = −(x_d − z_d)/ℓ_d² · k(x, z)
        k = self(x, Z)
        ls = _ls(self.lengthscale, x)[..., None, :]
        diff = (Z[..., None, :, :] - x[..., :, None, :]) / ls**2
        return diff * k[..., None]

    def dxT(self, x, Z):
        kT = self(Z, x)  # (..., M, N)
        diffT = (Z.transpose(-1, -2)[..., :, :, None]
                 - x.transpose(-1, -2)[..., :, None, :]) / _ls_dim(self.lengthscale, x) ** 2
        return diffT * kT[..., None, :, :]

    def dxdz_diag(self, x):
        return torch.ones_like(x) / _ls(self.lengthscale, x) ** 2

    def pairwise(self, a, b):
        ls = _point_param(self.lengthscale, a).reshape(-1)
        return torch.exp(-0.5 * (((a - b) / ls) ** 2).sum())

    def _leaf_value(self):
        return self.lengthscale

    def _with_leaf_value(self, value):
        return replace(self, lengthscale=value)


def _matern_of_d(d: Tensor, nu: float) -> Tensor:
    if nu == 0.5:
        return torch.exp(-d)
    if nu == 1.5:
        s = math.sqrt(3.0) * d
        return (1.0 + s) * torch.exp(-s)
    if nu == 2.5:
        s = math.sqrt(5.0) * d
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise NotImplementedError(f"Matern nu={nu} not supported")


# Below this d², ``Matern.pairwise`` takes the profile's Taylor series in d²
# (ν = 3⁄2: 1 − 3⁄2·d²; ν = 5⁄2: 1 − 5⁄6·d² + 25⁄24·d⁴), whose autodiff
# derivatives are right at a = b; the terms it drops (√3·d³ and −(√5 d)⁵/45)
# are below 2e-18 there, under float64's rounding of 1.
_MATERN_SERIES_D2 = 1e-12
_MATERN_SERIES = {1.5: (-1.5, 0.0), 2.5: (-5.0 / 6.0, 25.0 / 24.0)}


def _matern_of_d2(d2: Tensor, nu: float) -> Tensor:
    """The Matérn profile as a function of d², twice differentiable at 0 for
    ν = 3⁄2 and 5⁄2: the series below ``_MATERN_SERIES_D2``, the closed form
    above it, evaluated at d² = 1 where the series is taken so that neither
    branch's derivatives are infinite (a NaN would survive the select)."""
    if nu not in _MATERN_SERIES:
        return _matern_of_d(torch.sqrt(d2 + 1e-36), nu)
    c1, c2 = _MATERN_SERIES[nu]
    small = d2 < _MATERN_SERIES_D2
    exact = _matern_of_d(torch.sqrt(torch.where(small, torch.ones_like(d2), d2)), nu)
    return torch.where(small, 1.0 + d2 * (c1 + c2 * d2), exact)


def _matern_dcoeff(d2: Tensor, nu: float) -> Tensor:
    """c(d) with ∂k/∂x = −c · (x − z)/ℓ² (the ν=½ subgradient at d=0)."""
    if nu == math.inf:
        return torch.exp(-0.5 * d2)
    d = torch.sqrt(d2 + 1e-36)
    if nu == 1.5:
        return 3.0 * torch.exp(-math.sqrt(3.0) * d)
    if nu == 2.5:
        s = math.sqrt(5.0) * d
        return (5.0 / 3.0) * (1.0 + s) * torch.exp(-s)
    if nu == 0.5:
        return torch.exp(-d) / torch.clamp(d, min=1e-12)
    raise NotImplementedError(f"Matern nu={nu} not supported")


@dataclass(frozen=True)
class Matern(Kernel):
    """Matérn kernel, ν ∈ {½, 3⁄2, 5⁄2, ∞}, ARD lengthscales."""

    lengthscale: Param = 1.0
    nu: float = 1.5
    bounds: Tuple[float, float] = DEFAULT_BOUNDS

    def __call__(self, X, Z=None):
        Z = X if Z is None else Z
        ls = _ls(self.lengthscale, X)
        d2 = _sqdist(X / ls, Z / ls)
        if self.nu == math.inf:
            return torch.exp(-0.5 * d2)
        return _matern_of_d(torch.sqrt(d2 + 1e-36), self.nu)

    def diag(self, X):
        return X.new_ones(X.shape[:-1])

    def pairwise(self, a, b):
        ls = _point_param(self.lengthscale, a).reshape(-1)
        d2 = (((a - b) / ls) ** 2).sum()
        if self.nu == math.inf:
            return torch.exp(-0.5 * d2)
        return _matern_of_d2(d2, self.nu)

    def dx(self, x, Z):
        ls = _ls(self.lengthscale, x)
        diff = (x[..., :, None, :] - Z[..., None, :, :]) / ls[..., None, :] ** 2
        c = _matern_dcoeff(_sqdist(x / ls, Z / ls), self.nu)
        return -diff * c[..., None]

    def dxT(self, x, Z):
        ls = _ls(self.lengthscale, x)
        diffT = (Z.transpose(-1, -2)[..., :, :, None]
                 - x.transpose(-1, -2)[..., :, None, :]) / _ls_dim(self.lengthscale, x) ** 2
        c = _matern_dcoeff(_sqdist(Z / ls, x / ls), self.nu)
        return diffT * c[..., None, :, :]

    def dxdz_diag(self, x):
        self._check_twice_differentiable()
        scale = {math.inf: 1.0, 1.5: 3.0, 2.5: 5.0 / 3.0}[self.nu]
        return scale * torch.ones_like(x) / _ls(self.lengthscale, x) ** 2

    def _check_twice_differentiable(self):
        if self.nu not in (math.inf, 1.5, 2.5):
            raise NotImplementedError(f"dxdz_diag undefined for nu={self.nu}")

    def _leaf_value(self):
        return self.lengthscale

    def _with_leaf_value(self, value):
        return replace(self, lengthscale=value)


@dataclass(frozen=True)
class Sum(Kernel):
    k1: Kernel
    k2: Kernel

    def _leaves(self):
        return self.k1._leaves() + self.k2._leaves()

    def _rebuild(self, theta, offset):
        k1, offset = self.k1._rebuild(theta, offset)
        k2, offset = self.k2._rebuild(theta, offset)
        return Sum(k1, k2), offset

    def __call__(self, X, Z=None):
        return self.k1(X, Z) + self.k2(X, Z)

    def diag(self, X):
        return self.k1.diag(X) + self.k2.diag(X)

    def pairwise(self, a, b):
        return self.k1.pairwise(a, b) + self.k2.pairwise(a, b)

    def dx(self, x, Z):
        return self.k1.dx(x, Z) + self.k2.dx(x, Z)

    def dxT(self, x, Z):
        return self.k1.dxT(x, Z) + self.k2.dxT(x, Z)

    def dxdz_diag(self, x):
        return self.k1.dxdz_diag(x) + self.k2.dxdz_diag(x)


@dataclass(frozen=True)
class Product(Kernel):
    k1: Kernel
    k2: Kernel

    def _leaves(self):
        return self.k1._leaves() + self.k2._leaves()

    def _rebuild(self, theta, offset):
        k1, offset = self.k1._rebuild(theta, offset)
        k2, offset = self.k2._rebuild(theta, offset)
        return Product(k1, k2), offset

    def __call__(self, X, Z=None):
        return self.k1(X, Z) * self.k2(X, Z)

    def diag(self, X):
        return self.k1.diag(X) * self.k2.diag(X)

    def pairwise(self, a, b):
        return self.k1.pairwise(a, b) * self.k2.pairwise(a, b)

    def dx(self, x, Z):
        a = self.k1(x, Z)[..., None]
        b = self.k2(x, Z)[..., None]
        return self.k1.dx(x, Z) * b + a * self.k2.dx(x, Z)

    def dxT(self, x, Z):
        # symmetric stationary kernels: k(x, Z)ᵀ = k(Z, x)
        aT = self.k1(Z, x)[..., None, :, :]
        bT = self.k2(Z, x)[..., None, :, :]
        return self.k1.dxT(x, Z) * bT + aT * self.k2.dxT(x, Z)

    def dxdz_diag(self, x):
        # the product rule at a = b: k1''·k2 + k1'·k2' + k2'·k1' + k1·k2'';
        # the first derivatives of a stationary factor vanish there, so each
        # factor's own closed form gives the product's (a Constant or White
        # factor has k'' = 0 and reduces it to c·k'').  Not autodiff through
        # ``pairwise``: the closed forms are exact and cheaper (the JAX
        # package's autodiff form is wrong at a = b for a Matérn factor).
        return (self.k1.diag(x)[..., None] * self.k2.dxdz_diag(x)
                + self.k2.diag(x)[..., None] * self.k1.dxdz_diag(x))
