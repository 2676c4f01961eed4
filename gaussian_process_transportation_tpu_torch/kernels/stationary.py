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
* ``dxdz_diag(x)`` → (..., N, D) = ∂²k(a, b)/∂a_d∂b_d at a = b = x_i.

The hyperparameter vector (``theta``/``with_theta``/bounds) belongs to the
hyperparameter-fitting part of the port and is not here yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import Tensor

Param = Union[float, Tensor]


def _vec(value: Param, like: Tensor) -> Tensor:
    """A hyperparameter as a 1-D tensor in ``like``'s dtype and device."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device).reshape(-1)


def _scalar(value: Param, like: Tensor) -> Param:
    """A scalar hyperparameter ready to multiply ``like``: a float stays a
    float, a tensor moves to ``like``'s dtype and device."""
    if isinstance(value, Tensor):
        return value.to(dtype=like.dtype, device=like.device)
    return value


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

    def dx(self, x: Tensor, Z: Tensor) -> Tensor:
        raise NotImplementedError(f"{type(self).__name__}.dx")

    def dxT(self, x: Tensor, Z: Tensor) -> Tensor:
        raise NotImplementedError(f"{type(self).__name__}.dxT")

    def dxdz_diag(self, x: Tensor) -> Tensor:
        raise NotImplementedError(f"{type(self).__name__}.dxdz_diag")


def _as_kernel(x) -> Kernel:
    return x if isinstance(x, Kernel) else Constant(x)


@dataclass(frozen=True)
class Constant(Kernel):
    constant_value: Param = 1.0

    def __call__(self, X, Z=None):
        Z = X if Z is None else Z
        return X.new_full(_cross_shape(X, Z), 1.0) * _scalar(self.constant_value, X)

    def diag(self, X):
        return X.new_full(X.shape[:-1], 1.0) * _scalar(self.constant_value, X)

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

    def __call__(self, X, Z=None):
        noise = _scalar(self.noise_level, X)
        if Z is None:
            n = X.shape[-2]
            eye = torch.eye(n, dtype=X.dtype, device=X.device)
            return eye.expand(X.shape[:-2] + (n, n)) * noise
        return X.new_zeros(_cross_shape(X, Z)) * noise

    def diag(self, X):
        return X.new_full(X.shape[:-1], 1.0) * _scalar(self.noise_level, X)

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

    def __call__(self, X, Z=None):
        Z = X if Z is None else Z
        ls = _vec(self.lengthscale, X)
        return torch.exp(-0.5 * _sqdist(X / ls, Z / ls))

    def diag(self, X):
        return X.new_ones(X.shape[:-1])

    def dx(self, x, Z):
        # ∂k/∂x_d = −(x_d − z_d)/ℓ_d² · k(x, z)
        k = self(x, Z)
        ls = _vec(self.lengthscale, x)
        diff = (Z[..., None, :, :] - x[..., :, None, :]) / ls**2
        return diff * k[..., None]

    def dxT(self, x, Z):
        kT = self(Z, x)  # (..., M, N)
        ls = _vec(self.lengthscale, x)
        diffT = (Z.transpose(-1, -2)[..., :, :, None]
                 - x.transpose(-1, -2)[..., :, None, :]) / (ls**2)[:, None, None]
        return diffT * kT[..., None, :, :]

    def dxdz_diag(self, x):
        return torch.ones_like(x) / _vec(self.lengthscale, x) ** 2


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

    def __call__(self, X, Z=None):
        Z = X if Z is None else Z
        ls = _vec(self.lengthscale, X)
        d2 = _sqdist(X / ls, Z / ls)
        if self.nu == math.inf:
            return torch.exp(-0.5 * d2)
        return _matern_of_d(torch.sqrt(d2 + 1e-36), self.nu)

    def diag(self, X):
        return X.new_ones(X.shape[:-1])

    def dx(self, x, Z):
        ls = _vec(self.lengthscale, x)
        diff = (x[..., :, None, :] - Z[..., None, :, :]) / ls**2
        c = _matern_dcoeff(_sqdist(x / ls, Z / ls), self.nu)
        return -diff * c[..., None]

    def dxT(self, x, Z):
        ls = _vec(self.lengthscale, x)
        diffT = (Z.transpose(-1, -2)[..., :, :, None]
                 - x.transpose(-1, -2)[..., :, None, :]) / (ls**2)[:, None, None]
        c = _matern_dcoeff(_sqdist(Z / ls, x / ls), self.nu)
        return diffT * c[..., None, :, :]

    def dxdz_diag(self, x):
        scale = {math.inf: 1.0, 1.5: 3.0, 2.5: 5.0 / 3.0}.get(self.nu)
        if scale is None:
            raise NotImplementedError(f"dxdz_diag undefined for nu={self.nu}")
        return scale * torch.ones_like(x) / _vec(self.lengthscale, x) ** 2


@dataclass(frozen=True)
class Sum(Kernel):
    k1: Kernel
    k2: Kernel

    def __call__(self, X, Z=None):
        return self.k1(X, Z) + self.k2(X, Z)

    def diag(self, X):
        return self.k1.diag(X) + self.k2.diag(X)

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

    def __call__(self, X, Z=None):
        return self.k1(X, Z) * self.k2(X, Z)

    def diag(self, X):
        return self.k1.diag(X) * self.k2.diag(X)

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
        # exact for a constant factor times a stationary kernel; the product
        # of two non-constant kernels needs the autodiff form, not ported
        if isinstance(self.k1, (Constant, White)):
            return self.k1.diag(x)[..., None] * self.k2.dxdz_diag(x)
        if isinstance(self.k2, (Constant, White)):
            return self.k2.diag(x)[..., None] * self.k1.dxdz_diag(x)
        raise NotImplementedError(
            "dxdz_diag of a product of two non-constant kernels")
