"""Carry kernels and fitted state from the JAX package into the port.

The JAX objects are read duck-typed, by class name and field names, with
``np.asarray`` on every array leaf, so this module never imports JAX.
Plain numpy dictionaries work the same way, which is how saved state or
a test hands both packages the same parameters.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from . import kernels as K
from .models.affine import AffineParams
from .models.exact_gp import ExactGP


def _tensor(value, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(value), dtype=dtype, device=device)


def kernel_from_tree(k, dtype: torch.dtype = torch.float64, device=None) -> K.Kernel:
    """The port's kernel equal to a JAX kernel expression ``k``
    (Constant, White, RBF, Matern, Sum, Product)."""
    name = type(k).__name__
    if name in ("Sum", "Product"):
        cls = K.Sum if name == "Sum" else K.Product
        return cls(kernel_from_tree(k.k1, dtype, device), kernel_from_tree(k.k2, dtype, device))
    if name == "Constant":
        return K.Constant(_tensor(k.constant_value, dtype, device))
    if name == "White":
        return K.White(_tensor(k.noise_level, dtype, device))
    if name == "RBF":
        return K.RBF(_tensor(k.lengthscale, dtype, device))
    if name == "Matern":
        return K.Matern(_tensor(k.lengthscale, dtype, device), nu=float(k.nu))
    raise TypeError(f"no torch counterpart for kernel {name}")


def affine_from_numpy(
    params: Mapping[str, np.ndarray], dtype: torch.dtype = torch.float64, device=None
) -> AffineParams:
    """AffineParams from arrays keyed rotation, scale, source_centroid and
    target_centroid (optionally with a leading ensemble axis)."""
    return AffineParams(**{
        key: _tensor(params[key], dtype, device)
        for key in ("rotation", "scale", "source_centroid", "target_centroid")
    })


def exact_gp_from_numpy(
    state: Mapping[str, Optional[np.ndarray]],
    kernel: K.Kernel,
    dtype: torch.dtype = torch.float64,
    device=None,
    jitter: float = 1e-10,
) -> ExactGP:
    """ExactGP from arrays keyed X, Y, alpha and optionally L and K_inv."""
    opt = lambda key: None if state.get(key) is None else _tensor(state[key], dtype, device)
    return ExactGP(
        kernel=kernel,
        X=_tensor(state["X"], dtype, device),
        Y=_tensor(state["Y"], dtype, device),
        alpha=_tensor(state["alpha"], dtype, device),
        L=opt("L"),
        K_inv=opt("K_inv"),
        jitter=jitter,
    )
