"""Carry kernels and fitted state from the JAX package into the port.

The JAX objects are read duck-typed, by class name and field names, with
``np.asarray`` on every array leaf, so this module never imports JAX.
Plain numpy dictionaries work the same way, which is how saved state or
a test hands both packages the same parameters.  The learned models' state
(MLP and flow parameters, SVGP states, GMM and forest arrays, the
multi-frame baselines' parameters) is read the same way, by field name,
from the JAX objects or from mappings of arrays, and so are the obstacle
scenes and the fitted obstacle flow field.

Like the port's other entry points, every function puts its tensors on the
card unless the caller asks for another device (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from . import kernels as K
from .avoidance.flow_field import ObstacleFlowField
from .avoidance.geometry import Obstacles
from .models.affine import AffineParams
from .models.exact_gp import ExactGP
from .models.flows import CouplingNet, CouplingParams
from .models.gmr import ConditionalParams, GMMParams
from .models.hmm_lqr import HMMParams
from .models.random_forest import ForestParams
from .models.svgp import CollapsedSVGP, SVGPParams, SVGPState
from .models.tpgmm import TPGMMParams
from .ops.blocked_chol import BlockedCholesky
from .parallel.sharded_chol import ShardedBlockedCholesky


def _tensor(value, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(value), dtype=dtype, device=device)


def _field(obj, name: str):
    """``obj[name]`` of a mapping, else the attribute ``name``."""
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _fields(cls, obj, dtype, device):
    """The dataclass ``cls`` with each of its fields read from ``obj``."""
    return cls(**{f.name: _tensor(_field(obj, f.name), dtype, device)
                  for f in dataclasses.fields(cls)})


def kernel_from_tree(k, dtype: torch.dtype = torch.float64, device="cuda") -> K.Kernel:
    """The port's kernel equal to a JAX kernel expression ``k``
    (Constant, White, RBF, Matern, Sum, Product), every node's ``bounds``
    (and a Matérn's ``nu``) carried over."""
    name = type(k).__name__
    if name in ("Sum", "Product"):
        cls = K.Sum if name == "Sum" else K.Product
        return cls(kernel_from_tree(k.k1, dtype, device), kernel_from_tree(k.k2, dtype, device))
    bounds = tuple(float(b) for b in getattr(k, "bounds", K.DEFAULT_BOUNDS))
    if name == "Constant":
        return K.Constant(_tensor(k.constant_value, dtype, device), bounds=bounds)
    if name == "White":
        return K.White(_tensor(k.noise_level, dtype, device), bounds=bounds)
    if name == "RBF":
        return K.RBF(_tensor(k.lengthscale, dtype, device), bounds=bounds)
    if name == "Matern":
        return K.Matern(_tensor(k.lengthscale, dtype, device), nu=float(k.nu), bounds=bounds)
    raise TypeError(f"no torch counterpart for kernel {name}")


def affine_from_numpy(
    params: Mapping[str, np.ndarray], dtype: torch.dtype = torch.float64, device="cuda"
) -> AffineParams:
    """AffineParams from arrays keyed rotation, scale, source_centroid and
    target_centroid (optionally with a leading ensemble axis)."""
    return AffineParams(**{
        key: _tensor(params[key], dtype, device)
        for key in ("rotation", "scale", "source_centroid", "target_centroid")
    })


def blocked_cholesky_from_numpy(
    panels: Sequence[np.ndarray],
    linvs: np.ndarray,
    n: int,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> BlockedCholesky:
    """BlockedCholesky from a panel factor's arrays: the column panels,
    the stacked diagonal-block inverses and the logical size."""
    return BlockedCholesky([_tensor(p, dtype, device) for p in panels],
                           _tensor(linvs, dtype, device), int(n))


def exact_gp_from_numpy(
    state: Mapping[str, Optional[np.ndarray]],
    kernel: K.Kernel,
    dtype: torch.dtype = torch.float64,
    device="cuda",
    jitter: float = 1e-10,
) -> ExactGP:
    """ExactGP from arrays keyed X, Y, alpha and optionally L and K_inv,
    and optionally ``chol``: a panel factor with ``panels``, ``linvs`` and
    ``n`` (the JAX ``BlockedCholesky`` or the port's)."""
    opt = lambda key: None if state.get(key) is None else _tensor(state[key], dtype, device)
    chol = state.get("chol")
    if chol is not None:
        chol = blocked_cholesky_from_numpy(chol.panels, chol.linvs, chol.n, dtype, device)
    return ExactGP(
        kernel=kernel,
        X=_tensor(state["X"], dtype, device),
        Y=_tensor(state["Y"], dtype, device),
        alpha=_tensor(state["alpha"], dtype, device),
        L=opt("L"),
        chol=chol,
        K_inv=opt("K_inv"),
        jitter=jitter,
    )


def mlp_params_from_tree(params, dtype: torch.dtype = torch.float64, device="cuda") -> list:
    """The port's MLP parameters from a list of (W, b) pairs, optionally
    with a leading member axis (an ensemble's)."""
    return [(_tensor(W, dtype, device), _tensor(b, dtype, device)) for W, b in params]


def flow_layers_from_tree(layers, dtype: torch.dtype = torch.float64, device="cuda") -> list:
    """The port's coupling stack from the JAX package's list of
    ``CouplingParams`` (each net's ``layers`` and ``kind``), optionally
    with a leading member axis."""
    def net(n):
        pairs = tuple((_tensor(W, dtype, device), _tensor(b, dtype, device))
                      for W, b in _field(n, "layers"))
        return CouplingNet(pairs, str(_field(n, "kind")))

    return [CouplingParams(net(_field(p, "s_net")), net(_field(p, "t_net"))) for p in layers]


def svgp_state_from_tree(state, dtype: torch.dtype = torch.float64, device="cuda") -> SVGPState:
    """SVGPState from the JAX package's (its ``params``, ``kernel`` and
    ``jitter``)."""
    return SVGPState(params=_fields(SVGPParams, _field(state, "params"), dtype, device),
                     kernel=kernel_from_tree(_field(state, "kernel"), dtype, device),
                     jitter=float(_field(state, "jitter")))


def collapsed_svgp_from_tree(c, dtype: torch.dtype = torch.float64,
                             device="cuda") -> CollapsedSVGP:
    """CollapsedSVGP from the JAX package's (theta, Z, alpha, Lk, Lw and
    the kernel)."""
    arrays = {n: _tensor(_field(c, n), dtype, device) for n in ("theta", "Z", "alpha", "Lk", "Lw")}
    return CollapsedSVGP(**arrays, kernel=kernel_from_tree(_field(c, "kernel"), dtype, device))


def gmm_params_from_numpy(params, dtype: torch.dtype = torch.float64, device="cuda") -> GMMParams:
    """GMMParams from arrays log_weights, means and covs."""
    return _fields(GMMParams, params, dtype, device)


def conditional_from_numpy(cp, dtype: torch.dtype = torch.float64,
                           device="cuda") -> ConditionalParams:
    """ConditionalParams (a joint GMM conditioned on x) from its arrays."""
    return _fields(ConditionalParams, cp, dtype, device)


def forest_params_from_numpy(params, dtype: torch.dtype = torch.float64,
                             device="cuda") -> ForestParams:
    """ForestParams from arrays feature, threshold and value."""
    return ForestParams(feature=_tensor(_field(params, "feature"), torch.int64, device),
                        threshold=_tensor(_field(params, "threshold"), dtype, device),
                        value=_tensor(_field(params, "value"), dtype, device))


def tpgmm_params_from_numpy(params, dtype: torch.dtype = torch.float64,
                            device="cuda") -> TPGMMParams:
    """TPGMMParams from arrays priors, mu and sigma."""
    return _fields(TPGMMParams, params, dtype, device)


def hmm_params_from_numpy(params, dtype: torch.dtype = torch.float64, device="cuda") -> HMMParams:
    """HMMParams from arrays init, trans, mu and sigma."""
    return _fields(HMMParams, params, dtype, device)


def obstacles_from_tree(obs, dtype: torch.dtype = torch.float64, device="cuda") -> Obstacles:
    """The port's Obstacles from the JAX package's (or a mapping of its
    fields' arrays)."""
    return _fields(Obstacles, obs, dtype, device)


def flow_field_from_tree(ff, dtype: torch.dtype = torch.float64,
                         device="cuda") -> ObstacleFlowField:
    """The port's ObstacleFlowField holding a fitted JAX one's state: its
    boundary, PCA center, axes and dimensions, and its GP (the initial and
    fitted kernels, the jitter ``alpha``, the restarts and the posterior
    through :func:`exact_gp_from_numpy`)."""
    gp = ff.gp
    out = ObstacleFlowField(_tensor(ff.boundary, dtype, device),
                            kernel=kernel_from_tree(gp.kernel, dtype, device), alpha=gp.alpha,
                            n_restarts=gp.n_restarts_optimizer, device=device)
    for name in ("center", "components", "dimensions"):
        setattr(out, name, _tensor(getattr(ff, name), dtype, device))
    if getattr(ff, "projected_boundary_points", None) is not None:
        out.projected_boundary_points = _tensor(ff.projected_boundary_points, dtype, device)
    state = gp.state
    fitted = kernel_from_tree(state.kernel, dtype, device)
    out.gp.state = exact_gp_from_numpy(
        {key: getattr(state, key) for key in ("X", "Y", "alpha", "L", "K_inv")},
        fitted, dtype, device, jitter=float(state.jitter))
    out.gp.kernel_ = fitted
    out.gp.noise_var_ = float(gp.noise_var_)
    return out


def sharded_cholesky_from_jax(chol, rank: int, mesh=None, axis: str = "data",
                              dtype: torch.dtype = torch.float64,
                              device="cuda") -> ShardedBlockedCholesky:
    """One rank's part of a JAX ``ShardedBlockedCholesky`` (or a mapping of
    its ``panels``, ``linvs``, ``n`` and ``block``, the global arrays as
    numpy): device ``rank``'s rows of JAX's ``panels[j]`` (D·H_j, B) become
    slot j, global panel j·D + rank, cut to its true height Np − k·B (JAX
    pads each device's slot to H_j with zero rows), and its rows of
    ``linvs[j]`` (D·B, B) the slot's L_kk⁻¹.  ``mesh`` is the port's mesh
    whose ``axis`` has D ranks, this one at ``rank`` (None for D = 1);
    every rank carries its own part, and the factor's :meth:`solve` and
    :meth:`logdet` are then the port's collectives."""
    panels, linvs = _field(chol, "panels"), _field(chol, "linvs")
    n, B = int(_field(chol, "n")), int(_field(chol, "block"))
    D = np.shape(linvs[0])[0] // B
    slots, invs = [], []
    for p, li in zip(panels, linvs):
        H = np.shape(p)[0] // D
        slots.append(_tensor(np.asarray(p)[rank * H:rank * H + H - rank * B], dtype, device))
        invs.append(_tensor(np.asarray(li)[rank * B:(rank + 1) * B], dtype, device))
    return ShardedBlockedCholesky(slots, invs, n, B, mesh, axis)
