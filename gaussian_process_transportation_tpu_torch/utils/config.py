"""Typed configuration dataclasses.

Port of ``gaussian_process_transportation_tpu/utils/config.py``.  A
workload is described by serializable dataclasses: ``KernelConfig.build``
makes the port's kernel expression from its specs, and the preset
functions give the original project's example settings.  The configs are
data only; ``build`` puts each lengthscale on the requested device (the
card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import kernels as K


@dataclass(frozen=True)
class KernelSpec:
    """One multiplicative group ``constant · base(lengthscale)`` or an
    additive white term; a full kernel is a sum of terms."""

    kind: str  # 'rbf' | 'matern' | 'white' | 'constant'
    value: float = 1.0  # constant value or noise level
    lengthscale: Tuple[float, ...] = (1.0,)
    nu: float = 1.5
    bounds: Tuple[float, float] = (1e-5, 1e5)


@dataclass(frozen=True)
class KernelConfig:
    terms: Tuple[Tuple[KernelSpec, ...], ...]  # sum of products

    def build(self, dtype: torch.dtype = torch.float32, device="cuda") -> K.Kernel:
        """The kernel: the sum over ``terms`` of each group's product, each
        lengthscale a ``dtype`` tensor on ``device``."""
        total = None
        for product_terms in self.terms:
            prod = None
            for spec in product_terms:
                k = _build_one(spec, dtype, device)
                prod = k if prod is None else prod * k
            total = prod if total is None else total + prod
        return total

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "KernelConfig":
        raw = json.loads(s)
        terms = tuple(
            tuple(KernelSpec(**{**t, "lengthscale": tuple(t["lengthscale"]),
                                "bounds": tuple(t["bounds"])}) for t in group)
            for group in raw["terms"]
        )
        return KernelConfig(terms=terms)


def _build_one(spec: KernelSpec, dtype: torch.dtype, device) -> K.Kernel:
    if spec.kind == "rbf":
        return K.RBF(torch.tensor(spec.lengthscale, dtype=dtype, device=device),
                     bounds=spec.bounds)
    if spec.kind == "matern":
        return K.Matern(torch.tensor(spec.lengthscale, dtype=dtype, device=device), nu=spec.nu,
                        bounds=spec.bounds)
    if spec.kind == "white":
        return K.White(spec.value, bounds=spec.bounds)
    if spec.kind == "constant":
        return K.Constant(spec.value, bounds=spec.bounds)
    raise ValueError(f"unknown kernel kind {spec.kind!r}")


@dataclass(frozen=True)
class TransportConfig:
    kernel: KernelConfig
    do_scale: bool = False
    do_rotation: bool = True
    optimize_hyperparameters: bool = True
    n_restarts: int = 5
    jitter: float = 1e-10


@dataclass(frozen=True)
class MeshConfig:
    n_ens: Optional[int] = None
    n_data: int = 1


# ---- presets of the original project's examples ---------------------------

def surface_2d_transport_config() -> TransportConfig:
    """The 2-D surface example's transport kernel: C(10)·RBF([4,4]) +
    White(0.01)."""
    return TransportConfig(
        kernel=KernelConfig(
            terms=(
                (KernelSpec("constant", value=10.0), KernelSpec("rbf", lengthscale=(4.0, 4.0))),
                (KernelSpec("white", value=0.01),),
            )
        )
    )


def dynamics_2d_config() -> KernelConfig:
    """The 2-D surface example's dynamics kernel: C(√0.1)·Matern₂.₅([1,1])
    + White(0.01)."""
    return KernelConfig(
        terms=(
            (
                KernelSpec("constant", value=math.sqrt(0.1)),
                KernelSpec("matern", lengthscale=(1.0, 1.0), nu=2.5),
            ),
            (KernelSpec("white", value=0.01),),
        )
    )


def multi_frame_transport_config() -> TransportConfig:
    """The multi-reference-frame benchmark's kernel: C(√10)·RBF(20, [10,50])
    + White(0.01)."""
    return TransportConfig(
        kernel=KernelConfig(
            terms=(
                (
                    KernelSpec("constant", value=math.sqrt(10.0)),
                    KernelSpec("rbf", lengthscale=(20.0,), bounds=(10.0, 50.0)),
                ),
                (KernelSpec("white", value=0.01, bounds=(1e-7, 1e-6)),),
            )
        ),
        do_scale=True,
    )
