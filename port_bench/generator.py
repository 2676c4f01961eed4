"""The one traffic generator: a configuration's scene and a traffic mix's
targets, made on the device from the seed.

A configuration's ``scene`` names the module ``scenes/<scene>.py`` that
lays out its demo and source point set (``make(cfg, g, device)``); a
traffic mix's ``targets.family`` names the module ``targets/<family>.py``
that draws each call's E target point sets (``draw(params, scene, E, g)``).
Every number they use comes from the two JSON files.  The work is drawn in
float64 with a ``torch.Generator`` on the device and handed to the program
in the configuration's dtype; the reference gets those same values.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch import Tensor

from . import spec

SEED_MOD = 2**63


@dataclass
class Scene:
    X: Tensor  # demo positions (Q, D)
    dX: Tensor  # demo velocities (Q, D), the last row 0
    S: Tensor  # source point set (n, D)
    base: Tensor  # the point set the targets perturb (n, D)
    param: Tensor  # each point's coordinates on its curve or surface, (n, k) in [0, 1]
    extra: Dict[str, Tensor] = field(default_factory=dict)  # more inputs of the entry, by keyword


@dataclass
class Inputs:
    scene: Scene
    pool: List[Tensor]  # the batches of targets a run cycles, each (E, n, D)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one use of the seed: ``stream`` keeps the scene's,
    the targets' and the program's draws apart."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % SEED_MOD)
    return g


def velocities(X: Tensor) -> Tensor:
    dX = torch.zeros_like(X)
    dX[:-1] = X[1:] - X[:-1]
    return dX


def make_inputs(cfg: dict, traffic: dict, seed: int, device, members: Optional[int] = None,
                pool: Optional[int] = None) -> Inputs:
    """The scene and the pool of target batches of one run.  ``members`` and
    ``pool`` override the traffic's (the tests' small runs)."""
    scene = spec.module("scenes", cfg["scene"]).make(cfg, generator(seed, device, 1), device)
    t = traffic["targets"]
    draw = spec.module("targets", t["family"]).draw
    E = traffic["members"] if members is None else members
    P = traffic["pool"] if pool is None else pool
    g = generator(seed, device, 2)
    batches = [draw(t, scene, E, g) for _ in range(P)]
    dtype = getattr(torch, cfg["dtype"])
    cast = lambda x: x.to(dtype).contiguous()
    scene = Scene(cast(scene.X), cast(scene.dX), cast(scene.S), cast(scene.base), scene.param,
                  {k: cast(v) for k, v in scene.extra.items()})
    return Inputs(scene, [cast(b) for b in batches])
