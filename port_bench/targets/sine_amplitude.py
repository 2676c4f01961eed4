"""base + a·sin(π s) on the last coordinate, s the point's curve parameter:
the E amplitudes evenly spaced on [0, ``max_amplitude``], in an order drawn
from the seed (every seed and batch fits the same set of members, so the
fit's work does not move with the seed)."""
import math

import torch
from torch import Tensor

from port_bench.generator import Scene


def draw(t: dict, scene: Scene, E: int, g: torch.Generator) -> Tensor:
    base, s = scene.base, scene.param[:, 0]
    order = torch.randperm(E, generator=g, device=base.device).to(torch.float64)
    a = (order / max(E - 1, 1) * t["max_amplitude"])[:, None]
    out = base[None].repeat(E, 1, 1)
    out[..., -1] += a * torch.sin(math.pi * s)[None]
    return out
