"""base + a shift (each coordinate uniform in ±``shift``) + a bump on the
last coordinate, exp(−‖param − c‖²/(2w²)) of height uniform in
±``bump_height`` at a centre c uniform over the parameter domain."""
import torch
from torch import Tensor

from port_bench.generator import Scene


def draw(t: dict, scene: Scene, E: int, g: torch.Generator) -> Tensor:
    base, param = scene.base, scene.param
    n, D = base.shape
    f64 = dict(dtype=torch.float64, device=base.device)
    shift = (2 * torch.rand((E, 1, D), generator=g, **f64) - 1) * t["shift"]
    height = (2 * torch.rand((E, 1), generator=g, **f64) - 1) * t["bump_height"]
    centre = torch.rand((E, 1, param.shape[1]), generator=g, **f64)
    d = param[None] - centre
    bump = height * torch.exp(-0.5 * (d * d).sum(-1) / t["bump_width"] ** 2)  # (E, n)
    out = base[None] + shift
    out[..., -1] += bump
    return out
