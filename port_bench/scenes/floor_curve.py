"""The 2-D floor of the upstream example with synthetic curves: the demo
(a·t, b·sin(ω t)), the floor (a·s, y0) and the new floor
(a·s, y0 + c·sin(ν s)), t and s evenly spaced on [0, 1].  The targets
perturb the new floor; a point's parameter is its s."""
import torch

from port_bench.generator import Scene, velocities


def make(cfg: dict, g: torch.Generator, device) -> Scene:
    c = cfg["curves"]
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.linspace(0, 1, cfg["demo_points"], **f64)
    X = torch.stack([c["extent"] * t, c["demo_height"] * torch.sin(c["demo_freq"] * t)], 1)
    s = torch.linspace(0, 1, cfg["dist_points"], **f64)
    S = torch.stack([c["extent"] * s, c["floor_y"] + 0 * s], 1)
    S1 = torch.stack([c["extent"] * s, c["floor_y"] + c["new_height"] * torch.sin(c["new_freq"] * s)], 1)
    return Scene(X, velocities(X), S, S1, s[:, None])
