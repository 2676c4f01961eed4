"""Vector fields, rollouts of the GP dynamical system, and plotting helpers.

Port of ``gaussian_process_transportation_tpu/viz.py``.  The compute part
goes through the port's ``exact_gp.predict`` and ``variance_gradient``, so
on the card a dense grid's predict and each rollout step's take the fused
kernels where ``exact_gp.fused_predict_route`` says so: a 100×100 grid
with a cached K⁻¹ takes the mean-and-variance kernel, and a rollout step
of Nq starts over N training points the mean kernel from Nq·N ≥ 2¹¹.  A
rollout is a loop of steps into a preallocated (n_steps, B, D) tensor,
and a step reads nothing back to the host.

Matplotlib is imported when a plot is asked for; where it is not
installed every ``plot_*`` and ``draw_*`` helper does nothing and returns
None.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from .models import exact_gp as core


# ---------------------------------------------------------------------------
# Compute
# ---------------------------------------------------------------------------

def _grid_points(x_grid, y_grid, like: Tensor) -> Tuple[Tensor, Tuple[int, int]]:
    """The meshgrid of x_grid and y_grid (xy indexing) as (Gy·Gx, 2) points
    in ``like``'s dtype and on its device, and the grid's shape."""
    gx = torch.as_tensor(x_grid, dtype=like.dtype, device=like.device)
    gy = torch.as_tensor(y_grid, dtype=like.dtype, device=like.device)
    GX, GY = torch.meshgrid(gx, gy, indexing="xy")
    return torch.stack([GX.reshape(-1), GY.reshape(-1)], 1), tuple(GX.shape)


def vector_field(gp: core.ExactGP, x_grid, y_grid) -> Tuple[Tensor, Tensor, Tensor]:
    """(u, v, std) of the GP's posterior on the meshgrid, one batched
    predict: u and v (Gy, Gx), std (Gy, Gx, P)."""
    pos, shape = _grid_points(x_grid, y_grid, gp.X)
    mean, std = core.predict(gp, pos, return_std=True)
    return (mean[:, 0].reshape(shape), mean[:, 1].reshape(shape),
            std.reshape(shape + (std.shape[1],)))


def rollout_gp_ds(
    gp: core.ExactGP,
    x0: Tensor,
    n_steps: int,
    dt: float = 1.0,
    modulation_fn: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tensor:
    """Euler rollout of the GP dynamical system ẋ = f(x), or ẋ = M(x) f(x)
    with ``modulation_fn``: x0 (B, D) → the states after each step
    (n_steps, B, D)."""
    x = torch.as_tensor(x0, dtype=gp.X.dtype, device=gp.X.device)
    traj = x.new_empty((n_steps,) + tuple(x.shape))
    for i in range(n_steps):
        v = core.predict(gp, x)
        if modulation_fn is not None:
            v = (modulation_fn(x) @ v[:, :, None])[:, :, 0]
        x = x + v * dt
        traj[i] = x
    return traj


def rollout_stable_gp_ds(gp: core.ExactGP, x0: Tensor, n_steps: int = 1000) -> Tensor:
    """Uncertainty-stabilized Euler rollout of the GP dynamical system:
    each step x ← x + f(x) − σ(x)·∇σ²/‖∇σ²‖ (the std-scaled descent of
    the predictive variance keeps the rollout near the demonstration).
    x0 (B, D) → (n_steps, B, D)."""
    x = torch.as_tensor(x0, dtype=gp.X.dtype, device=gp.X.device)
    traj = x.new_empty((n_steps,) + tuple(x.shape))
    for i in range(n_steps):
        vel, std = core.predict(gp, x, return_std=True)
        g = core.variance_gradient(gp, x)
        n = torch.linalg.vector_norm(g, dim=1, keepdim=True)
        x = x + vel - std * (g / torch.clamp(n, min=1e-12))
        traj[i] = x
    return traj


def plot_traj_evolution(gp, x_grid, y_grid, z_grid, demo=None, surface=None, n_steps=1000,
                        generator: Optional[torch.Generator] = None):
    """3-D trajectory-evolution figure: a stabilized GP-DS rollout from a
    uniform random start in the grid's box (drawn from ``generator``, a CPU
    generator, seed 0 when None), plotted over the surface and the
    demonstration.  Returns the 3-D axis."""
    plt = _plt()
    if plt is None:
        return None
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    lo = torch.tensor([x_grid[0], y_grid[0], z_grid[0]], dtype=torch.float64)
    hi = torch.tensor([x_grid[-1], y_grid[-1], z_grid[-1]], dtype=torch.float64)
    x0 = lo + (hi - lo) * torch.rand((1, 3), generator=generator, dtype=torch.float64)
    traj = rollout_stable_gp_ds(gp, x0, n_steps)[:, 0].cpu().numpy()
    ax = plot_traj_3D(traj, surface)
    if ax is not None and demo is not None:
        demo = np.asarray(demo)
        ax.scatter(demo[:, 0], demo[:, 1], demo[:, 2], color=[1, 0, 0])
    return ax


def plot_traj_3D(trajectory, surface=None, ax=None):
    """Trajectory scatter over a (Gx, Gy, 3) surface mesh."""
    plt = _plt()
    if plt is None:
        return None
    if ax is None:
        ax = plt.figure().add_subplot(projection="3d")
    if surface is not None:
        from matplotlib import cm

        surface = _numpy(surface)
        ax.plot_surface(surface[:, :, 0], surface[:, :, 1], surface[:, :, 2],
                        cmap=cm.coolwarm, linewidth=0, antialiased=False)
    trajectory = _numpy(trajectory)
    ax.scatter(trajectory[:, 0], trajectory[:, 1], trajectory[:, 2], color=[0, 0, 1])
    return ax


def min_variance_attractor_field(gp: core.ExactGP, query: Tensor, step: float = 1.0) -> Tensor:
    """The velocity field that descends the predictive variance,
    v(x) = −step · ∇σ²/‖∇σ²‖ at the queries (Nq, D)."""
    query = torch.as_tensor(query, dtype=gp.X.dtype, device=gp.X.device)
    g = core.variance_gradient(gp, query)
    n = torch.linalg.vector_norm(g, dim=1, keepdim=True)
    return -step * g / torch.clamp(n, min=1e-12)


# ---------------------------------------------------------------------------
# Plotting (matplotlib imported on use)
# ---------------------------------------------------------------------------

def _plt():
    try:
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, Tensor) else np.asarray(a)


def plot_vector_field(gp, x_grid, y_grid, demo=None, surface=None, ax=None, density=2):
    plt = _plt()
    if plt is None:
        return None
    u, v, _ = vector_field(gp, x_grid, y_grid)
    gx, gy = np.meshgrid(_numpy(x_grid), _numpy(y_grid))
    ax = ax or plt.figure(figsize=(12, 7)).gca()
    ax.streamplot(gx, gy, _numpy(u), _numpy(v), density=density)
    if demo is not None:
        ax.scatter(_numpy(demo)[:, 0], _numpy(demo)[:, 1], color=[1, 0, 0])
    if surface is not None:
        ax.scatter(_numpy(surface)[:, 0], _numpy(surface)[:, 1], color=[0, 0, 0])
    return ax


def draw_error_band(ax, x, y, err, loop: bool = False, **kwargs):
    """Normal-offset error band around a curve."""
    plt = _plt()
    if plt is None or ax is None:
        return None
    from matplotlib.patches import PathPatch
    from matplotlib.path import Path

    x, y, err = _numpy(x), _numpy(y), _numpy(err)
    if err.ndim == 2:
        err = np.linalg.norm(err, axis=1)
    dx = np.gradient(x)
    dy = np.gradient(y)
    l = np.hypot(dx, dy)
    l = np.where(l > 1e-12, l, 1.0)
    nx, ny = dy / l, -dx / l
    xp, yp = x + nx * err, y + ny * err
    xn, yn = x - nx * err, y - ny * err
    vertices = np.block([[xp, xn[::-1]], [yp, yn[::-1]]]).T
    codes = np.full(len(vertices), Path.LINETO)
    codes[0] = codes[len(xp)] = Path.MOVETO
    path = Path(vertices, codes)
    ax.add_patch(PathPatch(path, **kwargs))
    return ax
