"""Dataset loaders and synthetic generators.

Port of ``gaussian_process_transportation_tpu/data/datasets.py``:

* the 2-D drawing npz (demo / floor / newfloor), the 3-D example npz, the
  ``reach_target`` multi-reference-frame dataset and the LASA handwriting
  ``.mat`` files, read from the original project's layout under ``root``
  (or the file ``path``); where neither is given, under the directory that
  the ``GPT_REFERENCE_ROOT`` environment variable names;
* the frame → 10-point distribution expansion and the random
  out-of-distribution frames (numpy, with numpy's ``RandomState``, so both
  packages draw the same frames);
* random GP-sampled 3-D surfaces and the spiral demonstration over them,
  whose standard normals come from a ``torch.Generator`` or are given;
* the SVGP completion of a surface point cloud (the port's SVGP).

Every generator and the completion compute on ``device`` (the card unless
the caller asks for the CPU) and return numpy arrays, as JAX's do.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

ROOT_ENV = "GPT_REFERENCE_ROOT"


def _under_root(root: Optional[str], relative: str) -> str:
    """``root``, else ``relative`` under the directory ``GPT_REFERENCE_ROOT``
    names (a checkout of the original project)."""
    if root is not None:
        return root
    base = os.environ.get(ROOT_ENV)
    if not base:
        raise FileNotFoundError(f"pass the data's directory or path, or set {ROOT_ENV} to a "
                                f"checkout of the original project (which holds {relative})")
    return os.path.join(base, relative)


def load_2d_drawing(name: str = "example", root: Optional[str] = None) -> Dict[str, np.ndarray]:
    root = _under_root(root, "example/2D/data")
    data = np.load(os.path.join(root, f"{name}.npz"))
    return {"demo": data["demo"], "floor": data["floor"], "newfloor": data["newfloor"]}


def load_3d_example(root: Optional[str] = None) -> Dict[str, np.ndarray]:
    root = _under_root(root, "example/3D/data")
    data = np.load(os.path.join(root, "example.npz"))
    return {k: data[k] for k in data.files}


def load_reach_target(path: Optional[str] = None) -> Dict:
    """Returns a dict with keys 'x' (list of (T, 2) demos), 'A' (per-demo
    (T, n_frames, 2, 2) frame rotations) and 'b' (the frame origins)."""
    if path is None:
        path = os.path.join(_under_root(None, "example/comparisons/multi_reference_frames/data"),
                            "reach_target.npy")
    demos = np.load(path, allow_pickle=True, encoding="latin1")[()]
    return {"x": list(demos["x"]), "A": list(demos["A"]), "b": list(demos["b"])}


def distribution_from_frames(A: List, b: List, frame_dim: float = 5.0) -> np.ndarray:
    """(n_demos, 10, 2) point-pair distributions from the start and goal
    frames of each demo: each origin, and ±frame_dim along each frame's
    axes."""
    n = len(A)
    out = np.zeros((n, 10, 2))
    for i in range(n):
        A0, A1 = np.asarray(A[i][0][0]), np.asarray(A[i][0][1])
        b0, b1 = np.asarray(b[i][0][0]), np.asarray(b[i][0][1])
        out[i, 0] = b0
        out[i, 1] = b0 + A0 @ np.array([0.0, frame_dim])
        out[i, 2] = b1
        out[i, 3] = b1 + A1 @ np.array([0.0, -frame_dim])
        out[i, 4] = b0 + A0 @ np.array([0.0, -frame_dim])
        out[i, 5] = b1 + A1 @ np.array([0.0, frame_dim])
        out[i, 6] = b0 + A0 @ np.array([frame_dim, 0.0])
        out[i, 7] = b1 + A1 @ np.array([frame_dim, 0.0])
        out[i, 8] = b0 + A0 @ np.array([-frame_dim, 0.0])
        out[i, 9] = b1 + A1 @ np.array([-frame_dim, 0.0])
    return out


def generate_frame_orientation(
    A: List, b: List, rng: Optional[np.random.RandomState] = None,
    rotation_magnitude: float = 0.5, translation_offset: float = 20.0,
) -> Tuple[List, List]:
    """Randomly rotated and translated copies of both frames of each demo,
    for the out-of-distribution study (numpy's ``RandomState``)."""
    rng = rng or np.random.RandomState(0)
    A_new = copy.deepcopy(A)
    b_new = copy.deepcopy(b)
    for i in range(len(A)):
        for j in range(2):
            t = (translation_offset * rng.randn(2) - translation_offset / 2).reshape(-1)
            theta = rng.uniform(-rotation_magnitude * np.pi, rotation_magnitude * np.pi)
            c, s = np.cos(theta), np.sin(theta)
            R = np.array([[c, -s], [s, c]])
            A_new[i][0][j] = R @ np.asarray(A[i][0][j])
            b_new[i][0][j] = np.asarray(b_new[i][0][j]) + t
    return A_new, b_new


def random_gp_surface(
    generator: Optional[torch.Generator] = None,
    n: int = 20,
    extent: float = 1.0,
    lengthscale: float = 0.4,
    amplitude: float = 0.2,
    normals: Optional[Tensor] = None,
    device="cuda",
) -> np.ndarray:
    """(n, n, 3) random smooth surface: z ~ GP(0, C·RBF) on an n×n grid
    over [−extent, extent]², sampled as L·ε through the Cholesky factor of
    the grid's Gram (+1e-8 I) in float64 on ``device``.  ε (n²,) are
    ``normals`` where given, else standard normals from ``generator`` (a
    CPU generator, seed 0 when None)."""
    from ..kernels import RBF, Constant

    f64 = dict(dtype=torch.float64, device=device)
    g = torch.linspace(-extent, extent, n, **f64)
    gx, gy = torch.meshgrid(g, g, indexing="xy")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1)
    if normals is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        normals = torch.randn(pts.shape[0], generator=generator, dtype=torch.float64)
    k = Constant(amplitude**2) * RBF(lengthscale * torch.ones(2, **f64))
    L = torch.linalg.cholesky(k(pts) + 1e-8 * torch.eye(pts.shape[0], **f64))
    z = L @ torch.as_tensor(normals, **f64)
    return torch.stack([gx, gy, z.reshape(n, n)], -1).cpu().numpy()


def spiral_demo(
    generator: Optional[torch.Generator] = None,
    n_spiral: int = 360,
    n_lift: int = 100,
    n_grid: int = 20,
    lengthscale: float = 0.7,
    amplitude: float = 0.1,
    normals: Optional[Tensor] = None,
    device="cuda",
):
    """A 3-D spiral demonstration over a flat source surface and a
    GP-sampled target surface: a closed-form Archimedean spiral, a
    parabolic lift from its end back to its start, and
    :func:`random_gp_surface` over the spiral's extent (its ``normals`` or
    ``generator``).  Returns ``(demo (N, 3), old_surface (n, n, 3),
    new_surface (n, n, 3))`` as numpy arrays."""
    t = np.linspace(0.0, 6.0 * np.pi, n_spiral)
    r = 0.02 + 0.15 * t
    x = r * np.cos(t)
    y = r * np.sin(t)
    z = np.zeros_like(x)

    # the parabola through (0, 0), (0.5, 1), (1, 0) from the spiral's end to its start
    s = np.linspace(0.0, 1.0, n_lift)
    zl = 4.0 * s * (1.0 - s)
    xl = (1 - s) * x[-1] + s * x[0]
    yl = (1 - s) * y[-1] + s * y[0]
    demo = np.column_stack(
        [np.concatenate([x, xl]), np.concatenate([y, yl]), np.concatenate([z, zl])]
    )

    ext = float(np.abs(demo[:, :2]).max()) * 1.1
    g = np.linspace(-ext, ext, n_grid)
    gx, gy = np.meshgrid(g, g)
    old_surface = np.stack([gx, gy, np.zeros_like(gx)], axis=-1)
    new_surface = random_gp_surface(generator, n=n_grid, extent=ext, lengthscale=lengthscale,
                                    amplitude=amplitude, normals=normals, device=device)
    return demo, old_surface, new_surface


def complete_surface(
    points: np.ndarray,
    grid_n: int = 20,
    num_inducing: int = 1000,
    num_epochs: int = 5,
    seed: int = 0,
    margins: float = 0.0,
    device="cuda",
) -> np.ndarray:
    """SVGP surface completion: fit z(x, y) on a raw point cloud (N, 3) on
    ``device`` and evaluate it on a grid over its xy bounding box →
    (grid_n², 3)."""
    from ..models.svgp import StochasticVariationalGaussianProcess

    points = np.asarray(points)
    xy, z = points[:, :2], points[:, 2:3]
    model = StochasticVariationalGaussianProcess(
        xy, z, num_inducing=min(num_inducing, len(xy)), seed=seed, device=device
    )
    model.fit(num_epochs=num_epochs)
    gx = np.linspace(xy[:, 0].min() + margins, xy[:, 0].max() - margins, grid_n)
    gy = np.linspace(xy[:, 1].min() + margins, xy[:, 1].max() - margins, grid_n)
    GX, GY = np.meshgrid(gx, gy)
    grid = np.column_stack([GX.ravel(), GY.ravel()])
    zg = model.predict(grid)[:, 0].cpu().numpy()
    return np.column_stack([grid, zg])


def load_lasa(name: str = "Angle", root: Optional[str] = None) -> List[Dict[str, np.ndarray]]:
    """LASA handwriting dataset loader.  Returns a list of demos, each
    ``{"pos": (T, 2), "t": (T,), "vel": (T, 2), "acc": (T, 2)}`` (time
    first, unlike the .mat files' (2, T))."""
    from scipy.io import loadmat

    root = _under_root(root, "example/paper_figures/DataSet")
    mat = loadmat(os.path.join(root, f"{name}.mat"))
    demos = []
    for demo in mat["demos"][0]:
        fields = {n: demo[n][0, 0] for n in ("pos", "t", "vel", "acc")}
        demos.append(
            {
                "pos": np.asarray(fields["pos"], float).T,
                "t": np.asarray(fields["t"], float).ravel(),
                "vel": np.asarray(fields["vel"], float).T,
                "acc": np.asarray(fields["acc"], float).T,
            }
        )
    return demos
