"""AprilTag distribution adapters (the offline half of the original
project's tag detector).

Port of ``gaussian_process_transportation_tpu/data/tags.py``, on the
port's ``ops/quaternion.py``.  The adapters work on plain arrays and dicts
on the host:

* a detection is ``{"id": int, "position": (3,), "orientation": (4,) wxyz,
  "size": float}``;
* ``convert_distribution`` matches tag IDs across the source and target
  scans and optionally expands each tag into 12 oriented cube corners;
* ``find_closest_source_to_target`` picks, among several recorded source
  scans, the one with the least total displacement to the target.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops import quaternion as quat


def marker_corners(marker_dimension: float) -> np.ndarray:
    """The 12 cube-corner offsets of a tag of the given side length."""
    h = marker_dimension / 2.0
    base = np.array([[-h, -h], [-h, h], [h, h], [h, -h]], dtype=float)
    return np.concatenate(
        [
            np.column_stack([base, np.zeros(4)]),
            np.column_stack([base, np.full(4, h)]),
            np.column_stack([base, np.full(4, -h)]),
        ]
    )


def _rotation(orientation) -> np.ndarray:
    q = torch.as_tensor(np.asarray(orientation, dtype=float), dtype=torch.float64)
    return quat.to_rotation_matrix(q).numpy()


def convert_distribution(
    source_detections: Sequence[Dict],
    target_detections: Sequence[Dict],
    use_orientation: bool = False,
    scale_factor: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Match tag IDs across the scans → the paired point sets and their
    total displacement."""
    source_rows, target_rows = [], []
    for s in source_detections:
        for t in target_detections:
            if s["id"] != t["id"]:
                continue
            sp = np.asarray(s["position"], float)
            tp = np.asarray(t["position"], float)
            source_rows.append(sp[None])
            target_rows.append(tp[None])
            if use_orientation:
                for det, pos, rows in ((s, sp, source_rows), (t, tp, target_rows)):
                    corners = marker_corners(scale_factor * det["size"])
                    rows.append(corners @ _rotation(det["orientation"]).T + pos)
    if not source_rows:
        return np.zeros((0, 3)), np.zeros((0, 3)), 0.0
    source_array = np.concatenate(source_rows)
    target_array = np.concatenate(target_rows)
    distance = float(np.sum(np.linalg.norm(target_array - source_array, axis=1)))
    return source_array, target_array, distance


def find_closest_source_to_target(
    sources: Sequence[Sequence[Dict]],
    target: Sequence[Dict],
    use_orientation: bool = False,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """The recorded source scan with the least total displacement to the
    target scan: (its points, the target's, its index)."""
    converted = [convert_distribution(s, target, use_orientation=use_orientation)
                 for s in sources]
    index = int(np.argmin([c[2] for c in converted]))
    return converted[index][0], converted[index][1], index
