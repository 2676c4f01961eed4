"""Versioned on-disk artifact store (checkpoint and resume).

Port of ``gaussian_process_transportation_tpu/utils/artifacts.py``.  A
tree of tensors (nested dicts, lists, tuples and named tuples; fitted GP
state, sampler chains) is saved as its flattened leaves in ``<path>.pt``
(``torch.save`` of CPU tensors, read back with ``weights_only``) beside a
JSON sidecar ``<path>.json`` with the tree's structure and free-form
metadata.  Loading needs an exemplar tree of the same structure, whose
leaves give each loaded leaf its dtype and device.  Each file is written
to a temporary name and renamed into place, so a run killed mid-save
leaves the previous file whole.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["ArtifactStore", "load_metadata", "load_pytree", "save_pytree"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, leaves: List[Any]) -> Any:
    """Appends the leaves of ``tree`` to ``leaves`` in order (dict keys
    sorted, as JAX's tree utilities order them); returns the structure."""
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(tree[k], leaves) for k in sorted(tree)}}
    if _is_namedtuple(tree):
        return {type(tree).__name__: [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(v, leaves) for v in tree]}
    if tree is None:
        return None
    leaves.append(tree)
    return "*"


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*[_unflatten(v, leaves) for v in like])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    value = next(leaves)
    if isinstance(like, torch.Tensor):
        return value.to(dtype=like.dtype, device=like.device)
    if isinstance(like, np.ndarray):
        return value.numpy().astype(like.dtype)
    return type(like)(value.item()) if value.dim() == 0 else value


def _atomic_write(path: str, write) -> None:
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix="tmp-", suffix=os.path.splitext(path)[1])
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_pytree(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    """Save a tree of tensors (or arrays, or numbers) to ``<path>.pt`` with
    the JSON sidecar ``<path>.json`` (structure, leaf count, metadata)."""
    leaves: List[Any] = []
    structure = _flatten(tree, leaves)
    tensors = {f"leaf_{i}": torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                                            else x).detach().cpu()
               for i, x in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    _atomic_write(path + ".pt", lambda tmp: torch.save(tensors, tmp))
    sidecar = {"treedef": structure, "n_leaves": len(leaves), "metadata": metadata or {},
               "version": 1}

    def write_json(tmp):
        with open(tmp, "w") as f:
            json.dump(sidecar, f)

    _atomic_write(path + ".json", write_json)


def load_pytree(path: str, like: Any) -> Any:
    """The tree saved by :func:`save_pytree` at ``path``, in the structure
    of ``like``, each leaf in the dtype and on the device of ``like``'s."""
    data = torch.load(path + ".pt", map_location="cpu", weights_only=True)
    n = len(data)
    count: List[Any] = []
    _flatten(like, count)
    if len(count) != n:
        raise ValueError(f"{path}.pt holds {n} leaves, the exemplar tree {len(count)}")
    return _unflatten(like, iter(data[f"leaf_{i}"] for i in range(n)))


def load_metadata(path: str) -> Dict:
    with open(path + ".json") as f:
        return json.load(f)["metadata"]


class ArtifactStore:
    """A directory of named artifacts, each saved as versions 1, 2, …"""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def latest_version(self, name: str) -> int:
        versions = [int(f.split(".v")[-1].split(".")[0]) for f in os.listdir(self.root)
                    if f.startswith(name + ".v") and f.endswith(".json")]
        return max(versions, default=0)

    def save(self, name: str, tree: Any, metadata: Optional[Dict] = None) -> int:
        v = self.latest_version(name) + 1
        save_pytree(os.path.join(self.root, f"{name}.v{v}"), tree, metadata)
        return v

    def load(self, name: str, like: Any, version: Optional[int] = None) -> Any:
        v = version if version is not None else self.latest_version(name)
        if v == 0:
            raise FileNotFoundError(f"no artifact named {name!r} in {self.root}")
        return load_pytree(os.path.join(self.root, f"{name}.v{v}"), like)
