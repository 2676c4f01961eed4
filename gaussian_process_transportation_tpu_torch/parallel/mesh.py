"""Device meshes over ``torch.distributed`` ranks.

Port of ``gaussian_process_transportation_tpu/parallel/mesh.py``.  The
parallel axes are those of the JAX package:

* ``ens``  — the ensemble or chain axis: transport ensembles, HMC chains,
             SMC particles; pure data parallelism.
* ``data`` — the within-problem axis: the panels of a large Gram
             (``sharded_chol``, ``sharded_lml``).

JAX runs one program over all devices and carries the sharding on the
arrays.  Here every rank is one process with one device (SPMD), the mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` of shape (n_ens,
n_data) over the initialized default group, and a sharded array is each
rank's own contiguous slice of axis 0.  Every rank holds the whole host
input, as in JAX's multi-process runs, so putting an array under a
sharding is a slice and moves nothing.

The collectives the multi-device paths need are two, both of which the
gloo backend also takes for CUDA tensors: ``broadcast`` (JAX's ``psum`` of
an owner-masked value) and ``all_reduce`` (its sums).  :class:`MeshAxis`
wraps them for one axis; with ``mesh=None`` it is one rank and no
communication.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import Tensor

__all__ = ["MeshAxis", "Sharding", "axis_of", "ensemble_sharding", "global_put", "make_mesh",
           "replicated", "shard_slice"]


def make_mesh(n_ens: Optional[int] = None, n_data: int = 1, device_type: str = "cuda"):
    """The (n_ens, n_data) mesh of every rank of the default group, axes
    named ("ens", "data"); rank r sits at (r // n_data, r % n_data).
    ``n_ens`` None takes world_size // n_data.  Every rank calls it (it
    creates the axes' process groups, on the default group's backend)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if n_ens is None:
        n_ens = world // n_data
    if n_ens * n_data != world:
        raise ValueError(f"a ({n_ens}, {n_data}) mesh needs {n_ens * n_data} ranks; the "
                         f"default group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(n_ens, n_data),
                      mesh_dim_names=("ens", "data"))


class Sharding(NamedTuple):
    """Where an array lives on a mesh: its axis 0 split over ``axis``, or
    replicated (``axis`` None); JAX's ``NamedSharding``."""

    mesh: object
    axis: Optional[str]


def ensemble_sharding(mesh) -> Sharding:
    """Axis 0 split over the ``ens`` axis."""
    return Sharding(mesh, "ens")


def replicated(mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_slice(total: int, index: int, count: int) -> slice:
    """The ``index``-th of ``count`` contiguous shards of ``total`` rows:
    total // count each, the last one taking the rest."""
    per = total // count
    return slice(index * per, (index + 1) * per if index < count - 1 else total)


def global_put(x, sharding: Sharding):
    """This rank's part of the host array ``x``, which every rank holds
    whole: its contiguous shard of axis 0 along the sharding's axis, or
    ``x`` itself when replicated.  No communication."""
    if sharding.axis is None:
        return x
    ax = axis_of(sharding.mesh, sharding.axis)
    return x[shard_slice(x.shape[0], ax.index, ax.size)]


class MeshAxis:
    """One axis of a mesh as this rank sees it: the axis' process ``group``
    (None without a mesh), its ``size``, this rank's ``index`` along it and
    the global ranks of its members, with the collectives over it."""

    def __init__(self, group, size: int, index: int, ranks: List[int]):
        self.group, self.size, self.index, self.ranks = group, size, index, ranks

    def broadcast(self, t: Tensor, owner: int) -> Tensor:
        """``t`` overwritten in place with member ``owner``'s.  ``t`` must be
        contiguous: a collective sends and receives raw storage, so a strided
        source would arrive transposed."""
        if not t.is_contiguous():
            raise ValueError(f"broadcast of a non-contiguous {tuple(t.shape)} tensor")
        if self.group is not None:
            dist.broadcast(t, src=self.ranks[owner], group=self.group)
        return t

    def all_reduce(self, t: Tensor) -> Tensor:
        """``t`` summed over the axis in place; every member gets the same
        bits."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def shard(self, total: int) -> slice:
        """This rank's rows of a length-``total`` axis split over the axis."""
        return shard_slice(total, self.index, self.size)

    def gather(self, local: Tensor, total: int) -> Tensor:
        """The (total, ...) array whose shards the members hold, each member's
        ``local`` in its rows: one broadcast per member, into views of one
        preallocated output.  Exact."""
        out = local.new_empty((total,) + tuple(local.shape[1:]))
        for i in range(self.size):
            rows = out[shard_slice(total, i, self.size)]
            if i == self.index:
                rows.copy_(local)
            self.broadcast(rows, i)
        return out


def axis_of(mesh, axis: str) -> MeshAxis:
    """The :class:`MeshAxis` of ``axis``; ``mesh`` None is one rank alone."""
    if mesh is None:
        return MeshAxis(None, 1, 0, [0])
    group = mesh.get_group(axis)
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    ranks = [dist.get_global_rank(group, i) for i in range(size)]
    return MeshAxis(group, size, mesh.get_local_rank(axis), ranks)
