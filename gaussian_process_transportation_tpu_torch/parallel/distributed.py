"""Multi-process runtime helpers.

Port of ``gaussian_process_transportation_tpu/parallel/distributed.py``:
call :func:`initialize` once per process, then :func:`multihost_mesh` to
lay the ``ens`` axis across hosts (chains and ensemble members do not
communicate until their gather) and the ``data`` axis within a host (the
sharded Gram's per-step broadcasts).  One process drives one device.

Nothing in the environment describes a cluster: the caller gives the
rendezvous address, the process count and this process's index, or sets
``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``.
"""
from __future__ import annotations

import os
import tempfile
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import make_mesh, shard_slice

__all__ = ["BACKEND_OF_DEVICE", "initialize", "multihost_mesh", "process_local_slice"]

# the backend a device's tensors take unless the caller names another
BACKEND_OF_DEVICE = {"cuda": "nccl", "cpu": "gloo"}
TIMEOUT_S = 120  # a collective that waits longer raises


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` with the environment's
    ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID`` where an
    argument is None.

    ``coordinator_address`` is ``host:port`` (TCP) or a URL
    (``tcp://host:port``, ``file:///path``).  The backend is ``backend``,
    else the one of ``device`` ("cuda" → nccl, "cpu" → gloo; "cuda" when
    None); nothing falls back from one to the other.  A single process
    without a ``backend`` is a no-op; with one it makes a one-rank group
    (rendezvous through a file under the temporary directory when no
    address is given).  A collective that waits past ``TIMEOUT_S`` raises."""
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    if num_processes <= 1 and backend is None:
        return
    if backend is None:
        backend = BACKEND_OF_DEVICE[torch.device(device or "cuda").type]
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address is None:
        if num_processes > 1:
            raise ValueError("initialize: no coordinator address for "
                             f"{num_processes} processes")
        address = "file://" + os.path.join(tempfile.mkdtemp(), "rendezvous")
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    dist.init_process_group(backend, init_method=address if "://" in address else
                            f"tcp://{address}", world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=TIMEOUT_S))


def multihost_mesh(n_data_per_host: int = 1, device_type: str = "cuda"):
    """(ens × data) mesh with ``ens`` spanning hosts.  Ranks are numbered
    host by host (as ``torchrun`` numbers them), so the ``data`` axis, which
    carries the within-problem collectives, stays inside a host; a host
    has ``LOCAL_WORLD_SIZE`` ranks (the whole world when unset)."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_data = min(n_data_per_host, per_host)
    return make_mesh(world // n_data, n_data, device_type)


def process_local_slice(total: int) -> slice:
    """This process's contiguous shard of a length-``total`` ensemble axis."""
    if not dist.is_initialized():
        return slice(0, total)
    return shard_slice(total, dist.get_rank(), dist.get_world_size())
