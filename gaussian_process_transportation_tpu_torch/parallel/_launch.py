"""Run one program as SPMD ranks on this host, under a deadline.

``launch(target, args, nprocs)`` starts ``nprocs`` processes
(``torch.multiprocessing``, spawn), each of which sets one intra-op thread,
takes its card (rank mod the card count) for CUDA, joins a process group
by ``distributed.initialize`` from the environment (``COORDINATOR_ADDRESS``
a ``file://`` rendezvous in a temporary directory, so no TCP port collides
with another run; ``NUM_PROCESSES``, ``PROCESS_ID``), runs
``target(*args)`` and leaves its return value, moved to the CPU, for the
caller.  ``target`` must be a module-level
function of this package, so that it pickles by reference.

A rank that raises before a collective leaves the others waiting in it:
the launcher then kills every rank and raises with each rank's traceback,
and so it does when ``deadline_s`` passes.  Each rank also checks that
neither JAX nor the JAX package was imported into it.

Ranks never build a kernel: for CUDA the launcher builds (or finds) every
library under ``_build/`` before it spawns, and a rank that would build
raises.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import _cuda
from .distributed import BACKEND_OF_DEVICE, initialize

__all__ = ["DEADLINE_S", "KERNEL_SOURCES", "launch"]

DEADLINE_S = 300
KERNEL_SOURCES = ("spd_inverse_elast", "factor_panel", "stationary_gram", "fused_lml")
_FORBIDDEN = ("jax", "jaxlib", "gaussian_process_transportation_tpu")


def _check_imports(when: str) -> None:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in _FORBIDDEN)
    if bad:
        raise AssertionError(f"a rank imported {bad[:5]} {when}")


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, tuple):  # a NamedTuple
        return type(x)(*(_to_cpu(v) for v in x))
    return x


def _rank_main(rank, nprocs, address, backend, device, target, args, work):
    os.environ.update(COORDINATOR_ADDRESS=address, NUM_PROCESSES=str(nprocs),
                      PROCESS_ID=str(rank), **{_cuda.NO_BUILD_ENV: "1"})
    torch.set_num_threads(1)
    try:
        _check_imports("before its program")
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        initialize(backend=backend)
        out = target(*args)
        _check_imports("in its program")
        torch.save(_to_cpu(out), os.path.join(work, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(work, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    if dist.is_initialized():
        dist.destroy_process_group()


def _build_kernels() -> None:
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_cuda.build, KERNEL_SOURCES))


def launch(target, args=(), nprocs: int = 2, backend=None, device: str = "cpu",
           deadline_s: float = DEADLINE_S):
    """``target(*args)`` in ``nprocs`` ranks; returns their return values in
    rank order.  ``backend`` None takes the device's (nccl for "cuda", gloo
    for "cpu")."""
    backend = backend or BACKEND_OF_DEVICE[device]
    if device == "cuda":
        _build_kernels()
    with tempfile.TemporaryDirectory() as work:
        address = "file://" + os.path.join(work, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(nprocs, address, backend, device, target, args, work),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {target.__name__} still ran after "
                                       f"{deadline_s} s")
        except Exception as exc:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
            errors = []
            for r in range(nprocs):
                path = os.path.join(work, f"err{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"--- rank {r} ---\n{f.read()}")
            raise RuntimeError(f"launch of {target.__name__} on {nprocs} ranks failed: {exc}\n"
                               + "\n".join(errors)) from exc
        return [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
                for r in range(nprocs)]
