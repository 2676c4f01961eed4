"""Sampler runs in checkpointed segments, resumable after a kill.

Port of ``gaussian_process_transportation_tpu/parallel/checkpointed.py``.
A long run persists (chain state, tuned step sizes and mass, the samples so
far, the count of samples done) to ``<path>.ckpt`` through
``utils.artifacts`` after the warm-up and after every segment.  A run that
finds the checkpoint loads it and goes on from the next segment.  Every
draw of step s hashes (chain, phase, s) (``samplers.chain_bits``) whatever
range of steps a call covers, so a run killed after any segment and
resumed gives the samples of an uninterrupted run, bit for bit.

* ``run_hmc_checkpointed``: C chains of HMC over a log-density of one
  position that ``torch.func`` differentiates, batched over the chains
  with ``torch.func.vmap``;
* ``run_hmc_batched_checkpointed``: the same for the ensemble-last sampler
  over a batched value-and-gradient (``samplers.hmc_batched``, e.g. over
  the fused LML kernel).

Delete the checkpoint files to force a fresh run.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from ..utils.artifacts import load_metadata, load_pytree, save_pytree
from .samplers import (
    LpAndGrad,
    hmc_batched_sample_range,
    hmc_batched_warmup,
    vmapped_lp_and_grad,
)

__all__ = ["run_hmc_batched_checkpointed", "run_hmc_checkpointed"]


def _ckpt_path(path: str) -> str:
    return path + ".ckpt"


def _run(lp_and_grad: LpAndGrad, init_te: Tensor, seed: int, path: str, num_warmup: int,
         num_samples: int, segment: int, num_leapfrog: int, initial_step_size: float,
         target_accept: float, chain_ids: Optional[Tensor]):
    """The segmented run over an ensemble-last state (T, E); returns
    (samples (E, num_samples, T), step (E,), inv_mass (T, E), the sum over
    samples of each chain's accept probability (E,))."""
    T, E = init_te.shape
    ckpt = _ckpt_path(path)
    z = dict(dtype=init_te.dtype, device=init_te.device)
    template = {"position": torch.zeros(T, E, **z), "log_prob": torch.zeros(E, **z),
                "grad": torch.zeros(T, E, **z), "step_size": torch.zeros(E, **z),
                "inv_mass": torch.zeros(T, E, **z),
                "samples": torch.zeros(E, num_samples, T, **z),
                "accept_sum": torch.zeros(E, **z), "done": 0}
    if os.path.exists(ckpt + ".pt"):
        saved = load_pytree(ckpt, template)
        done = saved["done"]
        if done != int(load_metadata(ckpt)["done"]):
            raise RuntimeError(f"{ckpt}: the checkpoint and its sidecar disagree on the samples "
                               "done")
    else:
        state, step, inv_mass = hmc_batched_warmup(lp_and_grad, init_te, seed, num_warmup,
                                                   num_leapfrog, initial_step_size,
                                                   target_accept, chain_ids)
        saved = dict(template, position=state[0], log_prob=state[1], grad=state[2],
                     step_size=step, inv_mass=inv_mass)
        done = 0
        save_pytree(ckpt, saved, metadata={"done": 0})
    state = (saved["position"], saved["log_prob"], saved["grad"])
    step, inv_mass = saved["step_size"], saved["inv_mass"]
    samples, accept_sum = saved["samples"], saved["accept_sum"]
    while done < num_samples:
        stop = min(done + segment, num_samples)
        state, seg, accepts = hmc_batched_sample_range(lp_and_grad, state, seed, done, stop, step,
                                                       inv_mass, num_leapfrog, chain_ids)
        samples = samples.clone()
        samples[:, done:stop] = seg
        accept_sum = accept_sum + accepts.sum(0)
        done = stop
        save_pytree(ckpt, dict(position=state[0], log_prob=state[1], grad=state[2],
                               step_size=step, inv_mass=inv_mass, samples=samples,
                               accept_sum=accept_sum, done=done), metadata={"done": done})
    return samples, step, inv_mass, accept_sum


def run_hmc_checkpointed(
    logprob_fn: Callable[[Tensor], Tensor],
    init_positions: Tensor,
    seed: int,
    path: str,
    num_warmup: int = 300,
    num_samples: int = 300,
    segment: int = 100,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[Tensor, dict]:
    """C chains of HMC from ``init_positions`` (C, D) over ``logprob_fn``
    ((D,) -> ()), in segments of ``segment`` samples checkpointed at
    ``path``: chain c draws as chain c of ``samplers.hmc_batched``.
    Returns (samples (C, num_samples, D), info with ``step_size`` (C,) and
    ``inv_mass`` (C, D))."""
    samples, step, inv_mass, _ = _run(
        vmapped_lp_and_grad(logprob_fn), init_positions.T.contiguous(), seed, path, num_warmup,
        num_samples, segment, num_leapfrog, initial_step_size, target_accept, None)
    return samples, dict(step_size=step, inv_mass=inv_mass.T)


def run_hmc_batched_checkpointed(
    lp_and_grad_batched: LpAndGrad,
    init_positions: Tensor,
    seed: int,
    path: str,
    num_warmup: int = 300,
    num_samples: int = 300,
    segment: int = 100,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    chain_ids: Optional[Tensor] = None,
) -> Tuple[Tensor, dict]:
    """The segment-checkpointed :func:`samplers.hmc_batched` over the
    ensemble-last ``init_positions`` (T, E): the same samples and info
    (``step_size`` (E,), ``inv_mass`` (E, T), ``mean_accept`` (E,)) as one
    uninterrupted ``hmc_batched`` call, however often it is killed and
    resumed."""
    samples, step, inv_mass, accept_sum = _run(
        lp_and_grad_batched, init_positions, seed, path, num_warmup, num_samples, segment,
        num_leapfrog, initial_step_size, target_accept, chain_ids)
    return samples, dict(step_size=step, inv_mass=inv_mass.T,
                         mean_accept=accept_sum / max(num_samples, 1))
