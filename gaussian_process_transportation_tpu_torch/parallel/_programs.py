"""Rank programs that run the multi-device paths at small sizes.

Each function runs in every rank of ``_launch.launch`` (so it is a
module-level function of the package, and imports neither JAX nor the JAX
package), builds the meshes it is asked for over the ranks, runs the paths
on them and returns the results, which the launcher hands back as CPU
tensors.  The package's CPU tests launch them on gloo ranks and hold the
results against the JAX package's and against runs in one process.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..convert import sharded_cholesky_from_jax
from . import smc
from .distributed import process_local_slice
from .ensemble import make_ensemble_train_step, posterior_transport_ensemble, transport_ensemble
from .mesh import axis_of, ensemble_sharding, global_put, make_mesh, replicated
from .samplers import sample_gp_posterior
from .sharded_chol import sharded_gram_cholesky_solve
from .sharded_lml import fit_sharded, make_sharded_lml, sharded_lml_value_and_grad


def _mesh(n_data: int):
    """The (world / n_data, n_data) mesh of the CPU ranks."""
    return make_mesh(dist.get_world_size() // n_data, n_data, "cpu")


def mesh_layout(shapes, total: int):
    """The default group (formed by ``distributed.initialize`` from the
    environment alone, as ``_launch`` calls it): its rank, size and
    backend.  For each (n_ens, n_data) in ``shapes``: each axis' size, this
    rank's index, the members' global ranks and the group's backend; this
    rank's ``global_put`` of a (total, 3) array under the ensemble sharding
    and whether the replicated one is the array itself; the shards gathered
    back; the data axis' sum of the ranks.  And ``process_local_slice``."""
    x = torch.arange(total * 3, dtype=torch.float64).reshape(total, 3)
    out = {"process_local_slice": process_local_slice(total),
           "group": (dist.get_rank(), dist.get_world_size(), dist.get_backend())}
    for n_ens, n_data in shapes:
        mesh = make_mesh(n_ens, n_data, "cpu")
        rec = {}
        for axis in ("ens", "data"):
            ax = axis_of(mesh, axis)
            rec[axis] = dict(size=ax.size, index=ax.index, ranks=ax.ranks,
                             backend=dist.get_backend(mesh[axis].get_group()))
        put = global_put(x, ensemble_sharding(mesh))
        rec.update(put=put, replicated_is_x=global_put(x, replicated(mesh)) is x,
                   gathered=axis_of(mesh, "ens").gather(put, total),
                   data_sum=axis_of(mesh, "data").all_reduce(
                       torch.tensor([float(dist.get_rank())])))
        out[(n_ens, n_data)] = rec
    return out


def fail_before_collective(bad_rank: int):
    """Rank ``bad_rank`` raises; the others wait in an ``all_reduce``."""
    if dist.get_rank() == bad_rank:
        raise RuntimeError(f"injected failure on rank {bad_rank}")
    dist.all_reduce(torch.ones(1))


def hang():
    """Rank 0 waits for a broadcast that rank 1, asleep, never sends."""
    if dist.get_rank() == 0:
        dist.broadcast(torch.zeros(1), src=1)
    else:
        time.sleep(3600)


def sharded_cholesky_cases(cases):
    """Per case (X, Y, lengthscale, amplitude, noise, block, family, n_data,
    b, and optionally ``precision`` and ``jax``, a JAX factor's arrays): α,
    log det and a solve of b through the factor; with ``jax``, the solve
    and log det through the JAX factor carried into the port."""
    out = []
    for c in cases:
        mesh = _mesh(c["n_data"])
        alpha, chol = sharded_gram_cholesky_solve(c["X"], c["Y"], c["lengthscale"],
                                                  c["amplitude"], c["noise"], mesh,
                                                  block=c["block"], family=c["family"],
                                                  precision=c.get("precision", "highest"))
        rec = dict(alpha=alpha, logdet=chol.logdet(),
                   resolve=chol.solve(c["b"], c.get("precision", "highest")))
        if "jax" in c:
            carried = sharded_cholesky_from_jax(c["jax"], axis_of(mesh, "data").index, mesh,
                                                dtype=c["X"].dtype, device="cpu")
            rec.update(jax_solve=carried.solve(c["b"]), jax_logdet=carried.logdet())
        out.append(rec)
    return out


def sharded_lml_cases(cases):
    """Per case (X, Y, family, log_amp, log_ls, log_noise, block, n_data,
    and ``kind``, optionally ``precision``): "value_and_grad" gives the
    value and gradient;
    "autograd" the value and θ's gradients through ``make_sharded_lml``;
    "fit" ``fit_sharded``'s θ and trace (``kernel``, ``maxiter``)."""
    out = []
    for c in cases:
        mesh = _mesh(c["n_data"])
        precision = c.get("precision", "highest")
        if c["kind"] == "value_and_grad":
            val, g = sharded_lml_value_and_grad(c["X"], c["Y"], c["family"], c["log_amp"],
                                                c["log_ls"], c["log_noise"], mesh,
                                                block=c["block"], precision=precision)
            out.append(dict(value=val, grad=g))
        elif c["kind"] == "autograd":
            theta = {k: c[k].clone().requires_grad_(True)
                     for k in ("log_amp", "log_ls", "log_noise")}
            val = make_sharded_lml(c["family"], mesh, block=c["block"],
                                   precision=precision)(theta, c["X"], c["Y"])
            val.backward()
            out.append(dict(value=val, grad={k: t.grad for k, t in theta.items()}))
        else:
            _, theta, vals = fit_sharded(c["kernel"], c["X"], c["Y"], mesh, maxiter=c["maxiter"],
                                         block=c["block"], precision=c.get("precision"))
            out.append(dict(theta=theta, vals=vals))
    return out


def ensemble_cases(kernel, S, S1, targets, X, dX, n_ens_list, steps: int, n_members: int,
                   seed: int):
    """For each ``ens`` size: the transport ensemble, ``steps`` joint Adam
    steps (θ and loss after each) and ``n_members`` posterior draws from a
    generator seeded ``seed``."""
    out = {}
    sources = S.expand(targets.shape[0], *S.shape)
    for n_ens in n_ens_list:
        mesh = make_mesh(n_ens, dist.get_world_size() // n_ens, "cpu")
        step, optimizer = make_ensemble_train_step(kernel, mesh=mesh)
        theta = kernel.theta
        state = optimizer.init(theta)
        thetas, losses = [], []
        for _ in range(steps):
            theta, state, loss = step(theta, state, sources, targets)
            thetas.append(theta)
            losses.append(loss)
        out[n_ens] = dict(
            transport=transport_ensemble(kernel, S, targets, X, dX, mesh=mesh),
            thetas=torch.stack(thetas), losses=torch.stack(losses),
            posterior=posterior_transport_ensemble(kernel, S, S1, X, n_members,
                                                   torch.Generator().manual_seed(seed),
                                                   mesh=mesh))
    return out


def sampler_cases(kernel, X, Y, hmc_kw, chain_counts, smc_kernel, S, S1, traj, goal,
                  n_particles: int, smc_steps: int):
    """Mesh HMC over ``ens`` (all ranks) for each chain count; then SMC:
    ``init_particles`` and ``smc_steps`` steps of the goal likelihood
    (generators seeded 0 and 1), the final trajectories gathered."""
    mesh = _mesh(1)
    out = {c: sample_gp_posterior(kernel, X, Y, num_chains=c, mesh=mesh, **hmc_kw)
           for c in chain_counts}
    p = smc.init_particles(smc_kernel, S, S1, traj, n_particles,
                           torch.Generator().manual_seed(0), mesh=mesh)
    gen, esss = torch.Generator().manual_seed(1), []
    for _ in range(smc_steps):
        p, ess = smc.smc_step(p, smc.goal_likelihood(goal, 0.5), gen, mesh=mesh)
        esss.append(ess)
    out["smc"] = dict(local=p.trajectories, log_weights=p.log_weights, ess=torch.stack(esss),
                      trajectories=axis_of(mesh, "ens").gather(p.trajectories, n_particles))
    return out
