"""Hamiltonian Monte Carlo and NUTS over GP kernel hyperparameters, on one
device.

Port of the single-device part of
``gaussian_process_transportation_tpu/parallel/samplers.py``:

* ``hmc_batched`` (with ``hmc_batched_warmup`` and
  ``hmc_batched_sample_range``) and ``nuts_batched``: all chains in one
  ensemble-last state (positions (T, E)), leapfrog HMC or iterative NUTS
  (doubling, multinomial proposal, no U-turn check inside a subtree) with
  per-chain dual-averaging step sizes and a Welford diagonal mass over two
  warm-up windows.  The caller gives the batched log-density and gradient,
  so no autograd runs.
* ``hmc`` (``hmc_warmup``, ``hmc_sample_range``) and ``nuts``: one chain
  over a log-density that ``torch.func`` differentiates, the batched
  machinery at E = 1.
* ``sample_gp_posterior``: chains over p(θ | X, Y) ∝ exp(LML) with a soft
  barrier at the kernel's log-bounds.  The fused route (the
  C·stationary(+White) family, n ≤ 32, p ≤ 8, HMC or NUTS) makes every
  leapfrog step one call of the fused LML kernel
  (``ops.fused_lml.small_lml_value_grad``) on the card, or its plain twin
  for CPU tensors; the generic route (any kernel, any n and p) runs the
  chains batched over ``torch.func.vmap`` of the gradient of
  ``models.exact_gp.log_marginal_likelihood``.
  Under a mesh (``mesh=``) the chains shard over ``ens``: each rank runs
  its contiguous chains, keyed by their global indices, and the samples
  and per-chain diagnostics are gathered by broadcasts.
* ``split_rhat`` and ``effective_sample_size``.

Randomness is per chain, as in JAX: every draw is a counter-based hash
(``chain_bits``) of (seed, global chain index, phase, step, slot), phase
0 and 1 the warm-up windows, 2 sampling and 3 the initial positions;
momenta come from it by Box–Muller.  An HMC step takes slots [0, 2T] (T
normals and the accept uniform); a NUTS step slots [0, 2T) for the
momentum, then per tree depth the direction and merge uniforms, then one
selection uniform per leapfrog step (``_nuts_slots``).  So chain e draws
the same numbers however many chains run beside it (a run of chains
[0, k) equals the first k chains of a longer run), and a segmented warm-up
plus sample range equals the monolithic run bit for bit.
The hash is integer tensor arithmetic below 2⁶³, so a CPU and a CUDA
tensor give the same integers.  The numbers differ from JAX's keys.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from .mesh import axis_of

LpAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]
State = Tuple[Tensor, Tensor, Tensor]  # positions (T, E), log-density (E,), gradient (T, E)

_WARMUP_1, _WARMUP_2, _SAMPLING, _INIT = 0, 1, 2, 3
# sample_gp_posterior's fused route takes p ≤ 8 output columns, as JAX's
# route does; wider Y goes to the generic route.
FUSED_ROUTE_MAX_P = 8


class HMCState(NamedTuple):
    """One chain's state: position (T,), log-density (), gradient (T,)."""

    position: Tensor
    log_prob: Tensor
    grad: Tensor


_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # 2³² / φ, odd: spreads small counters over all 32 bits


def _mix32(x: Tensor) -> Tensor:
    """A 32-bit integer hash with full avalanche (T. Mueller's, multiplier
    0x45d9f3b) on words held in int64: every operand is below 2³² and the
    multiplier below 2²⁷, so no product reaches 2⁶³."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    return (x >> 16) ^ x


def _hash_words(h: Tensor, *words: int) -> Tensor:
    """Fold each 32-bit word, spread by the golden-ratio multiplier, into
    the hashes ``h``."""
    for w in words:
        h = _mix32(h ^ ((w * _GOLDEN) & _MASK32))
    return h


def chain_keys(seed: int, chain_ids: Tensor) -> Tensor:
    """(E,) int64 keys of the chains ``chain_ids`` (their global indices,
    below 2³²) under ``seed``; a chain's key depends on its own index only."""
    return _hash_words(_mix32(chain_ids.to(torch.int64) & _MASK32), seed, seed >> 32)


def chain_bits(keys: Tensor, phase: int, steps, slots: int) -> Tensor:
    """(len(steps), slots, E) int64 draws of 24 bits: slot r of step s
    (below 2³⁰) of phase ``phase`` (0 … 3) for chain e is the top 24 bits of
    the hash of (keys[e], 4·s + phase, r).  Integer work only, so many steps
    at once give the same bits as one at a time."""
    words = torch.tensor([4 * s + phase for s in steps], dtype=torch.int64)
    h = _mix32(keys[None, :] ^ ((words.to(keys.device) * _GOLDEN) & _MASK32)[:, None])
    r = (torch.arange(slots, dtype=torch.int64, device=keys.device) * _GOLDEN) & _MASK32
    return _mix32(h[:, None, :] ^ r[None, :, None]) >> 8


def chain_uniforms(keys: Tensor, phase: int, step: int, slots: int, dtype) -> Tensor:
    """(slots, E) uniforms in [0, 1) of step ``step`` of phase ``phase``:
    ``chain_bits`` over 2²⁴."""
    return chain_bits(keys, phase, [step], slots)[0].to(dtype) * (2.0 ** -24)


def _box_muller(bits: Tensor, rows: int, dtype) -> Tuple[Tensor, Tensor]:
    """(normals (rows, E) from slots [0, 2·rows), the accept uniform (E,)
    from slot 2·rows) of one trajectory's (2·rows + 1, E) bits."""
    u = bits.to(dtype) * (2.0 ** -24)
    radius = torch.sqrt(-2.0 * torch.log1p(-u[:rows]))  # 1 − u lies in (0, 1]
    return radius * torch.cos((2.0 * np.pi) * u[rows:2 * rows]), u[2 * rows]


_DRAW_CHUNK = 64  # steps whose bits are hashed together


def _step_draws(keys: Tensor, phase: int, steps: range, rows: int, dtype):
    """One trajectory's draws for each step in ``steps``, in order: (normals
    (rows, E) by Box–Muller, the accept uniform (E,)).  The bits of up to
    ``_DRAW_CHUNK`` steps are hashed at once, the float work is done step by
    step, so a step's draws do not depend on how the steps are cut."""
    for c0 in range(0, len(steps), _DRAW_CHUNK):
        for bits in chain_bits(keys, phase, steps[c0:c0 + _DRAW_CHUNK], 2 * rows + 1):
            yield _box_muller(bits, rows, dtype)


def _nuts_slots(rows: int, max_depth: int) -> Dict[str, int]:
    """Where a NUTS step's draws lie among its slots: the momentum's normals
    from [0, 2·rows), the direction uniform of depth d at ``dir`` + d, its
    merge uniform at ``merge`` + d, and the selection uniform of leapfrog
    step i of depth d at ``select`` + 2^d − 1 + i; ``total`` slots in all."""
    base = 2 * rows
    return dict(dir=base, merge=base + max_depth, select=base + 2 * max_depth,
                total=base + 2 * max_depth + 2**max_depth - 1)


def _nuts_draws(keys: Tensor, phase: int, steps: range, rows: int, max_depth: int, dtype):
    """One NUTS transition's draws for each step in ``steps``, in order:
    (momentum normals (rows, E), direction uniforms (max_depth, E), merge
    uniforms (max_depth, E), selection uniforms (2^max_depth − 1, E)), laid
    out by ``_nuts_slots``; hashed a few steps at once, as ``_step_draws``."""
    at = _nuts_slots(rows, max_depth)
    chunk = max(1, _DRAW_CHUNK * (2 * rows + 1) // at["total"])
    for c0 in range(0, len(steps), chunk):
        for bits in chain_bits(keys, phase, steps[c0:c0 + chunk], at["total"]):
            z, _ = _box_muller(bits[:2 * rows + 1], rows, dtype)
            u = bits[2 * rows:].to(dtype) * (2.0 ** -24)
            yield (z, u[:max_depth], u[max_depth:2 * max_depth], u[2 * max_depth:])


def _dual_averaging_init(step_size0: Tensor) -> Dict[str, Tensor]:
    log_step = torch.log(step_size0)
    return dict(log_step=log_step, log_step_avg=log_step, h_avg=torch.zeros_like(log_step),
                mu=torch.log(10.0 * step_size0), t=torch.zeros_like(log_step))


def _dual_averaging_update(state: Dict[str, Tensor], accept_prob: Tensor, target=0.8,
                           gamma=0.05, t0=10.0, kappa=0.75) -> Dict[str, Tensor]:
    t = state["t"] + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * state["h_avg"] + (target - accept_prob) / (t + t0)
    log_step = state["mu"] - torch.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state["log_step_avg"]
    return dict(log_step=log_step, log_step_avg=log_step_avg, h_avg=h_avg, mu=state["mu"], t=t)


def _keys_of(seed: int, E: int, device, chain_ids: Optional[Tensor]) -> Tensor:
    """The keys of E chains; ``chain_ids`` None means chains 0 … E−1."""
    if chain_ids is None:
        chain_ids = torch.arange(E, device=device)
    if chain_ids.shape != (E,):
        raise ValueError(f"chain_ids must be ({E},), got {tuple(chain_ids.shape)}")
    return chain_keys(seed, chain_ids.to(device))


def _batched_machinery(lp_and_grad_batched: LpAndGrad, num_leapfrog: int):
    """``one_step(state, draws, step, inv_mass)``: one Metropolis-adjusted
    leapfrog trajectory of every chain with the draws (momenta, accept
    uniforms) of ``_step_draws``; returns (state, accept_prob (E,))."""

    def leapfrog(q, p, g, step, inv_mass):
        lp = None
        for _ in range(num_leapfrog):
            p = p + 0.5 * step[None, :] * g
            q = q + step[None, :] * inv_mass * p
            lp, g = lp_and_grad_batched(q)
            p = p + 0.5 * step[None, :] * g
        return q, p, g, lp

    def one_step(state: State, draws: Tuple[Tensor, Tensor], step: Tensor, inv_mass: Tensor):
        q0, lp0, g0 = state
        z, u = draws
        p0 = z / torch.sqrt(inv_mass)
        q, p, g, lp = leapfrog(q0, p0, g0, step, inv_mass)
        ke0 = 0.5 * (p0 * p0 * inv_mass).sum(0)
        ke1 = 0.5 * (p * p * inv_mass).sum(0)
        accept_prob = torch.clamp(torch.exp((lp - ke1) - (lp0 - ke0)), max=1.0)
        accept = u < accept_prob
        state = (torch.where(accept[None, :], q, q0), torch.where(accept, lp, lp0),
                 torch.where(accept[None, :], g, g0))
        return state, accept_prob

    return one_step


def _batched_adaptation(one_step, draws, state0: State, num_warmup: int,
                        initial_step_size: float, target_accept: float):
    """The two-window dual-averaging and Welford adaptation, generic over
    the transition ``one_step(state, draws, step, inv_mass)`` and its draws
    ``draws(phase, steps)``; returns (state, step (E,), inv_mass (T, E))."""
    q0 = state0[0]
    T, E = q0.shape
    state = state0
    da = _dual_averaging_init(torch.full((E,), initial_step_size, dtype=q0.dtype,
                                         device=q0.device))
    inv_mass = torch.ones_like(q0)
    half = num_warmup // 2
    for phase, steps in ((_WARMUP_1, half), (_WARMUP_2, num_warmup - half)):
        mean, m2, count = torch.zeros_like(q0), torch.zeros_like(q0), 0.0
        for d in draws(phase, range(steps)):
            state, accept_prob = one_step(state, d, torch.exp(da["log_step"]), inv_mass)
            da = _dual_averaging_update(da, accept_prob, target=target_accept)
            count += 1.0
            delta = state[0] - mean
            mean = mean + delta / count
            m2 = m2 + delta * (state[0] - mean)
        if phase == _WARMUP_1:
            # the mass from the first window's variance; dual averaging restarts
            inv_mass = torch.clamp(m2 / max(count - 1.0, 1.0), 1e-4, 1e4)
            da = _dual_averaging_init(torch.exp(da["log_step_avg"]))
    return state, torch.exp(da["log_step_avg"]), inv_mass


def hmc_batched_warmup(
    lp_and_grad_batched: LpAndGrad,
    init_positions: Tensor,
    seed: int = 0,
    num_warmup: int = 500,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    chain_ids: Optional[Tensor] = None,
) -> Tuple[State, Tensor, Tensor]:
    """The adaptation phase of :func:`hmc_batched` alone: returns
    (state (q, lp, g), step (E,), inv_mass (T, E)), exactly what
    :func:`hmc_batched` holds when sampling starts."""
    T, E = init_positions.shape
    keys = _keys_of(seed, E, init_positions.device, chain_ids)
    lp0, g0 = lp_and_grad_batched(init_positions)
    return _batched_adaptation(
        _batched_machinery(lp_and_grad_batched, num_leapfrog),
        lambda phase, steps: _step_draws(keys, phase, steps, T, init_positions.dtype),
        (init_positions, lp0, g0), num_warmup, initial_step_size, target_accept)


def hmc_batched_sample_range(
    lp_and_grad_batched: LpAndGrad,
    state: State,
    seed: int,
    start: int,
    stop: int,
    step: Tensor,
    inv_mass: Tensor,
    num_leapfrog: int = 16,
    chain_ids: Optional[Tensor] = None,
) -> Tuple[State, Tensor, Tensor]:
    """Samples [start, stop) of the stream :func:`hmc_batched` draws: step s
    hashes (chain, 2, s) however the run is cut.  Returns (state, samples
    (E, stop − start, T), accept_probs (stop − start, E))."""
    q = state[0]
    keys = _keys_of(seed, q.shape[1], q.device, chain_ids)
    one_step = _batched_machinery(lp_and_grad_batched, num_leapfrog)
    samples, accepts = [], []
    for draws in _step_draws(keys, _SAMPLING, range(start, stop), q.shape[0], q.dtype):
        state, a = one_step(state, draws, step, inv_mass)
        samples.append(state[0])
        accepts.append(a)
    q = state[0]
    samples = torch.stack(samples, 0) if samples else q.new_zeros((0,) + q.shape)
    accepts = torch.stack(accepts, 0) if accepts else q.new_zeros((0, q.shape[1]))
    return state, samples.permute(2, 0, 1), accepts


def hmc_batched(
    lp_and_grad_batched: LpAndGrad,
    init_positions: Tensor,
    seed: int = 0,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    chain_ids: Optional[Tensor] = None,
) -> Tuple[Tensor, dict]:
    """All chains of an ensemble-last state in one loop of HMC steps.

    ``lp_and_grad_batched(q (T, E)) -> (lp (E,), grad (T, E))`` evaluates
    every chain at once (for the GP hyperposterior, one fused-kernel
    launch).  Step size and mass adapt per chain.  ``chain_ids`` (E,) are
    the chains' global indices, which key their draws (default 0 … E−1;
    a shard passes its own).  Calls
    ``lp_and_grad_batched`` 1 + (num_warmup + num_samples)·num_leapfrog
    times.  Returns (samples (E, S, T), info with ``step_size`` (E,),
    ``inv_mass`` (E, T) and ``mean_accept`` (E,))."""
    state, step, inv_mass = hmc_batched_warmup(
        lp_and_grad_batched, init_positions, seed, num_warmup, num_leapfrog,
        initial_step_size, target_accept, chain_ids)
    state, samples, accepts = hmc_batched_sample_range(
        lp_and_grad_batched, state, seed, 0, num_samples, step, inv_mass, num_leapfrog,
        chain_ids)
    return samples, dict(step_size=step, inv_mass=inv_mass.T, mean_accept=accepts.mean(0))


def _nuts_batched_machinery(lp_and_grad_batched: LpAndGrad, max_depth: int):
    """``one_step(state, draws, step, inv_mass)``: one NUTS transition of
    every chain with the draws of ``_nuts_draws``; returns (state,
    accept statistic (E,), tree depth (E,)).

    The JAX tree policy: iterative doubling to ``max_depth``, a multinomial
    proposal across each subtree and between subtree and tree, the U-turn
    check between the tree's ends after each doubling, no check inside a
    subtree.  Every leapfrog step is one call of ``lp_and_grad_batched`` for
    all chains.  A round runs while any chain is still building (one host
    read a round); finished chains compute and keep nothing (``where``)."""

    def one_step(state: State, draws, step: Tensor, inv_mass: Tensor):
        q0, lp0, g0 = state
        z, u_dir, u_merge, u_sel = draws
        E = q0.shape[1]
        p0 = z / torch.sqrt(inv_mass)
        H0 = -lp0 + 0.5 * (p0 * p0 * inv_mass).sum(0)
        zeros = torch.zeros_like(lp0)
        no = torch.zeros(E, dtype=torch.bool, device=q0.device)
        t = dict(q_l=q0, p_l=p0, g_l=g0, q_r=q0, p_r=p0, g_r=g0, q_prop=q0, lp_prop=lp0,
                 g_prop=g0, log_w=-H0, turning=no, diverged=no, sum_accept=zeros,
                 n_leap=zeros, depth=zeros)
        for depth in range(max_depth):
            active = ~t["turning"] & ~t["diverged"]
            if not bool(active.any()):  # every chain's tree is done: no round runs
                break
            go_right = u_dir[depth] < 0.5
            eps = torch.where(go_right, step, -step)[None, :]
            right = go_right[None, :]
            q = torch.where(right, t["q_r"], t["q_l"])
            p = torch.where(right, t["p_r"], t["p_l"])
            g = torch.where(right, t["g_r"], t["g_l"])
            log_w_sub = torch.full_like(lp0, -math.inf)
            q_p, lp_p, g_p = t["q_prop"], t["lp_prop"], t["g_prop"]
            sum_a, div = zeros, no
            for i in range(2**depth):
                p_half = p + 0.5 * eps * g
                q = q + eps * inv_mass * p_half
                lp, g = lp_and_grad_batched(q)
                p = p_half + 0.5 * eps * g
                dH = H0 - (-lp + 0.5 * (p * p * inv_mass).sum(0))
                div = div | (dH < -1000.0)
                log_w_new = torch.logaddexp(log_w_sub, dH)
                take = torch.log(u_sel[2**depth - 1 + i]) < dH - log_w_new
                log_w_sub = log_w_new
                q_p = torch.where(take[None, :], q, q_p)
                lp_p = torch.where(take, lp, lp_p)
                g_p = torch.where(take[None, :], g, g_p)
                sum_a = sum_a + torch.clamp(torch.exp(dH), max=1.0)
            log_w_tot = torch.logaddexp(t["log_w"], log_w_sub)
            sel = active & (torch.log(u_merge[depth]) < log_w_sub - log_w_tot)
            upd_r = (active & go_right)[None, :]
            upd_l = (active & ~go_right)[None, :]
            ends = {}
            for side, upd in (("l", upd_l), ("r", upd_r)):
                for name, new in (("q", q), ("p", p), ("g", g)):
                    ends[f"{name}_{side}"] = torch.where(upd, new, t[f"{name}_{side}"])
            dq = ends["q_r"] - ends["q_l"]
            turn = ((dq * inv_mass * ends["p_l"]).sum(0) < 0) | \
                ((dq * inv_mass * ends["p_r"]).sum(0) < 0)
            t = dict(**ends,
                     q_prop=torch.where(sel[None, :], q_p, t["q_prop"]),
                     lp_prop=torch.where(sel, lp_p, t["lp_prop"]),
                     g_prop=torch.where(sel[None, :], g_p, t["g_prop"]),
                     log_w=torch.where(active, log_w_tot, t["log_w"]),
                     turning=torch.where(active, turn, t["turning"]),
                     diverged=torch.where(active, t["diverged"] | div, t["diverged"]),
                     sum_accept=t["sum_accept"] + torch.where(active, sum_a, zeros),
                     n_leap=t["n_leap"] + torch.where(active, zeros + 2**depth, zeros),
                     depth=t["depth"] + active.to(lp0.dtype))
        accept_stat = t["sum_accept"] / torch.clamp(t["n_leap"], min=1.0)
        return (t["q_prop"], t["lp_prop"], t["g_prop"]), accept_stat, t["depth"]

    return one_step


def nuts_batched(
    lp_and_grad_batched: LpAndGrad,
    init_positions: Tensor,
    seed: int = 0,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 8,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    chain_ids: Optional[Tensor] = None,
) -> Tuple[Tensor, dict]:
    """All chains of an ensemble-last state in one loop of NUTS transitions:
    :func:`hmc_batched`'s contract (``lp_and_grad_batched(q (T, E)) ->
    (lp (E,), grad (T, E))``, finite-guarded by the caller; per-chain
    draws keyed by ``chain_ids``; the same two-window adaptation), the tree
    of JAX's ``nuts_batched``.  Returns (samples (E, S, T), info with
    ``step_size`` (E,), ``inv_mass`` (E, T), ``mean_accept`` (E,) and
    ``mean_tree_depth`` (E,) over the sampling steps)."""
    T, E = init_positions.shape
    dtype = init_positions.dtype
    keys = _keys_of(seed, E, init_positions.device, chain_ids)
    one_step = _nuts_batched_machinery(lp_and_grad_batched, max_depth)
    lp0, g0 = lp_and_grad_batched(init_positions)
    state, step, inv_mass = _batched_adaptation(
        lambda st, d, stp, im: one_step(st, d, stp, im)[:2],
        lambda phase, steps: _nuts_draws(keys, phase, steps, T, max_depth, dtype),
        (init_positions, lp0, g0), num_warmup, initial_step_size, target_accept)
    samples, accepts, depths = [], [], []
    for d in _nuts_draws(keys, _SAMPLING, range(num_samples), T, max_depth, dtype):
        state, a, depth = one_step(state, d, step, inv_mass)
        samples.append(state[0])
        accepts.append(a)
        depths.append(depth)
    q = state[0]
    samples = torch.stack(samples, 0) if samples else q.new_zeros((0,) + q.shape)
    accepts = torch.stack(accepts, 0) if accepts else q.new_zeros((0, E))
    depths = torch.stack(depths, 0) if depths else q.new_zeros((0, E))
    return samples.permute(2, 0, 1), dict(step_size=step, inv_mass=inv_mass.T,
                                          mean_accept=accepts.mean(0),
                                          mean_tree_depth=depths.mean(0))


# ---- one chain over an autograd log-density --------------------------------

def vmapped_lp_and_grad(logprob_fn: Callable[[Tensor], Tensor]) -> LpAndGrad:
    """The batched value and gradient (T, E) of a log-density of one (T,)
    position, every chain in one ``torch.func.vmap`` of its gradient; a
    non-finite value reads −1e10 and a non-finite gradient entry 0 (JAX's
    guard)."""
    from torch.func import grad_and_value, vmap

    vg = vmap(grad_and_value(logprob_fn))

    def lp_and_grad(q: Tensor) -> Tuple[Tensor, Tensor]:
        g, lp = vg(q.T)
        lp = torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -1e10))
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        return lp, g.T

    return lp_and_grad


def _chain_id(chain_id: int, device) -> Tensor:
    return torch.tensor([chain_id], device=device)


def hmc_warmup(
    logprob_fn: Callable[[Tensor], Tensor],
    init_position: Tensor,
    seed: int = 0,
    num_warmup: int = 500,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    chain_id: int = 0,
) -> Tuple[HMCState, Tensor, Tensor]:
    """The adaptation phase of :func:`hmc` alone: (state, step size (),
    inv_mass (T,)), exactly what :func:`hmc` holds when sampling starts."""
    (q, lp, g), step, inv_mass = hmc_batched_warmup(
        vmapped_lp_and_grad(logprob_fn), init_position[:, None], seed, num_warmup, num_leapfrog,
        initial_step_size, target_accept, _chain_id(chain_id, init_position.device))
    return HMCState(q[:, 0], lp[0], g[:, 0]), step[0], inv_mass[:, 0]


def hmc_sample_range(
    logprob_fn: Callable[[Tensor], Tensor],
    state: HMCState,
    seed: int,
    num_samples_total: int,
    start: int,
    stop: int,
    step_size: Tensor,
    inv_mass: Tensor,
    num_leapfrog: int = 16,
    chain_id: int = 0,
) -> Tuple[HMCState, Tensor, Tensor]:
    """Samples [start, stop) of the stream :func:`hmc` draws with
    ``num_samples=num_samples_total`` (the hash keys a step by its index, so
    the total only bounds the range).  Returns (state, samples (stop −
    start, T), accept_probs (stop − start,))."""
    if not 0 <= start <= stop <= num_samples_total:
        raise ValueError(f"need 0 <= start <= stop <= {num_samples_total}, got {start}, {stop}")
    batched = (state.position[:, None], state.log_prob.reshape(1), state.grad[:, None])
    (q, lp, g), samples, accepts = hmc_batched_sample_range(
        vmapped_lp_and_grad(logprob_fn), batched, seed, start, stop, step_size.reshape(1),
        inv_mass[:, None], num_leapfrog, _chain_id(chain_id, state.position.device))
    return HMCState(q[:, 0], lp[0], g[:, 0]), samples[0], accepts[:, 0]


def hmc(
    logprob_fn: Callable[[Tensor], Tensor],
    init_position: Tensor,
    seed: int = 0,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    chain_id: int = 0,
) -> Tuple[Tensor, dict]:
    """Single-chain HMC over a log-density ``logprob_fn((T,)) -> ()`` that
    ``torch.func`` differentiates: :func:`hmc_batched` at one chain, whose
    draws are those of chain ``chain_id`` in a batched run.  Returns
    (samples (num_samples, T), info with ``step_size`` (), ``inv_mass``
    (T,) and ``mean_accept`` ())."""
    state, step, inv_mass = hmc_warmup(logprob_fn, init_position, seed, num_warmup,
                                       num_leapfrog, initial_step_size, target_accept, chain_id)
    _, samples, accepts = hmc_sample_range(logprob_fn, state, seed, num_samples, 0, num_samples,
                                           step, inv_mass, num_leapfrog, chain_id)
    return samples, dict(step_size=step, inv_mass=inv_mass, mean_accept=accepts.mean())


def nuts(
    logprob_fn: Callable[[Tensor], Tensor],
    init_position: Tensor,
    seed: int = 0,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 8,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    chain_id: int = 0,
) -> Tuple[Tensor, dict]:
    """Single-chain NUTS over a log-density that ``torch.func``
    differentiates: :func:`nuts_batched` at one chain.  Returns (samples
    (num_samples, T), info with ``step_size`` (), ``inv_mass`` (T,),
    ``mean_accept`` () and ``mean_tree_depth`` ())."""
    samples, info = nuts_batched(vmapped_lp_and_grad(logprob_fn), init_position[:, None], seed,
                                 num_warmup, num_samples, max_depth, initial_step_size,
                                 target_accept, _chain_id(chain_id, init_position.device))
    return samples[0], {k: v[0] for k, v in info.items()}


def split_rhat(chains: Tensor) -> Tensor:
    """Split-R̂ per dimension; chains (C, S, D) → (D,)."""
    C, S, D = chains.shape
    half = S // 2
    x = chains[:, :2 * half, :].reshape(C * 2, half, D)
    m = x.mean(1)
    w = x.var(1, correction=1).mean(0)
    b = half * m.var(0, correction=1)
    var_plus = (half - 1) / half * w + b / half
    return torch.sqrt(var_plus / torch.clamp(w, min=1e-30))


def effective_sample_size(chains: Tensor, max_lag: int = 100) -> Tensor:
    """Bulk ESS per dimension from the autocorrelation (Geyer's initial
    positive sequence, truncated); chains (C, S, D) → (D,)."""
    C, S, D = chains.shape
    x = chains - chains.mean(1, keepdim=True)
    max_lag = min(max_lag, S - 1)
    den = (x * x).mean((0, 1))
    rhos = torch.stack([(x[:, :S - lag] * x[:, lag:]).sum((0, 1)) / max(C * (S - lag), 1)
                        / torch.clamp(den, min=1e-30) for lag in range(1, max_lag + 1)])
    positive = torch.cumprod((rhos > -0.05).to(rhos.dtype), 0)
    tau = 1.0 + 2.0 * (rhos * positive).sum(0)
    return C * S / torch.clamp(tau, min=1.0)


def fused_lp_and_grad(X: Tensor, Y2: Tensor, lo_c: Tensor, hi_c: Tensor, family: str,
                      n_ls: int, has_noise: bool, jitter: float,
                      use_kernel: Optional[bool] = None) -> LpAndGrad:
    """The hyperposterior's batched log-density and gradient in the
    canonical layout: LML − 100·Σ softplus barrier at the log-bounds
    (lo_c, hi_c (T, 1)), the barrier's gradient in closed form; a
    non-finite lane gets lp = −1e10 and a zero gradient.

    ``use_kernel`` None takes the fused kernel for CUDA tensors and its
    plain twin for CPU ones; False forces the twin (the reference run on
    the card)."""
    from ..ops import fused_lml

    if use_kernel is None:
        use_kernel = X.device.type == "cuda"
    fn = fused_lml.small_lml_value_grad if use_kernel else fused_lml.small_lml_value_grad_ref

    def lp_and_grad(theta_te: Tensor) -> Tuple[Tensor, Tensor]:
        val, grad = fn(X, Y2, theta_te, family=family, n_ls=n_ls, has_noise=has_noise,
                       jitter=jitter)
        z_lo = (theta_te - lo_c) * 20.0
        z_hi = (theta_te - hi_c) * 20.0
        barrier = (torch.nn.functional.softplus(-z_lo) + torch.nn.functional.softplus(z_hi)).sum(0)
        d_barrier = 20.0 * (torch.sigmoid(z_hi) - torch.sigmoid(-z_lo))
        lp = val - 100.0 * barrier
        g = grad - 100.0 * d_barrier
        bad = ~torch.isfinite(lp)
        lp = torch.where(bad, torch.full_like(lp, -1e10), lp)
        g = torch.where(torch.isfinite(g) & ~bad[None, :], g, torch.zeros_like(g))
        return lp, g

    return lp_and_grad


def _barrier(theta: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """100·Σ softplus barrier at the log-bounds (the JAX sampler's)."""
    return 100.0 * (torch.nn.functional.softplus(-(theta - lo) * 20.0)
                    + torch.nn.functional.softplus((theta - hi) * 20.0)).sum(-1)


def generic_lp_and_grad(kernel, X: Tensor, Y: Tensor, lo: Tensor, hi: Tensor,
                        jitter: float) -> LpAndGrad:
    """The hyperposterior's batched log-density and gradient for any kernel:
    LML − the softplus barrier at the log-bounds (lo, hi (n_theta,)), in
    ``kernel.theta`` order, every chain at once (:func:`vmapped_lp_and_grad`
    of ``models.exact_gp.log_marginal_likelihood``)."""
    from ..models.exact_gp import log_marginal_likelihood

    def logprob(theta: Tensor) -> Tensor:
        return log_marginal_likelihood(kernel.with_theta(theta), X, Y, jitter) - \
            _barrier(theta, lo, hi)

    return vmapped_lp_and_grad(logprob)


def sample_gp_posterior(
    kernel,
    X: Tensor,
    Y: Tensor,
    seed: int = 0,
    num_chains: int = 8,
    num_warmup: int = 300,
    num_samples: int = 300,
    algorithm: str = "hmc",
    mesh=None,
    jitter: float = 1e-10,
    fused: Optional[bool] = None,
    use_kernel: Optional[bool] = None,
    chain_ids: Optional[Tensor] = None,
    **kw,
):
    """Sample p(θ | X, Y) ∝ exp(LML) with a flat prior inside the kernel's
    log-bounds (a soft barrier at their edges).  Returns (samples (C, S,
    n_theta) in ``kernel.theta`` order, diagnostics with ``rhat``, ``ess``
    and ``mean_accept``, and for NUTS ``mean_tree_depth``).

    ``algorithm`` is "hmc" (:func:`hmc_batched`) or "nuts"
    (:func:`nuts_batched`); the chains start uniformly in the central half
    of the box and run ensemble-last.  Two routes, as in JAX:

    * fused, for a C·stationary(+White) kernel, n ≤ 32 and p ≤ 8: float32
      on X's device, every leapfrog step one launch of the fused LML
      kernel for CUDA tensors (``use_kernel`` False forces its twin) and
      the twin for CPU ones;
    * generic, for everything else (or ``fused=False``): any kernel, in
      X's dtype, every leapfrog step one batched evaluation of
      :func:`generic_lp_and_grad` for all chains.

    ``kw`` goes to the sampler (``num_leapfrog`` for HMC, ``max_depth`` for
    NUTS, ``initial_step_size``, ``target_accept``).  ``chain_ids``
    (num_chains,) are the chains' global indices (default 0 …
    num_chains−1): chain e's initial position and draws depend on its index
    alone.  Under a mesh the chains shard over ``ens``: every rank calls
    this with the same arguments, runs its contiguous share of the chains
    and gets all of them back (samples and per-chain diagnostics gathered
    by broadcasts), equal to the unsharded run chain for chain.  A chain
    count that ``ens`` does not divide runs unsharded on every rank, as in
    JAX."""
    if algorithm not in ("hmc", "nuts"):
        raise ValueError(f"algorithm must be 'hmc' or 'nuts', got {algorithm!r}")
    if chain_ids is None:
        chain_ids = torch.arange(num_chains, device=X.device)
    ens = axis_of(mesh, "ens")
    if num_chains % ens.size:
        ens = axis_of(None, "ens")
    rows = ens.shard(num_chains)
    samples, info = _run_chains(kernel, X, Y, seed, chain_ids[rows], num_warmup, num_samples,
                                algorithm, jitter, fused, use_kernel, kw)
    if ens.group is not None:
        samples = ens.gather(samples, num_chains)
        info = {k: ens.gather(v, num_chains) for k, v in info.items()}
    samples = samples.contiguous()  # one layout, so the diagnostics' sums round alike
    diags = dict(rhat=split_rhat(samples), ess=effective_sample_size(samples),
                 mean_accept=info["mean_accept"])
    if "mean_tree_depth" in info:
        diags["mean_tree_depth"] = info["mean_tree_depth"]
    return samples, diags


def _run_chains(kernel, X: Tensor, Y: Tensor, seed: int, chain_ids: Tensor, num_warmup: int,
                num_samples: int, algorithm: str, jitter: float, fused: Optional[bool],
                use_kernel: Optional[bool], kw) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The chains ``chain_ids`` of :func:`sample_gp_posterior` on this rank:
    (samples (C, S, n_theta), the per-chain ``mean_accept`` and, for NUTS,
    ``mean_tree_depth``)."""
    from ..models.exact_gp import small_lml_theta_layout
    from ..ops import fused_lml

    sampler = hmc_batched if algorithm == "hmc" else nuts_batched
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    layout = small_lml_theta_layout(kernel)
    use_fused = (layout is not None and X.shape[0] <= fused_lml.MAX_N
                 and Y2.shape[1] <= FUSED_ROUTE_MAX_P)
    if fused is not None:
        use_fused = bool(fused) and use_fused
    device = X.device
    dtype = torch.float32 if use_fused else X.dtype
    bounds = kernel.theta_bounds.to(dtype=dtype, device=device)
    lo, hi = bounds[:, 0], bounds[:, 1]
    num_chains = chain_ids.shape[0]
    keys = _keys_of(seed, num_chains, device, chain_ids)
    u = chain_uniforms(keys, _INIT, 0, lo.shape[0], dtype).T  # (num_chains, n_theta)
    inits = lo + u * (hi - lo) * 0.5 + 0.25 * (hi - lo)  # the central half of the box
    if use_fused:
        family, n_ls, has_noise, perm_np = layout
        perm = torch.as_tensor(perm_np, device=device)
        lp_and_grad = fused_lp_and_grad(
            X.to(torch.float32).contiguous(), Y2.to(torch.float32).contiguous(),
            lo[perm][:, None], hi[perm][:, None], family, n_ls, has_noise, jitter, use_kernel)
        samples_c, info = sampler(lp_and_grad, inits[:, perm].T.contiguous(), seed=seed,
                                  num_warmup=num_warmup, num_samples=num_samples,
                                  chain_ids=chain_ids, **kw)
        samples = samples_c[:, :, torch.as_tensor(np.argsort(perm_np), device=device)]
    else:
        lp_and_grad = generic_lp_and_grad(kernel, X, Y2.to(X.dtype), lo, hi, jitter)
        samples, info = sampler(lp_and_grad, inits.T.contiguous(), seed=seed,
                                num_warmup=num_warmup, num_samples=num_samples,
                                chain_ids=chain_ids, **kw)
    return samples, {k: info[k] for k in ("mean_accept", "mean_tree_depth") if k in info}
