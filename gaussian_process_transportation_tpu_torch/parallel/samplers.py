"""Hamiltonian Monte Carlo over GP kernel hyperparameters, on one device.

Port of the single-device part of
``gaussian_process_transportation_tpu/parallel/samplers.py``:

* ``hmc_batched`` (with ``hmc_batched_warmup`` and
  ``hmc_batched_sample_range``): all chains in one ensemble-last state
  (positions (T, E)), leapfrog HMC with per-chain dual-averaging step sizes
  and a Welford diagonal mass over two warm-up windows.  The caller gives
  the batched log-density and gradient, so no autograd runs.
* ``sample_gp_posterior``: chains over p(θ | X, Y) ∝ exp(LML) with a soft
  barrier at the kernel's log-bounds, for the C·stationary(+White) family
  at n ≤ 32 and p ≤ 8, every leapfrog step one call of the fused LML
  kernel (``ops.fused_lml.small_lml_value_grad``) on the card, or its
  plain twin for CPU tensors.
* ``split_rhat`` and ``effective_sample_size``.

Randomness is per chain, as in JAX: every draw is a counter-based hash
(``chain_bits``) of (seed, global chain index, phase, step, slot), phase
0 and 1 the warm-up windows, 2 sampling and 3 the initial positions;
momenta come from it by Box–Muller.  So chain e draws the same numbers
however many chains run beside it (a run of chains [0, k) equals the
first k chains of a longer run), and a segmented warm-up plus sample
range equals the monolithic run bit for bit.
The hash is integer tensor arithmetic below 2⁶³, so a CPU and a CUDA
tensor give the same integers.  The numbers differ from JAX's keys.

Not ported yet (each raises ``NotImplementedError``; ``ROADMAP.md``, queue
1): single-chain ``hmc`` and ``nuts``, ``nuts_batched``, the generic
(autograd) path of ``sample_gp_posterior`` and its ``mesh=`` sharding.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

LpAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]
State = Tuple[Tensor, Tensor, Tensor]  # positions (T, E), log-density (E,), gradient (T, E)

_WARMUP_1, _WARMUP_2, _SAMPLING, _INIT = 0, 1, 2, 3
_ROADMAP = "not ported yet: see ROADMAP.md, queue 1"
# sample_gp_posterior's fused route takes p ≤ 8 output columns, as JAX's
# route does; wider Y goes to the generic path (not ported yet).
FUSED_ROUTE_MAX_P = 8


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


def _batched_adaptation(one_step, keys: Tensor, state0: State, num_warmup: int,
                        initial_step_size: float, target_accept: float):
    """The two-window dual-averaging and Welford adaptation; returns
    (state, step (E,), inv_mass (T, E))."""
    q0 = state0[0]
    T, E = q0.shape
    state = state0
    da = _dual_averaging_init(torch.full((E,), initial_step_size, dtype=q0.dtype,
                                         device=q0.device))
    inv_mass = torch.ones_like(q0)
    half = num_warmup // 2
    for phase, steps in ((_WARMUP_1, half), (_WARMUP_2, num_warmup - half)):
        mean, m2, count = torch.zeros_like(q0), torch.zeros_like(q0), 0.0
        for draws in _step_draws(keys, phase, range(steps), T, q0.dtype):
            state, accept_prob = one_step(state, draws, torch.exp(da["log_step"]), inv_mass)
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
    keys = _keys_of(seed, init_positions.shape[1], init_positions.device, chain_ids)
    lp0, g0 = lp_and_grad_batched(init_positions)
    return _batched_adaptation(_batched_machinery(lp_and_grad_batched, num_leapfrog), keys,
                               (init_positions, lp0, g0), num_warmup, initial_step_size,
                               target_accept)


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


def hmc(*args, **kwargs):
    """Single-chain HMC over an autograd log-density."""
    raise NotImplementedError(f"hmc (one chain) is {_ROADMAP}")


def nuts(*args, **kwargs):
    """Single-chain NUTS over an autograd log-density."""
    raise NotImplementedError(f"nuts is {_ROADMAP}")


def nuts_batched(*args, **kwargs):
    """Ensemble-last batched NUTS."""
    raise NotImplementedError(f"nuts_batched is {_ROADMAP}")


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
    use_kernel: Optional[bool] = None,
    chain_ids: Optional[Tensor] = None,
    **kw,
):
    """Sample p(θ | X, Y) ∝ exp(LML) with a flat prior inside the kernel's
    log-bounds (a soft barrier at their edges).  Returns (samples (C, S,
    n_theta) in ``kernel.theta`` order, diagnostics with ``rhat``, ``ess``
    and ``mean_accept``).

    The route ported here is the fused one: ``algorithm="hmc"``, a
    C·stationary(+White) kernel, n ≤ 32 and p ≤ 8.  All chains run
    ensemble-last through :func:`hmc_batched`, started uniformly in the
    central half of the box, in float32 on X's device; every leapfrog step
    is one launch of the fused LML kernel for CUDA tensors (``use_kernel``
    False forces its twin) and the twin for CPU ones.  ``kw`` goes to
    :func:`hmc_batched` (``num_leapfrog``, ``initial_step_size``,
    ``target_accept``).  ``chain_ids`` (num_chains,) are the chains'
    global indices (default 0 … num_chains−1): chain e's initial position
    and draws depend on its index alone."""
    from ..models.exact_gp import small_lml_theta_layout
    from ..ops import fused_lml

    if mesh is not None:
        raise NotImplementedError(f"sample_gp_posterior(mesh=...) is {_ROADMAP}")
    if algorithm != "hmc":
        raise NotImplementedError(f"sample_gp_posterior(algorithm={algorithm!r}) is {_ROADMAP}")
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    layout = small_lml_theta_layout(kernel)
    if layout is None or X.shape[0] > fused_lml.MAX_N or Y2.shape[1] > FUSED_ROUTE_MAX_P:
        raise NotImplementedError(
            f"sample_gp_posterior's generic path (no fused C·stationary(+White) route) is {_ROADMAP}")
    family, n_ls, has_noise, perm_np = layout
    device = X.device
    f32 = dict(dtype=torch.float32, device=device)
    perm = torch.as_tensor(perm_np, device=device)
    bounds = kernel.theta_bounds.to(**f32)
    lo, hi = bounds[:, 0], bounds[:, 1]
    keys = _keys_of(seed, num_chains, device, chain_ids)
    u = chain_uniforms(keys, _INIT, 0, lo.shape[0], torch.float32).T  # (num_chains, n_theta)
    inits = lo + u * (hi - lo) * 0.5 + 0.25 * (hi - lo)  # the central half of the box
    lp_and_grad = fused_lp_and_grad(
        X.to(torch.float32).contiguous(), Y2.to(torch.float32).contiguous(),
        lo[perm][:, None], hi[perm][:, None], family, n_ls, has_noise, jitter, use_kernel)
    samples_c, info = hmc_batched(lp_and_grad, inits[:, perm].T.contiguous(), seed=seed,
                                  num_warmup=num_warmup, num_samples=num_samples,
                                  chain_ids=chain_ids, **kw)
    samples = samples_c[:, :, torch.as_tensor(np.argsort(perm_np), device=device)]
    return samples, dict(rhat=split_rhat(samples), ess=effective_sample_size(samples),
                         mean_accept=info["mean_accept"])
