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

Randomness: the draws of step s of phase φ (0 and 1 the warm-up windows,
2 sampling) come from one ``torch.Generator`` on the chains' device seeded
from (seed, φ, s), so a segmented warm-up plus sample range equals the
monolithic run bit for bit.  The numbers differ from JAX's keys.

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


def step_generator(seed: int, phase: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of phase ``phase``, seeded from
    (seed, phase, step) alone."""
    state = np.random.SeedSequence([seed, phase, step]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


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


def _batched_machinery(lp_and_grad_batched: LpAndGrad, seed: int, num_leapfrog: int):
    """``one_step(state, phase, s, step, inv_mass)``: one Metropolis-adjusted
    leapfrog trajectory of every chain, its randomness from
    ``step_generator(seed, phase, s)``; returns (state, accept_prob (E,))."""

    def leapfrog(q, p, g, step, inv_mass):
        lp = None
        for _ in range(num_leapfrog):
            p = p + 0.5 * step[None, :] * g
            q = q + step[None, :] * inv_mass * p
            lp, g = lp_and_grad_batched(q)
            p = p + 0.5 * step[None, :] * g
        return q, p, g, lp

    def one_step(state: State, phase: int, s: int, step: Tensor, inv_mass: Tensor):
        q0, lp0, g0 = state
        gen = step_generator(seed, phase, s, q0.device)
        p0 = torch.randn(q0.shape, generator=gen, dtype=q0.dtype, device=q0.device)
        p0 = p0 / torch.sqrt(inv_mass)
        u = torch.rand(q0.shape[1:], generator=gen, dtype=q0.dtype, device=q0.device)
        q, p, g, lp = leapfrog(q0, p0, g0, step, inv_mass)
        ke0 = 0.5 * (p0 * p0 * inv_mass).sum(0)
        ke1 = 0.5 * (p * p * inv_mass).sum(0)
        accept_prob = torch.clamp(torch.exp((lp - ke1) - (lp0 - ke0)), max=1.0)
        accept = u < accept_prob
        state = (torch.where(accept[None, :], q, q0), torch.where(accept, lp, lp0),
                 torch.where(accept[None, :], g, g0))
        return state, accept_prob

    return one_step


def _batched_adaptation(one_step, state0: State, num_warmup: int, initial_step_size: float,
                        target_accept: float):
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
        for s in range(steps):
            state, accept_prob = one_step(state, phase, s, torch.exp(da["log_step"]), inv_mass)
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
) -> Tuple[State, Tensor, Tensor]:
    """The adaptation phase of :func:`hmc_batched` alone: returns
    (state (q, lp, g), step (E,), inv_mass (T, E)), exactly what
    :func:`hmc_batched` holds when sampling starts."""
    one_step = _batched_machinery(lp_and_grad_batched, seed, num_leapfrog)
    lp0, g0 = lp_and_grad_batched(init_positions)
    return _batched_adaptation(one_step, (init_positions, lp0, g0), num_warmup,
                               initial_step_size, target_accept)


def hmc_batched_sample_range(
    lp_and_grad_batched: LpAndGrad,
    state: State,
    seed: int,
    start: int,
    stop: int,
    step: Tensor,
    inv_mass: Tensor,
    num_leapfrog: int = 16,
) -> Tuple[State, Tensor, Tensor]:
    """Samples [start, stop) of the stream :func:`hmc_batched` draws: step s
    takes ``step_generator(seed, 2, s)`` however the run is cut.  Returns
    (state, samples (E, stop − start, T), accept_probs (stop − start, E))."""
    one_step = _batched_machinery(lp_and_grad_batched, seed, num_leapfrog)
    samples, accepts = [], []
    for s in range(start, stop):
        state, a = one_step(state, _SAMPLING, s, step, inv_mass)
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
) -> Tuple[Tensor, dict]:
    """All chains of an ensemble-last state in one loop of HMC steps.

    ``lp_and_grad_batched(q (T, E)) -> (lp (E,), grad (T, E))`` evaluates
    every chain at once (for the GP hyperposterior, one fused-kernel
    launch).  Step size and mass adapt per chain.  Calls
    ``lp_and_grad_batched`` 1 + (num_warmup + num_samples)·num_leapfrog
    times.  Returns (samples (E, S, T), info with ``step_size`` (E,),
    ``inv_mass`` (E, T) and ``mean_accept`` (E,))."""
    state, step, inv_mass = hmc_batched_warmup(
        lp_and_grad_batched, init_positions, seed, num_warmup, num_leapfrog,
        initial_step_size, target_accept)
    state, samples, accepts = hmc_batched_sample_range(
        lp_and_grad_batched, state, seed, 0, num_samples, step, inv_mass, num_leapfrog)
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
    ``target_accept``)."""
    from ..models.exact_gp import small_lml_theta_layout
    from ..ops import fused_lml

    if mesh is not None:
        raise NotImplementedError(f"sample_gp_posterior(mesh=...) is {_ROADMAP}")
    if algorithm != "hmc":
        raise NotImplementedError(f"sample_gp_posterior(algorithm={algorithm!r}) is {_ROADMAP}")
    Y2 = Y[:, None] if Y.dim() == 1 else Y
    layout = small_lml_theta_layout(kernel)
    if layout is None or X.shape[0] > fused_lml.MAX_N or Y2.shape[1] > fused_lml.MAX_P:
        raise NotImplementedError(
            f"sample_gp_posterior's generic path (no fused C·stationary(+White) route) is {_ROADMAP}")
    family, n_ls, has_noise, perm_np = layout
    device = X.device
    f32 = dict(dtype=torch.float32, device=device)
    perm = torch.as_tensor(perm_np, device=device)
    bounds = kernel.theta_bounds.to(**f32)
    lo, hi = bounds[:, 0], bounds[:, 1]
    u = torch.rand((num_chains, lo.shape[0]), generator=step_generator(seed, _INIT, 0, device),
                   **f32)
    inits = lo + u * (hi - lo) * 0.5 + 0.25 * (hi - lo)  # the central half of the box
    lp_and_grad = fused_lp_and_grad(
        X.to(torch.float32).contiguous(), Y2.to(torch.float32).contiguous(),
        lo[perm][:, None], hi[perm][:, None], family, n_ls, has_noise, jitter, use_kernel)
    samples_c, info = hmc_batched(lp_and_grad, inits[:, perm].T.contiguous(), seed=seed,
                                  num_warmup=num_warmup, num_samples=num_samples, **kw)
    samples = samples_c[:, :, torch.as_tensor(np.argsort(perm_np), device=device)]
    return samples, dict(rhat=split_rhat(samples), ess=effective_sample_size(samples),
                         mean_accept=info["mean_accept"])
