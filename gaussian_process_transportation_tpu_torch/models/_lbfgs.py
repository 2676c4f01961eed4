"""optax's L-BFGS with its zoom line search, per lane, on (T, L) parameters.

The JAX package's large-N and restart fits (``fit_jit``, ``fit_blocked``,
``fit_sharded``) drive ``optax.lbfgs()`` in a ``lax.scan``: each iteration
takes v, g at θ (g's non-finite entries set to 0), runs the update with
``value=v, grad=g``, adds it and clips θ to the log-bounds.  ``lbfgs()``
chains three transforms, which :func:`lbfgs_minimize` reproduces per lane:

* ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: a ring
  buffer of the last ten differences of the parameters the caller passes
  (the clipped θ) and of the gradients, each weighted 1/⟨Δg, Δθ⟩ (0 where
  that is 0, with no test of its sign), the two-loop recursion seeded with
  ⟨Δg, Δθ⟩/‖Δg‖² times the identity, and min(1, 1/‖g‖) on the first step;
* ``scale(-1)``;
* ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` at optax's other defaults: a search for
  an interval from a unit step, doubling, then a zoom into it by cubic,
  else quadratic, else bisection interpolation, until the step meets the
  sufficient-decrease test (Armijo, or Hager and Zhang's approximate test
  near a minimum) and the curvature test; after 20 candidates, or once the
  interval is below 1e-5 with a step that decreased, the best such step
  (the safe step), or no step at all where the last candidate's decrease
  error is infinite (outside the objective's domain).

Every candidate of the line search is a value and a gradient: the caller's
function returns the value already mapped to 1e25 where it is not finite,
and the gradient unsanitized, as JAX's ``value_and_grad`` of that mapped
objective gives it (:func:`negated_lml` builds both from an LML).  Only the
iteration's first gradient is sanitized.

Lanes run in lockstep, as ``jax.vmap`` runs JAX's ``while_loop``: one
batched call of the function evaluates every lane's candidate, and a lane
whose line search has ended keeps its state while the others go on, so each
lane's iterates are those it takes alone.  Whether every lane has ended is
read on the host once a round: one device-to-host read per line-search
candidate for a CUDA tensor.

Ported from optax 0.2.6 (``_src/alias.py::lbfgs``,
``_src/transform.py::scale_by_lbfgs``, ``_src/linesearch.py::
zoom_linesearch``), Copyright 2019 DeepMind Technologies Limited and the
optax authors, licensed under the Apache License, Version 2.0
(http://www.apache.org/licenses/LICENSE-2.0).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import Tensor

__all__ = ["lbfgs_minimize", "negated_lml"]

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5


def negated_lml(val: Tensor, grad: Tensor) -> Tuple[Tensor, Tensor]:
    """The objective ``where(isfinite(−LML), −LML, 1e25)`` and its gradient
    as JAX differentiates it, from an LML's values (L,) and gradients
    (T, L): a lane whose value is not finite passes a zero cotangent back,
    so its gradient is 0·∂LML, NaN wherever ∂LML is not finite (a Gram that
    does not factor), and the line search then reads the candidate as
    outside the domain."""
    bad = ~torch.isfinite(val)
    v = torch.where(bad, torch.full_like(val, 1e25), -val)
    return v, torch.where(bad[None, :], grad * -0.0, -grad)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    """Per-lane inner product of (T, L) tensors."""
    return (a * b).sum(0)


def _where(cond: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """Lane-wise select; cond (L,) broadcasts over a (T, L) operand."""
    return torch.where(cond if a.dim() == 1 else cond[None, :], a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN where there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc * dc * r0 + -(db * db) * r1) / denom
    B = (-(dc * dc * dc) * r0 + db * db * db * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the parabola through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _decrease_error(t, value, slope, value_init, slope_init):
    """Positive where neither the Armijo test nor the approximate decrease
    test holds; NaN reads inf."""
    armijo = value - value_init - SLOPE_RTOL * t * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    err = torch.minimum(torch.maximum(approx, delta_values), armijo)
    err = torch.clamp(err, min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, torch.inf), err)


def _curvature_error(slope, slope_init):
    err = torch.clamp(torch.abs(slope) - CURV_RTOL * torch.abs(slope_init), min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, torch.inf), err)


def _weight(sy: Tensor) -> Tensor:
    """A memory slot's weight 1/⟨Δg, Δθ⟩, 0 where that is 0 (optax tests
    nothing else: a pair of negative curvature keeps its weight)."""
    return torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)


def _precondition(g: Tensor, dw: Tensor, du: Tensor, rho: Tensor, gamma: Tensor,
                  memory_idx: int) -> Tensor:
    """The two-loop recursion over the ring buffer, newest slot first."""
    m = rho.shape[0]
    order = [(memory_idx + i) % m for i in range(m)]
    vec, alphas = g, {}
    for idx in reversed(order):
        a = rho[idx] * _dot(dw[idx], vec)
        vec = vec + (-a)[None, :] * du[idx]
        alphas[idx] = a
    vec = gamma[None, :] * vec
    for idx in order:
        b = rho[idx] * _dot(du[idx], vec)
        vec = vec + (alphas[idx] - b)[None, :] * dw[idx]
    return vec


def _line_search(value_and_grad_b, x: Tensor, u: Tensor, v: Tensor, g: Tensor) -> Tensor:
    """Each lane's zoom line search from x along u (value v and gradient g
    at x); returns the stepsizes (L,)."""
    L = v.shape[0]
    zero = torch.zeros_like(v)
    slope = _dot(u, g)
    s = dict(count=torch.zeros(L, dtype=torch.int64, device=v.device),
             stepsize=zero, value=v, grad=g, slope=slope,
             found=torch.zeros(L, dtype=torch.bool, device=v.device),
             done=torch.zeros(L, dtype=torch.bool, device=v.device),
             failed=torch.zeros(L, dtype=torch.bool, device=v.device),
             low=zero, value_low=v, slope_low=slope, high=zero, value_high=v, slope_high=slope,
             cubic_ref=zero, value_cubic_ref=v, safe=zero, safe_value=v, safe_grad=g)
    value_init, slope_init = v, slope
    while True:
        active = ~(s["done"] | s["failed"])
        if not bool(active.any()):
            return s["stepsize"]
        lbfgs_minimize.rounds += 1
        count, found = s["count"], s["found"]
        low, high, cubic_ref = s["low"], s["high"], s["cubic_ref"]
        value_low, slope_low, value_high = s["value_low"], s["slope_low"], s["value_high"]
        # the interval search's candidate: 1, then doubling
        t_search = torch.where(count == 0, torch.ones_like(v), INCREASE_FACTOR * s["stepsize"])
        # the zoom's candidate: cubic, else quadratic, else bisection
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        m_cubic = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                            s["value_cubic_ref"])
        use_cubic = (m_cubic > left + 0.2 * delta) & (m_cubic < right - 0.2 * delta)
        m_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = ~use_cubic & (m_quad > left + 0.1 * delta) & (m_quad < right - 0.1 * delta)
        middle = torch.where(use_cubic, m_cubic, cubic_ref)
        middle = torch.where(use_quad, m_quad, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        t = torch.where(found, middle, t_search)

        v_t, g_t = value_and_grad_b(x + t[None, :] * u)
        lbfgs_minimize.evaluations += 1
        slope_t = _dot(g_t, u)
        dec = _decrease_error(t, v_t, slope_t, value_init, slope_init)
        good = torch.maximum(dec, _curvature_error(slope_t, slope_init)) <= 0.0
        last = count + 1 >= MAX_LINESEARCH_STEPS

        # the interval search (Nocedal and Wright, algorithm 3.5)
        high_to_new = (dec > 0.0) | ((v_t >= s["value"]) & (count > 0))
        low_to_new = (slope_t >= 0.0) & ~high_to_new
        search = dict(
            low=torch.where(low_to_new, t, s["stepsize"]),
            value_low=torch.where(low_to_new, v_t, s["value"]),
            slope_low=torch.where(low_to_new, slope_t, s["slope"]),
            high=torch.where(low_to_new, s["stepsize"], t),
            value_high=torch.where(low_to_new, s["value"], v_t),
            slope_high=torch.where(low_to_new, s["slope"], slope_t),
            found=high_to_new | low_to_new | good,
            failed=last & ~good)
        search.update(cubic_ref=search["low"], value_cubic_ref=search["value_low"])
        keep = dec <= 0.0
        search.update(safe=torch.where(keep, t, s["safe"]),
                      safe_value=torch.where(keep, v_t, s["safe_value"]),
                      safe_grad=_where(keep, g_t, s["safe_grad"]))

        # the zoom (algorithm 3.6)
        keep = (dec <= 0.0) & (v_t < s["safe_value"])
        high_to_mid = (dec > 0.0) | (v_t >= value_low)
        high_to_low = (slope_t * (high - low) >= 0.0) & ~high_to_mid
        new_high = torch.where(high_to_low, low, torch.where(high_to_mid, t, high))
        new_value_high = torch.where(high_to_low, value_low,
                                     torch.where(high_to_mid, v_t, value_high))
        new_slope_high = torch.where(high_to_low, slope_low,
                                     torch.where(high_to_mid, slope_t, s["slope_high"]))
        ref_is_high = high_to_mid | high_to_low
        zoom = dict(
            low=torch.where(high_to_mid, low, t),
            value_low=torch.where(high_to_mid, value_low, v_t),
            slope_low=torch.where(high_to_mid, slope_low, slope_t),
            high=new_high, value_high=new_value_high, slope_high=new_slope_high,
            cubic_ref=torch.where(ref_is_high, high, low),
            value_cubic_ref=torch.where(ref_is_high, value_high, value_low),
            found=found,
            safe=torch.where(keep, t, s["safe"]),
            safe_value=torch.where(keep, v_t, s["safe_value"]),
            safe_grad=_where(keep, g_t, s["safe_grad"]))
        zoom["failed"] = (last | ((delta <= STEPSIZE_PRECISION) & (zoom["safe"] > 0.0))) & ~good

        new = {k: _where(found, zoom[k], search[k]) for k in search}
        new.update(count=count + 1, stepsize=t, value=v_t, grad=g_t, slope=slope_t, done=good)
        # a failed search falls back on the safe step, or on no step where
        # the last candidate was outside the domain
        take_safe = new["failed"] & ((new["safe"] > 0.0) | torch.isinf(dec))
        new["stepsize"] = torch.where(take_safe, new["safe"], t)
        new["value"] = torch.where(take_safe, new["safe_value"], v_t)
        new["grad"] = _where(take_safe, new["safe_grad"], g_t)
        s = {k: _where(active, new[k], s[k]) for k in s}


def lbfgs_minimize(value_and_grad_b: Callable[[Tensor], Tuple[Tensor, Tensor]], x0: Tensor,
                   lower: Tensor, upper: Tensor, maxiter: int,
                   final_value: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """``maxiter`` iterations of ``optax.lbfgs()`` on each lane of x0 (T, L),
    the step loop of the JAX package's fits: v, g = ``value_and_grad_b(θ)``
    (values (L,), gradients (T, L); the value mapped to 1e25 where it is
    not finite, the gradient as it comes), g's non-finite entries set to 0,
    the preconditioned direction, the zoom line search along it (every
    candidate another ``value_and_grad_b`` call), then θ clipped to
    [lower, upper] (broadcast against (T, L)).

    Returns (θ (T, L), the value at each iteration's start (maxiter, L),
    the values at the final θ (L,), evaluated once more where
    ``final_value``, else None).  The function's counters ``iterations``,
    ``evaluations`` (calls of ``value_and_grad_b``, the final one included)
    and ``rounds`` (line-search candidates) add up over calls."""
    T, L = x0.shape
    m = MEMORY_SIZE
    dw = x0.new_zeros((m, T, L))
    du = x0.new_zeros((m, T, L))
    rho = x0.new_zeros((m, L))
    x, x_prev, g_prev = x0, x0.new_zeros((T, L)), x0.new_zeros((T, L))
    vals = []
    for k in range(maxiter):
        lbfgs_minimize.iterations += 1
        v, g = value_and_grad_b(x)
        lbfgs_minimize.evaluations += 1
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        vals.append(v)
        memory_idx, prev_idx = k % m, (k - 1) % m
        if k > 0:
            d_x, d_g = x - x_prev, g - g_prev
            sy = _dot(d_g, d_x)
            dw[prev_idx], du[prev_idx] = d_x, d_g
            rho[prev_idx] = _weight(sy)
            yy = _dot(d_g, d_g)
            gamma = torch.where(yy > 0.0, sy / yy, torch.ones_like(sy))
        else:
            gamma = torch.clamp(1.0 / torch.sqrt(_dot(g, g)), max=1.0)
        u = -_precondition(g, dw, du, rho, gamma, memory_idx)
        x_prev, g_prev = x, g
        t = _line_search(value_and_grad_b, x, u, v, g)
        x = torch.minimum(torch.maximum(x + t[None, :] * u, lower), upper)
    v_final = None
    if final_value:
        v_final = value_and_grad_b(x)[0]
        lbfgs_minimize.evaluations += 1
    vals = torch.stack(vals) if vals else x0.new_zeros((0, L))
    return x, vals, v_final


lbfgs_minimize.iterations = 0
lbfgs_minimize.evaluations = 0
lbfgs_minimize.rounds = 0
