"""Port parity: ``models/_lbfgs.py::lbfgs_minimize`` (optax's L-BFGS and zoom
line search, per lane) against ``optax.lbfgs()`` driven by the step loop of
the JAX package's fits (v, g at θ, g's non-finite entries set to 0, the
update with ``value=v, grad=g, value_fn=nll``, θ clipped to the bounds),
float64 on the CPU, on objectives that both frameworks compute with the
same operations:

* a bounded Rosenbrock whose clip binds;
* an ill-conditioned quadratic;
* a pseudo-Huber loss far from its minimum, whose first line search
  brackets by doubling and then zooms;
* a log barrier whose candidates leave the domain (NaN and inf values,
  read as 1e25);
* a saddle in a box where a line search fails and a pair of negative
  curvature enters the memory.

θ and the value at every iteration are held to 1e-10 relative, and the
line-search candidates of every iteration counted alike."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_process_transportation_tpu_torch.models import _lbfgs

torch.set_num_threads(1)

TOL = 1e-10


def _rosen(x, np_):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum(0)


def _quad(x, np_):
    a = np_.asarray([1.0, 10.0, 100.0])
    c = np_.asarray([0.5, -1.0, 2.0])
    if np_ is torch:
        a, c = a.double()[:, None], c.double()[:, None]
    return 0.5 * (a * (x - c) ** 2).sum(0) + 2.0 * (x[0] - c[0]) * (x[1] - c[1])


def _huber(x, np_):
    c = np_.asarray([1.0, -2.0])
    if np_ is torch:
        c = c.double()[:, None]
    return np_.sqrt(1.0 + (x - c) ** 2).sum(0)


def _barrier(x, np_):
    return (20.0 * x - np_.log(x)).sum(0)


def _saddle(x, np_):
    return np_.cos(2.0 * x).sum(0) + 0.3 * x[0] * x[1]


# name: (objective, start, lower, upper, iterations)
CASES = {
    "rosenbrock": (_rosen, [-1.2, 1.0], [-2.0, -2.0], [0.8, 0.8], 20),
    "quadratic": (_quad, [3.0, 3.0, 3.0], [-10.0] * 3, [10.0] * 3, 12),
    "huber": (_huber, [30.0, 25.0], [-100.0] * 2, [100.0] * 2, 10),
    "barrier": (_barrier, [0.5, 0.3], [-5.0] * 2, [50.0] * 2, 10),
    "saddle": (_saddle, [0.1, 0.2], [-1.0] * 2, [1.0] * 2, 6),
}


def _jax_run(name):
    """optax.lbfgs() in the JAX package's step loop: θ after each iteration,
    the value at each iteration's start and the line-search steps."""
    f, x0, lo, hi, iters = CASES[name]
    opt = optax.lbfgs()
    lo, hi = jnp.asarray(lo), jnp.asarray(hi)

    def nll(theta):
        v = f(theta, jnp)
        return jnp.where(jnp.isfinite(v), v, 1e25)

    @jax.jit
    def run(t0):
        def step(carry, _):
            theta, state = carry
            v, g = jax.value_and_grad(nll)(theta)
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            updates, state = opt.update(g, state, theta, value=v, grad=g, value_fn=nll)
            theta = jnp.clip(optax.apply_updates(theta, updates), lo, hi)
            return (theta, state), (theta, v, state[2].info.num_linesearch_steps)

        return jax.lax.scan(step, (t0, opt.init(t0)), None, length=iters)[1]

    return [np.asarray(a) for a in run(jnp.asarray(x0, jnp.float64))]


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _jax_run(name) for name in CASES}


def _value_and_grad(f):
    """The port's candidate function for lanes (T, L): the value mapped to
    1e25 where it is not finite, the gradient by autograd of that mapped
    value (as JAX's value_and_grad of its nll)."""
    def vg(x):
        x = x.detach().requires_grad_(True)
        v = f(x, torch)
        v = torch.where(torch.isfinite(v), v, torch.full_like(v, 1e25))
        (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g
    return vg


def _port(name, starts=None, iters=None):
    """The port's θ after iterations 1..iters (one run each) and the run's
    values at each iteration's start; lanes are the columns of ``starts``."""
    f, x0, lo, hi, n = CASES[name]
    iters = iters or n
    x0 = torch.tensor(x0 if starts is None else starts, dtype=torch.float64)
    x0 = x0[:, None] if x0.dim() == 1 else x0
    lo = torch.tensor(lo, dtype=torch.float64)[:, None]
    hi = torch.tensor(hi, dtype=torch.float64)[:, None]
    thetas, rounds = [], []
    for k in range(1, iters + 1):
        before = _lbfgs.lbfgs_minimize.rounds
        x, vals, _ = _lbfgs.lbfgs_minimize(_value_and_grad(f), x0, lo, hi, k)
        thetas.append(x)
        rounds.append(_lbfgs.lbfgs_minimize.rounds - before)
    return torch.stack(thetas), vals, np.diff([0] + rounds)


def _assert_match(got_theta, got_vals, want):
    theta, vals, _ = want
    got_theta = got_theta[:, :, 0].numpy()
    got_vals = got_vals[:, 0].numpy()
    scale = np.abs(theta).max(1, keepdims=True)
    err_t = (np.abs(got_theta - theta) / scale).max()
    err_v = (np.abs(got_vals - vals) / np.maximum(np.abs(vals), 1e-2 * abs(vals[0]))).max()
    assert err_t <= TOL and err_v <= TOL, (err_t, err_v)
    return err_t, err_v


@pytest.mark.parametrize("name", ["rosenbrock", "quadratic", "huber", "barrier", "saddle"])
def test_iterates_match_optax(jax_runs, name):
    """θ after every iteration and the value at every iteration's start
    within 1e-10 relative of optax's, with the same number of line-search
    candidates in every iteration."""
    want = jax_runs[name]
    theta, vals, rounds = _port(name)
    _assert_match(theta, vals, want)
    np.testing.assert_array_equal(rounds, want[2])


def test_the_cases_reach_the_paths_they_name(jax_runs):
    """The clip binds in the Rosenbrock case; the pseudo-Huber's first line
    search doubles its step past the minimum and zooms back (more than two
    candidates); the barrier's candidates leave the domain; the saddle runs
    a line search to its 20 candidates."""
    f, _, lo, hi, _ = CASES["rosenbrock"]
    assert (jax_runs["rosenbrock"][0] == np.asarray(hi)).any()
    assert jax_runs["huber"][2][0] > 2
    bar = CASES["barrier"]
    x0 = np.asarray(bar[1])
    g0 = 20.0 - 1.0 / x0
    first = x0 - g0 / np.linalg.norm(g0)  # the unit step of the first line search
    assert (first <= 0).any()
    assert (jax_runs["saddle"][2] == _lbfgs.MAX_LINESEARCH_STEPS).any()


@pytest.mark.parametrize("name", ["huber", "barrier"])
def test_lanes_run_together_equal_each_lane_alone(name):
    """Three starts as the lanes of one run: each lane's θ and values after
    every iteration equal that start run alone, bit for bit, though the
    lanes' line searches end after different numbers of candidates."""
    _, x0, _, _, iters = CASES[name]
    starts = np.stack([x0, np.asarray(x0) * 0.5, np.asarray(x0) * 1.7], 1)
    together, vals, _ = _port(name, starts=starts.tolist(), iters=iters)
    for lane in range(3):
        alone, vals1, _ = _port(name, starts=starts[:, lane].tolist(), iters=iters)
        assert torch.equal(together[:, :, lane], alone[:, :, 0])
        assert torch.equal(vals[:, lane], vals1[:, 0])


@pytest.mark.parametrize("fault, name", [("weight_guard", "saddle"),
                                         ("curvature_constant", "huber")])
def test_a_planted_fault_breaks_the_match(jax_runs, monkeypatch, fault, name):
    """The saddle case tells optax's weight guard (only ⟨Δg, Δθ⟩ = 0 reads
    0) from a positivity test, and the pseudo-Huber case the curvature
    constant 0.9 from 0.5: either fault moves θ by over a thousand times
    the tolerance."""
    if fault == "weight_guard":
        def positive_only(sy):
            ok = sy > 1e-12
            return torch.where(ok, 1.0 / torch.where(ok, sy, torch.ones_like(sy)),
                               torch.zeros_like(sy))
        monkeypatch.setattr(_lbfgs, "_weight", positive_only)
    else:
        monkeypatch.setattr(_lbfgs, "CURV_RTOL", 0.5)
    theta, vals, _ = _port(name)
    with pytest.raises(AssertionError):
        _assert_match(theta, vals, jax_runs[name])
    err = np.abs(theta[:, :, 0].numpy() - jax_runs[name][0]).max()
    assert err > 1e3 * TOL, err


def test_negated_lml_differentiates_as_jax_does():
    """A finite LML gives −LML and −∂; a lane whose LML is not finite reads
    1e25, with gradient 0 where ∂ is finite and NaN where it is not, as
    JAX's value_and_grad of where(isfinite(v), v, 1e25) gives."""
    val = torch.tensor([2.0, float("nan"), float("-inf")], dtype=torch.float64)
    grad = torch.tensor([[1.0, float("nan"), 3.0], [-4.0, 5.0, float("inf")]],
                        dtype=torch.float64)
    v, g = _lbfgs.negated_lml(val, grad)
    assert v.tolist() == [-2.0, 1e25, 1e25]
    assert g[:, 0].tolist() == [-1.0, 4.0]
    assert torch.isnan(g[0, 1]) and g[1, 1] == 0.0 and g[0, 2] == 0.0 and torch.isnan(g[1, 2])

    def nll(theta):
        v_ = -(jnp.sqrt(theta[0]) + theta[1])
        return jnp.where(jnp.isfinite(v_), v_, 1e25)

    for theta in ([2.0, 1.0], [-1.0, 1.0]):
        vj, gj = jax.value_and_grad(nll)(jnp.asarray(theta))
        th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
        lv = torch.sqrt(th[0]) + th[1]
        (lg,) = torch.autograd.grad(lv, th)
        vt, gt = _lbfgs.negated_lml(lv.detach()[None], lg[:, None])
        assert float(vj) == vt.item()
        np.testing.assert_array_equal(np.isnan(np.asarray(gj)), torch.isnan(gt[:, 0]).numpy())
        np.testing.assert_allclose(np.nan_to_num(np.asarray(gj)),
                                   np.nan_to_num(gt[:, 0].numpy()), rtol=1e-15, atol=0)
