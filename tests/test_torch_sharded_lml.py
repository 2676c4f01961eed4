"""The port's distributed LML and gradient (parallel/sharded_lml.py) on
gloo ranks against the JAX package's (its panel kernel in interpret mode,
as tests/test_sharded_lml.py runs it), against the port's one-process
blocked LML and against itself; ``fit_sharded`` against JAX's (both optax's
L-BFGS and zoom line search) in θ and trace.

Two ranks run every case once (a module fixture): the ``data`` axis has 1
or 2 of them on (2, 1) and (1, 2) meshes; RBF, N = 512, block 128."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gaussian_process_transportation_tpu import kernels as JK
from gaussian_process_transportation_tpu.parallel.sharded_lml import fit_sharded as jfit
from gaussian_process_transportation_tpu.parallel.sharded_lml import (
    sharded_lml_value_and_grad as jvg,
)
from gaussian_process_transportation_tpu_torch import kernels as TK
from gaussian_process_transportation_tpu_torch.models.exact_gp import fit_blocked
from gaussian_process_transportation_tpu_torch.ops.blocked_lml import (
    blocked_lml_value,
    blocked_lml_value_and_grad,
)
from gaussian_process_transportation_tpu_torch.parallel import _launch, _programs

torch.set_num_threads(1)

N, B, WORLD, FAMILY, FIT_ITERS, FIT_EARLY = 512, 128, 2, "rbf", 12, 3
THETA = (0.3, np.log([1.2, 0.8]), math.log(0.05))


def _inputs():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((N, 2))
    Y = np.sin(2.0 * X[:, :1]) + 0.1 * rng.standard_normal((N, 2))
    return X, Y


def _theta(dtype):
    return dict(log_amp=torch.tensor(THETA[0], dtype=dtype),
                log_ls=torch.as_tensor(THETA[1], dtype=dtype),
                log_noise=torch.tensor(THETA[2], dtype=dtype))


def _fit_kernel():
    return TK.Constant(1.0, bounds=(1e-2, 1e2)) * TK.RBF(torch.ones(2), bounds=(0.05, 20.0)) + \
        TK.White(0.1, bounds=(1e-4, 1.0))


@pytest.fixture(scope="module")
def jax_ref():
    X, Y = _inputs()
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    val, (ga, gl, gn) = jvg(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), FAMILY,
                            jnp.float32(THETA[0]), jnp.asarray(THETA[1], jnp.float32),
                            jnp.float32(THETA[2]), mesh=mesh, block=B, jitter=1e-6,
                            interpret=True)
    return float(val), np.concatenate([[float(ga)], np.asarray(gl), [float(gn)]])


@pytest.fixture(scope="module")
def jax_fits():
    """JAX's fit_sharded (optax L-BFGS, panel kernel in interpret mode) on 2
    devices from the same kernel: θ and trace after FIT_ITERS and after
    FIT_EARLY iterations (~5 s each)."""
    X, Y = _inputs()
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jk = (JK.Constant(1.0, bounds=(1e-2, 1e2)) * JK.RBF(jnp.ones(2), bounds=(0.05, 20.0))
          + JK.White(0.1, bounds=(1e-4, 1.0)))
    out = {}
    for iters in (FIT_ITERS, FIT_EARLY):
        _, th, vals = jfit(jk, jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), mesh,
                           maxiter=iters, block=B, interpret=True)
        out[iters] = (np.concatenate([np.atleast_1d(np.asarray(th[k]))
                                      for k in ("log_amp", "log_ls", "log_noise")]),
                      np.asarray(vals))
    return out


@pytest.fixture(scope="module")
def ranks():
    X, Y = _inputs()
    keys, cases = [], []
    for n_data in (1, 2):
        for dtype in (torch.float32, torch.float64):
            keys.append(("vg", n_data, dtype))
            cases.append(dict(kind="value_and_grad", X=torch.as_tensor(X, dtype=dtype),
                              Y=torch.as_tensor(Y, dtype=dtype), family=FAMILY, block=B,
                              n_data=n_data, **_theta(dtype)))
    iso = dict(_theta(torch.float64), log_ls=torch.tensor(0.1, dtype=torch.float64))
    keys.append("autograd")
    cases.append(dict(kind="autograd", X=torch.as_tensor(X), Y=torch.as_tensor(Y), family=FAMILY,
                      block=B, n_data=2, **iso))
    for key, iters in (("fit", FIT_ITERS), ("fit_early", FIT_EARLY)):
        keys.append(key)
        cases.append(dict(kind="fit", X=torch.as_tensor(X, dtype=torch.float32),
                          Y=torch.as_tensor(Y, dtype=torch.float32), kernel=_fit_kernel(),
                          block=B, n_data=2, maxiter=iters))
    # the same cases at the reduced precisions, which CPU tensors ignore
    for precision in ("default", "high"):
        for n_data in (1, 2):
            keys.append(("vg", n_data, torch.float32, precision))
            cases.append(dict(cases[keys.index(("vg", n_data, torch.float32))],
                              precision=precision))
        keys.append(("autograd", precision))
        cases.append(dict(cases[keys.index("autograd")], precision=precision))
        keys.append(("fit_early", precision))
        cases.append(dict(cases[keys.index("fit_early")], precision=precision))
    outs = _launch.launch(_programs.sharded_lml_cases, (cases,), nprocs=WORLD)
    return {k: [o[i] for o in outs] for i, k in enumerate(keys)}


def _flat(value, grad):
    g_amp, g_ls, g_noise = grad
    return value.item(), torch.cat([g_amp.reshape(1), g_ls, g_noise.reshape(1)]).double().numpy()


@pytest.mark.parametrize("n_data", [1, 2])
def test_against_jax_and_the_blocked_lml(ranks, jax_ref, n_data):
    """float32 against JAX's sharded LML on 2 devices (value rtol 1e-5,
    gradient 1e-4 of its largest entry); float64 within 1e-10 of the port's
    one-process blocked LML without refinement; every rank the same bits."""
    X, Y = _inputs()
    for dtype, ref, tol_v, tol_g in (
            (torch.float32, jax_ref, 1e-5, 1e-4),
            (torch.float64, None, 1e-10, 1e-10)):
        outs = ranks[("vg", n_data, dtype)]
        for o in outs[1:]:
            assert _flat(o["value"], o["grad"])[0] == _flat(outs[0]["value"], outs[0]["grad"])[0]
            assert np.array_equal(_flat(o["value"], o["grad"])[1],
                                  _flat(outs[0]["value"], outs[0]["grad"])[1])
        v, g = _flat(outs[0]["value"], outs[0]["grad"])
        if ref is None:
            t = _theta(dtype)
            ref = _flat(*blocked_lml_value_and_grad(
                torch.as_tensor(X), torch.as_tensor(Y), FAMILY, t["log_amp"], t["log_ls"],
                t["log_noise"], jitter=1e-6, block=B, refine_iters=0))
        assert abs(v - ref[0]) < tol_v * abs(ref[0]), (v, ref[0])
        np.testing.assert_allclose(g, ref[1], rtol=0, atol=tol_g * np.abs(ref[1]).max())


def test_autograd_function_sums_an_isotropic_lengthscale(ranks):
    """make_sharded_lml's backward is the saved gradient: one shared log ℓ
    gets the sum over the input axes; the value is the function's."""
    X, Y = _inputs()
    t = dict(_theta(torch.float64), log_ls=torch.tensor(0.1, dtype=torch.float64))
    v, (ga, gl, gn) = blocked_lml_value_and_grad(torch.as_tensor(X), torch.as_tensor(Y), FAMILY,
                                                 t["log_amp"], t["log_ls"].expand(2),
                                                 t["log_noise"], jitter=1e-6, block=B,
                                                 refine_iters=0)
    for o in ranks["autograd"]:
        assert abs(o["value"].item() - v.item()) < 1e-10 * abs(v.item())
        assert o["grad"]["log_ls"].shape == ()
        torch.testing.assert_close(o["grad"]["log_ls"], gl.sum(), rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(o["grad"]["log_amp"], ga, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(o["grad"]["log_noise"], gn, rtol=1e-10, atol=1e-10)


def _theta_vec(theta):
    return torch.cat([theta["log_amp"].reshape(1), theta["log_ls"],
                      theta["log_noise"].reshape(1)]).double()


def test_fit_sharded_raises_the_lml_to_fit_blockeds_optimum(ranks, jax_fits):
    """fit_sharded on two ranks: its trace (the value at each iteration's
    start) is JAX's fit_sharded's within 1e-4 relative, rise included (the
    step that leaves the box is clipped back, in both), the LML at its θ
    is above the start's, every rank took the same steps, and it reaches
    the LML of the port's fit_blocked (same iterations) to 1e-3.  The
    tolerance is float32's: the two packages' sharded LMLs differ by
    ~1e-5 relative in value and gradient (test_against_jax_and_the_blocked_lml),
    and the traces read at most ~5e-5 apart."""
    X, Y = _inputs()
    Xf, Yf = torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(Y, dtype=torch.float32)
    outs = ranks["fit"]
    for o in outs[1:]:
        assert all(torch.equal(o["theta"][k], outs[0]["theta"][k]) for k in o["theta"])
        assert torch.equal(o["vals"], outs[0]["vals"])
    vals = outs[0]["vals"]
    want_vals = jax_fits[FIT_ITERS][1]
    assert vals.shape == (FIT_ITERS,)
    np.testing.assert_allclose(vals.double().numpy(), want_vals, rtol=1e-4, atol=0)

    def lml(th):
        return blocked_lml_value(torch.as_tensor(X), torch.as_tensor(Y), FAMILY, th[0],
                                 th[1:3], th[3], jitter=1e-10, block=B).item()

    got = lml(_theta_vec(outs[0]["theta"]))
    start = _fit_kernel().theta.double()
    assert got > lml(start) + 1.0
    want = lml(fit_blocked(_fit_kernel(), Xf, Yf, maxiter=FIT_ITERS, block=B)
               .kernel.theta.double())
    assert abs(got - want) < 1e-3 * abs(want), (got, want)


def test_fit_sharded_takes_jaxs_first_steps(ranks, jax_fits):
    """After FIT_EARLY iterations (the second's line search zooms back from
    a unit step whose −LML rises by ~2·10⁴) θ is JAX's within 1e-3 in each
    log hyperparameter and the trace within 1e-4 relative: the f32 LMLs'
    ~1e-5 difference, amplified by the zoom's cubic through float32 values
    (~1e-4 in θ read on the CPU)."""
    outs = ranks["fit_early"]
    want_theta, want_vals = jax_fits[FIT_EARLY]
    for o in outs:
        np.testing.assert_allclose(_theta_vec(o["theta"]).numpy(), want_theta, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o["vals"].double().numpy(), want_vals, rtol=1e-4, atol=0)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_every_precision_is_highest_bit_for_bit_on_the_cpu(ranks, precision):
    """As JAX's CPU backend ignores its precision: on every rank the value,
    the gradient, make_sharded_lml's backward and fit_sharded's steps at
    ``precision`` are "highest"'s bits."""
    for n_data in (1, 2):
        for o, w in zip(ranks[("vg", n_data, torch.float32, precision)],
                        ranks[("vg", n_data, torch.float32)]):
            assert torch.equal(o["value"], w["value"]) and all(map(torch.equal, o["grad"],
                                                                   w["grad"]))
    for o, w in zip(ranks[("autograd", precision)], ranks["autograd"]):
        assert torch.equal(o["value"], w["value"])
        assert all(torch.equal(o["grad"][k], w["grad"][k]) for k in w["grad"])
    for o, w in zip(ranks[("fit_early", precision)], ranks["fit_early"]):
        assert all(torch.equal(o["theta"][k], w["theta"][k]) for k in w["theta"])
        assert torch.equal(o["vals"], w["vals"])


def test_the_split_route_in_one_process(monkeypatch):
    """The card's split route of the sharded LML (each broadcast panel and
    owned slot of T split once), emulated on the CPU in one process: at
    "high" the value within 1e-4 of (|v| + N·P) and the gradient within
    1e-3 of its largest entry of the float64 LML (the tolerances of
    test_torch_blocked_lml.py's split route); an unknown name is refused."""
    from gaussian_process_transportation_tpu_torch.ops import linalg as tlin
    from gaussian_process_transportation_tpu_torch.parallel.sharded_lml import (
        sharded_lml_value_and_grad,
    )

    X, Y = _inputs()
    t64 = _theta(torch.float64)
    ref = _flat(*blocked_lml_value_and_grad(torch.as_tensor(X), torch.as_tensor(Y), FAMILY,
                                            t64["log_amp"], t64["log_ls"], t64["log_noise"],
                                            jitter=1e-6, block=B, refine_iters=0))

    def reduced(a, precision):
        return tlin.check_precision(precision) != "highest" and a.dtype == torch.float32

    monkeypatch.setattr(tlin, "reduced", reduced)
    t = _theta(torch.float32)
    v, g = _flat(*sharded_lml_value_and_grad(
        torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(Y, dtype=torch.float32), FAMILY,
        t["log_amp"], t["log_ls"], t["log_noise"], None, block=B, precision="high"))
    assert abs(v - ref[0]) <= 1e-4 * (abs(ref[0]) + Y.size)
    np.testing.assert_allclose(g, ref[1], rtol=0, atol=1e-3 * np.abs(ref[1]).max())
    with pytest.raises(ValueError, match="precision"):
        sharded_lml_value_and_grad(torch.as_tensor(X), torch.as_tensor(Y), FAMILY,
                                   t64["log_amp"], t64["log_ls"], t64["log_noise"], None,
                                   block=B, precision="HIGH")
