"""The port's distributed blocked Cholesky (parallel/sharded_chol.py) on
gloo ranks against the JAX package's on four virtual devices, against
numpy's float64 solve and against itself in one process.

Four ranks run every case once (a module fixture): the ``data`` axis has
1, 2 or 4 of them on (4, 1), (2, 2) and (1, 4) meshes; block 128; N = 600
(no multiple of B·D; RBF and Matérn-5/2) and 1024 (every rank owning two
panels at D = 4).  JAX's solve runs once, at N = 1024 on four devices (its
values do not depend on the layout): its interpret-mode panel kernel
compiles for seconds a call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gaussian_process_transportation_tpu.parallel.sharded_chol import (
    sharded_gram_cholesky_solve as jsolve,
)
from gaussian_process_transportation_tpu_torch.parallel import _launch, _programs
from gaussian_process_transportation_tpu_torch.parallel.sharded_chol import (
    sharded_gram_cholesky_solve,
)

torch.set_num_threads(1)

B, AMP, NOISE, WORLD = 128, 2.0, 0.1, 4
DATA = (1, 2, 4)
CASES = ((600, "rbf"), (1024, "rbf"), (600, "matern52"))
JAX_CASE, JAX_D = (1024, "rbf"), 4


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed + n)
    return rng.standard_normal((n, 3)), rng.standard_normal((n, 2)), rng.standard_normal((n, 3))


def _f64_golden(X, Y, family):
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    if family == "rbf":
        k = np.exp(-0.5 * d2)
    else:
        s = np.sqrt(5.0 * d2)
        k = (1 + s + s * s / 3) * np.exp(-s)
    K = AMP * k + NOISE * np.eye(len(X))
    return np.linalg.solve(K, Y), np.linalg.slogdet(K)[1], K


def _case(n, family, n_data, dtype, jax_factor=None):
    X, Y, b = _inputs(n)
    c = dict(X=torch.as_tensor(X, dtype=dtype), Y=torch.as_tensor(Y, dtype=dtype),
             lengthscale=torch.ones(3, dtype=dtype), amplitude=AMP, noise=NOISE, block=B,
             family=family, n_data=n_data, b=torch.as_tensor(b, dtype=dtype))
    if jax_factor is not None:
        c["jax"] = jax_factor
    return c


@pytest.fixture(scope="module")
def jax_ref():
    n, family = JAX_CASE
    X, Y, b = _inputs(n)
    mesh = Mesh(np.array(jax.devices()[:JAX_D]), ("data",))
    alpha, chol = jsolve(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
                         np.ones(3, np.float32), AMP, NOISE, mesh=mesh, block=B, family=family)
    return dict(alpha=np.asarray(alpha), logdet=float(chol.logdet()),
                solve=np.asarray(chol.solve(jnp.asarray(b, jnp.float32))),
                factor=dict(panels=[np.asarray(p) for p in chol.panels],
                            linvs=[np.asarray(p) for p in chol.linvs], n=chol.n, block=chol.block))


@pytest.fixture(scope="module")
def cases(jax_ref):
    keys, cases = [], []
    for n, family in CASES:
        for n_data in DATA:
            for dtype in (torch.float32, torch.float64):
                keys.append((n, family, n_data, dtype))
                cases.append(_case(n, family, n_data, dtype))
    # the (600, rbf) cases at the reduced precisions, which CPU tensors ignore
    for precision in ("default", "high"):
        for n_data in DATA:
            for dtype in (torch.float32, torch.float64):
                keys.append((600, "rbf", n_data, dtype, precision))
                cases.append(dict(_case(600, "rbf", n_data, dtype), precision=precision))
    # the JAX factor (f32, D = 4) carried into the four ranks' port factors
    keys.append("carried")
    cases.append(_case(*JAX_CASE, JAX_D, torch.float64, jax_ref["factor"]))
    outs = _launch.launch(_programs.sharded_cholesky_cases, (cases,), nprocs=WORLD)
    return {k: [o[i] for o in outs] for i, k in enumerate(keys)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n_data", DATA)
@pytest.mark.parametrize("n,family", CASES)
def test_against_jax_numpy_and_one_process(cases, jax_ref, n, family, n_data):
    """float32 α and log det within 5e-4 of JAX's (float32; at N = 1024, and
    of numpy's float64 elsewhere); float64 within 1e-9 of numpy's dense
    solve; every rank the same bits; D ranks within 1e-12 of the same
    algorithm in one process; a solve through the factor within 1e-9 of
    numpy's."""
    X, Y, b = _inputs(n)
    a64, ld64, K = _f64_golden(X, Y, family)
    r32, r64 = cases[(n, family, n_data, torch.float32)], cases[(n, family, n_data, torch.float64)]
    for ranks in (r32, r64):
        for r in ranks[1:]:
            assert all(torch.equal(r[k], ranks[0][k]) for k in ("alpha", "logdet", "resolve"))
    ref = jax_ref if (n, family) == JAX_CASE else dict(alpha=a64, logdet=ld64)
    assert _rel(r32[0]["alpha"], ref["alpha"]) < 5e-4
    assert abs(r32[0]["logdet"].item() - ref["logdet"]) < 5e-4 * abs(ref["logdet"])
    assert _rel(r64[0]["alpha"], a64) < 1e-9
    assert abs(r64[0]["logdet"].item() - ld64) < 1e-9 * abs(ld64)
    assert _rel(r64[0]["resolve"], np.linalg.solve(K, b)) < 1e-9
    c = _case(n, family, n_data, torch.float64)
    alpha1, chol1 = sharded_gram_cholesky_solve(c["X"], c["Y"], c["lengthscale"], AMP, NOISE,
                                                None, block=B, family=family)
    assert _rel(r64[0]["alpha"], alpha1) < 1e-12
    assert abs(r64[0]["logdet"].item() - chol1.logdet().item()) < 1e-12 * abs(ld64)


def test_a_jax_factor_solves_through_the_ports_collectives(cases, jax_ref):
    """JAX's float32 factor on 4 devices, carried into 4 ranks
    (convert.sharded_cholesky_from_jax): the port's collective solve and
    log det equal JAX's own to float32 rounding."""
    ref = jax_ref
    for r in cases["carried"]:
        assert _rel(r["jax_solve"], ref["solve"]) < 1e-5
        assert abs(r["jax_logdet"].item() - ref["logdet"]) < 1e-6 * abs(ref["logdet"])


@pytest.mark.parametrize("precision", ["default", "high"])
def test_every_precision_is_highest_bit_for_bit_on_the_cpu(cases, precision):
    """As JAX's CPU backend ignores its precision: α, log det and a solve
    through the factor at ``precision`` are "highest"'s bits on every rank."""
    for n_data in DATA:
        for dtype in (torch.float32, torch.float64):
            for o, w in zip(cases[(600, "rbf", n_data, dtype, precision)],
                            cases[(600, "rbf", n_data, dtype)]):
                assert all(torch.equal(o[k], w[k]) for k in ("alpha", "logdet", "resolve"))


def test_the_split_route_in_one_process(monkeypatch):
    """The card's split route of the sharded factor and solve (a step's
    ``below`` split once for every trailing update, the slots and L_kk⁻¹
    once for the solves), emulated on the CPU in one process at N = 600:
    "high" α within 1e-3 of numpy's float64 solve (it has no refinement,
    as JAX's; "highest" reads 5e-4 against it above), its log det within
    1e-4; an unknown name is refused."""
    from gaussian_process_transportation_tpu_torch.ops import linalg as tlin

    def reduced(a, precision):
        return tlin.check_precision(precision) != "highest" and a.dtype == torch.float32

    monkeypatch.setattr(tlin, "reduced", reduced)
    X, Y, b = _inputs(600)
    a64, ld64, K = _f64_golden(X, Y, "rbf")
    c = _case(600, "rbf", 1, torch.float32)
    alpha, chol = sharded_gram_cholesky_solve(c["X"], c["Y"], c["lengthscale"], AMP, NOISE,
                                              None, block=B, precision="high")
    assert _rel(alpha, a64) < 1e-3
    assert abs(chol.logdet().item() - ld64) < 1e-4 * abs(ld64)
    assert _rel(chol.solve(c["b"], "high"), np.linalg.solve(K, b)) < 1e-3
    with pytest.raises(ValueError, match="precision"):
        sharded_gram_cholesky_solve(c["X"], c["Y"], c["lengthscale"], AMP, NOISE, None,
                                    block=B, precision="HIGH")
