"""The plain reference agrees with the port's CPU twins at small sizes, and
a whole run on the CPU, at small sizes, comes out correct by the cells'
limits."""
import math

import pytest
import torch

from port_bench import generator, run, spec
from port_bench.reference import fit as ref_fit

BENCH = spec.benchmark()
PKG = "gaussian_process_transportation_tpu_torch"
COV = spec.module("reference", "cov_rbf")
TRANSPORT = spec.module("checks", "transport")
FIT = spec.module("checks", "fit")


def port_call(c, inputs, batch, seed=5):
    entry = spec.module("entries", c.traffic["entry"])
    _, payload = entry.prepare(c.config, c.traffic, inputs, "cpu", seed).call(inputs.pool[batch])
    return payload


@pytest.mark.parametrize("members", [1, 16])
def test_reference_agrees_with_the_port(members):
    c = spec.cell("floor2d-ensemble", BENCH)
    inputs = generator.make_inputs(c.config, c.traffic, 11, "cpu", members=members, pool=1)
    res = port_call(c, inputs, 0)["result"]
    nums, ref_mad = TRANSPORT.compare_call(c.config, inputs.scene, inputs.pool[0], res)
    assert set(nums) == set(TRANSPORT.NUMBERS)
    for name, value in nums.items():
        assert value < 1e-2, (name, value)
    assert ref_mad.shape == (members,)


def test_reference_in_float32_is_near_float64():
    c = spec.cell("floor2d-ensemble", BENCH)
    inputs = generator.make_inputs(c.config, c.traffic, 12, "cpu", members=8, pool=1)
    lo = TRANSPORT.reference_transport(c.config, inputs.scene, inputs.pool[0], dtype=torch.float32)
    nums, _ = TRANSPORT.compare_call(c.config, inputs.scene, inputs.pool[0], lo)
    assert max(nums.values()) < 1e-4, nums


def test_reference_lml_matches_the_ports_twin():
    from importlib import import_module

    lml_md = import_module(PKG + ".ops.fused_lml").small_lml_value_grad_md
    c = spec.cell("floor2d-refit", BENCH)
    inputs = generator.make_inputs(c.config, c.traffic, 2, "cpu", members=6, pool=1)
    X, Y = ref_fit.member_data(inputs.scene.S, inputs.pool[0])
    theta = torch.log(torch.tensor([3.0, 2.0, 5.0, 0.05], dtype=torch.float64)).expand(6, -1)
    want = ref_fit.lml(theta, X, Y, 1e-10, COV)
    got, _ = lml_md(X, Y, theta.T.contiguous(), family="rbf", n_ls=2, has_noise=True,
                    jitter=1e-10)
    assert torch.allclose(got.to(torch.float64), want, rtol=1e-8, atol=1e-8)


def test_reference_fit_climbs_and_returns_its_best_theta():
    c = spec.cell("floor2d-refit", BENCH)
    inputs = generator.make_inputs(c.config, c.traffic, 4, "cpu", members=4, pool=1)
    X, Y = ref_fit.member_data(inputs.scene.S, inputs.pool[0])
    st, lo, hi = FIT.starts(c.config, 4, 2, 2, generator.generator(4, "cpu", 9), "cpu")
    best, theta = ref_fit.fit(X, Y, st, lo, hi, 1e-10, COV, steps=200)
    assert torch.all(best >= ref_fit.lml(st[:, 0], X, Y, 1e-10, COV))
    assert torch.all((theta >= lo - 1e-9) & (theta <= hi + 1e-9))
    assert torch.allclose(ref_fit.lml(theta, X, Y, 1e-10, COV), best)


@pytest.mark.parametrize("cell,members", [("floor2d-ensemble", 64), ("floor2d-refit", 32)])
def test_small_cpu_run_is_correct(cell, members):
    c = spec.cell(cell, BENCH)
    out = run.run_cell(c, 2**31 + 77, 0.2, False, "cpu", members=members, pool=2)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
