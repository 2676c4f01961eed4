"""The generator makes the same work from the same seed, and other work
from another."""
import pytest
import torch

from port_bench import generator, spec

BENCH = spec.benchmark()
BIG_SEED = 2**31 + 987654321


def small(cell):
    c = spec.cell(cell, BENCH)
    return c, dict(members=5, pool=2)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_deterministic_for_a_seed(cell):
    c, kw = small(cell)
    a = generator.make_inputs(c.config, c.traffic, BIG_SEED, "cpu", **kw)
    b = generator.make_inputs(c.config, c.traffic, BIG_SEED, "cpu", **kw)
    other = generator.make_inputs(c.config, c.traffic, BIG_SEED + 1, "cpu", **kw)
    for x, y in zip(a.pool, b.pool):
        assert torch.equal(x, y)
    assert torch.equal(a.scene.X, b.scene.X) and torch.equal(a.scene.S, b.scene.S)
    assert not torch.equal(a.pool[0], other.pool[0])
    assert not torch.equal(a.pool[0], a.pool[1])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_shapes_and_dtype(cell):
    c, kw = small(cell)
    inp = generator.make_inputs(c.config, c.traffic, 3, "cpu", **kw)
    cfg = c.config
    n, Q, D = cfg["dist_points"], cfg["demo_points"], cfg["dims"]
    assert inp.scene.X.shape == (Q, D) and inp.scene.S.shape == (n, D)
    assert all(t.shape == (5, n, D) and t.dtype == torch.float32 for t in inp.pool)
    assert torch.all(inp.scene.dX[-1] == 0)
    full = generator.make_inputs(c.config, c.traffic, 3, "cpu", members=5, pool=None)
    assert len(full.pool) == c.traffic["pool"]


def test_refit_members_are_the_same_set_in_every_seed():
    c = spec.cell("floor2d-refit", BENCH)
    sets = [generator.make_inputs(c.config, c.traffic, s, "cpu", members=6, pool=1).pool[0]
            for s in (0, 1, BIG_SEED)]
    keys = [sorted(b[:, :, -1].sum(1).tolist()) for b in sets]
    assert keys[0] == pytest.approx(keys[1]) and keys[0] == pytest.approx(keys[2])
    assert not torch.equal(sets[0], sets[1])  # another order
