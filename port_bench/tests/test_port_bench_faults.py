"""A run with its timed path broken underneath comes out not correct: once
for each fault a cell's entry can have (one chip: no exchange between
chips).  The check of the card is skipped: these drive the rest of a run on
the CPU at small sizes.  The controls run on the card only: TF32 exists
only there."""
import pytest

from port_bench import run, spec

BENCH = spec.benchmark()
SIZES = {"floor2d-ensemble": 64, "floor2d-refit": 32}
CARD_SIZES = {"floor2d-ensemble": 2048, "floor2d-refit": 512}


def entry(cell):
    return spec.module("entries", spec.cell(cell, BENCH).traffic["entry"])


def test_every_cell_is_sized():
    assert set(SIZES) == set(CARD_SIZES) == {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(SIZES) for f in sorted(entry(c).FAULTS)])
def test_fault_is_not_correct(cell, fault):
    c = spec.cell(cell, BENCH)
    out = run.run_cell(c, 91, 0.2, False, "cpu", members=SIZES[cell], pool=2,
                       plant=entry(cell).FAULTS[fault])
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_every_entry_has_its_three_faults(cell):
    assert set(entry(cell).FAULTS) == {"unchanged", "half_batch", "altered"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", [(c, k) for c in sorted(SIZES) for k in sorted(entry(c).CONTROLS)])
def test_control_is_not_correct(cell, control, cuda_device):
    c = spec.cell(cell, BENCH)
    out = run.run_cell(c, 92, 0.5, False, cuda_device, members=CARD_SIZES[cell], pool=2,
                       prepare=entry(cell).CONTROLS[control], warmup=0)
    assert not out["correct"], out["checks"]
