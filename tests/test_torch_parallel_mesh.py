"""The port's meshes, process groups and rank launcher, on gloo ranks on
the CPU (the counterpart of tests/test_multihost.py, without the ``slow``
mark: a few seconds here)."""
import time

import pytest
import torch

from gaussian_process_transportation_tpu_torch.parallel import _launch, _programs
from gaussian_process_transportation_tpu_torch.parallel import distributed as tdist
from gaussian_process_transportation_tpu_torch.parallel.mesh import shard_slice

torch.set_num_threads(1)

WORLD, TOTAL = 4, 10
SHAPES = ((4, 1), (1, 4), (2, 2))


@pytest.fixture(scope="module")
def layouts():
    return _launch.launch(_programs.mesh_layout, (SHAPES, TOTAL), nprocs=WORLD)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_make_mesh_axes_and_their_backend(layouts, shape):
    """Rank r sits at (r // n_data, r % n_data); each axis' group has the
    default group's backend (gloo here: a sub-group that picked NCCL would
    break gloo on CUDA tensors); the data axis sums its members' ranks."""
    n_ens, n_data = shape
    for r, out in enumerate(layouts):
        rec = out[shape]
        e, d = divmod(r, n_data)
        assert rec["ens"] == dict(size=n_ens, index=e, ranks=[i * n_data + d for i in range(n_ens)],
                                  backend="gloo")
        assert rec["data"] == dict(size=n_data, index=d,
                                   ranks=[e * n_data + i for i in range(n_data)], backend="gloo")
        assert rec["data_sum"].item() == sum(rec["data"]["ranks"])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_global_put_slices_and_gather(layouts, shape):
    """global_put is this rank's contiguous shard over 'ens' (the last shard
    takes the rest), the replicated sharding returns the array itself, and
    the shards gathered over 'ens' are the whole array; on a (world, 1) mesh
    the shard is process_local_slice's."""
    x = torch.arange(TOTAL * 3, dtype=torch.float64).reshape(TOTAL, 3)
    n_ens, n_data = shape
    for r, out in enumerate(layouts):
        rec = out[shape]
        assert torch.equal(rec["put"], x[shard_slice(TOTAL, r // n_data, n_ens)])
        assert rec["replicated_is_x"] and torch.equal(rec["gathered"], x)
        if shape == (WORLD, 1):
            assert torch.equal(rec["put"], x[out["process_local_slice"]])
    assert [o["process_local_slice"] for o in layouts] == [slice(0, 2), slice(2, 4), slice(4, 6),
                                                          slice(6, 10)]


def test_initialize_reads_the_environment(layouts):
    """Four OS processes joined one group by ``initialize(backend=...)``
    from COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID alone (what the
    launcher sets, a file:// rendezvous); one process without a backend is
    a no-op."""
    assert [o["group"] for o in layouts] == [(r, WORLD, "gloo") for r in range(WORLD)]
    assert all(o[(1, WORLD)]["data_sum"].item() == sum(range(WORLD)) for o in layouts)
    tdist.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()


def test_a_failing_rank_stops_every_rank():
    """A rank that raises before a collective: the launcher kills the rank
    waiting in it and raises with the failing rank's traceback."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="injected failure on rank 1"):
        _launch.launch(_programs.fail_before_collective, (1,), nprocs=2)
    assert time.monotonic() - t0 < 60


def test_the_deadline_stops_a_hung_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="still ran after 4"):
        _launch.launch(_programs.hang, nprocs=2, deadline_s=4)
    assert time.monotonic() - t0 < 30
