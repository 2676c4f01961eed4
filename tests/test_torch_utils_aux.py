"""Port parity: ``utils/config.py`` and ``utils/logging_utils.py`` against
the JAX package's on the CPU: the built kernels' Grams to 1e-12, the
configs and presets equal field by field, the recorder's file the same;
``timed`` and ``device_trace`` on the port's terms."""
import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.utils import config as jcfg
from gaussian_process_transportation_tpu.utils import logging_utils as jlog
from gaussian_process_transportation_tpu_torch.utils import config as tcfg
from gaussian_process_transportation_tpu_torch.utils import logging_utils as tlog

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

PRESETS = ("surface_2d_transport_config", "dynamics_2d_config", "multi_frame_transport_config")


def _kernel_config(preset):
    c = preset()
    return c if isinstance(c, (tcfg.KernelConfig, jcfg.KernelConfig)) else c.kernel


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_build_jax_kernels(preset):
    tc, jc = getattr(tcfg, preset)(), getattr(jcfg, preset)()
    assert json.dumps(dataclasses.asdict(tc)) == json.dumps(dataclasses.asdict(jc))
    tk, jk = _kernel_config(getattr(tcfg, preset)), _kernel_config(getattr(jcfg, preset))
    X = np.random.default_rng(3).standard_normal((7, 2))
    got = tk.build(dtype=torch.float64, device="cpu")(torch.as_tensor(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(jk.build()(jnp.asarray(X))),
                               rtol=1e-12, atol=1e-12)
    # the json round trip keeps every field, bounds and ν included
    back = tcfg.KernelConfig.from_json(tk.to_json())
    assert back == tk and tk.to_json() == jk.to_json()
    assert got.dtype == torch.float64
    assert tk.build(device="cpu")(torch.as_tensor(X, dtype=torch.float32)).dtype == torch.float32


def test_kernel_specs_build_every_kind():
    specs = ((tcfg.KernelSpec("constant", value=2.0),
              tcfg.KernelSpec("matern", lengthscale=(0.5, 2.0), nu=1.5, bounds=(0.1, 10.0))),
             (tcfg.KernelSpec("white", value=0.1),))
    jspecs = tuple(tuple(jcfg.KernelSpec(**dataclasses.asdict(s)) for s in g) for g in specs)
    X = np.random.default_rng(4).standard_normal((6, 2))
    got = tcfg.KernelConfig(specs).build(dtype=torch.float64, device="cpu")
    want = jcfg.KernelConfig(jspecs).build()
    np.testing.assert_allclose(got(torch.as_tensor(X)).numpy(), np.asarray(want(jnp.asarray(X))),
                               rtol=1e-12, atol=1e-12)
    assert got.k1.k2.bounds == (0.1, 10.0) and got.k1.k2.nu == 1.5
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tcfg.KernelConfig(((tcfg.KernelSpec("linear"),),)).build(device="cpu")
    assert tcfg.MeshConfig() == tcfg.MeshConfig(n_ens=None, n_data=1)
    assert tcfg.dynamics_2d_config().terms[0][0].value == math.sqrt(0.1)


def test_metrics_recorder_writes_jax_file(tmp_path):
    for mod, name in ((tlog, "t.json"), (jlog, "j.json")):
        rec = mod.MetricsRecorder()
        rec.record("loss", 1.5)
        rec.record("loss", torch.tensor(1.0) if mod is tlog else 1.0, step=7)
        assert rec.last("loss") == 1.0 and rec.last("missing") is None
        rec.dump(str(tmp_path / "sub" / name))
    assert (tmp_path / "sub" / "t.json").read_text() == (tmp_path / "sub" / "j.json").read_text()
    assert tlog.get_logger().name == jlog.get_logger().name


def test_timed_records_the_block_and_device_trace_writes_a_chrome_trace(tmp_path):
    rec = tlog.MetricsRecorder()
    with tlog.timed("block", rec):
        torch.ones(8).sum()
    assert rec.last("time/block") >= 0.0
    with tlog.device_trace(str(tmp_path / "trace")) as prof:
        (torch.ones(16, 16) @ torch.ones(16, 16)).sum()
    assert prof is not None
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
