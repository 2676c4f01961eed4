"""The port's ``dryrun_multichip`` on eight gloo ranks on the CPU against
the JAX package's recorded run on eight devices (MULTICHIP_r05.json):
the joint step's loss and the distributed LML depend only on E = 512 and
N = 2048, not on the mesh or the devices."""
import json
import pathlib
import re

import torch

from gaussian_process_transportation_tpu_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(1)

RECORD = pathlib.Path(__file__).resolve().parent.parent / "MULTICHIP_r05.json"


def _summary(text):
    line = [ln for ln in text.splitlines() if ln.startswith("dryrun_multichip OK:")][-1]
    return {k: v for k, v in re.findall(r"(\w+)=(\([^)]*\)|[-\d.]+)", line)}, line


def test_dryrun_on_eight_ranks_matches_the_jax_record(capfd):
    outs = dryrun_multichip(8, device="cpu")
    got, line = _summary(capfd.readouterr().out)
    want, _ = _summary(json.loads(RECORD.read_text())["tail"])
    assert line.startswith("dryrun_multichip OK: mesh={'ens': 4, 'data': 2}, E=512,"), line
    for key in ("loss", "sharded_lml"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-4 * abs(float(want[key])), key
    assert got["hmc_chains"] == "(8, 10, 4)"
    assert [o["rank"] for o in outs] == list(range(8))
    assert all(o["backend"] == "gloo" and o["loss"] == outs[0]["loss"] for o in outs)
    assert outs[0]["chol_err"] < 2e-3
