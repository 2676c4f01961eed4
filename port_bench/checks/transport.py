"""The transport's outputs against the plain float64 reference
(``reference/transport.py``) on the same inputs, every member and demo
point of every kept call:

* ``traj_err``, ``std_err``, ``delta_err``, ``delta_var_err``: the largest
  |program − reference| of the field over the largest |reference| of that
  field in the call;
* ``min_abs_det_err``: the largest |program − reference| / |reference| of
  min|det J_Φ|, over every member of the kept call and of every host read
  that can be compared with it (each call's, at fixed hyperparameters).

A field that holds a NaN or an infinity reads infinite.  Where the kept
call carries the program's fitted log-hyperparameters (``theta``, in the
kernel's order: amplitude, lengthscales, noise), the reference takes them,
so it works out everything after the fit again from them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from port_bench import spec
from port_bench.check import finite_max
from port_bench.reference import transport as reference

FIELDS = ("traj", "std", "delta", "delta_var")
NUMBERS = tuple(f"{f}_err" for f in FIELDS) + ("min_abs_det_err",)
# elements of the reference's largest intermediate a block of members may hold
BLOCK_ELEMS = 2.5e7


def member_params(cfg: dict, E: int, theta: Optional[torch.Tensor], device, dtype=torch.float64):
    """(amp (E,), ℓ (E, D), noise (E,)): the configuration's, or exp of the
    fitted log-hyperparameters θ (E, 1 + D + 1)."""
    f = dict(dtype=dtype, device=device)
    if theta is None:
        k = cfg["kernel"]
        return (torch.full((E,), k["amplitude"], **f), torch.tensor(k["lengthscale"], **f).expand(E, -1),
                torch.full((E,), k["noise"], **f))
    p = torch.exp(theta.to(**f))
    return p[:, 0], p[:, 1:-1], p[:, -1]


def blocks(E: int, n: int, D: int, Q: int):
    """Member ranges small enough for the reference's intermediates."""
    step = max(1, int(BLOCK_ELEMS // max(n * n, D * n * Q)))
    return [(lo, min(E, lo + step)) for lo in range(0, E, step)]


def reference_transport(cfg: dict, scene, targets, theta=None, dtype=torch.float64,
                        mm=torch.matmul):
    """The reference's transport of the scene's demo onto ``targets``, in
    blocks of members, at the configuration's or the fitted
    hyperparameters (``dtype`` and ``mm`` as ``reference.transport``'s)."""
    E, n, D = targets.shape
    amp, ls, noise = member_params(cfg, E, theta, targets.device, dtype)
    cov = spec.module("reference", "cov_" + cfg["kernel"]["family"])
    parts = [reference.transport(scene.X, scene.dX, scene.S, targets[lo:hi], amp[lo:hi], ls[lo:hi],
                                 noise[lo:hi], cfg["kernel"]["jitter"], cov, dtype, mm)
             for lo, hi in blocks(E, n, D, scene.X.shape[0])]
    return reference.Transport(*(torch.cat([getattr(p, f) for p in parts])
                                 for f in FIELDS + ("min_abs_det",)))


def compare_call(cfg: dict, scene, targets, result, theta=None):
    """(the kept call's numbers, the reference's min|det J_Φ|)."""
    E, n, D = targets.shape
    if theta is not None and theta.shape[0] != E:  # the fit answered for other members
        return {k: math.inf for k in NUMBERS}, None
    out = {}
    ref_mad = []
    diff = {f: 0.0 for f in FIELDS}
    scale = {f: 0.0 for f in FIELDS}
    for lo, hi in blocks(E, n, D, scene.X.shape[0]):
        ref = reference_transport(cfg, scene, targets[lo:hi], None if theta is None else theta[lo:hi])
        for f in FIELDS:
            got = getattr(result, f)[lo:hi].to(torch.float64)
            want = getattr(ref, f)
            diff[f] = max(diff[f], finite_max((got - want).abs()))
            scale[f] = max(scale[f], float(want.abs().max()))
        ref_mad.append(ref.min_abs_det)
    out = {f"{f}_err": diff[f] / scale[f] if scale[f] > 0 else diff[f] for f in FIELDS}
    ref_mad = torch.cat(ref_mad)
    out["min_abs_det_err"] = mad_err(result.min_abs_det, ref_mad)
    return out, ref_mad


def mad_err(got, ref_mad) -> float:
    if ref_mad is None:
        return math.inf
    rel = (got.to(device=ref_mad.device, dtype=torch.float64) - ref_mad).abs() / ref_mad.abs()
    return finite_max(rel)


def compare(worst, cell, inputs, kept: dict, reads: dict, seed: int, bad) -> int:
    failed = 0
    for b, payload in sorted(kept.items()):
        nums, ref_mad = compare_call(cell.config, inputs.scene, inputs.pool[b], payload["result"],
                                     payload.get("theta"))
        for k, v in nums.items():
            worst.add(k, v)
        per_call = [mad_err(m, ref_mad) for m in reads[b]]
        for v in per_call:
            worst.add("min_abs_det_err", v)
        failed += sum(bad("min_abs_det_err", e) for e in per_call)
        # the kept call, where its host read was not already counted
        failed += (not (per_call and bad("min_abs_det_err", per_call[-1]))
                   and any(bad(k, v) for k, v in nums.items()))
    return failed
