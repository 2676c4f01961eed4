"""Controls: the timed path computed in a precision below the
configuration's (float32 with TF32 off), for reading the upper end of each
compared number (``calibrate.py``; the benchmark's own runs do not run
them).  Each entry names its own in its ``CONTROLS``, each a factory of the
same signature as the entry's ``prepare``.

* ``program_tf32(prepare)``: the program itself with its float32 products
  in TF32, the nearest precision below, on its own path (the package pins
  TF32 off).  It reaches the variances (K⁻¹k* is a batched product); the
  mean and the Jacobian contract 2-wide axes in kernels TF32 leaves alone.
* ``reference_bf16``: the plain reference put in the program's place, in
  float32 with every product's operands in bfloat16, the precision below
  for float32 arithmetic that TF32 does not reach; its factor and solves
  stay float32 (torch has none in bfloat16).
* ``reference_fit_bf16``: the same for the refit: the reference's fit, its
  likelihood's Gram rounded to bfloat16 (it has no product), from the
  configuration's starts, then ``reference_bf16``'s transport at the fitted
  hyperparameters.
"""
from __future__ import annotations

import contextlib

import torch

from . import generator, program, spec
from .reference import fit as ref_fit


@contextlib.contextmanager
def tf32():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])


def bf16_mm(a, b):
    """a @ b with both operands rounded to bfloat16."""
    return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)).to(a.dtype)


def bf16_round(x):
    return x.to(torch.bfloat16).to(x.dtype)


def program_tf32(prepare):
    def control(cfg, traffic, inputs, device, seed) -> program.Caller:
        caller = prepare(cfg, traffic, inputs, device, seed)

        @contextlib.contextmanager
        def installed():
            with tf32(), caller.installed():
                yield

        return program.Caller(caller.call, installed, caller.own_state)
    return control


def reference_bf16(cfg, traffic, inputs, device, seed) -> program.Caller:
    transport = spec.module("checks", "transport")

    def call(targets):
        res = transport.reference_transport(cfg, inputs.scene, targets, dtype=torch.float32,
                                            mm=bf16_mm)
        return res.min_abs_det, {"result": res}
    return program.Caller(call)


def reference_fit_bf16(cfg, traffic, inputs, device, seed) -> program.Caller:
    transport = spec.module("checks", "transport")
    fit = spec.module("checks", "fit")
    cov = spec.module("reference", "cov_" + cfg["kernel"]["family"])
    g = generator.generator(seed, device, 3)
    f32 = torch.float32

    def call(targets):
        E, n, D = targets.shape
        X, Y = ref_fit.member_data(inputs.scene.S, targets, f32, bf16_mm)
        st, lo, hi = fit.starts(cfg, E, D, cfg["refit"]["restarts"], g, targets.device, f32)
        _, theta = ref_fit.fit(X, Y, st, lo, hi, cfg["kernel"]["jitter"], cov, gram=bf16_round)
        theta = theta.detach()
        res = transport.reference_transport(cfg, inputs.scene, targets, theta, dtype=f32, mm=bf16_mm)
        return res.min_abs_det, {"result": res, "theta": theta}
    return program.Caller(call, own_state=True)
