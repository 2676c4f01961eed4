"""``transport.gpt.fit_and_transport_batched``: each call transports the
demo onto one batch of E targets at the configuration's hyperparameters
and ends in the host read of min|det J_Φ| (E floats)."""
from port_bench import controls, faults, program, spec

ENTRY = "transport.gpt.fit_and_transport_batched"


def prepare(cfg, traffic, inputs, device, seed) -> program.Caller:
    fn = program.entry(ENTRY)
    kern = spec.module("kernels", cfg["kernel"]["family"]).make(cfg, device)
    sc = inputs.scene
    kw = dict(jitter=cfg["kernel"]["jitter"], **sc.extra)

    def call(targets):
        res = fn(kern, sc.S, targets, sc.X, sc.dX, **kw)
        return res.min_abs_det, {"result": res}
    return program.Caller(call)


CONTROLS = {"program_tf32": controls.program_tf32(prepare),
            "reference_bf16": controls.reference_bf16}
FAULTS = {"unchanged": faults.apply_unchanged, "half_batch": faults.half_batch(ENTRY),
          "altered": faults.apply_altered}
