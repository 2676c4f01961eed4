"""``transport.gpt.fit_and_transport_batched_opt``: each call re-fits
every member's hyperparameters (``models.exact_gp.fit_ensemble_fused``,
the configuration's starts and iterations, the random starts drawn from
the seed), transports the demo onto one batch of E targets at them, and
ends in the host read of min|det J_Φ| (E floats).  The fitted θ is
captured for the checks: each call fits its own, so only the kept call's
host read can be compared."""
from port_bench import controls, faults, generator, program, spec

ENTRY = "transport.gpt.fit_and_transport_batched_opt"
FIT = "models.exact_gp.fit_ensemble_fused"


def prepare(cfg, traffic, inputs, device, seed) -> program.Caller:
    fn = program.entry(ENTRY)
    kern = spec.module("kernels", cfg["kernel"]["family"]).make(cfg, device)
    sc = inputs.scene
    kw = dict(jitter=cfg["kernel"]["jitter"], n_restarts=cfg["refit"]["restarts"],
              maxiter=cfg["refit"]["maxiter"], generator=generator.generator(seed, device, 3),
              **sc.extra)
    capture = program.Capture(FIT)

    def call(targets):
        capture.last = None
        res = fn(kern, sc.S, targets, sc.X, sc.dX, **kw)
        theta = None if capture.last is None else capture.last[0]
        return res.min_abs_det, {"result": res, "theta": theta}
    return program.Caller(call, capture.installed, own_state=True)


CONTROLS = {"program_tf32": controls.program_tf32(prepare),
            "reference_fit_bf16": controls.reference_fit_bf16}
FAULTS = {"unchanged": faults.fit_unchanged, "half_batch": faults.half_batch(ENTRY),
          "altered": faults.apply_altered}
