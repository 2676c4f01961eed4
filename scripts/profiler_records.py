#!/usr/bin/env python3
"""Check whether torch.profiler's CUDA sessions hold every kernel launch
they traced, before and after a session of ~141k launches (the HMC path of
``chip_smoke.py`` phase 14), and whether a wait before a session closes, or
a throwaway launch (``torch.cuda._sleep``) opening it, keeps every record:
``chip_smoke.traced`` opens its sessions so.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/profiler_records.py

Each line: when, (calls of kernel #3, launches of torch.cuda._sleep after
them, seconds waited before the session closed, sleep launches before
them), then (launches of #3 the session holds, their device µs a call,
sleep launches held).
"""
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from gaussian_process_transportation_tpu_torch import kernels as K  # noqa: E402
from gaussian_process_transportation_tpu_torch.ops import fused_lml as fl  # noqa: E402
from gaussian_process_transportation_tpu_torch.parallel import samplers  # noqa: E402

P = torch.profiler


def trace(fn, reps, pad, wait, lead=0):
    with P.profile(activities=[P.ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        for _ in range(pad):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(wait)
    rows = prof.key_averages()
    mine = [e for e in rows if "lml_kernel" in e.key]
    spin = [e for e in rows if "spin" in e.key.lower() or "sleep" in e.key.lower()]
    return (sum(e.count for e in mine), sum(e.self_device_time_total for e in mine) / reps,
            sum(e.count for e in spin))


def report(when, fn):
    for args in ((1, 0, 0.0), (5, 0, 0.0), (5, 8, 0.0), (5, 0, 0.2), (1, 0, 0.0, 1),
                 (5, 0, 0.0, 1), (5, 0, 0.0, 1), (1, 0, 0.0, 1), (5, 0, 0.2, 1)):
        print(when, args, trace(fn, *args), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("profiler_records: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    X, Y, th = cs.lml_inputs(dev, cs.E_FIT * (cs.RESTARTS + 1), cs.N_MAIN, 2, 2, 2, True, True)

    def kernel():
        return fl.small_lml_value_grad_md(X, Y, th, "rbf", 2, True)

    kernel()
    torch.cuda.synchronize()
    report("fresh", kernel)
    X14, Y14 = (torch.as_tensor(a, device=dev) for a in cs.hmc_inputs())
    kern14 = K.Constant(1.0) * K.RBF(torch.ones(2, device=dev)) + K.White(0.01)

    def hmc():
        return samplers.sample_gp_posterior(
            kern14, X14, Y14, seed=0, num_chains=cs.HMC_CHAINS, num_warmup=cs.HMC_WARMUP,
            num_samples=cs.HMC_SAMPLES, num_leapfrog=cs.HMC_LEAPFROG)

    print(cs.fmt_breakdown(cs.path_breakdown(hmc, "lml_kernel")), flush=True)
    report("after the HMC trace", kernel)


if __name__ == "__main__":
    main()
