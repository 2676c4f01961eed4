"""The refit's own check: how far each member's fitted hyperparameters fall
short of the highest likelihood the plain float64 fit reaches.

For a sample of members drawn from the seed across the kept calls,

    fit_shortfall = max over the sample of
        max(0, best_ref − lml(θ_program)) / max(best_ref − lml(θ_start), 1)

with every likelihood the reference's float64 one on the member's own data
(``reference/fit.py``), best_ref the best the reference's fit reaches from
the configuration's θ and six starts of its own, and θ_start the
configuration's θ, where the program's fit starts.  A fit that stops where
it started reads 1 on a member that the fit can improve by a nat or more.
"""
from __future__ import annotations

import math

import torch

from port_bench import generator, spec
from port_bench.reference import fit as ref_fit

SAMPLE = 256  # members the reference fits, spread over the kept calls
STARTS = 6  # the reference's own starts besides the configuration's θ


def log_bounds(cfg: dict, D: int, device, dtype=torch.float64):
    b = cfg["kernel"]["bounds"]
    rows = [b["amplitude"]] + [b["lengthscale"]] * D + [b["noise"]]
    t = torch.log(torch.tensor(rows, dtype=dtype, device=device))
    return t[:, 0], t[:, 1]


def start_theta(cfg: dict, device, dtype=torch.float64) -> torch.Tensor:
    k = cfg["kernel"]
    return torch.log(torch.tensor([k["amplitude"], *k["lengthscale"], k["noise"]], dtype=dtype,
                                  device=device))


def starts(cfg: dict, B: int, D: int, R: int, g: torch.Generator, device, dtype=torch.float64):
    """(B, 1 + R, 2 + D): the configuration's θ, then R uniform in the box."""
    lo, hi = log_bounds(cfg, D, device, dtype)
    t0 = start_theta(cfg, device, dtype).expand(B, -1)
    u = torch.rand((B, R, len(lo)), generator=g, dtype=dtype, device=device)
    return torch.cat([t0[:, None], lo + u * (hi - lo)], 1), lo, hi


def compare(worst, cell, inputs, kept: dict, reads: dict, seed: int, bad) -> int:
    cfg = cell.config
    device = inputs.pool[0].device
    S = inputs.scene.S
    batches = sorted(kept)
    E, n, D = inputs.pool[0].shape
    if any(kept[b].get("theta") is None or kept[b]["theta"].shape[0] != E for b in batches):
        worst.add("fit_shortfall", math.inf)  # no fit, or one for other members
        return len(batches)
    cov = spec.module("reference", "cov_" + cfg["kernel"]["family"])
    per = max(1, SAMPLE // len(batches))
    g = generator.generator(seed, device, 4)
    Xs, Ys, th = [], [], []
    for b in batches:
        idx = torch.randperm(E, generator=g, device=device)[:per]
        X, Y = ref_fit.member_data(S, inputs.pool[b][idx])
        Xs.append(X)
        Ys.append(Y)
        th.append(kept[b]["theta"][idx].to(torch.float64))
    X, Y, th = torch.cat(Xs), torch.cat(Ys), torch.cat(th)
    jitter = cfg["kernel"]["jitter"]
    st, lo, hi = starts(cfg, len(X), D, STARTS, g, device)
    best, _ = ref_fit.fit(X, Y, st, lo, hi, jitter, cov)
    with torch.no_grad():
        got = ref_fit.lml(th, X, Y, jitter, cov)
        at_start = ref_fit.lml(st[:, 0], X, Y, jitter, cov)
    short = (best - got).clamp(min=0) / (best - at_start).clamp(min=1.0)
    value = float(short.max()) if bool(torch.isfinite(short).all()) else math.inf
    worst.add("fit_shortfall", value)
    return len(batches) * bad("fit_shortfall", value)
