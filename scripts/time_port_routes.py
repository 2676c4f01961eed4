#!/usr/bin/env python3
"""Time the routes of the PyTorch port whose thresholds are set from
measurements, and the panel kernel they rest on, on one CUDA card:

* ``predict``: ``predict(return_std)`` with a cached K⁻¹, the fused
  mean-and-variance kernel against the dense path (k K⁻¹ through cuBLAS) on
  a 100×100 query grid, at each N of ``--predict-n``
  (``models/exact_gp.py::FUSED_MEAN_VAR_MAX_N``).  An N that is no multiple
  of 4 leaves K⁻¹'s rows unaligned, the kernel's 4-byte copies;
* ``chol``: ``condition()``'s solve, the blocked Cholesky against
  ``torch.linalg.cholesky`` on the dense Gram, at each N of ``--chol-n``
  (``models/exact_gp.py::BLOCKED_CHOL_MIN_N``);
* ``member``: one member of the 3-D ensemble transport
  (``fit_and_transport_batched`` with E=1, D=3, Q=1000, the inputs of
  ``chip_smoke.ensemble_3d_inputs`` at n points) through the blocked
  Cholesky and through the dense route (``torch.linalg.cholesky`` and K⁻¹),
  at each n of ``--member-n`` (``transport/gpt.py::BLOCKED_MIN_N``);
* ``panel``: ``factor_panel`` at B=512 (the panels of both routes above)
  and the cuSOLVER pair (``cholesky`` then ``solve_triangular``) on the
  same block (``chip_smoke.py`` phase 7 prints its launches per call and
  its diagonal step's time);
* ``lml``: the fused-LML kernels #2 and #3 at their paths' shapes, #3's
  value-only instance where the tree has one, each reading with the SM
  clock (``nvidia-smi`` clocks.sm and clocks.max.sm) before and after it;
* ``paths``: fits/s of ``fit_ensemble_fused`` and ``hmc_samples_per_s`` of
  ``sample_gp_posterior``, at ``chip_smoke.py``'s phase 13 and 14 sizes;
* ``kernels``: kernels #1 (``spd_inverse_elast_fused`` at E=16384, n=20)
  and #5 (``fused_gp_predict_mean`` on the 100×100 grid, N=2048, P=2) at
  their paths' shapes beside their library calls, each reading with the
  SM clock before and after it: with ``--root`` the parent tree's kernels;
* ``gram``: kernel #7 at its paths' shapes: the N=10240 solve's Gram
  (``stationary_gram_panels`` at B=512), the 3-D ensemble's (16 calls at
  n=2500, D=3), one (10240, 512) panel of the generic ``stationary_gram``,
  and the panels' plain twin where the tree has one; the device ms
  of every kernel the call launches (scaling copies and diagonal passes
  included) and of the Gram kernel alone, each reading with the SM clock
  before and after it: with ``--root`` the parent tree's panels;
* ``route``: ``predict()`` both ways around ``FUSED_PREDICT_MIN_ELEMS`` and
  ``FUSED_MEAN_VAR_MIN_ELEMS`` (``models/exact_gp.py``): the fused mean
  kernel against the dense product, and the mean-and-variance kernel
  against the dense path, at Nq·N from 2,048 to 2·10⁷ (Nq = 10⁴ with N in
  ``--route-n``, and N = 2048 with Nq in ``--route-nq``).

Run from the repository root: ``python3 scripts/time_port_routes.py``
(``--what`` picks the parts).  ``--root DIR`` imports the port and
``chip_smoke.py`` from another checkout instead, so that two trees are
timed on one card in one call.  One line per size: device ms (CUPTI, mean of
5) and CUDA-event ms (median of 5), each after a warm-up, twice in turn, with
the card's name and power limit first (``paths``: CUDA-event ms only,
medians of 5 and 3).
"""
import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

PARTS = ("predict", "chol", "member", "panel", "lml", "paths", "kernels", "gram", "route")


def time_predicts(cs, pkg, device, sizes):
    K, gp_core, pg = pkg["kernels"], pkg["exact_gp"], pkg["pallas_gram"]
    f32 = dict(dtype=torch.float32, device=device)
    Xq = torch.as_tensor(cs.grid_inputs()[2], **f32)
    kern = K.Constant(2.0) * K.RBF(torch.ones(2, **f32)) + K.White(0.1)
    ones2 = torch.ones(2, **f32)
    for N in sizes:
        X = torch.as_tensor(np.random.default_rng(N).standard_normal((N, 2)), **f32)
        gp = gp_core.condition(kern, X, torch.sin(X), cache_k_inv=True)
        a, Ki = gp.alpha, gp.K_inv

        def fused():
            return pg.fused_gp_predict_mean_var(Xq, X, a, Ki, ones2, 2.0, 2.1)

        def dense():
            k = kern(Xq, X)
            return k @ a, kern.diag(Xq) - ((k @ Ki) * k).sum(-1)

        for _ in range(2):
            print(f"predict(return_std) Nq={Xq.shape[0]} N={N}: kernel "
                  f"{cs.device_ms(fused):.4f} device / {cs.cuda_ms(fused)[0]:.4f} event ms, "
                  f"dense path {cs.device_ms(dense):.4f} / {cs.cuda_ms(dense)[0]:.4f}", flush=True)


def time_solves(cs, pkg, device, sizes):
    bc, pg = pkg["blocked_chol"], pkg["pallas_gram"]
    ls3 = torch.ones(cs.D_SOLVE, dtype=torch.float32, device=device)
    for N in sizes:
        X, Y = cs.solve_inputs(device, N)

        def blocked():
            return bc.gram_cholesky_solve(X, Y, ls3, 2.0, 0.1, block=cs.BLOCK)[0]

        def dense():
            Kd = pg.stationary_gram_plain(X, X, ls3, 2.0)
            Kd.diagonal().add_(0.1)
            return torch.cholesky_solve(Y, torch.linalg.cholesky(Kd))

        for _ in range(2):
            print(f"condition N={N}: blocked {cs.cuda_ms(blocked)[0]:.4f} event ms, "
                  f"dense {cs.cuda_ms(dense)[0]:.4f}", flush=True)


def member_inputs(n, device):
    """chip_smoke.ensemble_3d_inputs's recipe at n points: a surface S (n, 3)
    scaled by 2, one target S + 0.05·noise, a Q=1000 demo; seed 0, f32."""
    rng = np.random.default_rng(0)
    S = rng.standard_normal((n, 3)).astype(np.float32) * 2.0
    T = S[None] + 0.05 * rng.standard_normal((1, n, 3)).astype(np.float32)
    X = rng.standard_normal((1000, 3)).astype(np.float32) * 2.0
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return tuple(torch.as_tensor(a, device=device) for a in (S, T, X, dX))


def time_members(cs, pkg, device, sizes):
    K, gpt = pkg["kernels"], pkg["gpt"]
    kern = (K.Constant(2.0) * K.RBF(2.0 * torch.ones(3, dtype=torch.float32, device=device))
            + K.White(0.01))
    default = gpt.BLOCKED_MIN_N
    for n in sizes:
        args = member_inputs(n, device)

        def route(min_n):
            def run():
                gpt.BLOCKED_MIN_N = min_n
                try:
                    return gpt.fit_and_transport_batched(kern, *args)
                finally:
                    gpt.BLOCKED_MIN_N = default
            return run

        blocked, dense = route(0), route(n + 1)
        for _ in range(2):
            print(f"3-D member n={n}: blocked {cs.cuda_ms(blocked)[0]:.4f} event ms, dense "
                  f"(torch.linalg.cholesky + K^-1) {cs.cuda_ms(dense)[0]:.4f}; "
                  f"BLOCKED_MIN_N = {default}", flush=True)


def time_panel(cs, pkg, device, B=512):
    """The first diagonal block of the N=10240 solve's Gram, as chip_smoke's
    kernel record times it."""
    bc = pkg["blocked_chol"]
    X = cs.solve_inputs(device)[0]
    ls3 = torch.ones(cs.D_SOLVE, dtype=torch.float32, device=device)
    A = bc.stationary_gram_panels(X, ls3, 2.0, 0.1, B)[0][0][:B].contiguous()
    eye = torch.eye(B, dtype=torch.float32, device=device)

    def kernel():
        return bc.factor_panel(A)

    def library():
        return torch.linalg.solve_triangular(torch.linalg.cholesky(A), eye, upper=False)

    for _ in range(2):
        print(f"factor_panel B={B}: {cs.device_ms(kernel):.4f} device / "
              f"{cs.cuda_ms(kernel)[0]:.4f} event ms; cholesky + solve_triangular "
              f"{cs.device_ms(library):.4f} / {cs.cuda_ms(library)[0]:.4f}", flush=True)


def sm_clocks():
    """clocks.sm and clocks.max.sm (MHz) as nvidia-smi reads them now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def time_lml(cs, pkg, device):
    """Kernels #2 and #3 at their paths' shapes (phase 12's main cases), and
    #3's value-only instance where the tree has one; the SM clock sampled
    just before and just after each reading."""
    fl = pkg["fused_lml"]
    runs = [("small_lml_value_grad", cs.HMC_CHAINS, ("rbf", cs.N_MAIN, 2, 1, 2, True)),
            ("small_lml_value_grad_md", cs.E_FIT * (cs.RESTARTS + 1),
             ("rbf", cs.N_MAIN, 2, 2, 2, True))]
    if hasattr(fl, "_small_lml_value_md"):
        runs.append(("_small_lml_value_md", runs[1][1], runs[1][2]))
    for name, lanes, case in runs:
        fam, n, D, p, n_ls, noise = case
        X, Y, th = cs.lml_inputs(device, lanes, n, D, p, n_ls, noise, "_md" in name)
        fn = getattr(fl, name)

        def kernel():
            return fn(X, Y, th, fam, n_ls, noise)

        for _ in range(2):
            before = sm_clocks()
            dev, event = cs.device_ms(kernel), cs.cuda_ms(kernel)[0]
            print(f"{name} lanes={lanes} n={n} D={D} p={p}: {dev:.4f} device / {event:.4f} event "
                  f"ms; clocks.sm, clocks.max.sm before {before}, after {sm_clocks()}",
                  flush=True)


def time_paths(cs, pkg, device):
    """fits/s and hmc_samples_per_s as chip_smoke's phases 13 and 14 time
    them (CUDA events; median of 5 and of 3)."""
    K, gp_core, samplers = pkg["kernels"], pkg["exact_gp"], pkg["samplers"]
    affine = pkg["affine"]
    f32 = dict(dtype=torch.float32, device=device)
    X, dX, S, S1 = cs.make_workload()
    Sd = torch.as_tensor(S, **f32)
    T = torch.as_tensor(cs.fit_targets(S1, cs.E_FIT), **f32)
    kern = cs.fit_kernel(**f32)
    src = affine.predict(affine.fit_batched(Sd, T), Sd)

    def fit():
        return gp_core.fit_ensemble_fused(kern, src, T - src, n_restarts=cs.RESTARTS,
                                          maxiter=cs.MAXITER,
                                          generator=torch.Generator(device=device).manual_seed(0))

    X14, Y14 = (torch.as_tensor(a, **f32) for a in cs.hmc_inputs())
    kern14 = K.Constant(1.0) * K.RBF(torch.ones(2, **f32)) + K.White(0.01)

    def hmc():
        return samplers.sample_gp_posterior(
            kern14, X14, Y14, seed=0, num_chains=cs.HMC_CHAINS, num_warmup=cs.HMC_WARMUP,
            num_samples=cs.HMC_SAMPLES, num_leapfrog=cs.HMC_LEAPFROG)

    for _ in range(2):
        fit_ms = cs.cuda_ms(fit)[0]
        hmc_ms = cs.cuda_ms(hmc, reps=3)[0]
        print(f"fit_ensemble_fused E={cs.E_FIT}: {fit_ms:.4f} event ms = fits_per_s "
              f"{cs.E_FIT / (fit_ms / 1e3):.1f}; sample_gp_posterior {cs.HMC_CHAINS} chains: "
              f"{hmc_ms:.4f} event ms = hmc_samples_per_s "
              f"{cs.HMC_CHAINS * cs.HMC_SAMPLES / (hmc_ms / 1e3):.1f}", flush=True)


def time_kernels(cs, pkg, device):
    """Kernels #1 and #5 at their paths' shapes (chip_smoke.py phase 11's
    inputs), their library calls beside them."""
    K, bl, pg = pkg["kernels"], pkg["batched_linalg"], pkg["pallas_gram"]
    f32 = dict(dtype=torch.float32, device=device)
    K_main = cs.spd_batch(cs.N_MAIN, cs.E_MAIN)
    Ke = torch.from_numpy(np.transpose(K_main, (1, 2, 0))).to(**f32).contiguous()
    Kb = torch.from_numpy(K_main).to(**f32)
    Xg, Yg, Xqg = (torch.as_tensor(a, **f32) for a in cs.grid_inputs())
    kern = K.Constant(2.0) * K.RBF(torch.ones(2, **f32)) + K.White(0.1)
    gp = pkg["exact_gp"].condition(kern, Xg, Yg, cache_k_inv=True)
    ones2 = torch.ones(2, **f32)
    runs = [(f"spd_inverse_elast_fused n={cs.N_MAIN} E={cs.E_MAIN}",
             lambda: bl.spd_inverse_elast_fused(Ke),
             ("cholesky + cholesky_inverse",
              lambda: torch.cholesky_inverse(torch.linalg.cholesky(Kb)))),
            (f"fused_gp_predict_mean Nq={Xqg.shape[0]} N={Xg.shape[0]} P={Yg.shape[1]}",
             lambda: pg.fused_gp_predict_mean(Xqg, Xg, gp.alpha, ones2, 2.0),
             ("kern(Xq, X) @ alpha", lambda: kern(Xqg, Xg) @ gp.alpha))]
    for name, kernel, (lib_name, library) in runs:
        for _ in range(2):
            before = sm_clocks()
            dev, event = cs.device_ms(kernel), cs.cuda_ms(kernel)[0]
            lib_dev, lib_event = cs.device_ms(library), cs.cuda_ms(library)[0]
            print(f"{name}: {dev:.4f} device / {event:.4f} event ms; {lib_name} "
                  f"{lib_dev:.4f} / {lib_event:.4f}; clocks.sm, clocks.max.sm before {before}, "
                  f"after {sm_clocks()}", flush=True)


def gram_kernel_ms(cs, fn, reps=5):
    """Device ms a call of the Gram kernels alone (profiler rows whose name
    holds ``gram_``), mean over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with cs.traced() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in cs.kernel_rows(prof) if "gram_" in e.key]
    return sum(e.self_device_time_total for e in rows) / reps / 1e3, sum(e.count for e in rows)


def time_gram(cs, pkg, device):
    """Kernel #7 at the shapes of the N=10240 solve and of the 3-D ensemble
    (chip_smoke.py phases 8, 9 and 11)."""
    bc, pg, gpt = pkg["blocked_chol"], pkg["pallas_gram"], pkg["gpt"]
    f32 = dict(dtype=torch.float32, device=device)
    X = cs.solve_inputs(device)[0]
    ls3 = torch.ones(cs.D_SOLVE, **f32)
    S = torch.as_tensor(cs.ensemble_3d_inputs()[0], **f32)
    ls_e = 2.0 * torch.ones(3, **f32)
    runs = [(f"the N={cs.N_SOLVE} solve's Gram, B={cs.BLOCK}",
             lambda: bc.stationary_gram_panels(X, ls3, 2.0, 0.1, cs.BLOCK)),
            (f"the 3-D ensemble's Grams, {cs.E_3D} calls at n={cs.N_3D}",
             lambda: [bc.stationary_gram_panels(S, ls_e, 2.0, 0.01, gpt.BLOCKED_PANEL)
                      for _ in range(cs.E_3D)]),
            (f"stationary_gram ({cs.N_SOLVE}, {cs.BLOCK})",
             lambda: pg.stationary_gram(X, X[:cs.BLOCK], ls3, 2.0))]
    if hasattr(bc, "stationary_gram_panels_plain"):
        runs.append((f"the N={cs.N_SOLVE} solve's Gram, plain twin",
                     lambda: bc.stationary_gram_panels_plain(X, ls3, 2.0, 0.1, cs.BLOCK)))
    for name, fn in runs:
        for _ in range(2):
            before = sm_clocks()
            dev, event = cs.device_ms(fn), cs.cuda_ms(fn)[0]
            kern, launches = gram_kernel_ms(cs, fn)
            print(f"{name}: {dev:.4f} device / {event:.4f} event ms, of it the Gram kernel "
                  f"{kern:.4f} in {launches // 5} launches a call; clocks.sm, clocks.max.sm "
                  f"before {before}, after {sm_clocks()}", flush=True)


def time_route(cs, pkg, device, route_n, route_nq):
    """predict() with the fused route and with the dense one, at Nq·N on
    both sides of the routes' thresholds: the mean alone, and with the std
    where N <= FUSED_MEAN_VAR_MAX_N; CUDA-event ms of the call (the host's
    part included), then device ms."""
    K, gp_core = pkg["kernels"], pkg["exact_gp"]
    f32 = dict(dtype=torch.float32, device=device)
    kern = K.Constant(2.0) * K.RBF(torch.ones(2, **f32)) + K.White(0.1)
    grid = torch.as_tensor(cs.grid_inputs()[2], **f32)
    names = [c for c in ("FUSED_PREDICT_MIN_ELEMS", "FUSED_MEAN_VAR_MIN_ELEMS")
             if hasattr(gp_core, c)]
    default = {c: getattr(gp_core, c) for c in names}
    sizes = [(grid.shape[0], n) for n in route_n] + [(nq, 2048) for nq in route_nq]
    for Nq, N in sizes:
        X = torch.as_tensor(np.random.default_rng(N).standard_normal((N, 2)), **f32)
        gp = gp_core.condition(kern, X, torch.sin(X), cache_k_inv=True)
        Xq = grid[torch.linspace(0, grid.shape[0] - 1, Nq).long()].contiguous()

        def call(min_elems, std):
            def run():
                for c in names:
                    setattr(gp_core, c, min_elems)
                try:
                    return gp_core.predict(gp, Xq, return_std=std)
                finally:
                    for c in names:
                        setattr(gp_core, c, default[c])
            return run

        stds = (False, True) if N <= gp_core.FUSED_MEAN_VAR_MAX_N else (False,)
        for std in stds:
            fused, dense = call(0, std), call(Nq * N + 1, std)
            what = "predict(return_std)" if std else "predict"
            for _ in range(2):
                print(f"{what} Nq={Nq} N={N} (Nq*N={Nq * N}): fused {cs.cuda_ms(fused)[0]:.4f} "
                      f"event / {cs.device_ms(fused):.4f} device ms, dense "
                      f"{cs.cuda_ms(dense)[0]:.4f} / {cs.device_ms(dense):.4f}; "
                      + ", ".join(f"{c} = {v}" for c, v in default.items()), flush=True)


def load(root):
    """chip_smoke and the port's modules from the checkout at ``root``."""
    sys.path.insert(0, str(root))
    port = "gaussian_process_transportation_tpu_torch"
    mods = {name: importlib.import_module(f"{port}.{path}") for name, path in (
        ("kernels", "kernels"), ("exact_gp", "models.exact_gp"),
        ("blocked_chol", "ops.blocked_chol"), ("pallas_gram", "ops.pallas_gram"),
        ("gpt", "transport.gpt"), ("fused_lml", "ops.fused_lml"), ("affine", "models.affine"),
        ("samplers", "parallel.samplers"), ("batched_linalg", "ops.batched_linalg"))}
    return importlib.import_module("chip_smoke"), mods


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", nargs="*", choices=PARTS, default=list(PARTS))
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--predict-n", type=int, nargs="*",
                    default=[512, 1024, 2047, 2048, 3072, 4096, 8192])
    ap.add_argument("--chol-n", type=int, nargs="*", default=[4096, 10240, 20480])
    ap.add_argument("--member-n", type=int, nargs="*", default=[768, 1536, 2500, 4096])
    ap.add_argument("--route-n", type=int, nargs="*", default=[1, 4, 16, 64, 128, 209, 512, 2048])
    ap.add_argument("--route-nq", type=int, nargs="*", default=[1, 8, 64, 256, 1024, 4096])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_port_routes: needs a CUDA card")
    cs, pkg = load(Path(args.root).resolve())
    device = torch.device("cuda", 0)
    print(f"{cs.card_line()}; port from {Path(pkg['kernels'].__file__).parent}", flush=True)
    if "predict" in args.what:
        time_predicts(cs, pkg, device, args.predict_n)
    if "chol" in args.what:
        time_solves(cs, pkg, device, args.chol_n)
    if "member" in args.what:
        time_members(cs, pkg, device, args.member_n)
    if "panel" in args.what:
        time_panel(cs, pkg, device)
    if "lml" in args.what:
        time_lml(cs, pkg, device)
    if "paths" in args.what:
        time_paths(cs, pkg, device)
    if "kernels" in args.what:
        time_kernels(cs, pkg, device)
    if "gram" in args.what:
        time_gram(cs, pkg, device)
    if "route" in args.what:
        time_route(cs, pkg, device, args.route_n, args.route_nq)


if __name__ == "__main__":
    main()
