#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's ensemble transport.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one line each on stdout:

1. the card's name and power limit, as nvidia-smi reports them;
2. the build of the CUDA kernel from ``csrc/`` (seconds);
3. the kernel ``spd_inverse_elast_fused`` against its plain PyTorch twin on
   the card, n in {8, 20, 24, 32, 64}, E a full and a ragged block, f32 to
   2e-5 (and K^-1 to 1e-4 against numpy's f64 inverse), one f64 case to
   1e-10;
4. the main path ``fit_and_transport_batched`` at the bench size (E=16384
   targets of n=20 points, a Q=400 demo, C(10)*RBF(4)+White(0.01), f32):
   finite fields, exactly one kernel launch, and three members against the
   port's own f64 run on the CPU to err/max|X| < 1e-3;
5. times: median of 5 CUDA-event timed runs after a warm-up, of the kernel
   and its twin at n=20, E=16384, and of the whole main path (reported as
   transported trajectories per second), plus its peak device memory;
   on stderr, the main path's steps timed one by one and a
   ``torch.profiler`` table of one call.

Then one JSON line with the kernels' record and, last, the JSON status
line.  Any failed check raises, and the exit code is not 0.  With no CUDA
card it exits at once with a non-zero code.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

E_MAIN, Q_MAIN, N_MAIN = 16384, 400, 20
F32_ATOL, F32_INV_TOL, F64_ATOL, TRAJ_TOL = 2e-5, 1e-4, 1e-10, 1e-3
KERNEL_CASES = [(n, E) for n in (8, 20, 24, 32, 64) for E in (E_MAIN, E_MAIN + 37)]
REPS = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def spd_batch(n: int, E: int, seed: int = 0) -> np.ndarray:
    """(E, n, n) float32 SPD matrices A Aᵀ + 3I."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((E, n, n)).astype(np.float32)
    return np.einsum("eij,ekj->eik", A, A) + 3 * np.eye(n, dtype=np.float32)


def check_kernel(n, E, dtype, device, atol, inv_tol):
    """Kernel against twin and against numpy's f64 inverse; returns the
    largest kernel-vs-twin difference."""
    from gaussian_process_transportation_tpu_torch.ops.batched_linalg import (
        spd_inverse_elast, spd_inverse_elast_fused,
    )

    K = spd_batch(n, E)
    Ke = torch.from_numpy(np.transpose(K, (1, 2, 0))).to(device, dtype).contiguous()
    L1, Ki1 = spd_inverse_elast_fused(Ke)
    L0, Ki0 = spd_inverse_elast(Ke)
    torch.cuda.synchronize()
    err = max((L1 - L0).abs().max().item(), (Ki1 - Ki0).abs().max().item())
    upper = torch.triu(L1.permute(2, 0, 1), diagonal=1).abs().max().item()
    got = Ki1.permute(2, 0, 1).double().cpu().numpy()
    inv_err = float(np.abs(got - np.linalg.inv(K.astype(np.float64))).max())
    if not (err <= atol and inv_err < inv_tol and upper == 0.0):
        raise AssertionError(
            f"spd_inverse_elast_fused n={n} E={E} {dtype}: |kernel-twin|={err:.3g} "
            f"(atol {atol}), |K^-1 - inv|={inv_err:.3g} (tol {inv_tol}), "
            f"max above diagonal of L={upper:.3g}"
        )
    return err


def make_workload(n_traj=Q_MAIN, n_dist=N_MAIN):
    """The bench's synthetic 2-D workload: demo X (Q, 2) with velocities
    dX, source S and target S1 point sets (n, 2), float32."""
    t = np.linspace(0, 1, n_traj, dtype=np.float32)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, n_dist, dtype=np.float32)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return X, dX, S, S1


def cuda_ms(fn, reps=REPS):
    """Median over ``reps`` CUDA-event timed calls of ``fn``, after one
    warm-up call, in milliseconds."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def layer_ms(kernel, S, targets, X, dX) -> dict:
    """The batched transport's steps, as ``fit_and_transport_batched`` runs
    them for n <= 64, each timed with CUDA events; medians over REPS runs
    after a warm-up."""
    from gaussian_process_transportation_tpu_torch.models import affine as affine_core
    from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core
    from gaussian_process_transportation_tpu_torch.ops.batched_linalg import (
        spd_inverse_elast_fused,
    )
    from gaussian_process_transportation_tpu_torch.transport import gpt

    names = ("affine_fit", "gram", "chol_inverse_kernel", "alpha", "transport_apply")
    n = S.shape[0]
    eye = torch.eye(n, dtype=S.dtype, device=S.device) * gp_core._eff_jitter(S.dtype, 1e-10)
    runs = []
    for _ in range(REPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        aff = affine_core.fit_batched(S, targets)
        src_al = affine_core.predict(aff, S)
        delta_b = targets - src_al
        ev[1].record()
        Ke = (kernel(src_al) + eye).permute(1, 2, 0).contiguous()
        ev[2].record()
        L_e, Kinv_e = spd_inverse_elast_fused(Ke)
        ev[3].record()
        Kinv_b = Kinv_e.permute(2, 0, 1)
        alpha = Kinv_b @ delta_b
        ev[4].record()
        gp = gp_core.ExactGP(kernel=kernel, X=src_al, Y=delta_b, alpha=alpha,
                             L=L_e.permute(2, 0, 1), K_inv=Kinv_b)
        gpt.transport_apply(aff, gp, X, dX)
        ev[5].record()
        torch.cuda.synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
    med = np.median(np.array(runs[1:]), axis=0)
    return {name: float(t) for name, t in zip(names, med)}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")

    from gaussian_process_transportation_tpu_torch import kernels as K
    from gaussian_process_transportation_tpu_torch.ops import _cuda
    from gaussian_process_transportation_tpu_torch.ops.batched_linalg import (
        spd_inverse_elast, spd_inverse_elast_fused,
    )
    from gaussian_process_transportation_tpu_torch.transport import gpt

    device = torch.device("cuda", 0)

    # 1. device
    card = card_line()
    print(card, flush=True)
    tag = f"[{card}]"

    # 2. build
    t0 = time.perf_counter()
    lib_path = _cuda.build("spd_inverse_elast")
    _cuda.library("spd_inverse_elast")
    print(f"build: spd_inverse_elast in {time.perf_counter() - t0:.2f} s ({lib_path.name}) {tag}",
          flush=True)
    print(lib_path.with_suffix(".log").read_text(), file=sys.stderr)

    # 3. kernel against twin
    errs = {}
    for n, E in KERNEL_CASES:
        errs[f"f32 n={n} E={E}"] = check_kernel(n, E, torch.float32, device,
                                                F32_ATOL, F32_INV_TOL)
    errs[f"f64 n=20 E={E_MAIN + 37}"] = check_kernel(N_MAIN, E_MAIN + 37, torch.float64,
                                                     device, F64_ATOL, F64_ATOL)
    main_err = errs[f"f32 n={N_MAIN} E={E_MAIN}"]
    print("kernel vs twin: max|diff| " + ", ".join(f"{k}: {v:.3g}" for k, v in errs.items())
          + f"; all within tolerance {tag}", flush=True)

    # 4. main path
    X, dX, S, S1 = make_workload()
    f32 = dict(dtype=torch.float32, device=device)
    kernel = K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, **f32)) + K.White(0.01)
    Xd, dXd, Sd, S1d = (torch.as_tensor(a, **f32) for a in (X, dX, S, S1))
    shifts = torch.linspace(0.0, 1.0, E_MAIN, **f32)
    targets = S1d[None] + shifts[:, None, None]

    def main_path():
        return gpt.fit_and_transport_batched(kernel, Sd, targets, Xd, dXd)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    spd_inverse_elast_fused.launches = 0
    res = main_path()
    torch.cuda.synchronize()
    launches = spd_inverse_elast_fused.launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    if launches != 1:
        raise AssertionError(f"main path launched the kernel {launches} times, expected 1")
    fields = {name: getattr(res, name) for name in res._fields if getattr(res, name) is not None}
    for name, value in fields.items():
        if not torch.isfinite(value).all():
            raise AssertionError(f"main path field {name} has non-finite values")
    if res.traj.shape != (E_MAIN, Q_MAIN, 2) or res.min_abs_det.shape != (E_MAIN,):
        raise AssertionError(f"unexpected shapes {res.traj.shape}, {res.min_abs_det.shape}")

    members = [0, E_MAIN // 2, E_MAIN - 1]
    f64 = dict(dtype=torch.float64, device="cpu")
    kernel64 = K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, **f64)) + K.White(0.01)
    ref = gpt.fit_and_transport_batched(
        kernel64, torch.as_tensor(S, **f64), targets[members].to(**f64),
        torch.as_tensor(X, **f64), torch.as_tensor(dX, **f64),
    )
    scale = float(np.abs(X).max())
    rel = {}
    for i, e in enumerate(members):
        for name in ("traj", "delta"):
            got = getattr(res, name)[e].double().cpu()
            rel[f"{name}[{e}]"] = (got - getattr(ref, name)[i]).abs().max().item() / scale
    if max(rel.values()) >= TRAJ_TOL:
        raise AssertionError(f"main path differs from the f64 CPU run: {rel}")
    print(f"main path: E={E_MAIN} Q={Q_MAIN} n={N_MAIN} f32, fields {sorted(fields)} finite, "
          f"kernel launches {launches}, err/max|X| vs f64 CPU "
          + ", ".join(f"{k}: {v:.3g}" for k, v in rel.items())
          + f" (< {TRAJ_TOL}) {tag}", flush=True)

    # 5. times
    K_main = spd_batch(N_MAIN, E_MAIN)
    Ke = torch.from_numpy(np.transpose(K_main, (1, 2, 0))).to(**f32).contiguous()
    kernel_ms, kernel_all = cuda_ms(lambda: spd_inverse_elast_fused(Ke))
    plain_ms, plain_all = cuda_ms(lambda: spd_inverse_elast(Ke))
    path_ms, path_all = cuda_ms(main_path)
    rate = E_MAIN / (path_ms / 1e3)
    print(f"times (median of {REPS}, CUDA events): spd_inverse_elast_fused n={N_MAIN} "
          f"E={E_MAIN} {kernel_ms:.4f} ms {kernel_all}, plain twin {plain_ms:.4f} ms "
          f"{plain_all}; fit_and_transport_batched E={E_MAIN} {path_ms:.4f} ms {path_all} = "
          f"transported_trajectories_per_s_per_chip {rate:.1f}; "
          f"peak memory {peak_gib:.3f} GiB {tag}", flush=True)

    print(f"layers of fit_and_transport_batched E={E_MAIN} (ms, median of {REPS}, "
          f"CUDA events): {layer_ms(kernel, Sd, targets, Xd, dXd)} {tag}", file=sys.stderr)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        main_path()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30), file=sys.stderr)

    print(json.dumps({"kernels": [{
        "name": "spd_inverse_elast_fused",
        "route": "cuda",
        "source": "gaussian_process_transportation_tpu_torch/csrc/spd_inverse_elast.cu",
        "replaces": "gaussian_process_transportation_tpu/ops/batched_linalg.py:80",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
