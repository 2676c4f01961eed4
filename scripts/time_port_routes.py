#!/usr/bin/env python3
"""Time the two routes of the PyTorch port's exact GP whose thresholds are
set from measurements (``models/exact_gp.py``), on one CUDA card:

* ``predict(return_std)`` with a cached K⁻¹: the fused mean-and-variance
  kernel against the dense path (k K⁻¹ through cuBLAS) on a 100×100 query
  grid, at each N of ``--predict-n`` (``FUSED_MEAN_VAR_MAX_N``).  An N that
  is no multiple of 4 leaves K⁻¹'s rows unaligned, the kernel's 4-byte copies;
* ``condition()``: the blocked Cholesky solve against
  ``torch.linalg.cholesky`` on the dense Gram, at each N of ``--chol-n``
  (``BLOCKED_CHOL_MIN_N``).

Run from the repository root: ``python3 scripts/time_port_routes.py``.
One line per N: device ms (CUPTI, mean of 5) and CUDA-event ms (median of 5)
for the predicts, CUDA-event ms for the solves, each after a warm-up, twice
in turn, with the card's name and power limit first.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from gaussian_process_transportation_tpu_torch import kernels as K  # noqa: E402
from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core  # noqa: E402
from gaussian_process_transportation_tpu_torch.ops import blocked_chol as bc  # noqa: E402
from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg  # noqa: E402


def time_predicts(device, sizes):
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


def time_solves(device, sizes):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--predict-n", type=int, nargs="*",
                    default=[512, 1024, 2047, 2048, 3072, 4096, 8192])
    ap.add_argument("--chol-n", type=int, nargs="*", default=[4096, 10240, 20480])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_port_routes: needs a CUDA card")
    device = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    time_predicts(device, args.predict_n)
    time_solves(device, args.chol_n)


if __name__ == "__main__":
    main()
