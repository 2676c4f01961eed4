#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port: the ensemble transport, the
large-N exact GP, the hyperparameter fits (small and large N), the HMC and
NUTS hyperposteriors, checkpointed runs, SMC particles, the active-learning
GP, the diffeomorphism sweep, the mixed-precision solve, the transport
variants, the learned-map transports and the multi-frame baselines, obstacle
avoidance and the obstacle flow field, the GP dynamical system, the
metrics and comparison suites, the multi-device slice (meshes over
``torch.distributed`` ranks, the sharded ensemble, Cholesky and LML), and
the bench stages of ``bench.py``'s port.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one line each on stdout:

1. the card's name and power limit, as nvidia-smi reports them;
2. the build of the ``spd_inverse_elast`` kernel from ``csrc/`` (seconds;
   every kernel source starts building here, one nvcc each);
3. ``spd_inverse_elast_fused`` against its plain PyTorch twin on the card,
   n in {1, 8, 16, 20, 24, 32, 33, 64} (every instance of the kernel, each
   case printed with the instance it took), E the bench size and a ragged
   one, f32 to 2e-5 (and K^-1 to 1e-4 against numpy's f64 inverse), one
   f64 case to 1e-10, two runs at the bench shape bitwise equal;
4. the ensemble transport ``fit_and_transport_batched`` at the bench size
   (E=16384 targets of n=20 points, a Q=400 demo, C(10)*RBF(4)+White(0.01),
   f32): finite fields, exactly one launch of #1 and one of the fused
   apply #8 (``transport_apply_rbf``, its build and ptxas line first), and
   three members against the port's own f64 run on the CPU to err/max|X| <
   1e-3; then #8 alone on that call's state, each field against its twin's
   float64 evaluation within ``APPLY_REL`` times the float32 twin's own
   error plus ``APPLY_FLOOR``, and the variances' quadratic forms through
   the cached K⁻¹ (the plain route's) rejected by that bound;
5. times of phase 3's kernel and twin and of phase 4's path (median of 5
   CUDA-event timed runs after a warm-up), and peak device memory (#8's
   kernel and twin are timed with the others in phase 11, beside their
   bound from ``port_bench/counts.py::apply``);
6. the builds of ``factor_panel``, ``stationary_gram`` and ``fused_lml``
   (seconds; ptxas registers and spills of every kernel instance, those of
   ``spd_inverse_elast`` too, and the fused-LML instances' registers and
   resident warps per SM);
7. those kernels against their twins on the card: ``factor_panel`` at
   B in {128, 256, 512, 1024} against numpy's f64 factor (its device
   launches per call and its one-CTA diagonal step's device time from the
   profiler at B=512); kernel #7, per entry against its formula in float64
   on the same inputs to ``GRAM_TOL``, written into NaN-filled outputs:
   ``stationary_gram`` for the four families at ``GRAM_CASES`` (ragged
   widths M = 1, 3, 129, 1001 among them), ``stationary_gram_panels`` at
   ``GRAM_PANEL_CASES`` (both paths' shapes, the edges of its blocks, every
   family and D of its instances) with two runs bitwise equal, and three
   planted faults of the panels that the check must reject (the noise
   dropped on a diagonal block, a tile left unwritten, a padding row
   coupled to real points); the fused predicts at the grid
   size, a ragged one and every Nq, N in {1, 127, 128, 129, 300} (the edges
   of the mean-and-variance kernel's 128-wide tiles; D=3, P=2), per query
   against their formula in float64 on the same inputs (tolerances and
   reasons in ``check_*`` and beside ``VAR_REL``), two runs bitwise equal,
   and two planted faults of the variance that the check must reject; the
   mean kernel alone at the edges of its 128-point chunks and 256-query
   blocks (every Nq, N in ``MEAN_EDGES``, and the four families, D in
   {2, 3, 5}, P in {1, 2, 8} at a ragged shape), two runs bitwise equal,
   and two planted faults of the mean;
8. the large-N solve ``gram_cholesky_solve`` at N=10240 (the bench's
   inputs): one launch of the Gram's panels and 20 of ``factor_panel``,
   alpha against an f64 solve on the card,
   TFLOP/s beside the card's f32 matmul rate, and the blocked path beside
   cuSOLVER's dense Cholesky at each N of ``N_CHOL_ROUTE``, with the path
   ``condition()`` takes at each;
9. the slice's main path, the 3-D ensemble transport at the original
   project's surface scale (E=16 members of n=2500 points, Q=1000, D=3):
   one Gram launch a member and 80 of ``factor_panel``, members 0 and 15
   against the port's f64 dense run on the CPU; then the Gram kernel's
   device total over phase 8's one launch and this phase's 16 (one traced
   call each) beside its byte bound;
10. the dense-grid predicts (a 100x100 grid, N=2048): one launch of each
    fused kernel, as ``fused_predict_route`` says, the result against the
    f64 dense path on the card;
11. times of each kernel at the path's shapes, its twin and the nearest
    library call, each as the device time of the kernels the call launched
    (torch.profiler, mean of 5 after a warm-up) and as the CUDA-event time
    of the call (median of 5), ``spd_inverse_elast_fused`` beside its thread
    instance (the design every member took before the warp instances; the
    mean kernel's parent design is timed by ``scripts/time_port_routes.py
    --what kernels --root``, and kernel #7's by ``--what gram --root``),
    kernel #7 at both paths' shapes (the solve's Gram, the 3-D ensemble's 16
    Grams) and the generic entry on one (10240, 512) panel, each beside its
    twin and its byte bound, with the registers and spills of the paths'
    instances, the mean-and-variance kernel beside the dense
    path at N in {512, 2048, 4096} with the one ``predict(return_std)``
    takes at each, and phases 8-10 end to end (CUDA events).
    The kernels' record carries the device times (``"timing":
    "cupti_device"``) and the calls' CUDA-event times beside them;
12. the fused small-LML kernels #2 and #3 (``csrc/fused_lml.cu``, built in
    phase 6) against their twins and, per lane, against the same formula in
    float64 (error over the bound of ``lml_f64``): four families × n in
    {8, 20, 32} × D in {2, 3} × p in {1, 3} × both lengthscale forms × noise
    or not at a ragged E, the shapes past the kernel's eight coordinates
    or columns, (D, p) in {(12, 1), (2, 12), (12, 12)} at n in {20, 32},
    and the paths' own E, #3's value-only instance at every shape bit for
    bit the full kernel's value; three planted faults (the amplitude
    gradient negated, two lanes' datasets swapped, and that swap in the
    value-only instance) and a value-only result one ulp off must be
    rejected; then the times of #2, #3 and #3's value-only instance at the
    paths' shapes, with the SM clock just after;
13. the per-member-hyperopt transport ``fit_and_transport_batched_opt`` at
    E=4096, Q=400, n=20 (6 restarts, 30 L-BFGS iterations: 28,672 lanes,
    211 launches of #3, 180 of them its value-only instance for the line
    search's candidates, one of #1): every member's fitted LML (f64) at
    least its initial one, the fit's theta and LML bit for bit the same
    with the candidates through the full kernel, three members against the
    f64 CPU transport at their fitted kernels, fits/s and traj/s, peak
    memory, the device launches and idle share of a traced call;
14. ``sample_gp_posterior`` at ``bench.py``'s hmc workload (256 chains,
    48+48 steps of 16 leapfrog: 1,537 launches of #2): finite samples, #2 at
    the final positions against the f64 formula, a run of 64 chains equal
    bit for bit to the first 64 of the 256 (each chain's draws depend on
    its own index only), posterior means against a run through the twin,
    ``hmc_samples_per_s`` (median of 3);
15. the ``GaussianProcessTransportation`` façade on the card with the
    default L-BFGS-B fit: finite fields, a positive std, the fitted LML at
    least the initial one, its wall time.
16. the blocked hyperparameter fit at ``scripts/bench_blocked_lml.py``'s
    inputs (N=10240, D=3, rbf, seed 0): one evaluation of
    ``blocked_lml_value_and_grad`` (1 launch of the Gram's panels, 20 of
    ``factor_panel``), its value and gradient against the dense float64
    formula on the card within ``blocked_lml_f64``'s bound, a planted fault
    (the largest gradient entry negated) rejected, its time (median of 5)
    and TFLOP/s against the 3·N³/3 model; then ``fit_blocked`` (optax's
    L-BFGS and zoom line search, ``models/_lbfgs.py``) with ``maxiter`` cut
    to 10: its iterations, evaluations and line-search rounds counted, 1 +
    20 launches for each evaluation and for the conditioning, its LML (f64)
    past the initial one by the value's f32 bound, its wall time and peak
    memory;
17. ``sample_gp_posterior(algorithm="nuts")`` at the hmc workload (256
    chains, 48+48 steps, max_depth 8): finite samples, the launches of #2,
    64 chains equal bit for bit to the first 64 of 256, posterior means
    within 0.8·sd + 0.3 of phase 14's HMC means, the mean tree depth and
    ``nuts_samples_per_s`` of the counted run (one run: the whole run's
    length is held);
18. the generic route at n=40 (past the fused route): 64 chains of HMC,
    24+24 steps of 16 leapfrog through ``torch.func.vmap`` of the LML's
    gradient, finite samples, no hand-kernel launch, samples/s of that one
    run (one run, not three, holds the added phases to their time);
19. ``run_hmc_batched_checkpointed`` over kernel #2 at phase 14's shape in
    segments of 16: stopped after its first segment, resumed in a fresh
    call, equal bit for bit to the uninterrupted ``hmc_batched`` run;
20. SMC at ``bench.py``'s smc workload (8192 particles of 100 points, D=2,
    16 steps): finite particles, every ESS in (0, E],
    ``smc_particles_per_s`` (median of 3); and ``init_particles`` on the
    bench transport's S, S1 and X with 8192 particles, its mean against
    the analytic posterior mean;
21. ``fit_jit`` on the bench transport's residual (n=20, D=2, p=2, phase
    13's kernel and bounds, f32, 5 restarts as six lanes, maxiter 100):
    one launch of #2 for each counted evaluation of the lanes (each
    iteration's, each line-search round's, and the final values), the
    fitted LML (f64) at least the start's and
    within 1e-3 of the port's f64 CPU fit, its time (median of 5); then the
    façade with ``jit_fit=True`` on the bench inputs against the f64 CPU
    transport at the kernel it fitted to err/max|X| < 1e-3, and the same
    check rejecting that kernel moved by 0.1 in log space and the unfitted
    start;
22. ``GaussianProcessActiveLearning`` at the original project's cap: N =
    24,000 points of a smooth 3-D surface (the cap + 20%), m = 20,000, a
    2,000-point seed, C(1)·RBF(0.3)+White(0.01), f32: the selection's time,
    float32 and float64 picks at N=3000, m=2000 equal through the seed and
    100 greedy picks, the final variances at 256 unselected points against
    the f64 Schur complement, ``fit_blocked`` on the subset (maxiter cut to
    5; its counted evaluations, each one launch of #7 and 40 of #4), its
    LML (f64) at least the start's, one
    value+grad at N=20,000 (median of 3), peak memory, ``predict`` (no
    launch of #5: k_star @ α, as in JAX) and ``derivative`` at Q=1000
    against an f64 predict from the same subset, their times;
23. ``GaussianProcessTransportationDiffeo(jit_fit=True).optimize_diffeomorphism``
    on the bench inputs, 20 trials: the launches of #2 equal to the fits'
    counted evaluations, each trial's
    residual against the port's f64 CPU residual at the kernel the card
    fitted within 1e-3·(1 + κ·ε32), every fit's LML (f64) at least its
    start's, the best bound the same as in f64 at those kernels (or within
    1e-3 of it), planted faults (the inverse map at the fitted kernel, θ
    moved by 0.01) rejected on the first five trials, a five-trial sweep's
    best on the card the f64 CPU sweep's (or within 1e-3 of its residual),
    the sweep's time; then
    the heteroscedastic field on a 20x20 grid, finite and non-negative;
24. ``gram_chol_solve_mixed`` at phase 8's inputs, trailing updates at
    ``"default"`` (bf16) and ``"high"`` (three bf16 passes): whether each
    factor is definite, the residual of the factor alone and after PCG
    against phase 8's f32 solve's ("high": alone above 1e3·ε32, after PCG
    within 10x of phase 8's), the factor's and PCG's times; and
    ``"default"`` on the same points with noise 10, which it factors: alone
    above 1e3·ε32, after PCG within 10x of phase 8's f32 solve of that Gram;
25. ``AffineTransportation``, ``KMPTransport`` and
    ``LaplacianEditingTransport`` on the bench inputs: float64 on the card
    against float64 on the CPU to err/max|X| < 1e-6, float32 finite, its
    error printed;
26. the eight learned-map transports (``MLPTransport``,
    ``RandomForestTransport``, ``NeuralTransport``,
    ``EnsembleNeuralTransport``, ``BijectiveTransport``,
    ``EnsembleBijectiveTransport``, ``GMRTransport``, ``SVGPTransport``),
    each at its defaults, at the comparison suite's shapes (phase 4's demo,
    source and first target resampled to 100 points,
    ``benchmarks/comparison.py:58-59``): float64 on the card against
    float64 on the CPU with the same seed, every field to 1e-6 of its
    largest entry (the forest's fitted map applied on both, as its host fit
    flips near-tied splits; GMR's fields to 10x the spread that ε64 input
    perturbations cause on the CPU, its Σ_xx being near-singular on these
    inputs), samples of the right shape and finite, float32 finite with
    its error printed, no launch of a hand kernel; the f32 fit's time (one
    run after a warm-up) and the apply's (median of 5, CUDA events), and
    for ``MLPTransport`` and ``EnsembleBijectiveTransport`` one traced fit's
    wall and device ms, launches and idle share.  The random forest's split
    search builds ``csrc/cart.cpp`` with g++ into ``_build/`` here;
27. ``SVGPTransport`` on phase 9's member 0 (n=2500, D=3, Q=1000; M=100,
    20 epochs, batch 128) with unit quaternions: float64 card vs CPU to
    1e-6 of each field's largest entry, the quaternions unit to 1e-6, its
    fit and apply times and one traced fit; ``fit_natgrad`` at the same
    settings, card vs CPU; ``TPGMM()`` and ``HMMLQR()`` on six synthetic
    demonstrations (``tests/test_baselines.py:20-42``) reproduced at the
    seventh's frames, float64 card vs CPU to 1e-8 of max|traj|, float32
    finite;
28. obstacle avoidance at ``examples/obstacle_avoidance_ds.py``'s scenes:
    the wavy DS through ``avoid`` around the ellipse and the cuboid (9
    agents, 600 steps of 0.03), the modulated linear DS (50 agents, 800
    steps of 0.25) and the same agents through ``avoid`` past the ellipse
    moving and turning, each float64 on the card against the CPU to
    ``ROLLOUT_TOL`` of max|x|, float32 with every state's Γ at least 1 and
    no hand-kernel launch, its seconds and one traced step's launches; the
    ROAM field on the example's 20x20 grid (395 of 400 points outside) and
    on a 100x100 grid, float64 card vs CPU to ``AVOID_TOL``, finite outside
    the obstacles, one ``avoid`` call's time;
29. the obstacle flow field of ``examples/obstacle_flow_field_2d.py`` (60
    vertices, 200 interior samples, the fit with 2 restarts, the warp of a
    150-point trajectory and its velocities, the SDF projection of the
    samples): float64 on the card against the CPU conditioned at the kernel
    the card fitted, to ``FLOW_TOL``; float32's mean depth below a quarter
    of the trajectory's; the fit's, the warp's and the projection's times;
30. the GP dynamical system on a synthetic file in the LASA layout (7 demos
    of 1,000 points, read by ``load_lasa``): (a) ``examples/lasa_ds.py``'s
    fit and 600-step rollout, float64 card vs CPU and float32 vs float64;
    (b) all 7,000 points (or the largest stride whose float32 factor is
    finite) at (a)'s kernel, ``rollout_gp_ds`` from the 7 starts for 1,000
    steps: one call of kernel #5 a step, its means against the f64 formula,
    three steps under ``set_sync_debug_mode("error")``, the endpoints
    against float64, its time; (c) ``vector_field`` on a 100x100 grid over
    2,048 of the points with a cached K⁻¹: one call of kernel #6, mean and
    variance against the f64 formula (the variance's bound with ε32 of its
    cancelling terms) and two planted faults rejected; (d)
    ``rollout_stable_gp_ds`` and ``min_variance_attractor_field`` on
    ``spiral_demo``'s 3-D demonstration, float64 card vs CPU;
31. ``run_comparison`` at its defaults (six methods, 100 points) in float32
    on phase 26's inputs, its matrices against numpy float64 formulas on
    its trajectories; ``ablation_study()`` and ``compare_methods()`` at
    their defaults on a synthetic file in the reach-target layout (9 demos
    of 200 points), their first repetition float64 on the card against the
    CPU, their times and ``ranking_report``; DTW and Fréchet at T = 1,000
    in float64 on the card against the host row sweep, with their launches;
32. the multi-device slice at full width in a one-rank NCCL group on the
    card (``parallel/``; ``distributed.initialize`` and a (1, 1) mesh,
    destroyed at the phase's end): (a) ``transport_ensemble`` at phase 4's
    bench transport, bit for bit phase 4's result in one launch of #1; (b)
    three ``make_ensemble_train_step`` steps at E=16384, finite, the first
    loss within 1e-5 of the mean -LML of ``exact_gp`` over the members;
    (c) ``sharded_gram_cholesky_solve`` on phase 8's inputs (20 launches
    of #4): alpha against phase 8's f64 solve to phase 8's bound, its
    difference to phase 8's alpha, log det against f64 and a re-solve
    through the factor; (d) ``sharded_lml_value_and_grad`` on phase 16's
    inputs (20 launches of #4): value and gradient within phase 16's f64
    bound, as is ``blocked_lml_value_and_grad`` without refinement, the
    gradient within 1e-4 of its largest entry of that one's; then
    ``fit_sharded`` at maxiter 10 raising the LML, 20 launches of #4 for
    each counted evaluation; (e)
    ``sample_gp_posterior(mesh=)`` at phase 14's workload, bit for bit
    phase 14's chains, #2's launches counted; (f)
    ``init_particles(mesh=)`` and 16 ``smc_step``s at phase 20's size, equal
    to the run without a mesh; CUDA-event medians of (a), (c), (d) and (e)
    beside phases 4, 8, 16 and 14;
33. ``dryrun_multichip(8)`` on eight gloo ranks sharing the card (the
    collectives pass CUDA tensors through gloo): its ``loss`` and
    ``sharded_lml`` within 1e-4 of the JAX package's recorded run
    (``MULTICHIP_r05.json``), the launches of #1, #2 and #4 on every rank,
    and each rank's #4 against its plain twin at B=128; with two or more
    cards also ``dryrun_multichip`` over NCCL, one rank a card;
34. the bench stages (``gaussian_process_transportation_tpu_torch/bench.py``,
    the port of ``bench.py``) at full size: ``bench_ours`` (E=16384, one
    launch of #1 a call) with three members against the f64 CPU run as in
    phase 4; ``bench_cholesky`` at ``"high"`` (JAX's stage) and at
    ``"highest"``, each with TFLOP/s, the 8192² product rates at both
    precisions and the share of each, 1 Gram and 20 ``factor_panel``
    launches a solve, and alpha within phase 8's bound of its f64 solve
    (the unrefined "high" solve printed beside it); ``matmul_at(..., "high")``
    on a 4096² pair within 2^-14 relative of f64, and the one-pass
    ``"default"`` (the lo terms dropped) rejected by that check;
    ``bench_hmc`` (1,537 launches of #2 a call), ``bench_smc``,
    ``bench_reference_cpu`` and ``vs_baseline``; then ``python -m
    gaussian_process_transportation_tpu_torch.bench`` as a subprocess, its
    one JSON line parsed for the five metrics.

Each path is driven with every launch count set to 0 just before and read
just after.  Then one JSON line with the kernels' record and, last, the
JSON status line.  Any failed check raises, and the exit code is not 0.
With no CUDA card it exits at once with a non-zero code.
"""
import contextlib
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

E_MAIN, Q_MAIN, N_MAIN = 16384, 400, 20
F32_ATOL, F32_INV_TOL, F64_ATOL, TRAJ_TOL = 2e-5, 1e-4, 1e-10, 1e-3
# every instance of kernel #1 (ops/batched_linalg.py::spd_inverse_instance)
KERNEL_CASES = [(n, E) for n in (1, 8, 16, 20, 24, 32, 33, 64) for E in (E_MAIN, E_MAIN + 37)]
REPS = 5
CUPTI_TRIES = 4  # profiler sessions tried before a time falls back (traced_rows)
SOURCES = ("spd_inverse_elast", "factor_panel", "stationary_gram", "fused_lml", "transport_apply")

N_SOLVE, D_SOLVE, BLOCK = 10240, 3, 512
SOLVE_REL_TOL = 5e-3  # the N=10240 solve's alpha against f64, relative to max|alpha|
E_3D, N_3D, Q_3D = 16, 2500, 1000
NQ_GRID, N_GRID = 100, 2048
TILE_EDGES = (1, 127, 128, 129, 300)  # around the mean-and-variance kernel's 128-wide tiles
# around the mean kernel's 128-point chunks (129, 257: one past a chunk) and
# its 256-query blocks
MEAN_EDGES = (1, 127, 128, 129, 255, 256, 257, 300)
N_CHOL_ROUTE = (4096, 8192, N_SOLVE, 20480)  # condition()'s two paths are timed at these N
N_VAR_ROUTE = (512, N_GRID, 4096)  # predict(return_std)'s two paths, at Nq = NQ_GRID^2
FAMILIES = ("rbf", "matern12", "matern32", "matern52")
# kernel #7's phase-7 cases: the generic entry (N, M, D), each for the four
# families; the panel entry (family, n, B, D)
GRAM_CASES = ((1037, 531, 3), (77, 1, 3), (130, 3, 2), (65, 129, 1), (200, 1001, 5),
              (N_SOLVE, BLOCK, D_SOLVE))
GRAM_PANEL_CASES = (("rbf", N_SOLVE, BLOCK, D_SOLVE),
                    *(("rbf", n, 128, 3) for n in (1, 200, 511, 512, 513)),
                    *((fam, N_3D, 512, D) for fam in FAMILIES for D in (1, 2, 3, 5)))

# the fused predicts against their formula in float64, per query: the mean
# to MEAN_REL of Σ_n|k α| (f32 sums of N terms); the variance, prior − k K⁻¹ kᵀ,
# to VAR_REL of itself plus VAR_FLOOR.  The f32 error of the variance grows
# with the terms that cancel, so the bound is set from the readings of sound
# f32 evaluations (the kernel and its dense twin; PERF.md), and phase 7 shows
# that it rejects planted faults.
MEAN_REL, VAR_REL, VAR_FLOOR = 1e-5, 2e-2, 5e-4

# phase 7: the Gram kernels (#7) per entry against their formula in float64
# on the same float32 inputs, to GRAM_TOL of the largest entry (amp, or amp
# plus noise on a panel's diagonal): the f32 rounding of the scaled
# coordinates, of d² and of the profile is a few ulps.  The f32 twin reads at
# most 2.4e-7 of amp + noise on the CPU at phase 7's shapes (4 ulps;
# tests/test_torch_smoke_checks.py holds it below half); phase 7 shows that
# the bound rejects planted faults.
GRAM_TOL = 2e-6
# phases 12-14: the fused small-LML kernels #2 (shared data) and #3 (per lane).
# Per lane against the same formula in float64 on the same float32 inputs.
# A value or gradient entry sums terms (½y·α and ½log pivots; W_ij ∂K_ij/∂θ
# with W = ½(ααᵀ − p K⁻¹)): its bound is LML_REL of the terms' absolute sum,
# for the f32 rounding of the sum, plus LML_COND·κ(K)·ε32 of the unsigned
# sizes the Cholesky's error scales with (|y||α|, |α_i α_j| + p|K⁻¹_ij|),
# for the f32 factorization of a Gram of condition number κ.  LML_FLOOR
# keeps terms of 1e-207 in f64, 0 in f32, from reading as errors.  Set from
# the readings of sound f32 evaluations (the twin on the CPU reads below
# half of it, tests/test_torch_smoke_checks.py); phase 12 shows that it
# rejects planted faults.
LML_VAL_REL, LML_GRAD_REL, LML_COND, LML_FLOOR = 1e-4, 1e-3, 4.0, 1e-30
F32_EPS = 2.0**-24
LML_CASES = [(fam, n, D, p, n_ls, noise) for fam in FAMILIES for n in (8, 20, 32)
             for D in (2, 3) for p in (1, 3) for n_ls in (1, D) for noise in (True, False)]
# past the kernel's eight coordinates (chunked in the kernel) or columns (one
# launch per eight, summed by the wrapper)
LML_WIDE_CASES = [(fam, n, D, p, n_ls, True) for fam in FAMILIES for n in (20, 32)
                  for D, p in ((12, 1), (2, 12), (12, 12)) for n_ls in (1, D)]
E_LML_SMALL = 37  # ragged against the kernel's four lanes a block
VALUE_ONLY = "_small_lml_value_md"  # #3's value-only instance (the line search's candidates)
# the kernel's instances (csrc/fused_lml.cu, small_lml_occupancy's order)
LML_INSTANCES = ("n<=24 D<=2 p<=2", "n<=32 D<=8 p<=8", "n<=32 D>8 p<=8")
E_FIT, RESTARTS, MAXITER = 4096, 6, 30  # fit_and_transport_batched_opt (JAX's defaults)
HMC_CHAINS, HMC_WARMUP, HMC_SAMPLES, HMC_LEAPFROG = 256, 48, 48, 16  # bench.py:327-352

# published H100 SXM peaks (NVIDIA data sheet), for the kernels' bounds;
# and the special-function units' rate (expf, sqrtf): 16 results a clock on
# each of the 132 SMs (CUDA C++ Programming Guide, arithmetic instructions,
# compute capability 9.0) at the 1,980 MHz maximum SM clock
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
SFU_PER_S = 132 * 16 * 1.98e9

PKG = "gaussian_process_transportation_tpu_torch"
TPU_PKG = "gaussian_process_transportation_tpu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def sm_clocks() -> str:
    """The card's SM clock and its maximum now (MHz), as nvidia-smi reports
    them, to stand beside a kernel's time."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def timed_build(name: str):
    """Build ``csrc/<name>.cu`` (or find its build); (path, seconds)."""
    from gaussian_process_transportation_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    path = _cuda.build(name)
    return path, time.perf_counter() - t0


def spd_batch(n: int, E: int, seed: int = 0) -> np.ndarray:
    """(E, n, n) float32 SPD matrices A Aᵀ + 3I."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((E, n, n)).astype(np.float32)
    return np.einsum("eij,ekj->eik", A, A) + 3 * np.eye(n, dtype=np.float32)


def check_kernel(n, E, dtype, device, atol, inv_tol):
    """Kernel against twin and against numpy's f64 inverse; returns the
    largest kernel-vs-twin difference and the instance the launch took."""
    from gaussian_process_transportation_tpu_torch.ops.batched_linalg import (
        spd_inverse_elast, spd_inverse_elast_fused,
    )

    K = spd_batch(n, E)
    Ke = torch.from_numpy(np.transpose(K, (1, 2, 0))).to(device, dtype).contiguous()
    before = dict(spd_inverse_elast_fused.instance_launches)
    L1, Ki1 = spd_inverse_elast_fused(Ke)
    taken = [k for k, v in spd_inverse_elast_fused.instance_launches.items() if v != before[k]]
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
    return err, taken[0]


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


def member_errors(res, kernel64_of, S, X, dX, targets, members):
    """err/max|X| of traj and delta at ``members`` of a bench transport
    result against the port's f64 run on the CPU (phases 4 and 34)."""
    from gaussian_process_transportation_tpu_torch.transport import gpt

    f64 = dict(dtype=torch.float64, device="cpu")
    ref = gpt.fit_and_transport_batched(
        kernel64_of(f64), torch.as_tensor(S, **f64), targets[members].to(**f64),
        torch.as_tensor(X, **f64), torch.as_tensor(dX, **f64))
    scale = float(np.abs(X).max())
    rel = {}
    for i, e in enumerate(members):
        for name in ("traj", "delta"):
            got = getattr(res, name)[e].double().cpu()
            rel[f"{name}[{e}]"] = (got - getattr(ref, name)[i]).abs().max().item() / scale
    if max(rel.values()) >= TRAJ_TOL:
        raise AssertionError(f"bench transport differs from the f64 CPU run: {rel}")
    return rel


# ---- phases 4-5: the fused transport apply (#8) -----------------------------

APPLY_FIELDS = ("traj", "std", "delta", "delta_var", "min_abs_det")
# #8 against its twin's float64 evaluation of the same float32 inputs: each
# field's error at most APPLY_REL times the float32 twin's own, plus
# APPLY_FLOOR (relative; the sums of α·k and α·∂k over n ≤ 64 terms cancel as
# far as the GP's conditioning makes them, in either evaluation order).
# Phase 4 shows that the bound rejects the quadratic forms taken through the
# cached K⁻¹ (kᵀK⁻¹k, the plain route's form) in place of ‖L⁻¹k‖².
APPLY_REL, APPLY_FLOOR = 4.0, 1e-5
APPLY_CHUNK = 2048  # members a twin call: the twin holds (members, n, Q, 1 + D)


def apply_bench_state(device, E=E_MAIN):
    """Phase 4's state as the batched route forms it (γ, the E GPs from the
    Cholesky kernel, L and K⁻¹ carried) and its demo, float32."""
    from gaussian_process_transportation_tpu_torch.transport import gpt

    f32 = dict(dtype=torch.float32, device=device)
    X, dX, S, S1 = (torch.as_tensor(a, **f32) for a in make_workload())
    targets = S1[None] + torch.linspace(0.0, 1.0, E, **f32)[:, None, None]
    aff, src_al, y = gpt._affine_batched(S, targets, False, True)
    return aff, gpt._condition_batched(bench_kernel(**f32), src_al, y, 1e-10), X, dX


def apply_args(aff, gp, traj, delta):
    """``transport_apply_rbf``'s arguments for the batched route's state
    ``aff``, ``gp`` (E members, L carried) and a demo ``traj``, ``delta``."""
    from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core

    return (gp.X, gp.alpha, gp.L, aff.rotation, aff.scale, aff.source_centroid,
            aff.target_centroid, traj, delta, *gp_core.rbf_hyperparameters(gp.kernel))


def apply_errors(got, want, amplitude, noise):
    """Each field's worst |difference| over the reference's largest |value|;
    the std as the variance it is the root of, max(var, 0) = (std + √noise)²,
    over the prior amp + noise (the root's slope is unbounded at 0)."""
    amp, noise = (torch.as_tensor(v, device=got[0].device, dtype=torch.float64).reshape(-1, 1)
                  for v in (amplitude, noise))
    var = lambda std: (std.double() + noise.sqrt()) ** 2
    errs = {}
    for name, g, w in zip(APPLY_FIELDS, got, want):
        if name == "std":
            errs[name] = ((var(g) - var(w)).abs() / (amp + noise)).max().item()
        else:
            w = w.double()
            errs[name] = ((g.double() - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
    return errs


def apply_twin(args, cast=lambda a: a):
    """``transport_apply_rbf_plain`` of ``apply_args``' ``args``, each tensor
    through ``cast``, APPLY_CHUNK members at a time."""
    from gaussian_process_transportation_tpu_torch.ops import transport_apply as tfa

    E = args[0].shape[0]

    def members(a, i, part):  # the member tensors and per-member θ, cut to part
        per = i < 7 or (torch.is_tensor(a) and (a.dim() == 2 if i == 10 else a.numel() == E > 1))
        return a[part] if per else a

    parts = [tfa.transport_apply_rbf_plain(*(cast(members(a, i, slice(e, e + APPLY_CHUNK)))
                                             for i, a in enumerate(args)))
             for e in range(0, E, APPLY_CHUNK)]
    return [torch.cat(f) for f in zip(*parts)]


def apply_k_inv_form(aff, gp, traj, delta):
    """The fields of ``transport_apply``'s plain route through the cached K⁻¹
    (the GP without its factor L), shaped as ``transport_apply_rbf``'s."""
    from dataclasses import replace

    from gaussian_process_transportation_tpu_torch.transport import gpt

    r = gpt.transport_apply(aff, replace(gp, L=None), traj, delta)
    return r.traj, r.std[..., 0], r.delta, r.delta_var[..., 0], r.min_abs_det


def apply_check_errors(aff, gp, traj, delta, got=None):
    """(#8's errors, the float32 twin's errors) per field against the twin's
    float64 evaluation of the same float32 inputs (``apply_errors``).
    ``got`` stands in for #8's fields where given (a planted fault)."""
    from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core
    from gaussian_process_transportation_tpu_torch.ops import transport_apply as tfa

    args = apply_args(aff, gp, traj, delta)
    if got is None:
        got = tfa.transport_apply_rbf(*args)
    ref = apply_twin(args, lambda a: a.double() if torch.is_tensor(a) else a)
    amp, _, noise = gp_core.rbf_hyperparameters(gp.kernel)
    return apply_errors(got, ref, amp, noise), apply_errors(apply_twin(args), ref, amp, noise)


def apply_within(errs, twin_errs):
    """Whether every field's error is within APPLY_REL times the twin's
    plus APPLY_FLOOR."""
    return all(errs[k] <= APPLY_REL * twin_errs[k] + APPLY_FLOOR for k in errs)


def check_apply(aff, gp, traj, delta):
    """``apply_check_errors`` of #8, raising where they are not
    ``apply_within`` the bound."""
    errs, twin_errs = apply_check_errors(aff, gp, traj, delta)
    if not apply_within(errs, twin_errs):
        raise AssertionError(f"transport_apply_rbf against the twin's float64 evaluation: "
                             f"{errs}, the float32 twin's {twin_errs} (bound {APPLY_REL} x the "
                             f"twin's + {APPLY_FLOOR})")
    return errs, twin_errs


def bench_kernel(**dev):
    """The bench transport's C(10)·RBF(4)+White(0.01)."""
    from gaussian_process_transportation_tpu_torch import kernels as K

    return K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, **dev)) + K.White(0.01)


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


@contextlib.contextmanager
def traced():
    """A torch.profiler session of CUDA activity that opens with a throwaway
    launch (``torch.cuda._sleep``): late in a long run, after phase 14's
    trace of ~141k launches, CUPTI lost the first kernel record of every
    session (``scripts/profiler_records.py``), and isolated times read low.
    ``kernel_rows`` gives the session's kernels without that launch."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        yield prof


def kernel_rows(prof):
    """The device rows of a ``traced`` session (kernels, copies, fills), not
    the CUDA runtime's host-side rows and not the opening launch."""
    return [e for e in prof.key_averages() if e.self_device_time_total > 0
            and "spin" not in e.key.lower() and "sleep" not in e.key.lower()]


def traced_rows(run, want):
    """The kernel rows of the first of ``CUPTI_TRIES`` ``traced`` sessions of
    ``run()`` whose rows satisfy ``want``, with what ``run`` returned; (None,
    that) when none did.  CUPTI now and then hands a whole session back with
    no kernel record (seen late in a run, after the path traces), so one empty
    session is not a verdict on the code it traced."""
    for _ in range(CUPTI_TRIES):
        with traced() as prof:
            out = run()
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        if want(rows):
            return rows, out
        time.sleep(0.1)
    return None, out


def cupti_ms(fn, reps=REPS):
    """Device time of every CUDA kernel that one call of ``fn`` launches
    (torch.profiler, CUPTI), in milliseconds: the mean over ``reps`` calls
    traced in one session after a warm-up; the card's own time, without the
    host's launch gaps.  None where no session held a kernel record."""
    fn()
    torch.cuda.synchronize()
    rows, _ = traced_rows(lambda: [fn() for _ in range(reps)],
                          lambda r: sum(e.self_device_time_total for e in r) > 0)
    if rows is None:
        return None
    return sum(e.self_device_time_total for e in rows) / reps / 1e3


def device_ms(fn, reps=REPS):
    """``cupti_ms``, raising where no session held a kernel record."""
    ms = cupti_ms(fn, reps)
    if ms is None:
        raise AssertionError(f"torch.profiler recorded no device time in {CUPTI_TRIES} sessions")
    return ms


def measured(fn, reps=REPS):
    """(ms, CUDA-event ms, whether ms is CUPTI's device time) of ``fn``: the
    device time where CUPTI held the session's kernels, else the CUDA-event
    median, said so on standard error and in the record's ``timing``."""
    dev, event = cupti_ms(fn, reps), cuda_ms(fn, reps)[0]
    if dev is None:
        print(f"torch.profiler held no kernel record in {CUPTI_TRIES} sessions of "
              f"{getattr(fn, '__qualname__', fn)}: timed by CUDA events instead "
              f"({event:.4f} ms)", file=sys.stderr, flush=True)
        return event, event, False
    return dev, event, True


def timing_of(v):
    """The record's ``timing`` of one kernel: "cupti_device", or which of its
    times fell back to CUDA events (``measured``)."""
    fell = [k for k, t in v.items() if isinstance(t, tuple) and len(t) == 3 and t[2] is False]
    fell += v.get("event_timed", [])
    return "cupti_device" if not fell else "cupti_device; cuda_event for " + ", ".join(fell)


def path_breakdown(fn, kernel_key):
    """One call of ``fn`` traced (torch.profiler, CUDA activity): (wall ms
    of the call, device ms of all its kernels, device ms and launches of
    those whose name holds ``kernel_key``, launches of all kernels: device
    rows only, not the CUDA runtime's host-side ones).  A session that holds
    no ``kernel_key`` row is traced again (``traced_rows``); where none did,
    the kernel's numbers are NaN."""
    fn()
    torch.cuda.synchronize()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rows, wall = traced_rows(run, lambda r: any(kernel_key in e.key for e in r))
    if rows is None:
        print(f"torch.profiler held no {kernel_key} record in {CUPTI_TRIES} sessions",
              file=sys.stderr, flush=True)
        return dict(wall_ms=wall, device_ms=math.nan, kernel_ms=math.nan,
                    kernel_launches=math.nan, all_launches=math.nan)
    mine = [e for e in rows if kernel_key in e.key]
    return dict(wall_ms=wall, device_ms=sum(e.self_device_time_total for e in rows) / 1e3,
                kernel_ms=sum(e.self_device_time_total for e in mine) / 1e3,
                kernel_launches=sum(e.count for e in mine),
                all_launches=sum(e.count for e in rows))


def fmt_breakdown(b):
    return (f"one traced call {b['wall_ms']:.1f} ms wall, {b['device_ms']:.1f} ms of device "
            f"kernels in {b['all_launches']} launches ({100 * (1 - b['device_ms'] / b['wall_ms']):.1f}% "
            f"of the wall idle), of which the fused LML kernel {b['kernel_ms']:.1f} ms in "
            f"{b['kernel_launches']} launches")


def timed(kernel, twin, library=None, parent=None):
    """``measured`` times (device ms, CUDA-event ms, whether from CUPTI) of a
    kernel's wrapper call, its twin, the
    library call (None where there is none) and, where given, the parent
    design on the same inputs."""
    roles = (("ms", kernel), ("plain_ms", twin), ("library_ms", library))
    out = {role: None if fn is None else measured(fn) for role, fn in roles}
    if parent is not None:
        out["parent_ms"] = measured(parent)
    return out


def kernel_name(symbol):
    """``name<template arguments>`` of a mangled kernel symbol: the last
    length-prefixed name (after any namespace), its integer, boolean and
    type arguments."""
    pos, name, args = 2 + (symbol[2:3] == "N"), symbol, []
    while (m := re.match(r"\d+", symbol[pos:])):
        pos += m.end()
        name = symbol[pos:pos + int(m.group())]
        pos += int(m.group())
    if symbol.startswith("I", pos):
        pos += 1
        while (m := re.match(r"L[ib](\d+)E|([fd])", symbol[pos:])):
            args.append(m.group(1) or {"f": "float", "d": "double"}[m.group(2)])
            pos += m.end()
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(log):
    """One ``kernel<arguments>: registers, spill stores`` entry per kernel
    that ptxas compiled, from nvcc's ``-Xptxas -v`` output."""
    out, name, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = kernel_name(m.group(1)), "?"
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill} B spill stores")
            name = None
    return "; ".join(out)


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


def counted():
    """The kernel wrappers, each with its ``launches`` count."""
    from gaussian_process_transportation_tpu_torch.ops.batched_linalg import (
        spd_inverse_elast_fused,
    )
    from gaussian_process_transportation_tpu_torch.ops.blocked_chol import (
        factor_panel, stationary_gram_panels,
    )
    from gaussian_process_transportation_tpu_torch.ops.fused_lml import (
        small_lml_value_grad, small_lml_value_grad_md,
    )
    from gaussian_process_transportation_tpu_torch.ops.pallas_gram import (
        fused_gp_predict_mean, fused_gp_predict_mean_var, stationary_gram,
    )
    from gaussian_process_transportation_tpu_torch.ops.transport_apply import transport_apply_rbf

    return {f.__name__: f for f in (spd_inverse_elast_fused, factor_panel, stationary_gram,
                                    stationary_gram_panels, fused_gp_predict_mean,
                                    fused_gp_predict_mean_var, small_lml_value_grad,
                                    small_lml_value_grad_md, transport_apply_rbf)}


def drive(path):
    """Run ``path`` once with every launch count set to 0 just before;
    returns its result and the counts read just after."""
    wrappers = counted()
    md = wrappers["small_lml_value_grad_md"]
    torch.cuda.synchronize()
    for f in wrappers.values():
        f.launches = 0
    md.value_only_launches = 0
    out = path()
    torch.cuda.synchronize()
    counts = {name: f.launches for name, f in wrappers.items()}
    counts[VALUE_ONLY] = md.value_only_launches
    return out, counts


def expect_launches(what, counts, want):
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{what}: {name} launched {counts[name]} times, expected {n}")


def bound(bytes_moved, flops, transcendentals=0):
    """(bound_ms, bound_by): the larger of the memory time and the
    operations' time, which is the larger of the f32 time and the special
    function units' time for ``transcendentals`` (the two pipes run side by
    side)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(flops / F32_FLOP_PER_S, transcendentals / SFU_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def panel_bytes(n, B):
    """Bytes the Gram kernel writes for the lower column panels of an n-point
    Gram in blocks of B (``stationary_gram_panels``: n padded to P = ⌈n/B⌉
    blocks, panel k of (P − k)·B rows)."""
    P = -(-n // B)
    return 4 * B * B * P * (P + 1) // 2


def gram_flops(rows, cols, D):
    """Operations of one stationary-kernel entry: D differences, squares and
    sums, the profile (an exp and a few products) and the amplitude."""
    return rows * cols * (3 * D + 6)


# ---- phase 7: the new kernels against their twins -------------------------

def panel_spd(B):
    """A Aᵀ + B·I from a standard-normal A (seed B), float32 numpy."""
    A = np.random.default_rng(B).standard_normal((B, B))
    return (A @ A.T + B * np.eye(B)).astype(np.float32)


def panel_profile(A):
    """``factor_panel`` on the card traced over REPS calls after a warm-up
    (torch.profiler): (device launches per call, device ms per launch of
    its one-CTA diagonal step ``diag_kernel``).  A trace that records no
    diagonal step is taken again (``traced_rows``); where none did, both are
    NaN (the launch checks read the wrapper's count, not the profiler)."""
    from gaussian_process_transportation_tpu_torch.ops.blocked_chol import factor_panel

    factor_panel(A)
    torch.cuda.synchronize()
    rows, _ = traced_rows(lambda: [factor_panel(A) for _ in range(REPS)],
                          lambda r: any("diag_kernel" in e.key for e in r))
    if rows is None:
        print(f"torch.profiler held no diag_kernel record in {CUPTI_TRIES} sessions",
              file=sys.stderr, flush=True)
        return math.nan, math.nan
    diag = [e for e in rows if "diag_kernel" in e.key]
    return (sum(e.count for e in rows) / REPS,
            sum(e.self_device_time_total for e in diag) / sum(e.count for e in diag) / 1e3)


def check_factor_panel(device, B):
    """L and L⁻¹ against numpy's f64 factor to 5e-6 relative (the JAX
    kernel's bound, tests/test_blocked_chol.py:28-29), exact zeros above the
    diagonal; returns |kernel − f32 twin| on the card."""
    from gaussian_process_transportation_tpu_torch.ops.blocked_chol import (
        factor_panel, factor_panel_plain,
    )

    K = panel_spd(B)
    Kd = torch.as_tensor(K, device=device)
    L, Linv = factor_panel(Kd)
    L0, Linv0 = factor_panel_plain(Kd)
    torch.cuda.synchronize()
    L64 = np.linalg.cholesky(K.astype(np.float64))
    Linv64 = np.linalg.inv(L64)
    Ln, Linvn = L.double().cpu().numpy(), Linv.double().cpu().numpy()
    rel = (np.abs(Ln - L64).max() / np.abs(L64).max(),
           np.abs(Linvn - Linv64).max() / np.abs(Linv64).max())
    upper = max(np.abs(np.triu(Ln, 1)).max(), np.abs(np.triu(Linvn, 1)).max())
    if max(rel) >= 5e-6 or upper != 0.0:
        raise AssertionError(f"factor_panel B={B}: rel err L {rel[0]:.3g}, L^-1 {rel[1]:.3g} "
                             f"(tol 5e-6), max above diagonal {upper:.3g}")
    return max((L - L0).abs().max().item(), (Linv - Linv0).abs().max().item()), max(rel)


def gram_points(device, n, D, seed):
    """Standard-normal points (n, D) and lengthscales linspace(0.8, 1.5, D),
    float32."""
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal((n, D)), dtype=torch.float32, device=device),
            torch.linspace(0.8, 1.5, D, device=device))


def gram_excess(got, ref, scale):
    """The largest |got − ref| over GRAM_TOL·scale; an entry left NaN (not
    written) reads as infinite.  A sound kernel reads below 1."""
    err = (got.double() - ref).abs().nan_to_num(nan=math.inf)
    return (err.max() / (GRAM_TOL * scale)).item()


def flat_panels(panels):
    """The panels of one Gram as one flat tensor, in the buffer's order."""
    return torch.cat([p.reshape(-1) for p in panels])


def check_gram(device, N, M, D, family, amp=2.0):
    """``stationary_gram`` written into a NaN-filled (N, M) output, per entry
    against the formula in float64 on the same float32 inputs to
    GRAM_TOL·amp; returns (|kernel − f32 twin| max, error/bound max)."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    X, ls = gram_points(device, N, D, seed=N + M)
    Z = gram_points(device, M, D, seed=N + M + 1)[0]
    out = pg.stationary_gram_into(torch.full((N, M), math.nan, device=device), X, Z, ls, amp,
                                  family)
    ex = gram_excess(out, pg.stationary_gram_plain(X.double(), Z.double(), ls.double(), amp,
                                                   family), amp)
    if not ex < 1:
        raise AssertionError(f"stationary_gram {family} ({N}, {M}) D={D}: error/bound vs the "
                             f"f64 formula {ex:.3g}")
    return (out - pg.stationary_gram_plain(X, Z, ls, amp, family)).abs().max().item(), ex


def gram_panels_run(device, n, B, D, family, amp=2.0, noise=0.1):
    """The panel entry into a NaN-filled buffer: (points, lengthscales, the
    buffer, the same Gram from the f64 twin as one flat tensor)."""
    from gaussian_process_transportation_tpu_torch.ops import blocked_chol as bc

    X, ls = gram_points(device, n, D, seed=n * 8 + D)
    buf = torch.full((bc.panel_offsets(n, B)[-1],), math.nan, device=device)
    bc.stationary_gram_panels_into(buf, X, ls, amp, noise, B, family)
    ref = flat_panels(bc.stationary_gram_panels_plain(X.double(), ls.double(), amp, noise, B,
                                                      family)[0])
    return X, ls, buf, ref


def check_gram_panels(device, n, B, D, family, amp=2.0, noise=0.1):
    """``stationary_gram_panels`` into a NaN-filled buffer, per entry against
    the padded Gram in float64 on the same float32 inputs (the f64 twin) to
    GRAM_TOL·(amp + noise), and a second run into another NaN-filled buffer
    bitwise equal; returns (|kernel − f32 twin| max, error/bound max)."""
    from gaussian_process_transportation_tpu_torch.ops import blocked_chol as bc

    X, ls, buf, ref = gram_panels_run(device, n, B, D, family, amp, noise)
    ex = gram_excess(buf, ref, amp + noise)
    again = torch.full_like(buf, math.nan)
    bc.stationary_gram_panels_into(again, X, ls, amp, noise, B, family)
    if not (ex < 1 and torch.equal(buf, again)):
        raise AssertionError(f"stationary_gram_panels {family} n={n} B={B} D={D}: error/bound "
                             f"vs the f64 formula {ex:.3g}, two runs bitwise equal "
                             f"{torch.equal(buf, again)}")
    twin = flat_panels(bc.stationary_gram_panels_plain(X, ls, amp, noise, B, family)[0])
    return (buf - twin).abs().max().item(), ex


def gram_panel_faults(device, n=700, B=128, D=3, amp=2.0, noise=0.1):
    """``check_gram_panels``'s bound must reject a wrong panel kernel: its
    output with the noise dropped from panel 1's diagonal block, with the
    tile of rows 64-127 and columns 0-127 of panel 1 left unwritten (NaN),
    and with the first padding row (point n) coupled to the real columns of
    panel 0 (row n - 1's values).  Returns each fault's error/bound."""
    from gaussian_process_transportation_tpu_torch.ops import blocked_chol as bc

    _, _, buf, ref = gram_panels_run(device, n, B, D, "rbf", amp, noise)
    faults = {}
    for name in ("noise dropped on diagonal block 1", "tile (panel 1, rows 64-127) skipped",
                 "padding row coupled"):
        bad = buf.clone()
        panels = bc.panel_views(bad, n, B)
        if name.startswith("noise"):
            panels[1][:B].diagonal().sub_(noise)
        elif name.startswith("tile"):
            panels[1][64:128, :128] = math.nan
        else:
            panels[0][n] = panels[0][n - 1]
        faults[name] = gram_excess(bad, ref, amp + noise)
    for name, ex in faults.items():
        if not ex >= 1:
            raise AssertionError(f"the Gram panel check passes a planted fault, {name} "
                                 f"(error/bound {ex:.3g})")
    return faults


def predict_f64(Xq, X, alpha, K_inv, ls, amp, prior, family):
    """The fused predicts' formula in float64 on the same float32 inputs:
    (mean, var, Σ_n |k α| per output)."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    k = pg.stationary_gram_plain(Xq.double(), X.double(), ls.double(), amp, family)
    a = alpha.double()
    var = torch.clamp(prior - ((k @ K_inv.double()) * k).sum(1), min=0.0)
    return k @ a, var, k.abs() @ a.abs()


def predict_excess(mean, var, ref):
    """The largest error over the bound, per output, of a mean and a
    variance against ``predict_f64``'s: a sound kernel reads below 1."""
    m64, v64, m_scale = ref
    em = ((mean.double() - m64).abs() / (MEAN_REL * m_scale)).max().item()
    ev = ((var.double() - v64).abs() / (VAR_REL * v64 + VAR_FLOOR)).max().item()
    return em, ev


def check_predicts(device, Xq, X, alpha, K_inv, ls, amp, prior, family):
    """The fused predicts against the same formula in float64 on the same
    inputs, per query: mean to MEAN_REL of Σ_n|k α|, variance to
    VAR_REL·var64 + VAR_FLOOR.  Returns the largest kernel-vs-twin
    differences of mean and variance and the largest error/bound ratios."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    m0v, v0 = pg.fused_gp_predict_mean_var_plain(Xq, X, alpha, K_inv, ls, amp, prior, family)
    m = pg.fused_gp_predict_mean(Xq, X, alpha, ls, amp, family)
    mv, v = pg.fused_gp_predict_mean_var(Xq, X, alpha, K_inv, ls, amp, prior, family)
    ref = predict_f64(Xq, X, alpha, K_inv, ls, amp, prior, family)
    ex_m, ex_v = predict_excess(mv, v, ref)
    ex_m = max(ex_m, predict_excess(m, v, ref)[0])
    if ex_m >= 1 or ex_v >= 1:
        raise AssertionError(f"fused predicts {family} Nq={Xq.shape[0]} N={X.shape[0]}: "
                             f"error/bound vs the f64 formula: mean {ex_m:.3g}, var {ex_v:.3g}")
    em = max((m - m0v).abs().max().item(), (mv - m0v).abs().max().item())
    return em, (v - v0).abs().max().item(), ex_m, ex_v


def planted_faults(Xq, X, alpha, K_inv, ls, amp, prior):
    """``check_predicts``'s variance bound must reject a wrong kernel: the
    variance doubled, and the variance with the partial sums of K⁻¹ column
    tile 1 dropped (the kernel run on a K⁻¹ whose columns of that tile,
    ``MEAN_VAR_TILE_B`` wide, are zero).  Returns each fault's error/bound
    ratio."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    ref = predict_f64(Xq, X, alpha, K_inv, ls, amp, prior, "rbf")
    mean, var = pg.fused_gp_predict_mean_var(Xq, X, alpha, K_inv, ls, amp, prior)
    K_drop = K_inv.clone()
    K_drop[:, pg.MEAN_VAR_TILE_B:2 * pg.MEAN_VAR_TILE_B] = 0
    var_drop = pg.fused_gp_predict_mean_var(Xq, X, alpha, K_drop, ls, amp, prior)[1]
    faults = {"var x2": predict_excess(mean, 2 * var, ref)[1],
              "column tile 1 dropped": predict_excess(mean, var_drop, ref)[1]}
    for name, ex in faults.items():
        if not ex >= 1:
            raise AssertionError(f"the fused-variance check passes a planted fault, {name} "
                                 f"(error/bound {ex:.3g})")
    return faults


def mean_case(device, Nq, N, D, P, seed=0):
    """Standard-normal queries (Nq, D), training points (N, D) and α (N, P),
    lengthscales linspace(0.9, 1.4, D), float32: (Xq, X, alpha, lengthscale)."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    return (*(torch.as_tensor(rng.standard_normal(s), **f32) for s in ((Nq, D), (N, D), (N, P))),
            torch.linspace(0.9, 1.4, D, **f32))


def mean_excess(mean, Xq, X, alpha, ls, amp, family):
    """The largest error over the bound, per output, of a mean against the
    formula in float64 on the same float32 inputs: MEAN_REL of Σ_n|k α|, as
    ``predict_excess`` holds it.  A sound kernel reads below 1."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    k = pg.stationary_gram_plain(Xq.double(), X.double(), ls.double(), amp, family)
    a = alpha.double()
    return ((mean.double() - k @ a).abs() / (MEAN_REL * (k.abs() @ a.abs()))).max().item()


def check_mean(device, Nq, N, D, P, family, amp=2.0):
    """The mean kernel on ``mean_case``'s inputs against its twin on the
    card and per output against the f64 formula; returns (|kernel − twin|
    max, error/bound max)."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    Xq, X, alpha, ls = mean_case(device, Nq, N, D, P, seed=Nq * 1000 + N)
    m = pg.fused_gp_predict_mean(Xq, X, alpha, ls, amp, family)
    m0 = pg.fused_gp_predict_mean_plain(Xq, X, alpha, ls, amp, family)
    ex = mean_excess(m, Xq, X, alpha, ls, amp, family)
    if not (m.shape == (Nq, P) and ex < 1):
        raise AssertionError(f"fused_gp_predict_mean {family} Nq={Nq} N={N} D={D} P={P}: "
                             f"shape {tuple(m.shape)}, error/bound vs the f64 formula {ex:.3g}")
    return (m - m0).abs().max().item(), ex


def mean_faults(device, Nq=300, N=300, D=2, P=2):
    """``mean_excess`` must reject a wrong mean kernel: the kernel run with
    the α rows of training chunk 1 (``MEAN_CHUNK`` wide) set to zero, and
    its means shifted by one query.  Returns each fault's error/bound."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    Xq, X, alpha, ls = mean_case(device, Nq, N, D, P, seed=5)
    a_drop = alpha.clone()
    a_drop[pg.MEAN_CHUNK:2 * pg.MEAN_CHUNK] = 0
    m = pg.fused_gp_predict_mean(Xq, X, alpha, ls, 2.0)
    faults = {"chunk 1 dropped": mean_excess(pg.fused_gp_predict_mean(Xq, X, a_drop, ls, 2.0),
                                             Xq, X, alpha, ls, 2.0, "rbf"),
              "queries shifted by one": mean_excess(torch.roll(m, 1, 0), Xq, X, alpha, ls, 2.0,
                                                    "rbf")}
    for name, ex in faults.items():
        if not ex >= 1:
            raise AssertionError(f"the mean check passes a planted fault, {name} "
                                 f"(error/bound {ex:.3g})")
    return faults


def posterior_case(device, Nq, N, family, D=3, P=2, seed=6):
    """Standard-normal queries (Nq, D) and the X, α and K⁻¹ of a GP
    conditioned on N such points with Y = sin of their coordinates, so that
    the variance is a posterior one; C(2)·family(ℓ)+White(0.05), float32.
    Returns (Xq, X, alpha, K_inv, lengthscale, amplitude, prior)."""
    from gaussian_process_transportation_tpu_torch import kernels as K
    from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core

    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    Xq = torch.as_tensor(rng.standard_normal((Nq, D)), **f32)
    X = torch.as_tensor(rng.standard_normal((N, D)), **f32)
    ls = torch.linspace(0.9, 1.4, D, **f32)
    nu = {"rbf": None, "matern12": 0.5, "matern32": 1.5, "matern52": 2.5}[family]
    base = K.RBF(ls) if nu is None else K.Matern(ls, nu=nu)
    gp = gp_core.condition(K.Constant(2.0) * base + K.White(0.05), X,
                           torch.sin(X[:, torch.arange(P) % D]), cache_k_inv=True)
    return Xq, X, gp.alpha, gp.K_inv, ls, 2.0, 2.05


# ---- workloads of phases 8-10 ----------------------------------------------

def solve_inputs(device, n=N_SOLVE):
    """bench.py's Cholesky stage inputs (bench.py:237-246): X, Y (n, 3)
    standard normal f32 from seed 0."""
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((n, D_SOLVE)).astype(np.float32), device=device)
    Y = torch.as_tensor(rng.standard_normal((n, D_SOLVE)).astype(np.float32), device=device)
    return X, Y


def ensemble_3d_inputs():
    """scripts/bench_ensemble_3d.py:45-54: surfaces of N=2500 points in 3-D,
    E targets shifted and jittered, a Q=1000 demo; float32 numpy."""
    rng = np.random.default_rng(0)
    S = rng.standard_normal((N_3D, 3)).astype(np.float32) * 2.0
    shifts = np.linspace(0.0, 1.0, E_3D, dtype=np.float32)
    targets = (S[None] + shifts[:, None, None]
               + 0.05 * rng.standard_normal((E_3D, N_3D, 3)).astype(np.float32))
    X = rng.standard_normal((Q_3D, 3)).astype(np.float32) * 2.0
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return S, targets, X, dX


def grid_inputs():
    """The dense-grid predict: N=2048 training points (standard normal,
    seed 0) with targets sin(X), and a 100x100 query grid on [-3, 3]^2."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N_GRID, 2)).astype(np.float32)
    g = np.linspace(-3, 3, NQ_GRID, dtype=np.float32)
    Xq = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    return X, np.sin(X), Xq


def f64_gram(X, amp, noise):
    """amp·exp(−½‖x−x′‖²) + noise·I in float64, per-dimension differences."""
    Xd = X.double()
    d2 = sum((Xd[:, None, d] - Xd[None, :, d]) ** 2 for d in range(X.shape[1]))
    return amp * torch.exp(-0.5 * d2) + noise * torch.eye(X.shape[0], dtype=torch.float64,
                                                          device=X.device)


# ---- phases 12-15: the fused small-LML kernels and their paths -----------

def lml_jitter(has_noise):
    """Without a noise term a jitter keeps the f32 Gram definite."""
    return 1e-8 if has_noise else 1e-2


def lml_inputs(device, E, n, D, p, n_ls, has_noise, per_lane, seed=0):
    """float32 (X, Y, theta): X standard normal ((E,) n, D), Y = sin(x0) +
    0.1·noise, theta (T, E) uniform in (−1, 1), as the JAX tests draw them."""
    rng = np.random.default_rng(seed)
    lead = (E,) if per_lane else ()
    X = rng.standard_normal(lead + (n, D)).astype(np.float32)
    Y = (np.sin(X[..., :1]) + 0.1 * rng.standard_normal(lead + (n, p))).astype(np.float32)
    th = rng.uniform(-1.0, 1.0, (1 + n_ls + int(has_noise), E)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (X, Y, th))


def lml_f64(Xe, Ye, theta, family, n_ls, has_noise, jitter):
    """The fused LML's value and gradient per lane in float64 from the same
    inputs, written out here (Cholesky, solves, the trace identity), and
    the bound a sound float32 evaluation keeps to: (val, grad (T, E),
    val_bound (E,), grad_bound (T, E)).  Xe (E or 1, n, D), Ye (E or 1, n, p)."""
    from gaussian_process_transportation_tpu_torch.ops import fused_lml as fl
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    th = theta.double().T
    E, (n, D), p = th.shape[0], Xe.shape[-2:], Ye.shape[-1]
    Xd, Yd = Xe.double(), Ye.double().expand(E, n, p)
    eye = torch.eye(n, dtype=th.dtype, device=th.device)
    amp = torch.exp(th[:, 0])[:, None, None]
    inv_ls2 = torch.exp(-2.0 * th[:, 1:1 + n_ls]).expand(E, D)
    noise = torch.exp(th[:, 1 + n_ls]) if has_noise else th.new_zeros(E)
    d2 = (Xd[:, :, None, :] - Xd[:, None, :, :]) ** 2  # (E|1, n, n, D)
    s = (d2 * inv_ls2[:, None, None, :]).sum(-1)
    ph, dph = pg.stationary_from_sqdist(s, family), fl._dphi(s, family)
    K = amp * ph + (noise + jitter)[:, None, None] * eye
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(Yd, L)
    K_inv = torch.cholesky_inverse(L)
    eig = torch.linalg.eigvalsh(K.cpu()).to(K.device)  # cuSOLVER's batched form refuses E=28,675
    cond_eps = LML_COND * F32_EPS * (eig[:, -1] / eig[:, 0])  # (E,)
    logpiv = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    ya = Yd * alpha
    val = -0.5 * ya.sum((1, 2)) - p * (0.5 * logpiv.sum(1) + 0.5 * n * math.log(2 * math.pi))
    val_terms = 0.5 * ya.abs().sum((1, 2)) + 0.5 * p * logpiv.abs().sum(1) + n * p
    val_bound = (LML_VAL_REL * val_terms
                 + cond_eps * (0.5 * (Yd.abs() * alpha.abs()).sum((1, 2)) + 0.5 * p * n)
                 + LML_FLOOR)
    W = 0.5 * (alpha @ alpha.transpose(1, 2) - p * K_inv)
    U = 0.5 * (alpha.abs() @ alpha.abs().transpose(1, 2) + p * K_inv.abs())
    dK_ls = (amp * dph)[..., None] * d2 * (-2.0 * inv_ls2[:, None, None, :])  # (E, n, n, D)
    parts = [(amp * ph)[..., None], dK_ls if n_ls > 1 else dK_ls.sum(-1, keepdim=True)]
    if has_noise:
        parts.append((noise[:, None, None] * eye)[..., None])
    dK = torch.cat(parts, -1)  # (E, n, n, T)
    grad = (W[..., None] * dK).sum((1, 2)).T
    grad_bound = (LML_GRAD_REL * (W[..., None] * dK).abs().sum((1, 2)).T
                  + cond_eps[None, :] * (U[..., None] * dK.abs()).sum((1, 2)).T + LML_FLOOR)
    return val, grad, val_bound, grad_bound


def lml_excess(val, grad, ref):
    """The largest error over the bound of a value and a gradient against
    ``lml_f64``'s: a sound kernel reads below 1."""
    v64, g64, vb, gb = ref
    return ((val.double() - v64).abs() / vb).max().item(), ((grad.double() - g64).abs() / gb).max().item()


def check_lml_case(device, case, E, seed=0):
    """Kernels #2 and #3 on one case against their twins and the f64
    formula; returns (|kernel − twin| max, error/bound max) per kernel."""
    from gaussian_process_transportation_tpu_torch.ops import fused_lml as fl

    fam, n, D, p, n_ls, noise = case
    jit = lml_jitter(noise)
    out = {}
    for name, per_lane in (("small_lml_value_grad", False), ("small_lml_value_grad_md", True)):
        X, Y, th = lml_inputs(device, E, n, D, p, n_ls, noise, per_lane, seed)
        kern, twin = getattr(fl, name), getattr(fl, name + "_ref")
        v, g = kern(X, Y, th, fam, n_ls, noise, jit)
        v0, g0 = twin(X, Y, th, fam, n_ls, noise, jit)
        ref = lml_f64(X if per_lane else X[None], Y if per_lane else Y[None], th, fam, n_ls, noise,
                      jit)
        diff = max((v - v0).abs().max().item(), (g - g0).abs().max().item())
        out[name] = (diff, max(lml_excess(v, g, ref)))
        if not out[name][1] < 1:
            raise AssertionError(f"{name} {case} E={E}: error/bound vs the f64 formula "
                                 f"{out[name][1]:.3g}")
        if per_lane:
            # the value-only instance: bit for bit the full one's value
            vo = fl._small_lml_value_md(X, Y, th, fam, n_ls, noise, jit)
            if not torch.equal(vo, v):
                raise AssertionError(f"{VALUE_ONLY} {case} E={E}: values differ from "
                                     f"{name}'s by up to {(vo - v).abs().max().item():.3g}")
            out[VALUE_ONLY] = ((vo - v).abs().max().item(), lml_excess(vo, g, ref)[0])
    return out


def lml_faults(device, E, n=20, D=2, p=2):
    """The phase-12 bound must reject a wrong kernel: kernel #3's gradient
    with its amplitude row negated, and kernel #3 run with lanes 0 and 1's
    datasets swapped.  Returns each fault's error/bound ratio."""
    from gaussian_process_transportation_tpu_torch.ops import fused_lml as fl

    X, Y, th = lml_inputs(device, E, n, D, p, D, True, True)
    ref = lml_f64(X, Y, th, "rbf", D, True, 1e-8)
    v, g = fl.small_lml_value_grad_md(X, Y, th, "rbf", D, True, 1e-8)
    g_neg = g.clone()
    g_neg[0] = -g_neg[0]
    swap = torch.arange(E, device=X.device)
    swap[:2] = swap[[1, 0]]
    v_sw, g_sw = fl.small_lml_value_grad_md(X[swap].contiguous(), Y[swap].contiguous(), th, "rbf",
                                            D, True, 1e-8)
    faults = {"amplitude gradient negated": max(lml_excess(v, g_neg, ref)),
              "lanes 0 and 1 datasets swapped": max(lml_excess(v_sw, g_sw, ref))}
    for name, ex in faults.items():
        if not ex >= 1:
            raise AssertionError(f"the LML check passes a planted fault, {name} "
                                 f"(error/bound {ex:.3g})")
    return faults


def lml_occupancy():
    """Registers and resident warps (= lanes) per SM of each instance of the
    fused-LML kernel, as the runtime reports them."""
    from gaussian_process_transportation_tpu_torch.ops import _cuda

    k = 2 * len(LML_INSTANCES)
    regs, warps = (ctypes.c_int * k)(), (ctypes.c_int * k)()
    err = _cuda.library("fused_lml").small_lml_occupancy(regs, warps)
    if err != 0:
        raise RuntimeError(f"small_lml_occupancy: CUDA error {err}")
    return "fused_lml registers / warps per SM, value+gradient and value only: " + ", ".join(
        f"{c}: {regs[2 * i]}/{warps[2 * i]} and {regs[2 * i + 1]}/{warps[2 * i + 1]}"
        for i, c in enumerate(LML_INSTANCES))


def lml_value_faults(device, E, n=20, D=2, p=2):
    """The value-only instance's checks must reject a wrong one: its values
    with lanes 0 and 1's datasets swapped (the f64 bound), and its values
    one unit in the last place off in one lane (the bitwise comparison with
    the full kernel).  Returns the first fault's error/bound ratio."""
    from gaussian_process_transportation_tpu_torch.ops import fused_lml as fl

    X, Y, th = lml_inputs(device, E, n, D, p, D, True, True)
    ref = lml_f64(X, Y, th, "rbf", D, True, 1e-8)
    v, g = fl.small_lml_value_grad_md(X, Y, th, "rbf", D, True, 1e-8)
    swap = torch.arange(E, device=X.device)
    swap[:2] = swap[[1, 0]]
    v_sw = fl._small_lml_value_md(X[swap].contiguous(), Y[swap].contiguous(), th, "rbf", D, True,
                                  1e-8)
    ex = lml_excess(v_sw, g, ref)[0]
    if not ex >= 1:
        raise AssertionError(f"the LML check passes a planted fault of the value-only instance "
                             f"(error/bound {ex:.3g})")
    v_ulp = fl._small_lml_value_md(X, Y, th, "rbf", D, True, 1e-8)
    v_ulp[E // 2] = torch.nextafter(v_ulp[E // 2], torch.full_like(v_ulp[E // 2], math.inf))
    if torch.equal(v_ulp, v):
        raise AssertionError("the bitwise check passes a value-only result one ulp off")
    return ex


def lml_flops(n, D, p):
    """Operations of one lane: the Gram (D differences, squares and sums,
    the profile), the Cholesky n³/3 and the inverse 2n³/3, the two solves
    for α, and the gradient's row sums (W, φ and ∂φ again, D products)."""
    return n**3 + n * n * (4 * p + 8 * D + 20)


def lml_value_flops(n, D, p):
    """Operations of one lane's value alone: the Gram (D differences,
    squares and sums, the profile), the Cholesky n³/3 and the two solves."""
    return n**3 / 3 + n * n * (2 * p + 3 * D + 6)


def fit_targets(S1, E):
    """Phase 13's targets: S1 with a_e·sin(πs) added to its second
    coordinate, a_e = linspace(0, 2, E), so members fit different residual
    datasets."""
    s = np.linspace(0, 1, S1.shape[0], dtype=np.float32)
    a = np.linspace(0, 2, E, dtype=np.float32)
    bump = np.stack([0 * s, np.sin(np.pi * s)], 1).astype(np.float32)
    return S1[None] + a[:, None, None] * bump[None]


def fit_kernel(**device):
    """C(10)·RBF(4)+White(0.01) with the bounds of phase 13's fit: those of
    the JAX package's fused-fit test for the amplitude and lengthscale
    (tests/test_fused_lml.py:179-183) and the kernel's own 0.01 as the noise
    floor.  Under the default (1e-5, 1e5) these smooth, noise-free residuals
    run every member to ℓ = 1e5 and noise = 1e-5, where the float32 Gram is
    singular (PERF.md)."""
    from gaussian_process_transportation_tpu_torch import kernels as K

    return (K.Constant(10.0, bounds=(1e-2, 1e2)) * K.RBF(4.0 * torch.ones(2, **device),
                                                         bounds=(1e-1, 1e1))
            + K.White(0.01, bounds=(1e-2, 1e1)))


def hmc_inputs():
    """bench.py's hmc stage data (bench.py:340-345): X (20, 2), Y (20, 1)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((20, 2)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((20, 1))).astype(np.float32)
    return X, Y


# ---- phases 16-20: the blocked fit, NUTS, the generic route, the
# checkpointed run and SMC ----------------------------------------------------

FIT_N, FIT_D, FIT_MAXITER = 10240, 3, 10  # scripts/bench_blocked_lml.py's inputs; maxiter cut
NUTS_CHECK_CHAINS = HMC_CHAINS // 4
GENERIC_N, GENERIC_CHAINS, GENERIC_STEPS, GENERIC_LEAPFROG = 40, 64, 24, 16
CKPT_SEGMENT = 16  # three segments of phase 14's 48 samples
SMC_PARTICLES, SMC_STEPS, SMC_TRAJ = 8192, 16, 100  # bench.py:281-325


def blocked_fit_inputs(device):
    """scripts/bench_blocked_lml.py's inputs: X (10240, 3) standard normal,
    Y = sin(2·x0) + 0.1·noise, float32 from seed 0; θ0 = (log 2, 0, 0, 0,
    log 0.1)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((FIT_N, FIT_D)).astype(np.float32)
    Y = (np.sin(2.0 * X[:, :1]) + 0.1 * rng.standard_normal((FIT_N, 1))).astype(np.float32)
    return (torch.as_tensor(X, device=device), torch.as_tensor(Y, device=device),
            torch.tensor([math.log(2.0), 0.0, 0.0, 0.0, math.log(0.1)], device=device))


def blocked_lml_f64(X, Y, theta, jitter):
    """The blocked LML's value and θ-gradient (amplitude, ℓ per axis, noise)
    in float64 on the card from the same float32 inputs: the dense Gram, its
    Cholesky, α and K⁻¹, the trace identity; with phase 12's bound for a
    sound float32 evaluation, ``lml_f64``'s terms at κ(K) ≤ (Gershgorin's
    largest row sum)/(noise + jitter), the smallest eigenvalue of amp·φ +
    σ²I being at least σ².  Returns (val, grad (T,), val_bound, grad_bound
    (T,))."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg
    from gaussian_process_transportation_tpu_torch.ops.blocked_lml import stationary_dk_dd2

    th = theta.double()
    n, D = X.shape
    p = Y.shape[1]
    Xd, Yd = X.double(), Y.double()
    amp, ls, noise = torch.exp(th[0]), torch.exp(th[1:1 + D]), torch.exp(th[1 + D])
    Z = Xd / ls
    d2 = torch.zeros(n, n, dtype=torch.float64, device=X.device)
    for d in range(D):
        d2 += (Z[:, None, d] - Z[None, :, d]) ** 2
    Kf = amp * pg.stationary_from_sqdist(d2, "rbf")
    K = Kf.clone()
    K.diagonal().add_(noise + jitter)
    cond_eps = LML_COND * F32_EPS * (K.abs().sum(1).max() / (noise + jitter)).item()
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(Yd, L)
    logpiv = 2.0 * torch.log(torch.diagonal(L))
    ya = Yd * alpha
    val = (-0.5 * ya.sum() - p * (0.5 * logpiv.sum() + 0.5 * n * math.log(2 * math.pi))).item()
    val_bound = (LML_VAL_REL * (0.5 * ya.abs().sum() + 0.5 * p * logpiv.abs().sum() + n * p)
                 + cond_eps * (0.5 * (Yd.abs() * alpha.abs()).sum() + 0.5 * p * n)).item()
    K_inv = torch.cholesky_inverse(L)
    del L
    W = 0.5 * (alpha @ alpha.T - p * K_inv)
    U = 0.5 * (alpha.abs() @ alpha.abs().T + p * K_inv.abs())
    del K_inv
    dk = amp * stationary_dk_dd2(d2, "rbf")
    del d2
    grads, bounds = [], []
    parts = [Kf] + [dk * (-2.0) * (Z[:, None, d] - Z[None, :, d]) ** 2 for d in range(D)]
    parts.append(None)  # noise·I
    for dK in parts:
        if dK is None:
            wd, ud = noise * torch.diagonal(W), noise * torch.diagonal(U)
        else:
            wd, ud = W * dK, U * dK.abs()
        grads.append(wd.sum().item())
        bounds.append((LML_GRAD_REL * wd.abs().sum() + cond_eps * ud.sum()).item())
        del wd, ud
    return val, torch.tensor(grads, dtype=torch.float64), val_bound, torch.tensor(bounds,
                                                                                   dtype=torch.float64)


def blocked_excess(val, grads, ref):
    """(value error/bound, gradient error/bound max) of a blocked LML value
    and gradient (amplitude, ℓ (D,), noise) against ``blocked_lml_f64``."""
    v64, g64, vb, gb = ref
    g = torch.cat([grads[0].reshape(1), grads[1].reshape(-1), grads[2].reshape(1)]).double().cpu()
    return abs(val.item() - v64) / vb, ((g - g64).abs() / gb).max().item()


def fused_posterior(kern, X, Y, num_chains, seed=0, jitter=1e-10):
    """sample_gp_posterior's fused problem, for a sampler called directly:
    (the batched log-density over kernel #2, initial positions (T, E) in the
    central half of the box in the canonical layout)."""
    from gaussian_process_transportation_tpu_torch.models.exact_gp import small_lml_theta_layout
    from gaussian_process_transportation_tpu_torch.parallel import samplers

    family, n_ls, has_noise, perm_np = small_lml_theta_layout(kern)
    perm = torch.as_tensor(perm_np, device=X.device)
    bounds = kern.theta_bounds.to(dtype=torch.float32, device=X.device)[perm]
    lo, hi = bounds[:, :1], bounds[:, 1:]
    u = torch.rand((lo.shape[0], num_chains), generator=torch.Generator().manual_seed(seed))
    inits = lo + u.to(X.device) * (hi - lo) * 0.5 + 0.25 * (hi - lo)
    return samplers.fused_lp_and_grad(X, Y, lo, hi, family, n_ls, has_noise, jitter), inits


def drive_timed(path):
    """``drive(path)`` with CUDA events around the path: (result, counts,
    ms of that first run)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def run():
        ev[0].record()
        out = path()
        ev[1].record()
        return out

    out, counts = drive(run)
    return out, counts, ev[0].elapsed_time(ev[1])


def drive_fit(path, runner=drive):
    """``runner(path)`` (``drive`` or ``drive_timed``) with the fits'
    L-BFGS counters (``models/_lbfgs.py::lbfgs_minimize``) set to 0 just
    before as well: the runner's results, then the counts of its iterations,
    evaluations (value-and-gradient calls, each one batched call of all
    lanes) and line-search rounds read just after."""
    from gaussian_process_transportation_tpu_torch.models._lbfgs import lbfgs_minimize as f

    f.iterations = f.evaluations = f.rounds = 0
    out = runner(path)
    return (*out, dict(iterations=f.iterations, evaluations=f.evaluations, rounds=f.rounds))


def fit_text(opt):
    return (f"{opt['iterations']} iterations, {opt['evaluations']} evaluations, "
            f"{opt['rounds']} line-search rounds")


def smc_inputs(device):
    """bench.py's smc stage (bench.py:292-300): trajectories (8192, 100, 2)
    standard normal float32 from seed 0, uniform weights, the goal (1, 1)
    at scale 2."""
    from gaussian_process_transportation_tpu_torch.parallel import smc

    rng = np.random.default_rng(0)
    trajs = torch.as_tensor(rng.standard_normal((SMC_PARTICLES, SMC_TRAJ, 2)).astype(np.float32),
                            device=device)
    p0 = smc.ParticleEnsemble(trajs, torch.full((SMC_PARTICLES,), -math.log(SMC_PARTICLES),
                                                device=device))
    return p0, smc.goal_likelihood(torch.tensor([1.0, 1.0], device=device), scale=2.0)


# ---- phases 21-25: fit_jit, active learning at the cap, the diffeomorphism
# sweep and the heteroscedastic field, the mixed-precision solve, the variants

JIT_RESTARTS, JIT_MAXITER = 5, 100  # fit_jit: six lanes, JAX's maxiter
# The active-learning GP at the original project's cap (m = 20,000 points of
# N = 24,000: the reference subsamples only past 20,000), its seed 10% of
# m; the fit's maxiter cut to 5 (fit_blocked's default is 40); Q queries.
AL_N, AL_M, AL_Q, AL_MAXITER = 24000, 20000, 1000, 5
# the float32 picks against float64 ones on the card at a smaller size: the
# seed and the first AL_CHECK_GREEDY greedy picks after it must agree
AL_CHECK_N, AL_CHECK_M, AL_CHECK_GREEDY = 3000, 2000, 100
# the loop's final conditional variance at AL_SCHUR_POINTS unselected points
# against the float64 Schur complement over the selected set, to
# AL_SCHUR_TOL·(amp + noise): m float32 subtractions of l_j² give about
# sqrt(m)·ε32 ≈ 8e-6 of it at m = 20,000 (a CPU rehearsal at m = 2,000 read
# 4e-7), m·ε32 ≈ 1.2e-3 at worst
AL_SCHUR_POINTS, AL_SCHUR_TOL = 256, 1e-4
MIXED_NOISE = 10.0  # phase 24's second Gram, one that the bf16 factor keeps definite
DIFFEO_TRIALS = 20  # optimize_diffeomorphism's default
# the planted faults read on the first trials; the independent sweeps on the
# card and in float64 on the CPU, shorter for time
DIFFEO_FAULT_TRIALS, DIFFEO_CHECK_TRIALS = 5, 5
VARIANTS = ("AffineTransportation", "KMPTransport", "LaplacianEditingTransport")


def residual_inputs(device, dtype):
    """Phase 21's fit: the bench transport's residual (n=20, D=2, p=2), the
    targets S1 less the Kabsch fit γ(S) of the bench's source points."""
    from gaussian_process_transportation_tpu_torch.models import affine as affine_core

    _, _, S, S1 = make_workload()
    S, S1 = (torch.as_tensor(a, dtype=dtype, device=device) for a in (S, S1))
    src = affine_core.predict(affine_core.fit(S, S1), S)
    return src, S1 - src


def surface_inputs(n, seed=0):
    """Phase 22's data: n points on the smooth surface z = sin(x)·cos(y)/2,
    (x, y) uniform on [−3, 3]² from ``seed``, and Y (n, 3) a known nonlinear
    deformation of them; float32 numpy."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-3.0, 3.0, (n, 2))
    X = np.stack([xy[:, 0], xy[:, 1], 0.5 * np.sin(xy[:, 0]) * np.cos(xy[:, 1])], 1)
    Y = np.stack([0.3 * np.sin(X[:, 1] + X[:, 2]), 0.2 * X[:, 0] * np.cos(X[:, 1]),
                  0.1 * X[:, 0] ** 2 - 0.2 * X[:, 2]], 1)
    return X.astype(np.float32), Y.astype(np.float32)


def al_kernel(**device):
    """C(1)·RBF(0.3)+White(0.01): a lengthscale that keeps the conditional
    variances apart through the first picks after the seed."""
    from gaussian_process_transportation_tpu_torch import kernels as K

    return K.Constant(1.0) * K.RBF(0.3 * torch.ones(3, **device)) + K.White(0.01)


def schur_f64(kernel, X, idx, q):
    """The float64 conditional variance k(x, x) + σ² − k(x, S)(K_SS)⁻¹k(S, x)
    of the points ``q`` given the selected set S = X[idx] (K_SS with its
    White term), on the card."""
    Xd = X.double()
    S = Xd[idx]
    L = torch.linalg.cholesky(kernel(S))
    V = torch.linalg.solve_triangular(L, kernel(S, Xd[q]), upper=False)
    del L
    return kernel.diag(Xd[q]) - (V * V).sum(0)


def rel_residual_f64(K64, x, B):
    """max over the columns of ‖B − K x‖ / ‖B‖, in float64."""
    r = B.double() - K64 @ x.double()
    return (torch.linalg.norm(r, dim=0) / torch.linalg.norm(B.double(), dim=0)).max().item()


def drive_variant(name, device, dtype, X, dX, S, S1):
    """One transport of ``transport.variants`` on the bench inputs in
    ``dtype`` on ``device``; KMP's time GP fitted without restarts."""
    from gaussian_process_transportation_tpu_torch.transport import variants

    tr = getattr(variants, name)(device=device)
    if name == "KMPTransport":
        tr.transportation.n_restarts = 0
    tr.source_distribution, tr.target_distribution, tr.training_traj, tr.training_delta = (
        torch.as_tensor(a, dtype=dtype, device=device) for a in (S, S1, X, dX))
    tr.fit_transportation()
    tr.apply_transportation()
    return tr


# ---- phases 26-27: the learned-map transports and the multi-frame baselines

# benchmarks/comparison.py:24-50 and the variants' defaults: every transport
# at its own default settings
LEARNED = ("MLPTransport", "RandomForestTransport", "NeuralTransport", "EnsembleNeuralTransport",
           "BijectiveTransport", "EnsembleBijectiveTransport", "GMRTransport", "SVGPTransport")
TRACED_FITS = ("MLPTransport", "EnsembleBijectiveTransport")  # the two largest fits
N_CMP = 100  # run_comparison's n_traj and n_dist (benchmarks/comparison.py:58-59)
# float64 on the card against float64 on the CPU, of each field's largest
# entry; the baselines' trajectories of max|traj|
LEARNED_TOL, BASELINE_TOL = 1e-6, 1e-8
SVGP3_INDUCING, SVGP3_EPOCHS, SVGP3_BATCH = 100, 20, 128  # phase 27's 3-D SVGP
FIELDS = ("training_traj", "training_delta", "std", "var_vel_transported", "training_ori")


def comparison_inputs():
    """Phase 26's inputs, as ``run_comparison`` forms them: phase 4's demo,
    source and first target, each resampled to N_CMP points with the
    port's ``resample``, and velocities by forward differences; float64
    numpy."""
    from gaussian_process_transportation_tpu_torch.utils.resample import resample

    X, _, S, S1 = make_workload()
    X, S, S1 = (resample(torch.as_tensor(a, dtype=torch.float64), num_points=N_CMP).numpy()
                for a in (X, S, S1))
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return X, dX, S, S1


def fit_learned(name, device, dtype, S, S1, **fit_kw):
    """``transport.variants.<name>`` at its defaults, fitted on S → S1 in
    ``dtype`` on ``device``."""
    from gaussian_process_transportation_tpu_torch.transport import variants

    tr = getattr(variants, name)(device=device)
    tr.source_distribution, tr.target_distribution = (
        torch.as_tensor(a, dtype=dtype, device=device) for a in (S, S1))
    tr.fit_transportation(**fit_kw)
    return tr


def apply_learned(tr, X, dX, ori=None):
    """``apply_transportation`` of the trajectory X, velocities dX and,
    where given, orientations, put on the transport's device in the dtype
    of its fit."""
    dtype = torch.as_tensor(tr.source_distribution).dtype
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=tr.device)
    tr.training_traj, tr.training_delta = put(X), put(dX)
    if ori is not None:
        tr.training_ori = put(ori)
    tr.apply_transportation()
    return tr


def learned_fields(tr):
    return {f: getattr(tr, f) for f in FIELDS if getattr(tr, f, None) is not None}


def field_errors(got, want, scale=None):
    """Each field's max |got − want| over the largest |want| entry (over
    ``scale`` for the positions, where given)."""
    out = {}
    for f, w in learned_fields(want).items():
        w = w.double().cpu()
        ref = scale if (f == "training_traj" and scale) else w.abs().max().item()
        out[f] = (getattr(got, f).double().cpu() - w).abs().max().item() / max(ref, 1e-300)
    return out


def forest_on_cpu(tr):
    """A RandomForestTransport on the CPU holding the card run's fitted
    affine map and forest."""
    import copy
    import dataclasses

    cpu = lambda dc: type(dc)(**{f.name: getattr(dc, f.name).cpu()
                                 for f in dataclasses.fields(dc)})
    ref = copy.copy(tr)
    ref.device = torch.device("cpu")
    ref.affine_transform = copy.copy(tr.affine_transform)
    ref.affine_transform.params = cpu(tr.affine_transform.params)
    ref.delta_map = copy.copy(tr.delta_map)
    ref.delta_map.params = cpu(tr.delta_map.params)
    return ref


def fmt_traced(fn):
    """``path_breakdown`` of one fit (every kernel it launched), printed."""
    b = path_breakdown(fn, "")
    return (f"one traced fit {b['wall_ms']:.1f} ms wall, {b['device_ms']:.1f} ms of device "
            f"kernels in {b['all_launches']} launches "
            f"({100 * (1 - b['device_ms'] / b['wall_ms']):.1f}% of the wall idle)")


def wall_s(fn):
    """(seconds, result) of one call of ``fn``, the card synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def natgrad_posterior(device, S, S1, X):
    """``svgp.fit_natgrad`` of the residual S1 − S at phase 27's settings in
    float64 on ``device``: (fit seconds, posterior mean, posterior std at
    X), the posteriors on the CPU."""
    from gaussian_process_transportation_tpu_torch import kernels as K
    from gaussian_process_transportation_tpu_torch.models import svgp
    from gaussian_process_transportation_tpu_torch.models._training import cpu_generator

    put = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    kernel = K.Constant(1.0) * K.RBF(put(np.ones(S.shape[1])))
    fit_s, state = wall_s(lambda: svgp.fit_natgrad(
        kernel, put(S), put(S1 - S), num_inducing=SVGP3_INDUCING, num_epochs=SVGP3_EPOCHS,
        batch_size=SVGP3_BATCH, generator=cpu_generator(0)))
    mean, std = svgp.posterior_f(svgp.collapse(state), put(X))
    return fit_s, mean.cpu(), std.cpu()


def synthetic_frames(n_demos=7, T=40, seed=0):
    """tests/test_baselines.py:20-42: demonstrations from frame 0's origin
    to frame 1's with a bulge and a dwell at the goal."""
    r = np.random.RandomState(seed)
    demos_x, A, b = [], [], []
    for _ in range(n_demos):
        b0, b1 = r.uniform(-20, 20, 2), r.uniform(-20, 20, 2)
        th = r.uniform(-np.pi, np.pi)
        R1 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        t = np.linspace(0, 1, T - 6)
        path = np.outer(1 - t, b0) + np.outer(t, b1) + np.outer(np.sin(np.pi * t) * 5.0, R1 @ [0, 1])
        demos_x.append(np.vstack([path, np.tile(path[-1], (6, 1))]))
        A.append(np.tile(np.stack([np.eye(2), R1])[None], (T, 1, 1, 1)))
        b.append(np.tile(np.stack([b0, b1])[None], (T, 1, 1)))
    return demos_x, A, b


def run_baselines(device, dtype):
    """TPGMM() and HMMLQR() fitted on six synthetic demonstrations in
    ``dtype`` on ``device``, each reproduced at the seventh's frames:
    (TP-GMM trajectory, its covariances, HMM-LQR trajectory, fit seconds)."""
    from gaussian_process_transportation_tpu_torch.models.hmm_lqr import HMMLQR
    from gaussian_process_transportation_tpu_torch.models.tpgmm import TPGMM

    demos_x, A, b = synthetic_frames()
    demos_dx = [np.vstack([np.diff(x, axis=0), np.zeros((1, 2))]) for x in demos_x]
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    fit_x = [x.astype(np_dtype) for x in demos_x[:-1]]
    A_new, b_new = list(A[-1][0]), list(b[-1][0])
    t_tp, tp = wall_s(lambda: TPGMM(device=device).fit(fit_x, A[:-1], b[:-1]))
    t_hmm, hmm = wall_s(lambda: HMMLQR(device=device).fit(fit_x, demos_dx[:-1], A[:-1], b[:-1]))
    traj, cov = tp.reproduce(A_new, b_new)
    return traj, cov, hmm.reproduce(A_new, b_new, x0=demos_x[-1][0]), (t_tp, t_hmm)


def perturbation_spread(name, S, S1, X, dX, ref, trials=3):
    """Each field's largest change against ``ref`` over ``trials`` float64
    CPU runs of ``name`` with S1 and X moved by ε64·N(0, 1) of themselves:
    the spread that rounding alone causes in this transport on these
    inputs."""
    eps = np.finfo(np.float64).eps
    spread = {}
    for seed in range(trials):
        rng = np.random.default_rng(seed)
        S1p, Xp = (a * (1 + eps * rng.standard_normal(a.shape)) for a in (S1, X))
        tr = apply_learned(fit_learned(name, "cpu", torch.float64, S, S1p), Xp, dX)
        for f, e in field_errors(tr, ref, float(np.abs(X).max())).items():
            spread[f] = max(spread.get(f, 0.0), e)
    return spread


def phase26(device, tag):
    """The eight learned-map transports at the comparison suite's shapes."""
    t26 = time.perf_counter()
    Xc, dXc, Sc, S1c = comparison_inputs()
    scale26 = float(np.abs(Xc).max())
    no_kernels = {name: 0 for name in counted()}
    for name in LEARNED:
        t_card = time.perf_counter()
        card64 = apply_learned(fit_learned(name, device, torch.float64, Sc, S1c), Xc, dXc)
        t_cpu = time.perf_counter()
        t_card = t_cpu - t_card
        bounds, note = {}, ""
        if name == "RandomForestTransport":
            # the forest's CART fit on the host is a discontinuous function of
            # its inputs, and the aligned source points lie on a line, so the
            # last bits in which the card's affine map differs from the CPU's
            # flip near-tied splits: the card's fitted map is held against the
            # same map applied on the CPU, and its residual targets against
            # the CPU fit's, while the two fits end to end are printed
            own = apply_learned(fit_learned(name, "cpu", torch.float64, Sc, S1c), Xc, dXc)
            cpu64 = apply_learned(forest_on_cpu(card64), Xc, dXc)
            err64 = field_errors(card64, cpu64, scale26)
            err64["delta_distribution"] = ((card64.delta_distribution.cpu() - own.delta_distribution)
                                           .abs().max().item()
                                           / own.delta_distribution.abs().max().item())
            note = (f", the card's fit against the CPU's own end to end "
                    f"{max(field_errors(card64, own, scale26).values()):.3g} (not held: "
                    "near-tied splits)")
        else:
            cpu64 = apply_learned(fit_learned(name, "cpu", torch.float64, Sc, S1c), Xc, dXc)
            err64 = field_errors(card64, cpu64, scale26)
        if name == "GMRTransport":
            # the aligned source points lie on a line, so every component's
            # Σ_xx has one eigenvalue at the regulariser's floor (κ ~ 1e5
            # here), and the GMR Jacobian and std move by ~1e-3 of themselves
            # for last-bit changes of the inputs: each field is held to 10x
            # the spread that ε64 perturbations of S1 and X cause on the CPU
            spread = perturbation_spread(name, Sc, S1c, Xc, dXc, cpu64)
            bounds = {f: 10 * v for f, v in spread.items()}
            lam = torch.linalg.eigvalsh(card64.gmr.params.covs[:, :2, :2].cpu())
            note = (f", its bounds 10x the CPU's spread under ε64 input perturbations "
                    + ", ".join(f"{f} {v:.3g}" for f, v in spread.items())
                    + f" (Σ_xx condition {(lam[:, -1] / lam[:, 0]).max().item():.3g})")
        t_cpu = time.perf_counter() - t_cpu
        bounds = {f: max(LEARNED_TOL, bounds.get(f, 0.0)) for f in err64}
        ratio = {f: e / bounds[f] for f, e in err64.items()}
        draws = card64.sample_transportation()
        if not (max(ratio.values()) < 1 and draws.dim() == 3 and draws.shape[1:] == (N_CMP, 2)
                and torch.isfinite(draws).all()):
            raise AssertionError(f"{name}: float64 on the card vs the CPU error/bound {ratio}, "
                                 f"or its samples {tuple(draws.shape)} not finite")
        tr32, counts26 = drive(lambda: apply_learned(
            fit_learned(name, device, torch.float32, Sc, S1c), Xc, dXc))
        expect_launches(name, counts26, no_kernels)
        if not all(torch.isfinite(v).all() for v in learned_fields(tr32).values()):
            raise AssertionError(f"{name}: the float32 run is not finite")
        err32 = field_errors(tr32, card64, scale26)
        fit_s, tr32 = wall_s(lambda: fit_learned(name, device, torch.float32, Sc, S1c))
        apply_ms, _ = cuda_ms(lambda: apply_learned(tr32, Xc, dXc))
        traced = ""
        if name in TRACED_FITS:
            traced = "; " + fmt_traced(lambda: fit_learned(name, device, torch.float32, Sc, S1c))
        print(f"learned-map transport {name} at its defaults (Q=n={N_CMP}: phase 4's demo, "
              f"source and first target resampled), no hand-kernel launch: fit {fit_s:.3f} s, "
              f"apply {apply_ms:.3f} ms (f32; the apply a median of {REPS}, CUDA events)"
              + traced + "; float64 card vs CPU error/bound "
              + ", ".join(f"{f} {r:.3g}" for f, r in ratio.items()) + note
              + "; float32 vs the float64 card run "
              + ", ".join(f"{f} {e:.3g}" for f, e in err32.items())
              + f"; samples {tuple(draws.shape)} finite; the f64 card run {t_card:.2f} s, the "
              f"f64 CPU reference {t_cpu:.2f} s {tag}", flush=True)
    print(f"phase 26: {time.perf_counter() - t26:.1f} s {tag}", flush=True)


def phase27(device, tag):
    """SVGPTransport at the 3-D surface scale, and the multi-frame baselines."""
    t27 = time.perf_counter()
    S3, T3, X3, dX3 = ensemble_3d_inputs()
    q3 = np.random.default_rng(3).standard_normal((Q_3D, 4))
    q3 /= np.linalg.norm(q3, axis=1, keepdims=True)
    svgp_kw = dict(num_epochs=SVGP3_EPOCHS, num_inducing=SVGP3_INDUCING, batch_size=SVGP3_BATCH)
    runs27 = {}
    for dev, dtype in ((device, torch.float64), ("cpu", torch.float64), (device, torch.float32)):
        tr = fit_learned("SVGPTransport", dev, dtype, S3, T3[0], **svgp_kw)
        runs27[(str(dev), dtype)] = apply_learned(tr, X3, dX3, ori=q3)
    card64 = runs27[(str(device), torch.float64)]
    tr32 = runs27[(str(device), torch.float32)]
    err27 = field_errors(card64, runs27[("cpu", torch.float64)], float(np.abs(X3).max()))
    norm_err = max((torch.linalg.norm(t.training_ori.double(), dim=1) - 1).abs().max().item()
                   for t in (card64, tr32))
    if not (max(err27.values()) < LEARNED_TOL and norm_err < 1e-6
            and all(torch.isfinite(v).all() for v in learned_fields(tr32).values())):
        raise AssertionError(f"3-D SVGPTransport: float64 card vs CPU {err27}, quaternion norms "
                             f"off by {norm_err:.3g}, or the float32 run not finite")
    nat = {dev: natgrad_posterior(dev, S3, T3[0], X3) for dev in (device, "cpu")}
    nat_err = max((a.cpu() - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(nat[device][1:], nat["cpu"][1:]))
    if not nat_err < LEARNED_TOL:
        raise AssertionError(f"fit_natgrad: float64 card vs CPU posterior {nat_err:.3g} of its "
                             f"max (bound {LEARNED_TOL})")
    fit27_s, tr32 = wall_s(lambda: fit_learned("SVGPTransport", device, torch.float32, S3, T3[0],
                                               **svgp_kw))
    apply27_ms, _ = cuda_ms(lambda: apply_learned(tr32, X3, dX3, ori=q3))
    traced27 = fmt_traced(lambda: fit_learned("SVGPTransport", device, torch.float32, S3, T3[0],
                                              **svgp_kw))
    (tp64, cov64, hmm64, times64), (tpc, covc, hmmc, _), (tp32, cov32, hmm32, times32) = (
        run_baselines(device, torch.float64), run_baselines("cpu", torch.float64),
        run_baselines(device, torch.float32))
    err_tp = np.abs(tp64 - tpc).max() / np.abs(tpc).max()
    err_cov = np.abs(cov64 - covc).max() / np.abs(covc).max()
    err_hmm = np.abs(hmm64 - hmmc).max() / np.abs(hmmc).max()
    if not (max(err_tp, err_cov, err_hmm) < BASELINE_TOL
            and all(np.isfinite(a).all() for a in (tp32, cov32, hmm32))):
        raise AssertionError(f"baselines: float64 card vs CPU TP-GMM {err_tp:.3g}, covariances "
                             f"{err_cov:.3g}, HMM-LQR {err_hmm:.3g} (bound {BASELINE_TOL}), or "
                             "a float32 run not finite")
    print(f"3-D SVGPTransport (n={N_3D}, D=3, Q={Q_3D}, member 0 of phase 9, M={SVGP3_INDUCING}, "
          f"{SVGP3_EPOCHS} epochs, batch {SVGP3_BATCH}, unit quaternions): float64 card vs CPU "
          "error/bound " + ", ".join(f"{f} {e / LEARNED_TOL:.3g}" for f, e in err27.items())
          + f", quaternion norms within {norm_err:.3g} of 1; fit {fit27_s:.3f} s, apply "
          f"{apply27_ms:.3f} ms (f32), {traced27}; fit_natgrad on the same data "
          f"(f64, {nat[device][0]:.3f} s on the card): posterior mean and std card vs CPU "
          f"{nat_err / LEARNED_TOL:.3g} of the bound; TPGMM() and HMMLQR() on six "
          "synthetic demonstrations reproduced at the seventh's frames: float64 card vs CPU "
          f"error/max|traj| TP-GMM {err_tp:.3g}, its covariances {err_cov:.3g}, HMM-LQR "
          f"{err_hmm:.3g} (< {BASELINE_TOL}), float32 finite; fits on the card (f64, f32) TP-GMM "
          f"{times64[0]:.3f} s, {times32[0]:.3f} s, HMM-LQR {times64[1]:.3f} s, {times32[1]:.3f} s; "
          f"phase 27 {time.perf_counter() - t27:.1f} s {tag}", flush=True)


# ---- phases 28-31: obstacle avoidance, the flow field, the GP dynamical
# system, the metrics and the comparison suites ------------------------------

# float64 on the card against float64 on the CPU: one avoid() call to
# AVOID_TOL of its largest speed, a rollout to ROLLOUT_TOL of max|x| (the
# libm functions of the two sides may differ in the last bit, and Euler
# steps carry that along)
AVOID_TOL, ROLLOUT_TOL, FLOW_TOL = 1e-10, 1e-8, 1e-8
ROAM_GRIDS = (20, 100)  # the example's grid, and viz.py's 100x100 grid
WAVY_STEPS, WAVY_DT, LINEAR_STEPS, LINEAR_DT = 600, 0.03, 800, 0.25
# a moving obstacle's velocities: the ellipse drifts (−2, 1) and turns 4 rad
# over the 200 time units of the rollout
MOVING_LINEAR, MOVING_ANGULAR = (-0.01, 0.005), 0.02
# examples/lasa_ds.py on a synthetic LASA file: 7 demos of 1,000 points,
# the example's fit on every tenth point of the first three, velocities
# scaled by 0.01
LASA_DEMOS, LASA_T, LASA_STEPS, GPDS_STEPS = 7, 1000, 600, 1000
# phase 30(b)'s training sizes, tried from the largest until the float32
# factor is finite (evenly spaced points of all seven demos)
GPDS_SIZES = (7000, 6500, 6000, 5500, 5000, 4500, 4000, 3500, 3000, 2000)
VF_GRID, VF_N = 100, 2048  # phase 30(c): the dense grid over 2,048 points
SPIRAL_STEPS = 1000  # rollout_stable_gp_ds's default
# The stabilized rollout is chaotic near the demonstration (the unit
# variance gradient turns where it vanishes): a CPU probe grew a 1e-15
# relative change of its starts to 6e-12 of max|x| by step 200 and 2e-6 by
# step 1,000, so float64 on the card is held to the CPU over its first
# SPIRAL_HELD steps.  The variance-descent field goes through K⁻¹: held to
# 10·κ(K)·ε64.
SPIRAL_HELD = 200
DP_T = 1000  # phase 31: DTW and Frechet at T = 1,000
# the float32 GP-DS rollouts' states against float64 ones at the same
# kernel, of max|x| (a CPU rehearsal read 6.8e-4 for (a) and 2.6e-4 for
# (b): the fitted noise sits at its bound 1e-5, κ ~ 9e6)
GPDS_F32_TOL = 5e-3
REACH_DEMOS, REACH_T = 9, 200  # data/datasets.py:36-43's layout


def example_obstacles(moving=False, **device):
    """examples/obstacle_avoidance_ds.py:40-57: an ellipse and a cuboid;
    with ``moving`` the ellipse has linear and angular velocity."""
    from gaussian_process_transportation_tpu_torch.avoidance import Obstacles

    ellipse = dict(shape="ellipse", center=[4.0, 1.5], axis_length=[2.5, 1.5], orientation=30,
                   margin=0.1)
    if moving:
        ellipse.update(linear_velocity=MOVING_LINEAR, angular_velocity=MOVING_ANGULAR)
    cuboid = dict(shape="cuboid", center=[7.0, -1.5], axis_length=[2.0, 1.5], orientation=-15,
                  margin=0.1)
    return Obstacles.from_dicts([ellipse, cuboid], **device)


def roam_obstacles(**device):
    """examples/obstacle_avoidance_ds.py:101-113: three turned ellipses with
    off-center reference points."""
    from gaussian_process_transportation_tpu_torch.avoidance import Obstacles

    return Obstacles.from_dicts([
        dict(shape="ellipse", center=[c0, c1], reference_point=[0.0, 0.3], axis_length=[0.3, 0.7],
             orientation=ori)
        for (c0, c1), ori in (((0.20, -3.1), 0), ((0.45, -2.65), 120), ((-0.05, -2.65), 240))],
        **device)


def wavy(x, attractor):
    """The rotation-by-distance DS toward ``attractor`` (the example's)."""
    diff = attractor[None, :] - x
    dist = torch.linalg.vector_norm(diff, dim=1)
    c, s = torch.cos(torch.sin(dist)), torch.sin(torch.sin(dist))
    R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], 1)
    return (R @ diff[:, :, None])[:, :, 0]


def moved(obs, t):
    """The obstacles after t time units at their velocities."""
    import dataclasses

    return dataclasses.replace(obs, center=obs.center + t * obs.linear_velocity,
                               orientation=obs.orientation
                               + t * obs.angular_velocity * (180.0 / math.pi))


def avoid_rollout(obs, x0, n_steps, dt, field, moving=False):
    """Euler steps x ← x + dt·avoid(obs(t), x, field(x)) into (n_steps, N, 2),
    obs(t) the obstacles moved by their velocities where ``moving``; and the
    least Γ of every state against the obstacles where they then are (a
    device scalar, no host read in the loop)."""
    from gaussian_process_transportation_tpu_torch.avoidance import avoid, gamma

    traj = x0.new_empty((n_steps,) + tuple(x0.shape))
    x, g_min = x0, None
    for i in range(n_steps):
        at = moved(obs, i * dt) if moving else obs
        x = x + dt * avoid(at, x, field(x))
        traj[i] = x
        g = gamma(moved(obs, (i + 1) * dt) if moving else obs, x).min()
        g_min = g if g_min is None else torch.minimum(g_min, g)
    return traj, g_min


def avoidance_scenes(device, dtype):
    """Phase 28's three rollouts in ``dtype`` on ``device``, each a function
    of the number of steps returning (trajectory, least Γ): the wavy DS
    through avoid() (9 agents), the modulated linear DS (50 agents) and the
    linear DS through avoid() past the moving ellipse (50 agents); and each
    one's steps and dt."""
    from gaussian_process_transportation_tpu_torch.avoidance import (
        gamma, modulate_multiple, rollout)

    put = dict(dtype=dtype, device=device)
    att = torch.tensor([10.0, 0.0], **put)
    obs, obs_mv = example_obstacles(**put), example_obstacles(moving=True, **put)
    x9 = torch.as_tensor(np.stack([np.zeros(9), np.linspace(-3, 3, 9)], 1), **put)
    x50 = torch.as_tensor(np.stack([np.full(50, -2.0), np.linspace(-4, 4, 50)], 1), **put)
    linear = lambda x: 0.2 * (att[None] - x)

    def modulated(n):
        traj = rollout(linear, lambda x: modulate_multiple(obs, x), x50, n, LINEAR_DT)
        return traj, gamma(obs, traj.reshape(-1, 2)).min()

    return {
        "wavy DS, avoid()": (lambda n: avoid_rollout(obs, x9, n, WAVY_DT, lambda x: wavy(x, att)),
                             WAVY_STEPS),
        "linear DS, modulate_multiple": (modulated, LINEAR_STEPS),
        "linear DS, avoid() past the moving ellipse": (
            lambda n: avoid_rollout(obs_mv, x50, n, LINEAR_DT, linear, moving=True), LINEAR_STEPS),
    }


def roam_field(device, dtype, n):
    """The ROAM scene's avoid() field on an n×n grid over [−5, 1]²: (the
    field, the grid points outside every obstacle)."""
    from gaussian_process_transportation_tpu_torch.avoidance import avoid, gamma

    put = dict(dtype=dtype, device=device)
    obs = roam_obstacles(**put)
    att = torch.tensor([-1.0, -1.0], **put)
    g = torch.linspace(-5, 1, n, **put)
    gx, gy = torch.meshgrid(g, g, indexing="xy")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1)
    return avoid(obs, grid, wavy(grid, att)), gamma(obs, grid).min(0).values > 1.0, (obs, grid, att)


def flow_field_scene():
    """examples/obstacle_flow_field_2d.py:36-55: a 60-vertex boundary, 200
    interior samples, a 150-point trajectory crossing it and its
    velocities (numpy, float64)."""
    from gaussian_process_transportation_tpu_torch.avoidance.flow_field import sample_in_polygon

    th = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    boundary = np.stack([5.0 + 2.0 * np.cos(th), 1.2 * np.sin(th) + 0.3 * np.sin(2 * th)], 1)
    inside = sample_in_polygon(boundary, 200, rng=np.random.RandomState(0))
    t = np.linspace(0, 1, 150)
    traj = np.stack([10 * t, 0.2 * np.ones_like(t)], 1)
    return boundary, inside, traj, np.gradient(traj, axis=0)


def write_lasa_file(root, name="Synthetic", n_demos=LASA_DEMOS, T=LASA_T):
    """A .mat file in the LASA layout (a 1 x n cell of structs with pos, t,
    vel and acc, (2, T) each): n_demos quadratic Bezier curves of T points
    from starts on a 40 mm ring in the left half plane to the origin, over
    4 s, velocities and accelerations their derivatives."""
    import scipy.io

    demos = np.empty((1, n_demos), dtype=object)
    t = np.linspace(0.0, 4.0, T)
    s = t / 4.0
    for i in range(n_demos):
        th = np.pi / 2 + np.pi * (i + 0.5) / n_demos
        start = 40.0 * np.array([np.cos(th), np.sin(th)])
        ctrl = 0.6 * np.array([[np.cos(1.0), -np.sin(1.0)], [np.sin(1.0), np.cos(1.0)]]) @ start
        pos = np.outer(start, (1 - s) ** 2) + np.outer(ctrl, 2 * s * (1 - s))
        vel = (np.outer(start, -2 * (1 - s)) + np.outer(ctrl, 2 - 4 * s)) / 4.0
        acc = np.outer(2 * start - 4 * ctrl, np.ones_like(s)) / 16.0
        demos[0, i] = {"pos": pos, "t": t[None], "vel": vel, "acc": acc}
    scipy.io.savemat(os.path.join(root, f"{name}.mat"), {"demos": demos})


def lasa_demos():
    """The synthetic LASA demos as the port's ``load_lasa`` reads them, from
    a file written to a temporary directory."""
    import tempfile

    from gaussian_process_transportation_tpu_torch.data.datasets import load_lasa

    with tempfile.TemporaryDirectory() as root:
        write_lasa_file(root)
        return load_lasa("Synthetic", root=root)


def lasa_kernel(dtype, device):
    """examples/lasa_ds.py:41: C(1)·Matern 5/2(5)+White(0.01)."""
    from gaussian_process_transportation_tpu_torch import kernels as K

    return (K.Constant(1.0) * K.Matern(5.0 * torch.ones(2, dtype=dtype, device=device), nu=2.5)
            + K.White(0.01))


def at_theta(kernel, dtype, device):
    """``kernel`` with its hyperparameters put in ``dtype`` on ``device``."""
    return kernel.with_theta(kernel.theta.detach().to(dtype=dtype, device=device))


def condition_largest(kernel, X, Y, sizes=GPDS_SIZES):
    """The GP on the first of ``sizes`` evenly spaced points of X whose
    float32 factor and α are finite: (GP, the points' indices, the sizes
    that failed)."""
    from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core

    failed = []
    for n in sizes:
        idx = torch.as_tensor(np.linspace(0, X.shape[0] - 1, n).round().astype(np.int64),
                              device=X.device)
        try:
            gp = gp_core.condition(kernel, X[idx], Y[idx])
            if bool(torch.isfinite(gp.alpha).all()):
                return gp, idx, failed
        except torch.linalg.LinAlgError:
            pass
        failed.append(n)
    raise AssertionError(f"no float32 factor finite at the sizes {sizes}")


def write_reach_file(path, n_demos=REACH_DEMOS, T=REACH_T, seed=0):
    """A file in reach_target.npy's layout (data/datasets.py:36-43):
    ``synthetic_frames``' demonstrations with two frames each."""
    demos_x, A, b = synthetic_frames(n_demos=n_demos, T=T, seed=seed)
    np.save(path, {"x": demos_x, "A": A, "b": b}, allow_pickle=True)
    return path


def row_sweep(D, combine):
    """DTW (combine = np.add) or Frechet (np.maximum) of the distances D by
    the JAX package's schedule, cell by cell in float64 on the host."""
    n, m = D.shape
    acc = np.cumsum(D[0]) if combine is np.add else np.maximum.accumulate(D[0])
    for i in range(1, n):
        row, left = np.empty(m), np.inf
        for j in range(m):
            left = combine(D[i, j], min(left, acc[j], acc[j - 1] if j else np.inf))
            row[j] = left
        acc = row
    return float(acc[-1])


def phase28(device, tag):
    """Obstacle avoidance at the example's scenes and sizes."""
    from gaussian_process_transportation_tpu_torch.avoidance import avoid

    t28 = time.perf_counter()
    f64, f32 = torch.float64, torch.float32
    cpu64 = {name: run(n) for name, (run, n) in avoidance_scenes("cpu", f64).items()}
    card64 = {name: run(n) for name, (run, n) in avoidance_scenes(device, f64).items()}
    lines = []
    for name, (run, n) in avoidance_scenes(device, f32).items():
        (run_s, (traj32, g32)), counts28 = drive(lambda: wall_s(lambda: run(n)))
        expect_launches(name, counts28, {k: 0 for k in counts28})
        ref, g64 = cpu64[name]
        scale = ref.abs().max().item()
        err64 = (card64[name][0].cpu() - ref).abs().max().item() / scale
        err32 = (traj32.double().cpu() - ref).abs().max().item() / scale
        if not (err64 < ROLLOUT_TOL and g32.item() >= 1.0 and torch.isfinite(traj32).all()):
            raise AssertionError(f"{name}: float64 card vs CPU {err64:.3g} of max|x| (bound "
                                 f"{ROLLOUT_TOL}), or the float32 run's least Gamma "
                                 f"{g32.item():.4f} < 1, or not finite")
        step = path_breakdown(lambda: run(1), "")
        lines.append(f"{name} {tuple(traj32.shape)}: least Gamma {g32.item():.4f} (f32), "
                     f"{g64.item():.4f} (f64); f64 card vs CPU {err64:.3g} of max|x| (< "
                     f"{ROLLOUT_TOL}), f32 vs f64 {err32:.3g}; {run_s:.3f} s (f32, wall, the "
                     f"counted run: no hand-kernel launch), one traced step "
                     f"{step['wall_ms']:.3f} ms wall, {step['device_ms']:.3f} ms device in "
                     f"{step['all_launches']} launches")
        if name.startswith("wavy"):
            end = traj32[-1].double().cpu()
            near = int((torch.linalg.vector_norm(end - torch.tensor([10.0, 0.0], dtype=f64), dim=1)
                        < 1.0).sum())
            if near != 9:
                raise AssertionError(f"wavy DS: {near}/9 agents within 1.0 of the attractor")
            lines[-1] += f"; {near}/9 agents within 1.0 of the attractor"
    # the ROAM field: the example's 20x20 grid and the dense 100x100 grid
    for n in ROAM_GRIDS:
        v64, out64, _ = roam_field(device, f64, n)
        vc, outc, _ = roam_field("cpu", f64, n)
        (v32, out32, (obs_r, grid_r, att_r)), counts_r = drive(lambda: roam_field(device, f32, n))
        expect_launches("ROAM field", counts_r, {k: 0 for k in counts_r})
        err = ((v64.cpu() - vc)[outc].abs().max() / vc[outc].abs().max()).item()
        if not (torch.equal(out64.cpu(), outc) and torch.equal(out32.cpu(), outc)
                and err < AVOID_TOL and torch.isfinite(v32[out32]).all()):
            raise AssertionError(f"ROAM field {n}x{n}: f64 card vs CPU {err:.3g} (bound "
                                 f"{AVOID_TOL}), the points outside differ, or the f32 field is "
                                 "not finite outside the obstacles")
        if n == 20 and int(outc.sum()) != 395:
            raise AssertionError(f"ROAM field: {int(outc.sum())}/400 grid points outside, the "
                                 "example has 395")
        ms, _ = cuda_ms(lambda: avoid(obs_r, grid_r, wavy(grid_r, att_r)))
        lines.append(f"ROAM field {n}x{n}: {int(outc.sum())}/{n * n} points outside, finite "
                     f"there; f64 card vs CPU {err:.3g} of max|v| (< {AVOID_TOL}); one avoid() "
                     f"call {ms:.4f} ms (f32, median of {REPS}, CUDA events)")
    print("obstacle avoidance (examples/obstacle_avoidance_ds.py's scenes): " + "; ".join(lines)
          + f"; phase 28 {time.perf_counter() - t28:.1f} s {tag}", flush=True)


def flow_field_run(device, dtype, boundary, inside, traj, vel, kernel=None):
    """ObstacleFlowField on the scene in ``dtype`` on ``device``: fitted
    (the default kernel, 2 restarts) or, with ``kernel``, conditioned at it;
    then the warp of the trajectory and of its velocities.  Returns (field,
    fit seconds, (warped, uncertainty, velocities))."""
    from gaussian_process_transportation_tpu_torch.avoidance.flow_field import ObstacleFlowField
    from gaussian_process_transportation_tpu_torch.models.gp_regressor import GaussianProcess

    field = ObstacleFlowField(torch.as_tensor(boundary, dtype=dtype, device=device))
    if kernel is not None:
        field.gp = GaussianProcess(kernel=kernel, alpha=field.gp.alpha, optimizer=None)
    sync = torch.cuda.synchronize if field.device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    field.learn_flow_field(inside)
    sync()
    fit_s = time.perf_counter() - t0
    warped, unc = field.transform_space(traj)
    return field, fit_s, (warped, unc, field.transform_velocity(traj, vel))


def phase29(device, tag):
    """The obstacle flow field of examples/obstacle_flow_field_2d.py."""
    from gaussian_process_transportation_tpu_torch.avoidance.flow_field import signed_distance

    t29 = time.perf_counter()
    f64, f32 = torch.float64, torch.float32
    boundary, inside, traj, vel = flow_field_scene()
    card, fit64_s, out64 = flow_field_run(device, f64, boundary, inside, traj, vel)
    fitted = at_theta(card.gp.kernel_, f64, "cpu")
    cpu, _, outc = flow_field_run("cpu", f64, boundary, inside, traj, vel, kernel=fitted)
    errs = [((a.cpu() - b).abs().max() / b.abs().max()).item() for a, b in zip(out64, outc)]
    proj64 = card.project_using_sdf(inside)
    projc = cpu.project_using_sdf(inside)
    # the projection stops where every |d| is below its tolerance (1e-6),
    # which the last bits can decide a step earlier on one side: held there
    err_p = (proj64.cpu() - projc).abs().max().item()
    if not (max(errs) < FLOW_TOL and err_p <= 1e-6):
        raise AssertionError(f"flow field: float64 card vs CPU at the card's kernel: warp, "
                             f"uncertainty, velocities {errs} (bound {FLOW_TOL}), projection "
                             f"{err_p:.3g} (bound 1e-6, its tolerance), iterations "
                             f"{card.project_iterations} and {cpu.project_iterations}")
    (field32, fit32_s, (warped, unc, new_vel)), counts29 = drive(
        lambda: flow_field_run(device, f32, boundary, inside, traj, vel))
    bd, tj = torch.as_tensor(boundary), torch.as_tensor(traj)
    d_before = signed_distance(bd, tj)
    d_after = signed_distance(bd, warped.double().cpu())
    was_inside = d_before < 0
    depth_before = (-d_before[was_inside]).mean().item()
    depth_after = torch.clamp(-d_after[was_inside], min=0.0).mean().item()
    if not (depth_after < 0.25 * depth_before and torch.isfinite(new_vel).all()
            and torch.isfinite(unc).all()):
        raise AssertionError(f"flow field f32: mean depth {depth_before:.3f} -> "
                             f"{depth_after:.3f}, not below a quarter, or a non-finite warp")
    warp_ms, _ = cuda_ms(lambda: (field32.transform_space(traj),
                                  field32.transform_velocity(traj, vel)))
    proj_s, _ = wall_s(lambda: field32.project_using_sdf(inside))
    iters32 = field32.project_iterations
    print(f"obstacle flow field (60-vertex boundary, 200 interior samples, 150-point "
          f"trajectory): float64 on the card vs the CPU at the kernel the card fitted: warp, "
          f"uncertainty, velocities {', '.join(f'{e:.3g}' for e in errs)} of their max, the SDF "
          f"projection {err_p:.3g} (<= 1e-6) in {card.project_iterations} and "
          f"{cpu.project_iterations} iterations; "
          f"f32: {int(was_inside.sum())} trajectory points inside, mean depth "
          f"{depth_before:.3f} -> {depth_after:.3f} after the warp (< 0.25x), hand-kernel "
          f"launches {dict((k, v) for k, v in counts29.items() if v)}; the fit {fit32_s:.3f} s "
          f"(f32, 2 restarts; f64 {fit64_s:.3f} s), the warp {warp_ms:.3f} ms (positions and "
          f"velocities, median of {REPS}), the projection of the 200 samples {proj_s:.3f} s in "
          f"{iters32} iterations (f32; f64 {card.project_iterations}); phase 29 "
          f"{time.perf_counter() - t29:.1f} s {tag}", flush=True)


def gp_ds_inputs(demos, dtype, device):
    """examples/lasa_ds.py:36-37: every tenth point of the first three demos
    and their velocities times 0.01; and all points of every demo."""
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    X = np.concatenate([d["pos"][::10] for d in demos[:3]])
    dX = np.concatenate([d["vel"][::10] for d in demos[:3]]) * 0.01
    X7 = np.concatenate([d["pos"] for d in demos])
    dX7 = np.concatenate([d["vel"] for d in demos]) * 0.01
    return put(X), put(dX), put(X7), put(dX7)


def spiral_gp(device, dtype):
    """The GP dynamical system of ``spiral_demo``'s 3-D demonstration (its
    standard normals from a seeded CPU generator): C(1)·RBF(0.5)+White(1e-4)
    on each point's step to the next; and four starts off the demo."""
    from gaussian_process_transportation_tpu_torch import kernels as K
    from gaussian_process_transportation_tpu_torch.data.datasets import spiral_demo
    from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core
    from gaussian_process_transportation_tpu_torch.models._training import cpu_generator

    demo, _, new_surface = spiral_demo(cpu_generator(0), device=device)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    ls = 0.5 * torch.ones(3, dtype=dtype, device=device)
    kernel = K.Constant(1.0) * K.RBF(ls) + K.White(1e-4)
    gp = gp_core.condition(kernel, put(demo[:-1]), put(np.diff(demo, axis=0)))
    x0 = put(demo[[0, 120, 240, 400]] + np.array([0.3, -0.2, 0.25]))
    return gp, x0, put(new_surface.reshape(-1, 3))


def phase30(device, tag):
    """The GP dynamical system: the LASA example's fit and rollout, the
    rollout over all 7,000 points (kernel #5 a step), the dense vector field
    (kernel #6) and the stabilized 3-D rollout."""
    from gaussian_process_transportation_tpu_torch import viz
    from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core
    from gaussian_process_transportation_tpu_torch.models._training import cpu_generator

    t30 = time.perf_counter()
    f64, f32 = torch.float64, torch.float32
    demos = lasa_demos()
    X, dX, X7, dX7 = gp_ds_inputs(demos, f32, device)
    # (a) the example's fit and its 600-step rollout
    fit_s, gp_a = wall_s(lambda: gp_core.fit(lasa_kernel(f32, device), X, dX, n_restarts=2,
                                             generator=cpu_generator(0)))
    start = demos[0]["pos"][:1]
    traj_a = viz.rollout_gp_ds(gp_a, torch.as_tensor(start, dtype=f32, device=device), LASA_STEPS)
    ends = {}
    for dev in (device, "cpu"):
        Xd, dXd = (a.to(dtype=f64, device=dev) for a in (X, dX))
        gp64 = gp_core.condition(at_theta(gp_a.kernel, f64, dev), Xd, dXd, gp_a.jitter)
        ends[str(dev)] = viz.rollout_gp_ds(gp64, torch.as_tensor(start, dtype=f64, device=dev),
                                           LASA_STEPS).cpu()
    ref_a = ends["cpu"]
    scale = ref_a.abs().max().item()
    err_a64 = (ends[str(device)] - ref_a).abs().max().item() / scale
    err_a32 = (traj_a.double().cpu() - ref_a).abs().max().item() / scale
    goal_a = np.linalg.norm(traj_a[-1, 0].double().cpu().numpy() - demos[0]["pos"][-1])
    if not (err_a64 < ROLLOUT_TOL and err_a32 < GPDS_F32_TOL):
        raise AssertionError(f"LASA rollout: f64 card vs CPU {err_a64:.3g} of max|x| (bound "
                             f"{ROLLOUT_TOL}), f32 vs f64 {err_a32:.3g} (bound {GPDS_F32_TOL})")
    _, amp, ls = gp_core.stationary_family_params(gp_a.kernel)
    noise = float(gp_core.white_noise_level(gp_a.kernel))
    lines = [f"(a) the example's fit on {X.shape[0]} points (C(1)*Matern52(5)+White(0.01), 2 "
             f"restarts, f32) {fit_s:.3f} s, amplitude {float(amp):.4g}, lengthscale "
             f"{[round(v, 4) for v in ls.tolist()]}, noise {noise:.3g}; its "
             f"{LASA_STEPS}-step rollout ends {goal_a:.3f} from the demo's goal; f64 card vs CPU "
             f"{err_a64:.3g} of max|x| (< {ROLLOUT_TOL}), f32 vs f64 {err_a32:.3g} (< "
             f"{GPDS_F32_TOL})"]

    # (b) all 7,000 points at (a)'s kernel, 1,000 steps from the 7 starts
    kernel32 = at_theta(gp_a.kernel, f32, device)
    gp_b, idx_b, failed = condition_largest(kernel32, X7, dX7)
    x0 = torch.as_tensor(np.stack([d["pos"][0] for d in demos]), dtype=f32, device=device)
    traj_b, counts_b = drive(lambda: viz.rollout_gp_ds(gp_b, x0, GPDS_STEPS))
    expect_launches("GP-DS rollout", counts_b, {
        **{k: 0 for k in counts_b}, "fused_gp_predict_mean": GPDS_STEPS})
    states = [x0, traj_b[GPDS_STEPS // 2 - 1], traj_b[-2]]
    fam, amp_b, ls_b = gp_core.stationary_family_params(gp_b.kernel)
    ex_b = max(mean_excess(gp_core.predict(gp_b, s), s, gp_b.X, gp_b.alpha, ls_b, amp_b, fam)
               for s in states)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        viz.rollout_gp_ds(gp_b, x0, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    gp_b64 = gp_core.condition(at_theta(gp_a.kernel, f64, device), X7[idx_b].double(),
                               dX7[idx_b].double())
    traj_b64 = viz.rollout_gp_ds(gp_b64, x0.double(), GPDS_STEPS)
    scale_b = traj_b64.abs().max().item()
    err_b = (traj_b[-1].double() - traj_b64[-1]).abs().max().item() / scale_b
    if not (ex_b < 1 and err_b < GPDS_F32_TOL and torch.isfinite(traj_b).all()):
        raise AssertionError(f"GP-DS rollout over N={gp_b.X.shape[0]}: kernel #5 vs the f64 "
                             f"formula error/bound {ex_b:.3g}, f32 endpoints vs f64 {err_b:.3g} "
                             f"of max|x| (bound {GPDS_F32_TOL}), or not finite")
    roll_ms, _ = cuda_ms(lambda: viz.rollout_gp_ds(gp_b, x0, GPDS_STEPS), reps=3)
    # ten steps traced: a one-step session held no record of the mean
    # kernel in four tries late in a run (CUPTI)
    step = {k: v / 10 for k, v in path_breakdown(lambda: viz.rollout_gp_ds(gp_b, x0, 10),
                                                 "mean_chunk").items()}
    lines.append(
        f"(b) all {X7.shape[0]} points at (a)'s kernel: the f32 factor "
        + (f"not finite at N={failed} (torch.linalg.cholesky), finite at the largest N tried "
           f"after, {gp_b.X.shape[0]} evenly spaced points" if failed
           else f"finite at N={gp_b.X.shape[0]}")
        + f"; rollout_gp_ds from the {LASA_DEMOS} starts, {GPDS_STEPS} steps: "
        f"fused_gp_predict_mean {counts_b['fused_gp_predict_mean']} calls (one a step), its "
        f"means at three states vs the f64 formula error/bound {ex_b:.3g}; three steps under "
        f"set_sync_debug_mode('error') read nothing back; f32 endpoints vs f64 {err_b:.3g} of "
        f"max|x| (< {GPDS_F32_TOL}); the rollout {roll_ms:.2f} ms (median of 3, CUDA events), "
        f"{roll_ms / GPDS_STEPS:.4f} ms a step; ten steps traced, a step {step['wall_ms']:.3f} "
        f"ms wall, {step['device_ms']:.4f} ms device in {step['all_launches']:.1f} launches, the "
        f"mean kernel {step['kernel_ms']:.4f} ms in {step['kernel_launches']:.1f}")

    # (c) the vector field on a 100x100 grid over 2,048 of the points
    idx = np.linspace(0, X7.shape[0] - 1, VF_N).astype(int)
    gp_c = gp_core.condition(kernel32, X7[idx], dX7[idx], cache_k_inv=True)
    lo, hi = X7.min(0).values.tolist(), X7.max(0).values.tolist()
    xs, ys = (torch.linspace(a, b, VF_GRID, dtype=f32, device=device) for a, b in zip(lo, hi))
    (u, v, std), counts_c = drive(lambda: viz.vector_field(gp_c, xs, ys))
    expect_launches("vector field", counts_c, {**{k: 0 for k in counts_c},
                                               "fused_gp_predict_mean_var": 1})
    pos, _ = viz._grid_points(xs, ys, gp_c.X)
    prior = amp_b + gp_core.white_noise_level(gp_c.kernel)
    args_c = (pos, gp_c.X, gp_c.alpha, gp_c.K_inv, ls_b, amp_b, prior)
    ref_c = predict_f64(*args_c, fam)
    terms = cancelling_terms(pos, gp_c.X, gp_c.K_inv, ls_b, amp_b, fam)
    ex_cm = predict_excess(torch.stack([u.reshape(-1), v.reshape(-1)], 1), ref_c[1], ref_c)[0]
    ex_cv = cond_var_excess(std[..., 0].reshape(-1) ** 2, ref_c[1], terms)
    faults_c = var_faults(args_c, fam, ref_c[1], terms)
    if not (ex_cm < 1 and ex_cv < 1 and min(faults_c.values()) >= 1):
        raise AssertionError(f"vector field: kernel #6 vs the f64 formula error/bound mean "
                             f"{ex_cm:.3g}, variance {ex_cv:.3g}; planted faults {faults_c}")
    vf_ms, _ = cuda_ms(lambda: viz.vector_field(gp_c, xs, ys))
    lines.append(f"(c) vector_field on a {VF_GRID}x{VF_GRID} grid over {VF_N} points "
                 f"(cache_k_inv): fused_gp_predict_mean_var "
                 f"{counts_c['fused_gp_predict_mean_var']} call, vs the f64 formula error/bound "
                 f"mean {ex_cm:.3g}, variance {ex_cv:.3g} (the variance's bound with eps32 of "
                 f"its cancelling terms: their sum reaches {terms.max().item():.3g} against "
                 f"variances up to {ref_c[1].max().item():.3g}), planted faults rejected at "
                 + ", ".join(f"{k} {x:.3g}" for k, x in faults_c.items())
                 + f"; {vf_ms:.3f} ms (median of {REPS}, CUDA events)")

    # (d) the stabilized rollout and the variance-descent field in 3-D
    runs = []
    for dev, dtype in ((device, f64), ("cpu", f64), (device, f32)):
        gp_d, x0_d, queries = spiral_gp(dev, dtype)
        runs.append((viz.rollout_stable_gp_ds(gp_d, x0_d, SPIRAL_STEPS).cpu(),
                     viz.min_variance_attractor_field(gp_d, queries).cpu()))
    (tr64, f64_field), (trc, fc), (tr32, f32_field) = runs
    gp_cpu = spiral_gp("cpu", f64)[0]
    eig = torch.linalg.eigvalsh(gp_cpu.kernel(gp_cpu.X))
    field_tol = 10 * (eig[-1] / eig[0]).item() * np.finfo(np.float64).eps
    scale_d = trc.abs().max().item()
    err_d = (tr64 - trc)[:SPIRAL_HELD].abs().max().item() / scale_d
    err_d_all = (tr64 - trc).abs().max().item() / scale_d
    err_f = (f64_field - fc).abs().max().item()
    if not (err_d < ROLLOUT_TOL and err_f < field_tol and torch.isfinite(tr32).all()
            and torch.isfinite(f32_field).all()):
        raise AssertionError(f"stabilized 3-D rollout: f64 card vs CPU over {SPIRAL_HELD} steps "
                             f"{err_d:.3g} of max|x| (bound {ROLLOUT_TOL}), the variance-descent "
                             f"field {err_f:.3g} (bound {field_tol:.3g}), or f32 not finite")
    stable_s, _ = wall_s(lambda: viz.rollout_stable_gp_ds(*spiral_gp(device, f32)[:2],
                                                          SPIRAL_STEPS))
    lines.append(f"(d) rollout_stable_gp_ds on spiral_demo's 3-D demo ({SPIRAL_STEPS} steps, 4 "
                 f"starts): f64 card vs CPU {err_d:.3g} of max|x| over the first {SPIRAL_HELD} "
                 f"steps (< {ROLLOUT_TOL}), {err_d_all:.3g} over all (chaotic, not held); "
                 f"min_variance_attractor_field at the target surface's 400 points {err_f:.3g} "
                 f"(< 10 kappa eps64 = {field_tol:.3g}), f32 finite, {stable_s:.3f} s (f32, wall)")
    print("GP dynamical system on a synthetic LASA file (7 demos x 1000 points): "
          + "; ".join(lines) + f"; phase 30 {time.perf_counter() - t30:.1f} s {tag}", flush=True)
    return {"fused_gp_predict_mean": counts_b["fused_gp_predict_mean"],
            "fused_gp_predict_mean_var": counts_c["fused_gp_predict_mean_var"]}


def cancelling_terms(Xq, X, K_inv, ls, amp, family):
    """Σ_ij |k_i K⁻¹_ij k_j| per query in float64: the size of the terms that
    the variance prior − k K⁻¹ kᵀ cancels, which float32 sums round at
    about ε32 of."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    k = pg.stationary_gram_plain(Xq.double(), X.double(), ls.double(), amp, family).abs()
    return ((k @ K_inv.double().abs()) * k).sum(1)


def cond_var_excess(var, var64, terms):
    """The largest error over the bound of a variance against the f64
    formula: ``predict_excess``'s VAR_REL·var64 + VAR_FLOOR, plus ε32 of the
    cancelling terms (an ill-conditioned K⁻¹ makes them many times the
    variance; a CPU rehearsal of phase 30(c) read the f32 dense twin at
    0.077 of this bound and 11.3 of the plain one)."""
    bound = VAR_REL * var64 + VAR_FLOOR + F32_EPS * terms
    return ((var.double() - var64).abs() / bound).max().item()


def var_faults(args, family, var64, terms):
    """``cond_var_excess`` must reject a wrong kernel #6 at these inputs: the
    variance doubled, and K⁻¹ column tile 1 dropped (``planted_faults``'
    two faults).  Returns each fault's error/bound."""
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg

    Xq, X, alpha, K_inv, ls, amp, prior = args
    var = pg.fused_gp_predict_mean_var(Xq, X, alpha, K_inv, ls, amp, prior, family)[1]
    K_drop = K_inv.clone()
    K_drop[:, pg.MEAN_VAR_TILE_B:2 * pg.MEAN_VAR_TILE_B] = 0
    var_drop = pg.fused_gp_predict_mean_var(Xq, X, alpha, K_drop, ls, amp, prior, family)[1]
    return {"var x2": cond_var_excess(2 * var, var64, terms),
            "column tile 1 dropped": cond_var_excess(var_drop, var64, terms)}


def comparison_f64(out):
    """``run_comparison``'s three matrices by numpy float64 formulas on the
    trajectories and stds it returned."""
    names = out["names"]
    m = {k: np.asarray(out["trajectories"][k], np.float64) for k in names}
    s = {k: np.asarray(out["stds"][k], np.float64) for k in names}
    kl, wd, eu = (np.zeros((len(names), len(names))) for _ in range(3))
    for i, a in enumerate(names):
        for j, b in enumerate(names):
            vp, vq, d2 = s[a] ** 2 + 1e-12, s[b] ** 2 + 1e-12, (m[a] - m[b]) ** 2
            kl[i, j] = np.sum(0.5 * (np.log(vq / vp) + (vp + d2) / vq - 1.0))
            wd[i, j] = np.mean(np.sqrt(np.sum(d2 / s[a] ** 2 + d2 / s[b] ** 2, 1)))
            eu[i, j] = np.mean(np.sqrt(np.sum(2.0 * d2, 1)))
    return {"divergence": kl, "distribution_distance": wd, "euclidean_distance": eu}


def phase31(device, tag):
    """The metrics and the comparison suites at their defaults."""
    import tempfile

    from gaussian_process_transportation_tpu_torch import benchmarks
    from gaussian_process_transportation_tpu_torch.utils import metrics

    t31 = time.perf_counter()
    lines = []
    # the surfaces comparison at its defaults, f32 on the card, on phase 26's inputs
    Xc, _, Sc, S1c = comparison_inputs()
    cmp_s, out = wall_s(lambda: benchmarks.run_comparison(
        *(a.astype(np.float32) for a in (Xc, Sc, S1c)), device=device))
    want = comparison_f64(out)
    err_c = max(np.abs(out[k] - w).max() / max(np.abs(w).max(), 1e-300) for k, w in want.items())
    if not (err_c < 1e-5 and all(np.isfinite(out[k]).all() for k in want)):
        raise AssertionError(f"run_comparison: its matrices vs numpy f64 on its trajectories "
                             f"{err_c:.3g} of their max (bound 1e-5, float32 sums)")
    lines.append(f"run_comparison at its defaults ({len(out['names'])} methods, n_traj = n_dist "
                 f"= {N_CMP}, f32): {cmp_s:.2f} s, its three matrices vs numpy f64 formulas "
                 f"{err_c:.3g} of their max (< 1e-5)")
    # the multi-frame suites on a synthetic file in reach_target.npy's layout
    with tempfile.TemporaryDirectory() as root:
        path = write_reach_file(os.path.join(root, "reach_target.npy"))
        first = {dev: (benchmarks.ablation_study(number_repetitions=1, path=path, device=dev),
                       benchmarks.compare_methods(number_repetitions=1, path=path, device=dev))
                 for dev in (device, "cpu")}
        (ab_card, cm_card), (ab_cpu, cm_cpu) = first[device], first["cpu"]
        rel = lambda a, b: np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        err_ab = max(rel(ab_card[k], ab_cpu[k]) for k in ab_cpu)
        err_cm = max(rel(cm_card[t][n], cm_cpu[t][n]) for t in cm_cpu for n in cm_cpu[t])
        if not (err_ab < 1e-8 and err_cm < 1e-8):
            raise AssertionError(f"the multi-frame suites' first repetition, f64 card vs CPU: "
                                 f"ablation {err_ab:.3g}, comparison {err_cm:.3g} (bound 1e-8)")
        ab_s, ab = wall_s(lambda: benchmarks.ablation_study(path=path, device=device))
        cm_s, cm = wall_s(lambda: benchmarks.compare_methods(path=path, device=device))
    if not (all(np.isfinite(v).all() for v in ab.values())
            and all(np.isfinite(v).all() for per in cm.values() for v in per.values())):
        raise AssertionError("the multi-frame suites' samples are not all finite")
    report = benchmarks.ranking_report(cm)
    lines.append(f"on a synthetic reach-target file ({REACH_DEMOS} demos of {REACH_T} points, "
                 f"two frames): the first repetition f64 card vs CPU, ablation {err_ab:.3g}, "
                 f"comparison {err_cm:.3g} of the largest sample (< 1e-8); ablation_study() at its "
                 f"defaults {ab_s:.2f} s ({len(ab['df'])} reproductions, {len(ab['fde_ood'])} "
                 f"out of distribution; median FDE {np.median(ab['fde']):.3g}), compare_methods() "
                 f"{cm_s:.2f} s ({sum(len(v) for v in cm['Frechet Distance'].values())} samples a "
                 f"metric); ranking_report: " + " | ".join(report.splitlines()))
    # DTW and Frechet at T = 1,000 in f64 on the card against the row sweep
    rng = np.random.default_rng(31)
    A, B = (np.cumsum(rng.standard_normal((DP_T, 2)), 0) for _ in range(2))
    At, Bt = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in (A, B))
    D = metrics._pairwise_dist(At, Bt).cpu().numpy()
    dp = []
    for name, fn, combine in (("dtw", metrics.dtw_distance, np.add),
                              ("frechet", metrics.frechet_distance, np.maximum)):
        got, want_dp = fn(At, Bt).item(), row_sweep(D, combine)
        if not abs(got - want_dp) <= 1e-12 * abs(want_dp):
            raise AssertionError(f"{name} at T={DP_T}: {got!r} on the card, the row sweep "
                                 f"{want_dp!r}")
        b = path_breakdown(lambda: fn(At, Bt), "")
        dp.append(f"{name} {got:.6g} ({abs(got - want_dp) / want_dp:.3g} from the host row "
                  f"sweep), {b['wall_ms']:.2f} ms wall, {b['all_launches']} launches over "
                  f"{2 * DP_T - 1} anti-diagonals")
    lines.append(f"at T={DP_T} (f64 on the card): " + "; ".join(dp))
    print("metrics and comparison suites: " + "; ".join(lines)
          + f"; phase 31 {time.perf_counter() - t31:.1f} s {tag}", flush=True)


# ---- phases 32-33: the multi-device slice -----------------------------------

DRYRUN_RANKS = 8
MULTICHIP_RECORD = "MULTICHIP_r05.json"  # the JAX package's dryrun on eight devices
# the dryrun's launches a rank at DRYRUN_RANKS (E = 512 on 4 'ens' ranks: one
# batched call each; 2 chains a rank, 1 + (10 + 10)·4 leapfrog evaluations;
# N = 2048 in blocks of 128: every rank factors all 16 diagonal blocks)
DRYRUN_LAUNCHES = {"transport": {"spd_inverse_elast_fused": 1, "transport_apply_rbf": 1},
                   "hmc": {"small_lml_value_grad": 81},
                   "cholesky": {"factor_panel": 16}, "lml": {"factor_panel": 16}}


def jax_dryrun_summary(text):
    """The numbers of a ``dryrun_multichip OK:`` line."""
    line = [ln for ln in text.splitlines() if ln.startswith("dryrun_multichip OK:")][-1]
    return {k: float(v) for k, v in re.findall(r"(loss|sharded_lml)=([-\d.]+)", line)}


def phase32(device, tag, ref):
    """The multi-device slice at full width in a one-rank NCCL group on the
    card: (a) the transport ensemble, (b) three joint training steps, (c)
    the distributed Cholesky, (d) the distributed LML and fit, (e) mesh HMC,
    (f) mesh SMC, each against its one-process path; the CUDA-event times
    beside those paths'.  The group is destroyed at the end."""
    import torch.distributed as dist

    from gaussian_process_transportation_tpu_torch import kernels as K
    from gaussian_process_transportation_tpu_torch.models import affine as affine_core
    from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core
    from gaussian_process_transportation_tpu_torch.ops import blocked_lml as bll
    from gaussian_process_transportation_tpu_torch.parallel import (
        distributed, ensemble, samplers, sharded_chol, sharded_lml, smc,
    )
    from gaussian_process_transportation_tpu_torch.parallel.mesh import make_mesh

    t32 = time.perf_counter()
    f32 = dict(dtype=torch.float32, device=device)
    distributed.initialize(num_processes=1, backend="nccl")
    try:
        mesh = make_mesh(1, 1, "cuda")
        backends = {ax: dist.get_backend(mesh[ax].get_group()) for ax in ("ens", "data")}
        counts, ms, lines = {}, {}, []

        # (a) the bench transport sharded over 'ens': phase 4's result
        kernel, Sd, S1d, targets, Xd, dXd = ref["transport"]

        def ens_path():
            return ensemble.transport_ensemble(kernel, Sd, targets, Xd, dXd, mesh=mesh)

        want = ref["main_path"]()
        got, counts["transport"] = drive(ens_path)
        expect_launches("transport_ensemble", counts["transport"], {
            "spd_inverse_elast_fused": 1, "transport_apply_rbf": 1, "factor_panel": 0,
            "stationary_gram_panels": 0})
        for name in want._fields:
            w = getattr(want, name)
            if w is not None and not torch.equal(getattr(got, name), w):
                raise AssertionError(f"transport_ensemble's {name} differs from phase 4's")
        del got, want
        ms["a"] = cuda_ms(ens_path)
        lines.append(f"(a) transport_ensemble E={targets.shape[0]} Q={Xd.shape[0]} n="
                     f"{Sd.shape[0]}: bit for bit phase 4's fit_and_transport_batched, "
                     f"spd_inverse_elast_fused launches {counts['transport']['spd_inverse_elast_fused']}")

        # (b) three joint Adam steps over the members
        step, optimizer = ensemble.make_ensemble_train_step(kernel, mesh=mesh)
        E = targets.shape[0]
        sources = Sd.expand(E, *Sd.shape)

        def train():
            theta, state, losses = kernel.theta, optimizer.init(kernel.theta), []
            for _ in range(3):
                theta, state, loss = step(theta, state, sources, targets)
                losses.append(loss)
            return torch.stack(losses), theta

        (losses, theta_b), counts["train_step"] = drive(train)
        aff = affine_core.fit_batched(Sd, targets)
        src_al = affine_core.predict(aff, Sd)
        want_b = -gp_core.log_marginal_likelihood(kernel, src_al, targets - src_al).double().mean()
        rel_b = abs(losses[0].item() - want_b.item()) / abs(want_b.item())
        if not (torch.isfinite(losses).all() and torch.isfinite(theta_b).all() and rel_b < 1e-5):
            raise AssertionError(f"train steps: losses {losses.tolist()}, the first vs the mean "
                                 f"-LML of exact_gp over the members {want_b.item():.6g}: {rel_b:.3g}")
        lines.append(f"(b) make_ensemble_train_step x3 at E={E}: losses "
                     f"{[round(v, 5) for v in losses.tolist()]} finite, the first within "
                     f"{rel_b:.3g} of exact_gp's mean -LML (< 1e-5)")

        # (c) the distributed Cholesky on phase 8's inputs
        Xs, Ys, alpha8, a64, solve_ms = ref["solve"]
        ls3 = torch.ones(D_SOLVE, **f32)

        def chol_path():
            return sharded_chol.sharded_gram_cholesky_solve(Xs, Ys, ls3, 2.0, 0.1, mesh,
                                                            block=BLOCK)

        (a_s, chol), counts["cholesky"] = drive(chol_path)
        expect_launches("sharded_gram_cholesky_solve", counts["cholesky"], {
            "factor_panel": N_SOLVE // BLOCK, "stationary_gram_panels": 0, "stationary_gram": 0})
        err_c = ((a_s.double() - a64).abs().max() / a64.abs().max()).item()
        diff8 = ((a_s - alpha8).abs().max() / alpha8.abs().max()).item()
        K64 = f64_gram(Xs, 2.0, 0.1)
        ld64 = 2.0 * torch.log(torch.diagonal(torch.linalg.cholesky(K64))).sum().item()
        del K64
        ld_err = abs(chol.logdet().item() - ld64) / abs(ld64)
        again = chol.solve(Ys)
        same = torch.equal(again, a_s)
        re_err = ((again - a_s).abs().max() / a_s.abs().max()).item()
        if not (err_c < 5e-3 and ld_err < 1e-4 and re_err < 1e-6):
            raise AssertionError(f"sharded Cholesky at N={N_SOLVE}: alpha vs f64 {err_c:.3g} "
                                 f"(phase 8's bound 5e-3), log det vs f64 {ld_err:.3g} (1e-4), "
                                 f"a re-solve through the factor {re_err:.3g} (1e-6)")
        del a_s, chol, again
        ms["c"] = cuda_ms(chol_path)
        lines.append(f"(c) sharded_gram_cholesky_solve N={N_SOLVE} D={D_SOLVE} block={BLOCK}: "
                     f"factor_panel launches {counts['cholesky']['factor_panel']}; alpha vs the "
                     f"f64 solve {err_c:.3g} (< 5e-3, phase 8's bound; phase 8's blocked solve "
                     f"reads {ref['solve_err']:.3g}), vs phase 8's alpha {diff8:.3g} of its max; "
                     f"log det vs f64 {ld_err:.3g} (< 1e-4); a re-solve through the factor "
                     + ("bit for bit alpha" if same else f"{re_err:.3g} from alpha (< 1e-6)"))

        # (d) the distributed LML and gradient, and fit_sharded, on phase 16's inputs
        Xf, Yf, th16 = blocked_fit_inputs(device)
        jit16, ref16 = ref["jit16"], ref["ref16"]

        def lml_path():
            return sharded_lml.sharded_lml_value_and_grad(
                Xf, Yf, "rbf", th16[0], th16[1:1 + FIT_D], th16[1 + FIT_D], mesh, jitter=jit16,
                block=BLOCK)

        (v_d, g_d), counts["lml"] = drive(lml_path)
        panels16 = -(-FIT_N // BLOCK)
        expect_launches("sharded_lml_value_and_grad", counts["lml"], {
            "factor_panel": panels16, "stationary_gram_panels": 0, "stationary_gram": 0})
        v1, g1 = bll.blocked_lml_value_and_grad(Xf, Yf, "rbf", th16[0], th16[1:1 + FIT_D],
                                                th16[1 + FIT_D], jitter=jit16, block=BLOCK,
                                                refine_iters=0)
        flat = lambda g: torch.cat([g[0].reshape(1), g[1], g[2].reshape(1)]).double()
        rel_v = abs(v_d.item() - v1.item()) / abs(v1.item())
        rel_g = ((flat(g_d) - flat(g1)).abs().max() / flat(g1).abs().max()).item()
        # the value is held against float64 within phase 16's bound, as is the
        # blocked LML without refinement: on an NVIDIA H100 80GB HBM3 (700 W)
        # the two float32 values read 1.7e-4 apart (relative), the sharded one
        # at 1.2e-4 of the bound
        ex_d, ex_1 = blocked_excess(v_d, g_d, ref16), blocked_excess(v1, g1, ref16)
        if not (rel_g < 1e-4 and max(ex_d) < 1 and max(ex_1) < 1):
            raise AssertionError(f"sharded LML at N={FIT_N}: gradient vs the blocked LML (no "
                                 f"refinement) {rel_g:.3g} of its largest (1e-4); error/bound vs "
                                 f"f64 of the sharded LML {ex_d}, of the blocked one {ex_1}")
        ms["d"] = cuda_ms(lml_path)
        kern16 = K.Constant(2.0) * K.RBF(torch.ones(FIT_D, **f32)) + K.White(0.1)
        t_fit = time.perf_counter()
        (_, th_fit, vals), counts["fit"], opt_fit = drive_fit(lambda: sharded_lml.fit_sharded(
            kern16, Xf, Yf, mesh, maxiter=FIT_MAXITER, block=BLOCK))
        fit_s = time.perf_counter() - t_fit
        expect_launches("fit_sharded", counts["fit"], {  # panels16 an evaluation
            "factor_panel": panels16 * opt_fit["evaluations"], "stationary_gram_panels": 0,
            "stationary_gram": 0})
        th_vec = torch.cat([th_fit["log_amp"].reshape(1), th_fit["log_ls"],
                            th_fit["log_noise"].reshape(1)])
        lml_fit = blocked_lml_f64(Xf, Yf, th_vec, jit16)[0]
        if not lml_fit >= ref16[0] + ref16[2]:
            raise AssertionError(f"fit_sharded's LML {lml_fit:.6g} is not above the initial "
                                 f"{ref16[0]:.6g} by the value's bound {ref16[2]:.3g}")
        del Xf, Yf
        lines.append(f"(d) sharded_lml_value_and_grad N={FIT_N} D={FIT_D}: factor_panel "
                     f"launches {counts['lml']['factor_panel']}; value and gradient error/bound "
                     f"vs f64 {ex_d[0]:.3g}, {ex_d[1]:.3g} (the blocked LML without refinement "
                     f"{ex_1[0]:.3g}, {ex_1[1]:.3g}); against that blocked LML, value "
                     f"{rel_v:.3g} relative, gradient {rel_g:.3g} of its largest (< 1e-4); fit_sharded "
                     f"maxiter {FIT_MAXITER}: {fit_text(opt_fit)}, LML (f64) {ref16[0]:.6g} -> "
                     f"{lml_fit:.6g}, {counts['fit']['factor_panel']} factor_panel launches, "
                     f"{fit_s:.3f} s")

        # (e) mesh HMC at phase 14's workload: phase 14's chains
        kern14, X14, Y14, hmc_kw, s14, hmc_ms = ref["hmc"]

        def hmc_path():
            return samplers.sample_gp_posterior(kern14, X14, Y14, seed=0, mesh=mesh, **hmc_kw)

        (s_e, _), counts["hmc"] = drive(hmc_path)
        want_e = 1 + (HMC_WARMUP + HMC_SAMPLES) * HMC_LEAPFROG
        expect_launches("sample_gp_posterior(mesh=)", counts["hmc"],
                        {"small_lml_value_grad": want_e, "small_lml_value_grad_md": 0})
        if not torch.equal(s_e, s14):
            raise AssertionError("mesh HMC differs from phase 14's chains")
        ms["e"] = cuda_ms(hmc_path, reps=3)
        lines.append(f"(e) sample_gp_posterior(mesh=) {HMC_CHAINS} chains, {HMC_WARMUP}+"
                     f"{HMC_SAMPLES} steps of {HMC_LEAPFROG} leapfrog: bit for bit phase 14's, "
                     f"small_lml_value_grad launches {counts['hmc']['small_lml_value_grad']}")

        # (f) mesh SMC at phase 20's workload
        kern20, ll20 = ref["smc"]

        def smc_run(m):
            p = smc.init_particles(kern20, Sd, S1d, Xd, SMC_PARTICLES,
                                   torch.Generator(device=device).manual_seed(0), mesh=m)
            gen, esss = torch.Generator(device=device).manual_seed(1), []
            for _ in range(SMC_STEPS):
                p, ess = smc.smc_step(p, ll20, gen, mesh=m)
                esss.append(ess)
            return p, torch.stack(esss)

        (p_m, e_m), counts["smc"] = drive(lambda: smc_run(mesh))
        p_1, e_1 = smc_run(None)
        if not (torch.equal(p_m.trajectories, p_1.trajectories)
                and torch.equal(p_m.log_weights, p_1.log_weights) and torch.equal(e_m, e_1)):
            raise AssertionError("mesh SMC differs from the run without a mesh")
        if any(counts["smc"].values()):
            raise AssertionError(f"the SMC path launched a hand kernel: {counts['smc']}")
        lines.append(f"(f) init_particles(mesh=) and smc_step x{SMC_STEPS} on {SMC_PARTICLES} "
                     f"particles of Q={Xd.shape[0]}: equal to the run without a mesh "
                     f"({int((e_m < 0.5 * SMC_PARTICLES).sum())} of {SMC_STEPS} steps resampled)")
        del p_m, p_1
    finally:
        dist.destroy_process_group()
    beside = {"a": ("phase 4's fit_and_transport_batched", ref["path_ms"]),
              "c": ("phase 8's gram_cholesky_solve", solve_ms),
              "d": ("phase 16's blocked_lml_value_and_grad", ref["lml_ms16"]),
              "e": ("phase 14's sample_gp_posterior", hmc_ms)}
    times = "; ".join(f"({k}) {ms[k][0]:.4f} ms {ms[k][1]} beside {what} {t:.4f} ms"
                      for k, (what, t) in beside.items())
    print(f"multi-device slice in a one-rank NCCL group (axes' backends {backends}) on the card: "
          + "; ".join(lines) + f"; CUDA-event medians: {times}; phase 32 "
          f"{time.perf_counter() - t32:.1f} s {tag}", flush=True)
    return counts


def phase33(tag):
    """``dryrun_multichip`` on DRYRUN_RANKS gloo ranks sharing card 0, held
    against the JAX package's recorded run; NCCL across cards where there
    are two or more."""
    from gaussian_process_transportation_tpu_torch.parallel.dryrun import dryrun_multichip

    t33 = time.perf_counter()
    want = jax_dryrun_summary(json.loads(
        open(os.path.join(os.path.dirname(os.path.abspath(__file__)), MULTICHIP_RECORD)).read()
    )["tail"])
    torch.cuda.empty_cache()
    outs = dryrun_multichip(DRYRUN_RANKS, device="cuda", backend="gloo")
    rel = {k: abs(outs[0][k] - v) / abs(v) for k, v in want.items()}
    if not max(rel.values()) <= 1e-4:
        raise AssertionError(f"dryrun_multichip: loss {outs[0]['loss']}, sharded_lml "
                             f"{outs[0]['sharded_lml']} vs the JAX record {want}")
    for o in outs:
        if not (o["device"].startswith("cuda") and o["backend"] == "gloo"):
            raise AssertionError(f"rank {o['rank']} ran on {o['device']} over {o['backend']}")
        for step, want_counts in DRYRUN_LAUNCHES.items():
            expect_launches(f"dryrun rank {o['rank']} step {step}", o["counts"][step],
                            want_counts)
    fp = [o["factor_panel_vs_twin"] for o in outs]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        n_nccl = min(n_cards, DRYRUN_RANKS)
        outs_nccl = dryrun_multichip(n_nccl)
        nccl = (f"dryrun_multichip({n_nccl}) over NCCL, one rank a card: loss "
                f"{outs_nccl[0]['loss']:.4f}, sharded_lml {outs_nccl[0]['sharded_lml']:.1f}")
    else:
        nccl = ("one card cannot take dryrun_multichip over NCCL with several ranks (NCCL "
                "refuses two ranks on one card): not run")
    print(f"multi-device dryrun: dryrun_multichip({DRYRUN_RANKS}) on {DRYRUN_RANKS} gloo ranks "
          f"sharing cuda:0, every collective passing CUDA tensors through gloo: mesh "
          f"{outs[0]['mesh']}, E={outs[0]['E']}, loss {outs[0]['loss']:.4f} and sharded_lml "
          f"{outs[0]['sharded_lml']:.1f} vs the JAX record {want} (relative {rel}, < 1e-4), "
          f"hmc_chains {outs[0]['hmc_chains']}, smc_ess {outs[0]['smc_ess']:.1f}, Cholesky vs f64 "
          f"{outs[0]['chol_err']:.3g}; launches a rank {DRYRUN_LAUNCHES} on every rank; kernel #4 "
          f"vs its twin at B=128 on each rank, largest {max(r for r, _ in fp):.3g} of its max "
          f"(bounds 8*kappa*eps32 >= {min(b for _, b in fp):.3g}); rank 0's steps ended at "
          f"{[round(t, 1) for t in outs[0]['marks'].values()]} s; {nccl}; phase 33 "
          f"{time.perf_counter() - t33:.1f} s {tag}", flush=True)
    return outs[0]["counts"]


BENCH_METRICS = ("value", "vs_baseline", "tflops_chol_n10240", "hmc_samples_per_s",
                 "smc_particles_per_s")
PRODUCT_N, PRODUCT_TOL = 4096, 2.0**-14  # the "high" product check: ~16 bits of each operand


def phase34(device, tag, a64, solve_bound):
    """The bench stages of ``gaussian_process_transportation_tpu_torch/bench.py``
    at full size, each driven with the launch counts set to 0 just before;
    then the module as a subprocess.  Returns the stages' launches a call
    (a solve for the Cholesky stage)."""
    from gaussian_process_transportation_tpu_torch import bench as tb
    from gaussian_process_transportation_tpu_torch.ops import blocked_chol as bc
    from gaussian_process_transportation_tpu_torch.ops.linalg import matmul_at

    t34 = time.perf_counter()
    X, dX, S, S1 = tb.make_workload()
    counts, per_call = {}, {}

    # the transport: E_MAIN members, one launch of #1 a call; three members
    # against the f64 CPU run, as phase 4
    iters, reps = 5, 3
    (rate_t, det_t), counts["transport"] = drive(
        lambda: tb.bench_ours(X, dX, S, S1, iters=iters, reps=reps, device=device))
    calls = 1 + iters * reps
    expect_launches("bench_ours", counts["transport"], {"spd_inverse_elast_fused": calls,
                                                        "transport_apply_rbf": calls})
    per_call["transport"] = counts["transport"]["spd_inverse_elast_fused"] / calls
    res = tb.transport_fn(X, dX, S, S1, device=device)()
    targets = res.traj.new_tensor(S1)[None] + torch.linspace(0.0, 1.0, E_MAIN,
                                                             device=device)[:, None, None]
    rel = member_errors(res, lambda dev: bench_kernel(**dev), S, X, dX, targets,
                        [0, E_MAIN // 2, E_MAIN - 1])
    del res
    print(f"bench transport: bench_ours E={E_MAIN} f32: {rate_t:.1f} traj/s (median of {reps} x "
          f"{iters} calls, CUDA events, rep_ms {[round(t, 4) for t in det_t['rep_ms']]}); "
          f"spd_inverse_elast_fused launches {counts['transport']['spd_inverse_elast_fused']} in "
          f"{calls} calls; err/max|X| vs f64 CPU " + ", ".join(f"{k}: {v:.3g}" for k, v in rel.items())
          + f" (< {TRAJ_TOL}) {tag}", flush=True)

    # the Cholesky stage at "high" (JAX's) and at "highest"
    chol = {}
    for precision in ("high", "highest"):
        iters, reps = 15, 3
        (tf, det), counts[precision] = drive(lambda: tb.bench_cholesky(
            precision=precision, iters=iters, reps=reps, device=device,
            roofline_m=8192 if precision == "high" else 0))
        solves = 1 + iters * reps
        per = {k: counts[precision][k] / solves for k in ("stationary_gram_panels", "factor_panel")}
        if per != {"stationary_gram_panels": 1, "factor_panel": -(-N_SOLVE // BLOCK)}:
            raise AssertionError(f"bench_cholesky({precision}) launches a solve {per}")
        Xs, Ys = tb.cholesky_inputs(N_SOLVE, device)
        ls3 = torch.ones(D_SOLVE, device=device)
        err = {}
        for refine in (None, 0):
            alpha = bc.gram_cholesky_solve(Xs, Ys, ls3, 2.0, 0.1, block=BLOCK,
                                           precision=precision, refine_iters=refine)[0]
            err[refine] = ((alpha.double() - a64).abs().max() / a64.abs().max()).item()
        if not err[None] < solve_bound:
            raise AssertionError(f"bench_cholesky({precision}) alpha rel err {err[None]:.3g} >= "
                                 f"{solve_bound}")
        chol[precision] = (tf, det, per, err)
        per_call[precision] = per
    r_highest = chol["high"][1]["roofline_highest_tflops"]
    r_high = chol["high"][1]["roofline_high_tflops"]
    print(f"bench cholesky: gram_cholesky_solve N={N_SOLVE} B={BLOCK} D={D_SOLVE}, 8192^2 product "
          f"rates highest {r_highest:.2f} and high {r_high:.2f} TFLOP/s; " + "; ".join(
              f"{p}: {tf:.3f} TFLOP/s ({100 * tf / r_highest:.1f}% of highest's rate, "
              f"{100 * tf / r_high:.1f}% of high's), median {1e3 * tb.cholesky_flops(N_SOLVE) / tf / 1e12:.4f} ms "
              f"(rep_ms {[round(t, 4) for t in det['rep_ms']]}), launches a solve {per}, alpha rel err "
              f"vs f64 {err[None]:.3g} (< {solve_bound}: one refinement step with the residual in "
              f"float32 brings any precision's solve to the float32 solve's accuracy, phase 8's "
              f"bound), unrefined {err[0]:.3g}"
              for p, (tf, det, per, err) in chol.items()) + f" {tag}", flush=True)

    # the product check: "high" within PRODUCT_TOL of f64; the one-pass
    # "default" (the lo terms dropped) must be rejected by the same check
    gen = torch.Generator(device=device).manual_seed(34)
    a, b = (torch.randn(PRODUCT_N, PRODUCT_N, generator=gen, device=device) for _ in range(2))
    c64 = a.double() @ b.double()
    prod = {p: ((matmul_at(a, b, p).double() - c64).abs().max() / c64.abs().max()).item()
            for p in ("high", "default", "highest")}
    del a, b, c64
    if not (prod["high"] < PRODUCT_TOL <= prod["default"]):
        raise AssertionError(f"matmul_at at {PRODUCT_N}^2: rel err {prod} against {PRODUCT_TOL}")
    print(f"matmul_at {PRODUCT_N}^2 f32 vs f64, max|err|/max|C|: high {prod['high']:.3g} "
          f"(< 2^-14 = {PRODUCT_TOL:.3g}), the planted fault default (lo terms dropped) "
          f"{prod['default']:.3g} rejected, highest {prod['highest']:.3g} {tag}", flush=True)

    # the samplers and the host reference
    reps = 3
    (rate_h, det_h), counts["hmc"] = drive(lambda: tb.bench_hmc(reps=reps, device=device))
    want_h = (1 + reps) * (1 + (HMC_WARMUP + HMC_SAMPLES) * HMC_LEAPFROG)
    expect_launches("bench_hmc", counts["hmc"], {"small_lml_value_grad": want_h})
    per_call["hmc"] = counts["hmc"]["small_lml_value_grad"] / (1 + reps)
    (rate_s, det_s), counts["smc"] = drive(lambda: tb.bench_smc(device=device))
    if any(counts["smc"].values()):
        raise AssertionError(f"bench_smc launched a hand kernel: {counts['smc']}")
    ref_rate = tb.bench_reference_cpu(X, dX, S, S1)
    print(f"bench samplers: bench_hmc {rate_h:.1f} hmc_samples_per_s (rep_ms "
          f"{[round(t, 2) for t in det_h['rep_ms']]}, small_lml_value_grad launches "
          f"{per_call['hmc']:.0f} a call); bench_smc {rate_s:.1f} "
          f"smc_particles_per_s (rep_ms {[round(t, 3) for t in det_s['rep_ms']]}); "
          f"bench_reference_cpu {ref_rate:.1f} traj/s on the host; vs_baseline "
          f"{rate_t / ref_rate:.2f} {tag}", flush=True)

    # the module, as a user runs it
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", PKG + ".bench"], capture_output=True, text=True,
                         timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    sys.stderr.write(out.stderr)
    if out.returncode != 0:
        raise AssertionError(f"python -m {PKG}.bench exited {out.returncode}")
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    if len(lines) != 1 or not all(isinstance(line.get(k), float) and math.isfinite(line[k])
                                  for k in BENCH_METRICS):
        raise AssertionError(f"python -m {PKG}.bench printed {out.stdout!r}")
    print(f"python -m {PKG}.bench: one JSON line in {time.perf_counter() - t0:.1f} s, "
          + ", ".join(f"{k} {line[k]:.4g}" for k in BENCH_METRICS)
          + f", card {line['card']!r}; phase 34 {time.perf_counter() - t34:.1f} s {tag}", flush=True)
    return per_call


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")

    from gaussian_process_transportation_tpu_torch import kernels as K
    from gaussian_process_transportation_tpu_torch.models import exact_gp as gp_core
    from gaussian_process_transportation_tpu_torch.ops import _cuda
    from gaussian_process_transportation_tpu_torch.ops import batched_linalg as bl
    from gaussian_process_transportation_tpu_torch.ops import blocked_chol as bc
    from gaussian_process_transportation_tpu_torch.ops import pallas_gram as pg
    from gaussian_process_transportation_tpu_torch.ops import transport_apply as tfa
    from gaussian_process_transportation_tpu_torch.ops.batched_linalg import (
        spd_inverse_elast, spd_inverse_elast_fused,
    )
    from gaussian_process_transportation_tpu_torch.transport import gpt
    from port_bench import counts as bench_counts

    if any(m == "jax" or m.startswith(("jax.", TPU_PKG + ".")) or m == TPU_PKG
           for m in sys.modules):
        raise AssertionError("the port's smoke run imported JAX or the JAX package")

    device = torch.device("cuda", 0)
    kernels_json = {}

    # 1. device
    card = card_line()
    print(card, flush=True)
    tag = f"[{card}]"

    # 2. build: every source starts now, one nvcc each
    pool = ThreadPoolExecutor(len(SOURCES))
    builds = {name: pool.submit(timed_build, name) for name in SOURCES}
    lib_path, build_s = builds["spd_inverse_elast"].result()
    _cuda.library("spd_inverse_elast")
    print(f"build: spd_inverse_elast in {build_s:.2f} s ({lib_path.name}) {tag}", flush=True)
    print(lib_path.with_suffix(".log").read_text(), file=sys.stderr)

    # 3. kernel against twin, every instance
    errs = {}
    for n, E in KERNEL_CASES:
        errs[f"f32 n={n} E={E}"] = check_kernel(n, E, torch.float32, device,
                                                F32_ATOL, F32_INV_TOL)
    errs[f"f64 n=20 E={E_MAIN + 37}"] = check_kernel(N_MAIN, E_MAIN + 37, torch.float64,
                                                     device, F64_ATOL, F64_ATOL)
    main_err, main_instance = errs[f"f32 n={N_MAIN} E={E_MAIN}"]
    taken = {inst for _, inst in errs.values()}
    if taken != set(bl.SPD_INVERSE_INSTANCES):
        raise AssertionError(f"phase 3 launched the instances {sorted(taken)}, not all of "
                             f"{bl.SPD_INVERSE_INSTANCES}")
    Ke3 = torch.from_numpy(np.transpose(spd_batch(N_MAIN, E_MAIN), (1, 2, 0))).to(device).contiguous()
    run_a, run_b = spd_inverse_elast_fused(Ke3), spd_inverse_elast_fused(Ke3)
    if not (torch.equal(run_a[0], run_b[0]) and torch.equal(run_a[1], run_b[1])):
        raise AssertionError("two runs of spd_inverse_elast_fused on the same inputs differ")
    del run_a, run_b, Ke3
    print("kernel vs twin: max|diff| [instance] " + ", ".join(
        f"{k} [{inst}]: {v:.3g}" for k, (v, inst) in errs.items())
        + f"; all within tolerance; two runs at n={N_MAIN} E={E_MAIN} bitwise equal {tag}",
        flush=True)

    # 4. ensemble transport, its apply in one launch of #8 (built in phase 2)
    apply_lib, apply_build_s = builds["transport_apply"].result()
    _cuda.library("transport_apply")
    apply_log = apply_lib.with_suffix(".log").read_text()
    print(apply_log, file=sys.stderr)
    print(f"build: transport_apply in {apply_build_s:.2f} s, beside the others "
          f"({apply_lib.name}; ptxas: {ptxas_summary(apply_log)}) {tag}", flush=True)
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
    res, counts4 = drive(main_path)
    launches = counts4["spd_inverse_elast_fused"]
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    expect_launches("ensemble transport", counts4, {
        "spd_inverse_elast_fused": 1, "transport_apply_rbf": 1, "factor_panel": 0,
        "stationary_gram_panels": 0})
    fields = {name: getattr(res, name) for name in res._fields if getattr(res, name) is not None}
    for name, value in fields.items():
        if not torch.isfinite(value).all():
            raise AssertionError(f"main path field {name} has non-finite values")
    if res.traj.shape != (E_MAIN, Q_MAIN, 2) or res.min_abs_det.shape != (E_MAIN,):
        raise AssertionError(f"unexpected shapes {res.traj.shape}, {res.min_abs_det.shape}")

    members = [0, E_MAIN // 2, E_MAIN - 1]
    f64 = dict(dtype=torch.float64, device="cpu")
    scale = float(np.abs(X).max())
    rel = member_errors(res, lambda dev: bench_kernel(**dev), S, X, dX, targets, members)
    print(f"main path: E={E_MAIN} Q={Q_MAIN} n={N_MAIN} f32, fields {sorted(fields)} finite, "
          f"kernel launches {launches}, err/max|X| vs f64 CPU "
          + ", ".join(f"{k}: {v:.3g}" for k, v in rel.items())
          + f" (< {TRAJ_TOL}) {tag}", flush=True)
    del res

    # #8 alone on the main path's state: each field against the twin's
    # float64 evaluation, and the K⁻¹ form of the variances rejected
    state4 = apply_bench_state(device)
    apply_err, apply_twin_err = check_apply(*state4)
    k_inv_err, _ = apply_check_errors(*state4, got=apply_k_inv_form(*state4))
    if apply_within(k_inv_err, apply_twin_err):
        raise AssertionError(f"the apply check passed the K⁻¹ form of the variances: {k_inv_err}")
    apply_bound = {k: APPLY_REL * v + APPLY_FLOOR for k, v in apply_twin_err.items()}
    print(f"fused apply #8 (transport_apply_rbf) E={E_MAIN} n={N_MAIN} Q={Q_MAIN} D=2 against "
          f"the twin's float64 evaluation, error/bound: "
          + ", ".join(f"{k} {apply_err[k]:.3g}/{apply_bound[k]:.3g}" for k in APPLY_FIELDS)
          + "; the K⁻¹ form rejected: "
          + ", ".join(f"{k} {k_inv_err[k]:.3g}" for k in ("std", "delta_var")) + f" {tag}",
          flush=True)

    # 5. times
    K_main = spd_batch(N_MAIN, E_MAIN)
    Ke = torch.from_numpy(np.transpose(K_main, (1, 2, 0))).to(**f32).contiguous()
    kernel_ms, kernel_all = cuda_ms(lambda: spd_inverse_elast_fused(Ke))
    plain_ms, plain_all = cuda_ms(lambda: spd_inverse_elast(Ke))
    Kb = torch.from_numpy(K_main).to(**f32)  # the same matrices, (E, n, n)
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
    n, E = N_MAIN, E_MAIN
    args8 = apply_args(*state4)
    kernels_json["transport_apply_rbf"] = dict(
        source=f"{PKG}/csrc/transport_apply.cu",
        replaces="none: the JAX package left apply to XLA", launches=counts4["transport_apply_rbf"],
        max_abs_err=max(apply_err.values()),
        # float32 operations set the least time at this shape (port_bench/counts.py)
        bound=(bench_counts.apply(E_MAIN, N_MAIN, Q_MAIN, 2, 2) * 1e3, "operations"),
        shape=f"E={E_MAIN} n={N_MAIN} Q={Q_MAIN} D=2", ptxas=ptxas_summary(apply_log),
        calls=(lambda: tfa.transport_apply_rbf(*args8),
               lambda: tfa.transport_apply_rbf_plain(*args8), None))
    kernels_json["spd_inverse_elast_fused"] = dict(
        source=f"{PKG}/csrc/spd_inverse_elast.cu",
        replaces=f"{TPU_PKG}/ops/batched_linalg.py:80", launches=launches, max_abs_err=main_err,
        bound=bound(3 * n * n * E * 4, n**3 * E), shape=f"n={n} E={E} [{main_instance}]",
        instance=main_instance,
        calls=(lambda: spd_inverse_elast_fused(Ke), lambda: spd_inverse_elast(Ke),
               lambda: torch.cholesky_inverse(torch.linalg.cholesky(Kb)),
               lambda: bl._launch(Ke, "thread")))

    # 6. build of the large-N kernels (started in phase 2)
    print(f"ptxas: spd_inverse_elast: {ptxas_summary(lib_path.with_suffix('.log').read_text())} "
          f"{tag}", flush=True)
    logs = {}
    for name in ("factor_panel", "stationary_gram", "fused_lml"):
        path, build_s = builds[name].result()
        _cuda.library(name)
        log = logs[name] = path.with_suffix(".log").read_text()
        print(log, file=sys.stderr)
        print(f"build: {name} in {build_s:.2f} s, beside the others ({path.name}; ptxas: "
              + ptxas_summary(log)
              + (f"; mean_var_kernel dynamic smem "
                 f"{_cuda.library(name).predict_mean_var_smem_bytes()} bytes"
                 if name == "stationary_gram" else "")
              + (f"; {lml_occupancy()}" if name == "fused_lml" else "")
              + f") {tag}", flush=True)
    pool.shutdown()

    # 7. the new kernels against their twins
    fp_errs = {B: check_factor_panel(device, B) for B in (128, 256, 512, 1024)}
    # kernel #7: the generic entry at ragged shapes (M = 1, 3, 129, 1001: row
    # strides that are no multiple of 16 bytes, a ragged last column group)
    # and the path's panel width; the panel entry at both paths' shapes, at
    # the edges of its blocks and at every family and D of its instances
    gram_errs = {(fam, N, M, D_): check_gram(device, N, M, D_, fam)
                 for fam in FAMILIES for (N, M, D_) in GRAM_CASES}
    gram_panel_errs = {(fam, n_, B_, D_): check_gram_panels(device, n_, B_, D_, fam)
                       for fam, n_, B_, D_ in GRAM_PANEL_CASES}
    gram_faults = gram_panel_faults(device)
    Xg, Yg, Xqg = (torch.as_tensor(a, **f32) for a in grid_inputs())
    kern_grid = K.Constant(2.0) * K.RBF(torch.ones(2, **f32)) + K.White(0.1)
    gp_grid = gp_core.condition(kern_grid, Xg, Yg, cache_k_inv=True)
    ones2 = torch.ones(2, **f32)
    pred_errs = {}
    for fam in FAMILIES:
        pred_errs[(fam, NQ_GRID**2, N_GRID)] = check_predicts(
            device, Xqg, Xg, gp_grid.alpha, gp_grid.K_inv, ones2, 2.0, 2.1, fam)
    rng = np.random.default_rng(7)
    Xr = torch.as_tensor(rng.standard_normal((301, 2)), **f32)
    gp_r = gp_core.condition(kern_grid, Xr, torch.sin(Xr), cache_k_inv=True)
    Xqr = torch.as_tensor(rng.standard_normal((777, 2)), **f32)
    for fam in FAMILIES:
        pred_errs[(fam, 777, 301)] = check_predicts(device, Xqr, Xr, gp_r.alpha, gp_r.K_inv,
                                                    ones2, 2.0, 2.1, fam)
    edge_excess = [0.0, 0.0]
    for nq in TILE_EDGES:
        for nn in TILE_EDGES:
            out = check_predicts(device, *posterior_case(device, nq, nn, "rbf"), "rbf")
            edge_excess = [max(a, b) for a, b in zip(edge_excess, out[2:])]
    grid_args = (Xqg, Xg, gp_grid.alpha, gp_grid.K_inv, ones2, 2.0, 2.1)
    run_a, run_b = pg.fused_gp_predict_mean_var(*grid_args), pg.fused_gp_predict_mean_var(*grid_args)
    if not (torch.equal(run_a[0], run_b[0]) and torch.equal(run_a[1], run_b[1])):
        raise AssertionError("two runs of fused_gp_predict_mean_var on the same inputs differ")
    del run_a, run_b
    faults = planted_faults(*grid_args)
    # the mean kernel alone at the edges of its chunks and query blocks, then
    # every family, D and P capacity at a ragged shape
    mean_errs = [0.0, 0.0]
    for nq in MEAN_EDGES:
        for nn in MEAN_EDGES:
            mean_errs = [max(a, b) for a, b in zip(mean_errs, check_mean(device, nq, nn, 3, 2, "rbf"))]
    mean_shapes = [(fam, D_, P_) for fam in FAMILIES for D_ in (2, 3, 5) for P_ in (1, 2, 8)]
    for fam, D_, P_ in mean_shapes:
        mean_errs = [max(a, b) for a, b in zip(mean_errs, check_mean(device, 257, 300, D_, P_, fam))]
    mean_a = pg.fused_gp_predict_mean(Xqg, Xg, gp_grid.alpha, ones2, 2.0, "matern52")
    if not torch.equal(mean_a, pg.fused_gp_predict_mean(Xqg, Xg, gp_grid.alpha, ones2, 2.0,
                                                        "matern52")):
        raise AssertionError("two runs of fused_gp_predict_mean on the same inputs differ")
    del mean_a
    m_faults = mean_faults(device)
    fp_launches, fp_diag_ms = panel_profile(torch.as_tensor(panel_spd(BLOCK), device=device))
    print("new kernels vs twins: factor_panel |kernel-twin| (rel err vs f64) "
          + ", ".join(f"B={B}: {e:.3g} ({r:.3g})" for B, (e, r) in fp_errs.items())
          + f" (< 5e-6, exact zeros above the diagonal); at B={BLOCK} {fp_launches:g} device "
          f"launches per call, its diag_kernel {fp_diag_ms:.4f} ms a launch (CUPTI, mean of "
          f"{BLOCK // bc.SUB_BLOCK * REPS})"
          + f"; stationary_gram (N, M, D) in {GRAM_CASES}, four families, into NaN: "
          + f"|kernel-twin| max {max(e[0] for e in gram_errs.values()):.3g}, error/bound vs "
          + f"the f64 formula max {max(e[1] for e in gram_errs.values()):.3g} (bound "
          + f"{GRAM_TOL:g}*amp); stationary_gram_panels at {len(gram_panel_errs)} (family, n, "
          + "B, D) cases, into NaN, one launch each: |kernel-twin| max "
          + f"{max(e[0] for e in gram_panel_errs.values()):.3g}, error/bound max "
          + f"{max(e[1] for e in gram_panel_errs.values()):.3g} (bound "
          + f"{GRAM_TOL:g}*(amp+noise)), two runs bitwise equal; planted panel faults "
          + "rejected, error/bound " + ", ".join(f"{k} {v:.3g}" for k, v in gram_faults.items())
          + "; fused mean/var |kernel-twin| max (error/bound vs the f64 "
          + f"formula, bound mean {MEAN_REL:g}*sum|k alpha|, var {VAR_REL:g}*var64+{VAR_FLOOR:g}) "
          + ", ".join(f"{f} {nq}x{nn}: {a:.3g}/{b:.3g} ({c:.3g}/{d:.3g})"
                      for (f, nq, nn), (a, b, c, d) in pred_errs.items())
          + f"; rbf D=3 P=2 at every Nq, N in {TILE_EDGES}: error/bound max "
          + f"{edge_excess[0]:.3g}/{edge_excess[1]:.3g}; two runs bitwise equal"
          + "; planted faults rejected, error/bound "
          + ", ".join(f"{name} {ex:.3g}" for name, ex in faults.items())
          + f"; fused_gp_predict_mean at every Nq, N in {MEAN_EDGES} (rbf D=3 P=2) and "
          + f"{len(mean_shapes)} family/D/P cases at 257x300 (D in 2/3/5, P in 1/2/8): "
          + f"|kernel-twin| max {mean_errs[0]:.3g}, error/bound max {mean_errs[1]:.3g}; two runs "
          + "on the grid bitwise equal; planted mean faults rejected, error/bound "
          + ", ".join(f"{name} {ex:.3g}" for name, ex in m_faults.items())
          + f"; all within tolerance {tag}", flush=True)

    # 8. large-N solve
    Xs, Ys = solve_inputs(device)
    ls3 = torch.ones(D_SOLVE, **f32)

    def solve_path(X_=Xs, Y_=Ys):
        return bc.gram_cholesky_solve(X_, Y_, ls3, 2.0, 0.1, block=BLOCK)[0]

    alpha, counts8 = drive(solve_path)
    panels = -(-N_SOLVE // BLOCK)
    expect_launches("gram_cholesky_solve", counts8, {"factor_panel": panels,
                                                     "stationary_gram_panels": 1,
                                                     "stationary_gram": 0})
    K64 = f64_gram(Xs, 2.0, 0.1)
    a64 = torch.cholesky_solve(Ys.double(), torch.linalg.cholesky(K64))
    del K64
    solve_err = ((alpha.double() - a64).abs().max() / a64.abs().max()).item()
    if not solve_err < SOLVE_REL_TOL:
        raise AssertionError(f"gram_cholesky_solve alpha rel err {solve_err:.3g} >= "
                             f"{SOLVE_REL_TOL}")
    solve_ms, solve_all = cuda_ms(solve_path)
    n = N_SOLVE
    tflops = (2 * n * n * 3 + n**3 / 3 + 4 * n * n * 3) / (solve_ms / 1e3) / 1e12
    m = 8192
    Am = torch.ones(m, m, **f32) * 1e-3
    mm_ms, _ = cuda_ms(lambda: Am @ Am)
    del Am
    mm_tflops = 2 * m**3 / (mm_ms / 1e3) / 1e12

    def cusolver_path(X_, Y_):
        Kd = pg.stationary_gram_plain(X_, X_, ls3, 2.0)
        Kd.diagonal().add_(0.1)
        return torch.cholesky_solve(Y_, torch.linalg.cholesky(Kd))

    lib_ms = {}
    for nn in N_CHOL_ROUTE:
        Xn, Yn = solve_inputs(device, nn)
        lib_ms[nn] = (cuda_ms(lambda: solve_path(Xn, Yn))[0],
                      cuda_ms(lambda: cusolver_path(Xn, Yn))[0],
                      "blocked" if nn >= gp_core.BLOCKED_CHOL_MIN_N else "dense")
    del Xn, Yn
    print(f"large-N solve: gram_cholesky_solve N={n} D={D_SOLVE} block={BLOCK}: factor_panel "
          f"launches {counts8['factor_panel']}, stationary_gram_panels "
          f"{counts8['stationary_gram_panels']} (stationary_gram {counts8['stationary_gram']}); "
          f"alpha rel err vs f64 {solve_err:.3g} (< {SOLVE_REL_TOL}); {solve_ms:.4f} ms {solve_all} = "
          f"{tflops:.3f} TFLOP/s; f32 matmul 8192^2 {mm_tflops:.3f} TFLOP/s (TF32 off); "
          "blocked vs torch.linalg.cholesky+cholesky_solve (dense Gram included): "
          + ", ".join(f"N={k}: {a:.4f} vs {b:.4f} ms (condition() takes the {r} path)"
                      for k, (a, b, r) in lib_ms.items())
          + f"; BLOCKED_CHOL_MIN_N = {gp_core.BLOCKED_CHOL_MIN_N} {tag}", flush=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        solve_path()
        torch.cuda.synchronize()
    print(f"profile of gram_cholesky_solve N={n} {tag}\n"
          + prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), file=sys.stderr)
    gram8 = path_breakdown(solve_path, "gram_tile_kernel")
    gram8["bound"] = bound(panel_bytes(N_SOLVE, BLOCK), 0)

    # 9. the 3-D ensemble transport (the slice's main path)
    S3, T3, X3, dX3 = ensemble_3d_inputs()
    S3d, T3d, X3d, dX3d = (torch.as_tensor(a, **f32) for a in (S3, T3, X3, dX3))
    kern3 = K.Constant(2.0) * K.RBF(2.0 * torch.ones(3, **f32)) + K.White(0.01)

    def ensemble_3d():
        return gpt.fit_and_transport_batched(kern3, S3d, T3d, X3d, dX3d)

    res3, counts9 = drive(ensemble_3d)
    per_member = -(-N_3D // gpt.BLOCKED_PANEL)
    expect_launches("3-D ensemble", counts9, {"factor_panel": E_3D * per_member,
                                              "stationary_gram_panels": E_3D,
                                              "stationary_gram": 0,
                                              "spd_inverse_elast_fused": 0})
    for name in ("traj", "std", "delta", "delta_var", "min_abs_det"):
        if not torch.isfinite(getattr(res3, name)).all():
            raise AssertionError(f"3-D ensemble field {name} has non-finite values")
    if res3.traj.shape != (E_3D, Q_3D, 3):
        raise AssertionError(f"3-D ensemble traj shape {tuple(res3.traj.shape)}")
    kern3_64 = K.Constant(2.0) * K.RBF(2.0 * torch.ones(3, **f64)) + K.White(0.01)
    scale3 = float(np.abs(X3).max())
    rel3 = {}
    for e in (0, E_3D - 1):
        one = gpt.fit_and_transport(kern3_64, *(torch.as_tensor(a, **f64)
                                                for a in (S3, T3[e], X3, dX3)))
        for name in ("traj", "std", "delta"):
            got = getattr(res3, name)[e].double().cpu()
            rel3[f"{name}[{e}]"] = (got - getattr(one, name)).abs().max().item() / scale3
    if max(rel3.values()) >= TRAJ_TOL:
        raise AssertionError(f"3-D ensemble differs from the f64 dense CPU run: {rel3}")
    del res3
    ens_ms, ens_all = cuda_ms(ensemble_3d)
    print(f"3-D ensemble: fit_and_transport_batched E={E_3D} n={N_3D} Q={Q_3D} D=3 f32, fields "
          f"finite, factor_panel launches {counts9['factor_panel']}, stationary_gram_panels "
          f"{counts9['stationary_gram_panels']} (stationary_gram {counts9['stationary_gram']}); "
          "err/max|X| vs f64 dense CPU "
          + ", ".join(f"{k}: {v:.3g}" for k, v in rel3.items())
          + f" (< {TRAJ_TOL}); {ens_ms:.4f} ms/ensemble {ens_all} (median of {REPS}) = "
          f"{E_3D / (ens_ms / 1e3):.3f} members/s {tag}", flush=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ensemble_3d()
        torch.cuda.synchronize()
    print(f"profile of the 3-D ensemble {tag}\n"
          + prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), file=sys.stderr)
    gram9 = path_breakdown(ensemble_3d, "gram_tile_kernel")
    gram9["bound"] = bound(E_3D * panel_bytes(N_3D, gpt.BLOCKED_PANEL), 0)
    print("stationary_gram_panels' device total on its paths (CUPTI, one traced call): "
          + "; ".join(f"{what}: {g['kernel_ms']:.4f} ms in {g['kernel_launches']} launches, bound "
                      f"{g['bound'][0]:.4f} ms by {g['bound'][1]}"
                      for what, g in ((f"the N={N_SOLVE} solve", gram8),
                                      (f"the 3-D ensemble E={E_3D} n={N_3D}", gram9)))
          + f" {tag}", flush=True)

    # 10. dense-grid predicts
    route = lambda n, std: gp_core.fused_predict_route(
        "cuda", torch.float32, torch.float32, NQ_GRID**2, n, 2, Yg.shape[1], True, std)
    if (route(N_GRID, False), route(N_GRID, True)) != ("mean", "mean_var"):
        raise AssertionError("the grid shape no longer routes to the fused kernels")
    mean, counts_m = drive(lambda: gp_core.predict(gp_grid, Xqg))
    expect_launches("predict", counts_m, {"fused_gp_predict_mean": 1,
                                          "fused_gp_predict_mean_var": 0})
    (mean_s, std), counts_v = drive(lambda: gp_core.predict(gp_grid, Xqg, return_std=True))
    expect_launches("predict(return_std)", counts_v, {"fused_gp_predict_mean": 0,
                                                      "fused_gp_predict_mean_var": 1})
    kern_grid64 = K.Constant(2.0) * K.RBF(torch.ones(2, dtype=torch.float64, device=device)) \
        + K.White(0.1)
    gp64 = gp_core.condition(kern_grid64, Xg.double(), Yg.double())
    mean64, std64 = gp_core.predict(gp64, Xqg.double(), return_std=True)
    m_err = max((mean - mean64).abs().max().item(),
                (mean_s - mean64).abs().max().item()) / mean64.abs().max().item()
    s_err = (std - std64).abs().max().item()
    s_tol = 5e-3 * std64.abs().max().item() + 1e-3
    if not (m_err < 5e-3 and s_err < s_tol):
        raise AssertionError(f"dense-grid predict vs f64: mean rel {m_err:.3g} (tol 5e-3), "
                             f"std {s_err:.3g} (tol {s_tol:.3g})")
    print(f"dense-grid predict: Nq={NQ_GRID}x{NQ_GRID} N={N_GRID} C(2)*RBF(1)+White(0.1) f32: "
          f"fused_gp_predict_mean launches {counts_m['fused_gp_predict_mean']}, "
          f"fused_gp_predict_mean_var {counts_v['fused_gp_predict_mean_var']}; vs f64 dense "
          f"path: mean rel {m_err:.3g} (< 5e-3), std {s_err:.3g} (< {s_tol:.3g}) {tag}",
          flush=True)

    # 11. times at the path's shapes
    panels = bc.stationary_gram_panels(Xs, ls3, 2.0, 0.1, BLOCK)[0]
    A512 = panels[0][:BLOCK].contiguous()  # the first diagonal block of phase 8
    del panels
    L_k, Linv_k = bc.factor_panel(A512)
    L_0, Linv_0 = bc.factor_panel_plain(A512)
    eye512 = torch.eye(BLOCK, **f32)
    B = BLOCK
    kernels_json["factor_panel"] = dict(
        source=f"{PKG}/csrc/factor_panel.cu", replaces=f"{TPU_PKG}/ops/blocked_chol.py:282",
        launches=counts9["factor_panel"],
        max_abs_err=max((L_k - L_0).abs().max().item(), (Linv_k - Linv_0).abs().max().item()),
        bound=bound(3 * B * B * 4, 2 * B**3 / 3), shape=f"B={B}",
        calls=(lambda: bc.factor_panel(A512), lambda: bc.factor_panel_plain(A512),
               lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(A512), eye512,
                                                     upper=False)))
    # kernel #7 at both paths' shapes: the solve's Gram (one launch) and the
    # 3-D ensemble's (E_3D launches at the members' n); beside it the generic
    # entry on the solve's first panel, (10240, 512)
    entries = panel_bytes(N_SOLVE, B) // 4
    ls3_ens = 2.0 * torch.ones(3, **f32)
    kernels_json["stationary_gram_panels"] = dict(
        source=f"{PKG}/csrc/stationary_gram.cu", replaces=f"{TPU_PKG}/ops/pallas_gram.py:268",
        launches=counts9["stationary_gram_panels"],
        max_abs_err=gram_panel_errs[("rbf", N_SOLVE, B, D_SOLVE)][0],
        bound=bound(4 * entries + N_SOLVE * D_SOLVE * 4, gram_flops(entries, 1, D_SOLVE),
                    transcendentals=entries),
        shape=f"the N={N_SOLVE} solve's Gram, {N_SOLVE // B} panels of B={B}, D={D_SOLVE}",
        path_totals={"solve": gram8, "ensemble_3d": gram9},
        ptxas="; ".join(e for e in ptxas_summary(logs["stationary_gram"]).split("; ")
                        if e.startswith(("gram_tile_kernel<0,3,", "gram_tile_kernel<0,0,"))),
        calls=(lambda: bc.stationary_gram_panels(Xs, ls3, 2.0, 0.1, B),
               lambda: bc.stationary_gram_panels_plain(Xs, ls3, 2.0, 0.1, B), None))
    ens_entries = E_3D * panel_bytes(N_3D, gpt.BLOCKED_PANEL) // 4
    gram_extra = {
        "ensemble_3d_gram": (
            lambda: [bc.stationary_gram_panels(S3d, ls3_ens, 2.0, 0.01, gpt.BLOCKED_PANEL)
                     for _ in range(E_3D)],
            lambda: [bc.stationary_gram_panels_plain(S3d, ls3_ens, 2.0, 0.01, gpt.BLOCKED_PANEL)
                     for _ in range(E_3D)],
            bound(4 * ens_entries + E_3D * N_3D * 12, gram_flops(ens_entries, 1, 3),
                  transcendentals=ens_entries)),
        "generic": (lambda: pg.stationary_gram(Xs, Xs[:B], ls3, 2.0),
                    lambda: pg.stationary_gram_plain(Xs, Xs[:B], ls3, 2.0),
                    bound(N_SOLVE * B * 4 + (N_SOLVE + B) * D_SOLVE * 4,
                          gram_flops(N_SOLVE, B, D_SOLVE), transcendentals=N_SOLVE * B))}

    a_g, Ki_g = gp_grid.alpha, gp_grid.K_inv
    Nq, N, P, D = Xqg.shape[0], Xg.shape[0], a_g.shape[1], 2

    def dense_mean_var(X_=Xg, a_=a_g, Ki_=Ki_g):
        k_star = kern_grid(Xqg, X_)
        return k_star @ a_, kern_grid.diag(Xqg) - ((k_star @ Ki_) * k_star).sum(-1)

    kernels_json["fused_gp_predict_mean"] = dict(
        source=f"{PKG}/csrc/stationary_gram.cu", replaces=f"{TPU_PKG}/ops/pallas_gram.py:43",
        launches=counts_m["fused_gp_predict_mean"], max_abs_err=pred_errs[("rbf", Nq, N)][0],
        bound=bound((Nq * D + N * D + N * P + Nq * P) * 4, gram_flops(Nq, N, D) + 2 * Nq * N * P,
                    transcendentals=Nq * N),
        shape=f"Nq={Nq} N={N} P={P}",
        calls=(lambda: pg.fused_gp_predict_mean(Xqg, Xg, a_g, ones2, 2.0),
               lambda: pg.fused_gp_predict_mean_plain(Xqg, Xg, a_g, ones2, 2.0),
               lambda: kern_grid(Xqg, Xg) @ a_g))
    kernels_json["fused_gp_predict_mean_var"] = dict(
        source=f"{PKG}/csrc/stationary_gram.cu", replaces=f"{TPU_PKG}/ops/pallas_gram.py:123",
        launches=counts_v["fused_gp_predict_mean_var"],
        max_abs_err=max(pred_errs[("rbf", Nq, N)][:2]),
        bound=bound((Nq * D + N * D + N * P + N * N + Nq * P + Nq) * 4,
                    2 * gram_flops(Nq, N, D) + 2 * Nq * N * N + 2 * Nq * N * (P + 1)),
        shape=f"Nq={Nq} N={N} P={P}",
        calls=(lambda: pg.fused_gp_predict_mean_var(Xqg, Xg, a_g, Ki_g, ones2, 2.0, 2.1),
               lambda: pg.fused_gp_predict_mean_var_plain(Xqg, Xg, a_g, Ki_g, ones2, 2.0, 2.1),
               dense_mean_var))
    for v in kernels_json.values():
        v.update(timed(*v.pop("calls")))
    for key, (kernel_fn, twin_fn, bnd) in gram_extra.items():
        t = timed(kernel_fn, twin_fn)
        kernels_json["stationary_gram_panels"].setdefault("event_timed", []).extend(
            f"{key}_{role}" for role in ("ms", "plain_ms") if not t[role][2])
        kernels_json["stationary_gram_panels"]["extra"] = {
            **kernels_json["stationary_gram_panels"].get("extra", {}),
            f"{key}_ms": t["ms"][0], f"{key}_event_ms": t["ms"][1],
            f"{key}_plain_ms": t["plain_ms"][0], f"{key}_bound_ms": bnd[0]}

    # predict(return_std)'s two paths at Nq = 10^4: device ms of the kernel and
    # of the dense path, and which one the route takes
    var_ms = {N: (kernels_json["fused_gp_predict_mean_var"]["ms"][0],
                  kernels_json["fused_gp_predict_mean_var"]["library_ms"][0])}
    for nn in N_VAR_ROUTE:
        if nn == N:
            continue
        Xn = torch.as_tensor(np.random.default_rng(nn).standard_normal((nn, 2)), **f32)
        gp_n = gp_core.condition(kern_grid, Xn, torch.sin(Xn), cache_k_inv=True)
        a_n, Ki_n = gp_n.alpha, gp_n.K_inv
        var_ms[nn] = (measured(lambda: pg.fused_gp_predict_mean_var(Xqg, Xn, a_n, Ki_n, ones2,
                                                                     2.0, 2.1))[0],
                      measured(lambda: dense_mean_var(Xn, a_n, Ki_n))[0])
    del gp_n, a_n, Ki_n
    g7, x7 = kernels_json["stationary_gram_panels"], kernels_json["stationary_gram_panels"]["extra"]
    shapes7 = {"ensemble_3d_gram": f"the 3-D ensemble's Grams, {E_3D} launches at n={N_3D}",
               "generic": f"stationary_gram on the solve's first panel, ({N_SOLVE}, {B})"}
    print(f"kernel #7 (device ms from CUPTI, mean of {REPS} / CUDA-event ms, median of {REPS}): "
          f"the N={N_SOLVE} solve's Gram, one launch, {g7['ms'][0]:.4f}/{g7['ms'][1]:.4f}, twin "
          f"{g7['plain_ms'][0]:.4f}, bound {g7['bound'][0]:.4f}; "
          + "; ".join(f"{what} {x7[k + '_ms']:.4f}/{x7[k + '_event_ms']:.4f}, twin "
                      f"{x7[k + '_plain_ms']:.4f}, bound {x7[k + '_bound_ms']:.4f}"
                      for k, what in shapes7.items())
          + f"; ptxas {g7['ptxas']}; SM clock now {sm_clocks()} {tag}", flush=True)
    pm_ms = cuda_ms(lambda: gp_core.predict(gp_grid, Xqg))[0]
    pv_ms = cuda_ms(lambda: gp_core.predict(gp_grid, Xqg, return_std=True))[0]
    fmt = lambda t: "-" if t is None else f"{t[0]:.4f}/{t[1]:.4f}"
    print(f"times (device ms from CUPTI, mean of {REPS} / CUDA-event ms of the call, median of "
          f"{REPS}): "
          + "; ".join(f"{name} {v['shape']}: kernel {fmt(v['ms'])}, twin {fmt(v['plain_ms'])}, "
                      f"library {fmt(v['library_ms'])}, "
                      + (f"parent design {fmt(v['parent_ms'])}, " if "parent_ms" in v else "")
                      + f"bound {v['bound'][0]:.4f} by {v['bound'][1]}"
                      for name, v in kernels_json.items())
          + f"; fused_gp_predict_mean_var vs the dense path at Nq={Nq} (device ms): "
          + ", ".join(f"N={nn}: {var_ms[nn][0]:.4f} vs {var_ms[nn][1]:.4f} (predict(return_std) "
                      f"takes the {'kernel' if route(nn, True) else 'dense path'})"
                      for nn in N_VAR_ROUTE)
          + f", FUSED_MEAN_VAR_MAX_N = {gp_core.FUSED_MEAN_VAR_MAX_N}"
          + f"; the mean's bound counts {Nq * N} exponentials at {SFU_PER_S:.4g}/s beside "
          + f"{gram_flops(Nq, N, D) + 2 * Nq * N * P} f32 operations; SM clock now "
          + f"{sm_clocks()}"
          + f"; end to end (CUDA events): phase 8 gram_cholesky_solve N={N_SOLVE} "
          f"{solve_ms:.4f} ms, phase 9 3-D ensemble {ens_ms:.4f} ms, phase 10 predict "
          f"{pm_ms:.4f} ms, predict(return_std) {pv_ms:.4f} ms {tag}", flush=True)

    # 12. the fused small-LML kernels against their twins and the f64 formula
    lml_errs = {name: [0.0, 0.0] for name in ("small_lml_value_grad", "small_lml_value_grad_md",
                                              VALUE_ONLY)}

    def note(out):
        for name, (diff, ex) in out.items():
            lml_errs[name] = [max(lml_errs[name][0], diff), max(lml_errs[name][1], ex)]

    for case in LML_CASES + LML_WIDE_CASES:
        note(check_lml_case(device, case, E_LML_SMALL))
    main_cases = {"small_lml_value_grad": ("rbf", N_MAIN, 2, 1, 2, True),
                  "small_lml_value_grad_md": ("rbf", N_MAIN, 2, 2, 2, True)}
    lanes = {"small_lml_value_grad": HMC_CHAINS, "small_lml_value_grad_md": E_FIT * (RESTARTS + 1)}
    main_errs = {}
    for name, case in main_cases.items():
        for E in (lanes[name], lanes[name] + 3):
            out = check_lml_case(device, case, E, seed=E)
            note({name: out[name]})
            main_errs.setdefault(name, out[name][0])
    # kernel #2 at the shape of phases 21 and 23 (fit_jit's six lanes on the
    # bench residual, n=20 D=2 p=2: the "n<=24 D<=2 p<=2" instance), both n_ls
    jit_cases = [("rbf", N_MAIN, 2, 2, n_ls, True) for n_ls in (1, 2)]
    for case in jit_cases:
        note({"small_lml_value_grad":
              check_lml_case(device, case, JIT_RESTARTS + 1)["small_lml_value_grad"]})
    lml_fault = lml_faults(device, E_FIT)
    lml_fault["value-only lanes 0 and 1 datasets swapped"] = lml_value_faults(device, E_FIT)
    print(f"fused LML kernels vs twins and the f64 formula (bound {LML_VAL_REL:g}*value terms, "
          f"{LML_GRAD_REL:g}*gradient terms) over {len(LML_CASES)} cases (4 families, n in "
          f"8/20/32, D 2/3, p 1/3, both n_ls, noise or not) and {len(LML_WIDE_CASES)} past eight "
          f"coordinates or columns (D, p in 12/1, 2/12, 12/12, n 20/32, both n_ls) at "
          f"E={E_LML_SMALL} and the paths' E "
          + ", ".join(f"{lanes[k]} and {lanes[k] + 3}" for k in lanes)
          + f", small_lml_value_grad at fit_jit's n={N_MAIN} D=2 p=2 (n_ls 1 and 2) on "
          f"{JIT_RESTARTS + 1} lanes: "
          + ", ".join(f"{k} |kernel-twin| max {d:.3g}, error/bound max {ex:.3g}"
                      for k, (d, ex) in lml_errs.items() if k != VALUE_ONLY)
          + f"; the value-only instance {VALUE_ONLY} bit for bit the full kernel's value at "
          f"every shape (value error/bound max {lml_errs[VALUE_ONLY][1]:.3g})"
          + "; planted faults rejected (and a value-only result one ulp off), error/bound "
          + ", ".join(f"{k} {ex:.3g}" for k, ex in lml_fault.items()) + f" {tag}", flush=True)

    # times of kernels #2 and #3 at their paths' shapes, before the traces of
    # phases 13-14 (after phase 14's, sessions lose kernel records)
    from gaussian_process_transportation_tpu_torch.ops import fused_lml as fl

    for name, case in main_cases.items():
        fam, n, D, p, n_ls, noise = case
        per_lane = name.endswith("_md")
        X_, Y_, th_ = lml_inputs(device, lanes[name], n, D, p, n_ls, noise, per_lane)
        kern_fn, twin_fn = getattr(fl, name), getattr(fl, name + "_ref")
        L_ = lanes[name]
        data_bytes = (n * D + n * p) * 4 * (L_ if per_lane else 1)
        kernels_json[name] = dict(
            source=f"{PKG}/csrc/fused_lml.cu",
            replaces=f"{TPU_PKG}/ops/fused_lml.py:{279 if per_lane else 88}",
            max_abs_err=main_errs[name],
            bound=bound(data_bytes + L_ * (2 * th_.shape[0] + 1) * 4, L_ * lml_flops(n, D, p)),
            shape=f"lanes={L_} n={n} D={D} p={p}",
            calls=(lambda f=kern_fn, a=(X_, Y_, th_, fam, n_ls, noise): f(*a),
                   lambda f=twin_fn, a=(X_, Y_, th_, fam, n_ls, noise): f(*a), None))
        kernels_json[name].update(timed(*kernels_json[name].pop("calls")))
        if per_lane:  # the value-only instance at the same inputs
            vo_fn = lambda a=(X_, Y_, th_, fam, n_ls, noise): fl._small_lml_value_md(*a)
            kernels_json[name].update(
                value_only_ms=measured(vo_fn),
                value_only_bound=bound(data_bytes + L_ * (th_.shape[0] + 1) * 4,
                                       L_ * lml_value_flops(n, D, p)))
    clocks = sm_clocks()
    print("times of the fused LML kernels (device ms from CUPTI / CUDA-event ms): "
          + "; ".join(f"{name} {kernels_json[name]['shape']}: kernel "
                      f"{fmt(kernels_json[name]['ms'])}, twin {fmt(kernels_json[name]['plain_ms'])}"
                      f", bound {kernels_json[name]['bound'][0]:.4f} by "
                      f"{kernels_json[name]['bound'][1]}" for name in main_cases)
          + f"; {VALUE_ONLY} (the same lanes) "
          + fmt(kernels_json["small_lml_value_grad_md"]["value_only_ms"])
          + f", bound {kernels_json['small_lml_value_grad_md']['value_only_bound'][0]:.4f}; "
          f"clocks.sm, clocks.max.sm just after: {clocks} {tag}", flush=True)

    # 13. the per-member-hyperopt transport at full width
    from gaussian_process_transportation_tpu_torch.models import affine as affine_core
    from gaussian_process_transportation_tpu_torch.parallel import samplers

    T13 = fit_targets(S1, E_FIT)
    T13d = torch.as_tensor(T13, **f32)
    kern13 = fit_kernel(**f32)
    fitted = []
    real_fit = gp_core.fit_ensemble_fused

    def capture_fit(*args, **kwargs):
        fitted.append(real_fit(*args, **kwargs))
        return fitted[-1]

    def opt_path():
        return gpt.fit_and_transport_batched_opt(
            kern13, Sd, T13d, Xd, dXd, n_restarts=RESTARTS, maxiter=MAXITER,
            generator=torch.Generator(device=device).manual_seed(0))

    gp_core.fit_ensemble_fused = capture_fit
    try:
        torch.cuda.reset_peak_memory_stats(device)
        res13, counts13 = drive(opt_path)
    finally:
        gp_core.fit_ensemble_fused = real_fit
    peak13 = torch.cuda.max_memory_allocated(device) / 2**30
    thetas13 = fitted[0][0]
    want13 = 1 + MAXITER * (6 + 1)  # _lbfgs_elast's max_backtrack = 6
    expect_launches("fit_and_transport_batched_opt", counts13, {
        "small_lml_value_grad_md": want13, VALUE_ONLY: MAXITER * 6, "spd_inverse_elast_fused": 1,
        "transport_apply_rbf": 1, "small_lml_value_grad": 0})
    for name in ("traj", "std", "delta", "delta_var", "min_abs_det"):
        if not torch.isfinite(getattr(res13, name)).all():
            raise AssertionError(f"fit_and_transport_batched_opt field {name} has non-finite values")
    f64d = dict(dtype=torch.float64, device=device)
    kern13_64 = fit_kernel(**f64d)
    S64, T64 = torch.as_tensor(S, **f64d), torch.as_tensor(T13, **f64d)
    aff64 = affine_core.fit_batched(S64, T64)
    src64 = affine_core.predict(aff64, S64)
    lml0 = gp_core.log_marginal_likelihood(kern13_64, src64, T64 - src64)
    lml1 = gp_core.log_marginal_likelihood(kern13_64.with_theta(thetas13.double()), src64,
                                           T64 - src64)
    gain = (lml1 - lml0).min().item()
    if not gain >= -1e-3:
        raise AssertionError(f"a member's fitted LML is below its initial one by {-gain:.3g}")
    kern13_cpu = fit_kernel(**f64)
    rel13 = {}
    for e in (0, E_FIT // 2, E_FIT - 1):
        one = gpt.fit_and_transport(kern13_cpu.with_theta(thetas13[e].double().cpu()),
                                    *(torch.as_tensor(a, **f64) for a in (S, T13[e], X, dX)))
        for name in ("traj", "std", "delta", "delta_var"):
            got = getattr(res13, name)[e].double().cpu()
            rel13[f"{name}[{e}]"] = (got - getattr(one, name)).abs().max().item() / scale
    if max(rel13.values()) >= TRAJ_TOL:
        raise AssertionError(f"fit_and_transport_batched_opt differs from the f64 CPU run: {rel13}")
    del res13
    src32 = affine_core.predict(affine_core.fit_batched(Sd, T13d), Sd)
    fit_only = lambda: gp_core.fit_ensemble_fused(
        kern13, src32, T13d - src32, n_restarts=RESTARTS, maxiter=MAXITER,
        generator=torch.Generator(device=device).manual_seed(0))
    # the line search's candidates through the full kernel instead of the
    # value-only instance: the same fitted theta and LML, bit for bit
    th_a, lml_a = fit_only()
    real_value = fl._small_lml_value_md
    fl._small_lml_value_md = lambda *a, **k: fl.small_lml_value_grad_md(*a, **k)[0]
    try:
        th_b, lml_b = fit_only()
    finally:
        fl._small_lml_value_md = real_value
    if not (torch.equal(th_a, th_b) and torch.equal(lml_a, lml_b)):
        raise AssertionError("fit_ensemble_fused's theta or LML differ with the value-only route "
                             f"and without it: |dtheta| max {(th_a - th_b).abs().max().item():.3g}")
    lml_b64 = gp_core.log_marginal_likelihood(kern13_64.with_theta(th_b.double()), src64,
                                              T64 - src64)
    gain_b = (lml_b64 - lml0).min().item()
    if not gain_b >= -1e-3:
        raise AssertionError(f"without the value-only route a member's fitted LML is below its "
                             f"initial one by {-gain_b:.3g}")
    fit_ms, fit_all = cuda_ms(fit_only)
    opt_ms, opt_all = cuda_ms(opt_path)
    brk13 = path_breakdown(opt_path, "lml_kernel")
    brk_fit = path_breakdown(fit_only, "lml_kernel")
    print(f"per-member hyperopt transport: fit_and_transport_batched_opt E={E_FIT} Q={Q_MAIN} "
          f"n={N_MAIN} f32, {RESTARTS} restarts, maxiter {MAXITER} ({E_FIT * (RESTARTS + 1)} "
          f"lanes): small_lml_value_grad_md launches {counts13['small_lml_value_grad_md']} (of "
          f"them value-only {counts13[VALUE_ONLY]}), "
          f"spd_inverse_elast_fused {counts13['spd_inverse_elast_fused']}; fields finite; fitted "
          f"LML - initial LML (f64) min {gain:.4g} (>= -1e-3); fit_ensemble_fused's theta and LML "
          f"bit for bit the same with the value-only route and without it (LML gain min "
          f"{gain_b:.4g}); err/max|X| vs f64 CPU "
          "fit_and_transport at the fitted kernel "
          + ", ".join(f"{k}: {v:.3g}" for k, v in rel13.items())
          + f" (< {TRAJ_TOL}); fit_ensemble_fused {fit_ms:.4f} ms {fit_all} = fits_per_s "
          f"{E_FIT / (fit_ms / 1e3):.1f}; the path {opt_ms:.4f} ms {opt_all} = traj/s "
          f"{E_FIT / (opt_ms / 1e3):.1f} (medians of {REPS}, CUDA events); peak memory "
          f"{peak13:.3f} GiB; {fmt_breakdown(brk13)}; fit_ensemble_fused alone: "
          f"{fmt_breakdown(brk_fit)} {tag}", flush=True)

    # 14. the HMC hyperposterior at bench.py's hmc workload
    X14, Y14 = (torch.as_tensor(a, **f32) for a in hmc_inputs())
    kern14 = K.Constant(1.0) * K.RBF(torch.ones(2, **f32)) + K.White(0.01)
    hmc_kw = dict(num_chains=HMC_CHAINS, num_warmup=HMC_WARMUP, num_samples=HMC_SAMPLES,
                  num_leapfrog=HMC_LEAPFROG)

    def hmc_path(use_kernel=None):
        return samplers.sample_gp_posterior(kern14, X14, Y14, seed=0, use_kernel=use_kernel,
                                            **hmc_kw)

    (s14, d14), counts14 = drive(hmc_path)
    want14 = 1 + (HMC_WARMUP + HMC_SAMPLES) * HMC_LEAPFROG
    expect_launches("sample_gp_posterior", counts14, {"small_lml_value_grad": want14,
                                                      "small_lml_value_grad_md": 0})
    if s14.shape != (HMC_CHAINS, HMC_SAMPLES, 4) or not torch.isfinite(s14).all():
        raise AssertionError(f"HMC samples {tuple(s14.shape)} not finite or misshapen")
    fam14, nls14, noise14, perm14 = gp_core.small_lml_theta_layout(kern14)
    th_final = s14[:, -1, :][:, torch.as_tensor(perm14, device=device)].T.contiguous()
    v14, g14 = fl.small_lml_value_grad(X14, Y14, th_final, fam14, nls14, noise14, 1e-10)
    ex14 = lml_excess(v14, g14, lml_f64(X14[None], Y14[None], th_final, fam14, nls14, noise14,
                                        1e-10))
    if not max(ex14) < 1:
        raise AssertionError(f"kernel #2 at the chains' final positions: error/bound {ex14}")
    s64, _ = samplers.sample_gp_posterior(kern14, X14, Y14, seed=0,
                                          **dict(hmc_kw, num_chains=HMC_CHAINS // 4))
    if not torch.equal(s64, s14[:HMC_CHAINS // 4]):
        raise AssertionError(f"a run of {HMC_CHAINS // 4} chains differs from the first "
                             f"{HMC_CHAINS // 4} of {HMC_CHAINS}")
    s_twin, _ = hmc_path(use_kernel=False)
    m_k = s14.reshape(-1, 4).double().mean(0)
    flat_t = s_twin.reshape(-1, 4).double()
    m_t, sd_t = flat_t.mean(0), flat_t.std(0)
    if not ((m_k - m_t).abs() < 0.8 * sd_t + 0.3).all():
        raise AssertionError(f"HMC posterior means {m_k.tolist()} vs the twin run's "
                             f"{m_t.tolist()} (sd {sd_t.tolist()})")
    hmc_ms, hmc_all = cuda_ms(hmc_path, reps=3)
    brk14 = path_breakdown(hmc_path, "lml_kernel")
    print(f"HMC hyperposterior: sample_gp_posterior {HMC_CHAINS} chains, {HMC_WARMUP}+"
          f"{HMC_SAMPLES} steps of {HMC_LEAPFROG} leapfrog, n=20 D=2 p=1 f32: "
          f"small_lml_value_grad launches {counts14['small_lml_value_grad']}; samples finite; "
          f"kernel at the final positions error/bound vs f64 value {ex14[0]:.3g}, gradient "
          f"{ex14[1]:.3g}; {HMC_CHAINS // 4} chains alone equal the first {HMC_CHAINS // 4} of "
          f"{HMC_CHAINS} bit for bit; posterior means {[round(v, 4) for v in m_k.tolist()]} vs the twin "
          f"run's {[round(v, 4) for v in m_t.tolist()]} (within 0.8*sd+0.3); mean accept "
          f"{d14['mean_accept'].mean().item():.4f}; {hmc_ms:.4f} ms {hmc_all} (median of 3, "
          f"CUDA events) = hmc_samples_per_s {HMC_CHAINS * HMC_SAMPLES / (hmc_ms / 1e3):.1f}; "
          f"{fmt_breakdown(brk14)} {tag}", flush=True)

    # 15. the façade with the default optimizer
    from gaussian_process_transportation_tpu_torch import GaussianProcessTransportation

    kern15 = K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, **f32)) + K.White(0.01)
    tr = GaussianProcessTransportation(kernel_transport=kern15)
    tr.source_distribution, tr.target_distribution = S, S1
    tr.training_traj, tr.training_delta = X, dX
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit_transportation()
    tr.apply_transportation()
    torch.cuda.synchronize()
    wall15 = time.perf_counter() - t0
    for name in ("training_traj", "std", "training_delta", "var_vel_transported"):
        value = getattr(tr, name)
        if value.device.type != "cuda" or not torch.isfinite(value).all():
            raise AssertionError(f"façade field {name} is not finite on the card")
    if not tr.std.min().item() > 0:
        raise AssertionError(f"façade std not positive (min {tr.std.min().item():.3g})")
    Sa = affine_core.predict(tr.method.affine, Sd).double()  # the fit's own inputs, in f64
    delta15 = tr.method.delta_distribution.double()
    l0 = gp_core.log_marginal_likelihood(kern15, Sa, delta15).item()
    l1 = gp_core.log_marginal_likelihood(tr.method.delta_map.kernel_, Sa, delta15).item()
    if not l1 >= l0:
        raise AssertionError(f"façade fitted LML {l1:.6g} below the initial {l0:.6g}")
    print(f"façade: GaussianProcessTransportation on the card, C(10)*RBF(4)+White(0.01), "
          f"L-BFGS-B with 5 restarts, Q={Q_MAIN} n={N_MAIN} f32: fields finite, std min "
          f"{tr.std.min().item():.4g} > 0, LML (f64) {l0:.6g} -> {l1:.6g}, "
          f"diffeomorphic {tr.method.is_diffeomorphic}; fit + apply {wall15:.3f} s wall {tag}",
          flush=True)

    # 16. the blocked hyperparameter fit at scripts/bench_blocked_lml.py's size
    from gaussian_process_transportation_tpu_torch.ops import blocked_lml as bll

    Xf, Yf, th16 = blocked_fit_inputs(device)
    jit16 = gp_core._eff_jitter(torch.float32, 1e-10)

    def lml_step():
        return bll.blocked_lml_value_and_grad(Xf, Yf, "rbf", th16[0], th16[1:1 + FIT_D],
                                              th16[1 + FIT_D], jitter=jit16, block=BLOCK)

    panels16 = -(-FIT_N // BLOCK)
    (v16, g16), counts16a = drive(lml_step)
    expect_launches("blocked_lml_value_and_grad", counts16a, {
        "stationary_gram_panels": 1, "factor_panel": panels16, "stationary_gram": 0})
    ref16 = blocked_lml_f64(Xf, Yf, th16, jit16)
    ex16 = blocked_excess(v16, g16, ref16)
    if not max(ex16) < 1:
        raise AssertionError(f"blocked LML at N={FIT_N}: error/bound vs f64 value {ex16[0]:.3g}, "
                             f"gradient {ex16[1]:.3g}")
    g_flat = torch.cat([g16[0].reshape(1), g16[1], g16[2].reshape(1)])
    worst = int(ref16[1].abs().argmax())
    g_bad = g_flat.clone()
    g_bad[worst] = -g_bad[worst]
    fault16 = blocked_excess(v16, (g_bad[0], g_bad[1:1 + FIT_D], g_bad[1 + FIT_D]), ref16)[1]
    if not fault16 >= 1:
        raise AssertionError(f"the blocked LML bound accepts θ {worst}'s gradient negated "
                             f"(error/bound {fault16:.3g})")
    lml_ms16, lml_all16 = cuda_ms(lml_step)
    tflops16 = (3 * FIT_N**3 / 3 + 2 * FIT_N**2 * FIT_D + 8 * FIT_N**2) / (lml_ms16 / 1e3) / 1e12
    kern16 = K.Constant(2.0) * K.RBF(torch.ones(FIT_D, **f32)) + K.White(0.1)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    gp16, counts16, opt16 = drive_fit(lambda: gp_core.fit_blocked(kern16, Xf, Yf,
                                                                  maxiter=FIT_MAXITER, block=BLOCK))
    fit_s16 = time.perf_counter() - t0
    peak16 = torch.cuda.max_memory_allocated(device) / 2**30
    n_eval = opt16["evaluations"]
    expect_launches("fit_blocked", counts16, {  # every evaluation, then condition_blocked
        "stationary_gram_panels": n_eval + 1, "factor_panel": panels16 * (n_eval + 1),
        "stationary_gram": 0})
    th_fit = gp16.kernel.theta.to(device=device, dtype=torch.float32)
    lml_fit = blocked_lml_f64(Xf, Yf, th_fit, jit16)[0]
    if not lml_fit >= ref16[0] + ref16[2]:  # at least the start, and moved past the f32 bound
        raise AssertionError(f"fit_blocked's LML {lml_fit:.6g} is not above the initial "
                             f"{ref16[0]:.6g} by the value's bound {ref16[2]:.3g}")
    print(f"blocked fit: blocked_lml_value_and_grad N={FIT_N} D={FIT_D} rbf block={BLOCK} f32: "
          f"stationary_gram_panels {counts16a['stationary_gram_panels']}, factor_panel "
          f"{counts16a['factor_panel']} launches an evaluation; value and gradient vs the f64 "
          f"dense formula error/bound {ex16[0]:.3g}, {ex16[1]:.3g} (value {v16.item():.6g} vs "
          f"{ref16[0]:.6g}); planted fault (theta {worst}'s gradient negated) rejected at "
          f"{fault16:.3g}; one value+grad {lml_ms16:.4f} ms {lml_all16} (median of {REPS}, CUDA "
          f"events) = {tflops16:.3f} TFLOP/s (3N^3/3 model); fit_blocked maxiter {FIT_MAXITER}: "
          f"{fit_text(opt16)}, "
          f"{counts16['stationary_gram_panels']} Gram launches and {counts16['factor_panel']} "
          f"factor_panel (condition_blocked's included), LML (f64) {ref16[0]:.6g} -> "
          f"{lml_fit:.6g}, theta {[round(v, 4) for v in th_fit.tolist()]}, {fit_s16:.3f} s wall, "
          f"peak memory {peak16:.3f} GiB {tag}", flush=True)
    del gp16, Xf, Yf

    # 17. the NUTS hyperposterior at bench.py's hmc workload
    def nuts_path(num_chains=HMC_CHAINS):
        return samplers.sample_gp_posterior(kern14, X14, Y14, seed=0, num_chains=num_chains,
                                            num_warmup=HMC_WARMUP, num_samples=HMC_SAMPLES,
                                            algorithm="nuts")

    (s17, d17), counts17, first17 = drive_timed(nuts_path)
    if counts17["small_lml_value_grad"] < 1 + HMC_WARMUP + HMC_SAMPLES or \
            counts17["small_lml_value_grad_md"]:
        raise AssertionError(f"the NUTS route launched kernel #2 "
                             f"{counts17['small_lml_value_grad']} times (and #3 "
                             f"{counts17['small_lml_value_grad_md']})")
    if s17.shape != (HMC_CHAINS, HMC_SAMPLES, 4) or not torch.isfinite(s17).all():
        raise AssertionError(f"NUTS samples {tuple(s17.shape)} not finite or misshapen")
    s17b, _ = nuts_path(NUTS_CHECK_CHAINS)
    if not torch.equal(s17b, s17[:NUTS_CHECK_CHAINS]):
        raise AssertionError(f"a NUTS run of {NUTS_CHECK_CHAINS} chains differs from the first "
                             f"{NUTS_CHECK_CHAINS} of {HMC_CHAINS}")
    m17 = s17.reshape(-1, 4).double().mean(0)
    sd14 = s14.reshape(-1, 4).double().std(0)
    if not ((m17 - m_k).abs() < 0.8 * sd14 + 0.3).all():
        raise AssertionError(f"NUTS posterior means {m17.tolist()} vs phase 14's HMC "
                             f"{m_k.tolist()} (sd {sd14.tolist()})")
    nuts_ms = first17  # one run, the counted one (the whole run's length is held)
    print(f"NUTS hyperposterior: sample_gp_posterior(algorithm='nuts') {HMC_CHAINS} chains, "
          f"{HMC_WARMUP}+{HMC_SAMPLES} steps, max_depth 8, n=20 D=2 p=1 f32: small_lml_value_grad "
          f"launches {counts17['small_lml_value_grad']}; samples finite; {NUTS_CHECK_CHAINS} chains "
          f"alone equal the first {NUTS_CHECK_CHAINS} of {HMC_CHAINS} bit for bit; posterior means "
          f"{[round(v, 4) for v in m17.tolist()]} vs phase 14's HMC "
          f"{[round(v, 4) for v in m_k.tolist()]} (within 0.8*sd+0.3); mean tree depth "
          f"{d17['mean_tree_depth'].mean().item():.3f}, mean accept "
          f"{d17['mean_accept'].mean().item():.4f}; {nuts_ms:.4f} ms "
          f"(the counted run, CUDA events) = nuts_samples_per_s "
          f"{HMC_CHAINS * HMC_SAMPLES / (nuts_ms / 1e3):.1f} {tag}", flush=True)
    del s17b

    # 18. the generic route past the fused one (n = 40)
    rng18 = np.random.default_rng(0)
    X18 = rng18.standard_normal((GENERIC_N, 2)).astype(np.float32)
    Y18 = (np.sin(X18[:, :1]) + 0.1 * rng18.standard_normal((GENERIC_N, 1))).astype(np.float32)
    X18, Y18 = torch.as_tensor(X18, device=device), torch.as_tensor(Y18, device=device)

    def generic_path():
        return samplers.sample_gp_posterior(kern14, X18, Y18, seed=0, num_chains=GENERIC_CHAINS,
                                            num_warmup=GENERIC_STEPS, num_samples=GENERIC_STEPS,
                                            num_leapfrog=GENERIC_LEAPFROG)

    (s18, d18), counts18, first18 = drive_timed(generic_path)
    if any(counts18.values()):
        raise AssertionError(f"the generic route launched a hand kernel: {counts18}")
    if s18.shape != (GENERIC_CHAINS, GENERIC_STEPS, 4) or not torch.isfinite(s18).all():
        raise AssertionError(f"generic-route samples {tuple(s18.shape)} not finite or misshapen")
    gen_ms = first18  # one run: the counted one (the whole run's length is held)
    print(f"generic route: sample_gp_posterior n={GENERIC_N} (past the fused route's 32) "
          f"{GENERIC_CHAINS} chains of HMC, {GENERIC_STEPS}+{GENERIC_STEPS} steps of "
          f"{GENERIC_LEAPFROG} leapfrog, torch.func.vmap of the LML's gradient, f32: no hand-kernel "
          f"launch; samples finite, mean accept {d18['mean_accept'].mean().item():.4f}; "
          f"{gen_ms:.4f} ms (the counted run, CUDA events) = "
          f"{GENERIC_CHAINS * GENERIC_STEPS / (gen_ms / 1e3):.1f} samples/s {tag}", flush=True)

    # 19. a checkpointed run over kernel #2, killed after one segment and resumed
    import tempfile
    from gaussian_process_transportation_tpu_torch.parallel import checkpointed as ckpt

    lp19, q19 = fused_posterior(kern14, X14, Y14, HMC_CHAINS)
    ck_kw = dict(num_warmup=HMC_WARMUP, num_samples=HMC_SAMPLES, num_leapfrog=HMC_LEAPFROG)
    whole19, info19 = samplers.hmc_batched(lp19, q19, seed=0, **ck_kw)

    class Killed(Exception):
        pass

    real_save = ckpt.save_pytree
    saved = []

    def save_then_die(path_, tree, metadata=None):
        real_save(path_, tree, metadata)
        saved.append(metadata["done"])
        if len(saved) == 2:  # the warm-up's save, then the first segment's
            raise Killed

    with tempfile.TemporaryDirectory() as td:
        path19 = str(td) + "/hmc"
        ckpt.save_pytree = save_then_die
        try:
            ckpt.run_hmc_batched_checkpointed(lp19, q19, 0, path19, segment=CKPT_SEGMENT, **ck_kw)
            raise AssertionError("the checkpointed run was not stopped after its first segment")
        except Killed:
            pass
        finally:
            ckpt.save_pytree = real_save
        (res19, info19r), counts19 = drive(lambda: ckpt.run_hmc_batched_checkpointed(
            lp19, q19, 0, path19, segment=CKPT_SEGMENT, **ck_kw))
    want19 = (HMC_SAMPLES - CKPT_SEGMENT) * HMC_LEAPFROG
    expect_launches("the resumed checkpointed run", counts19, {"small_lml_value_grad": want19})
    if not (torch.equal(res19, whole19) and torch.equal(info19r["step_size"], info19["step_size"])):
        raise AssertionError("the resumed checkpointed run differs from the uninterrupted one: "
                             f"|d| max {(res19 - whole19).abs().max().item():.3g}")
    print(f"checkpointed run: run_hmc_batched_checkpointed over kernel #2, {HMC_CHAINS} chains, "
          f"{HMC_WARMUP}+{HMC_SAMPLES} steps, segments of {CKPT_SEGMENT}: stopped after the saves "
          f"{saved}, resumed in a fresh call ({counts19['small_lml_value_grad']} launches of #2), "
          f"samples and step sizes equal to the uninterrupted hmc_batched run bit for bit {tag}",
          flush=True)
    del whole19, res19

    # 20. SMC at bench.py's smc workload, and particles of the bench transport
    from gaussian_process_transportation_tpu_torch.parallel import smc

    p20, ll20 = smc_inputs(device)

    def smc_path():
        gen = torch.Generator(device=device).manual_seed(0)
        p, esss = p20, []
        for _ in range(SMC_STEPS):
            p, ess = smc.smc_step(p, ll20, gen)
            esss.append(ess)
        return p, torch.stack(esss)

    (p20b, ess20), counts20 = drive(smc_path)
    if any(counts20.values()):
        raise AssertionError(f"the SMC path launched a hand kernel: {counts20}")
    if not torch.isfinite(p20b.trajectories).all() or not torch.isfinite(p20b.log_weights).all():
        raise AssertionError("SMC particles or weights not finite")
    if not bool(((ess20 > 0) & (ess20 <= SMC_PARTICLES * (1 + 1e-5))).all()):
        raise AssertionError(f"SMC ESS outside (0, E]: {ess20.tolist()}")
    smc_ms, smc_all = cuda_ms(smc_path, reps=3)
    resampled = int((ess20 < 0.5 * SMC_PARTICLES).sum())
    kern20 = K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, **f32)) + K.White(0.01)

    def init_path():
        return smc.init_particles(kern20, Sd, S1d, Xd, SMC_PARTICLES,
                                  torch.Generator(device=device).manual_seed(0))

    parts20 = init_path()
    aff20, gp20 = gpt.fit_pipeline(kern20, Sd, S1d)
    pos20 = affine_core.predict(aff20, Xd)
    mean20, cov20 = gp_core.predict_cov(gp20, pos20)
    se20 = torch.sqrt(torch.clamp(torch.diagonal(cov20), min=0))[:, None] / math.sqrt(SMC_PARTICLES)
    dev20 = (parts20.trajectories.mean(0) - (pos20 + mean20)).abs()
    if parts20.trajectories.shape != (SMC_PARTICLES, Q_MAIN, 2) or \
            not torch.isfinite(parts20.trajectories).all() or not (dev20 <= 5 * se20 + 1e-3).all():
        raise AssertionError(f"init_particles: shape {tuple(parts20.trajectories.shape)}, mean off "
                             f"by up to {(dev20 / (5 * se20 + 1e-3)).max().item():.3g} of its bound")
    init_ms, _ = cuda_ms(init_path, reps=3)
    print(f"SMC: smc_step x {SMC_STEPS} on {SMC_PARTICLES} particles of {SMC_TRAJ} points (D=2, "
          f"goal (1, 1) at scale 2, f32): particles and weights finite, ESS in (0, E] "
          f"(min {ess20.min().item():.1f}, {resampled} of {SMC_STEPS} steps resampled, one host "
          f"read a step); {smc_ms:.4f} ms {smc_all} (median of 3, CUDA events) = "
          f"smc_particles_per_s {SMC_PARTICLES * SMC_STEPS / (smc_ms / 1e3):.1f}; init_particles "
          f"on the bench transport's S, S1 and X (Q={Q_MAIN}) with {SMC_PARTICLES} particles: "
          f"finite, mean within 5 standard errors of gamma(X) + the posterior mean, "
          f"{init_ms:.4f} ms (median of 3) {tag}", flush=True)
    del p20, p20b, parts20

    # 21. fit_jit: the restarts of one dataset as lanes of kernel #2
    src21, res21 = residual_inputs(device, torch.float32)
    kern21 = fit_kernel(**f32)
    lanes21 = JIT_RESTARTS + 1

    def jit_path():
        return gp_core.fit_jit(kern21, src21, res21, n_restarts=JIT_RESTARTS,
                               generator=torch.Generator().manual_seed(0), maxiter=JIT_MAXITER)

    gp21, counts21, opt21 = drive_fit(jit_path)
    # one launch for each evaluation of all lanes: the iterations' and the
    # line searches', then the final value of every lane
    expect_launches("fit_jit", counts21, {"small_lml_value_grad": opt21["evaluations"],
                                          "small_lml_value_grad_md": 0})
    if opt21["iterations"] != JIT_MAXITER or \
            opt21["evaluations"] != JIT_MAXITER + opt21["rounds"] + 1:
        raise AssertionError(f"fit_jit's L-BFGS: {fit_text(opt21)} at maxiter {JIT_MAXITER}")
    src64, res64 = residual_inputs("cpu", torch.float64)
    kern21_64 = fit_kernel(**f64)
    gp21_64 = gp_core.fit_jit(kern21_64, src64, res64, n_restarts=JIT_RESTARTS,
                              generator=torch.Generator().manual_seed(0), maxiter=JIT_MAXITER)
    lml21 = lambda k: gp_core.log_marginal_likelihood(k, src64, res64).item()
    l21_start = lml21(kern21_64)
    l21_card = lml21(kern21_64.with_theta(gp21.kernel.theta.double().cpu()))
    l21_cpu = lml21(gp21_64.kernel)
    if not (l21_card >= l21_start - 1e-3 and abs(l21_card - l21_cpu) <= 1e-3 * abs(l21_cpu)):
        raise AssertionError(f"fit_jit's LML (f64) {l21_card:.6g}: start {l21_start:.6g}, the f64 "
                             f"CPU fit {l21_cpu:.6g}")
    jit_ms, jit_all = cuda_ms(jit_path)
    # the façade with jit_fit on the card, against the f64 CPU transport at
    # the kernel it fitted (two separate fits part along the likelihood's
    # flat ridge at the noise floor; the transport at one kernel does not)
    tr21 = GaussianProcessTransportation(kernel_transport=fit_kernel(**f32), jit_fit=True)
    tr21.source_distribution, tr21.target_distribution = S, S1
    tr21.training_traj, tr21.training_delta = X, dX
    _, counts21f, opt21f = drive_fit(lambda: (tr21.fit_transportation(),
                                              tr21.apply_transportation()))
    expect_launches("the façade with jit_fit", counts21f,
                    {"small_lml_value_grad": opt21f["evaluations"], "small_lml_value_grad_md": 0})
    def facade_rel(theta):
        one = gpt.fit_and_transport(kern21_64.with_theta(theta),
                                    *(torch.as_tensor(a, **f64) for a in (S, S1, X, dX)),
                                    jitter=gp_core._eff_jitter(torch.float32, 1e-10))
        return {name: (getattr(tr21, attr).double().cpu() - getattr(one, name)).abs().max().item()
                / scale for name, attr in (("traj", "training_traj"), ("delta", "training_delta"),
                                           ("std", "std"))}

    th21 = tr21.method.delta_map.kernel_.theta.double().cpu()
    rel21 = facade_rel(th21)
    if not max(rel21.values()) < TRAJ_TOL:
        raise AssertionError(f"the façade with jit_fit differs from the f64 CPU transport at its "
                             f"fitted kernel: {rel21}")
    # the check must reject a transport at the wrong kernel: the card's θ
    # moved by 0.1 in log space, or the unfitted start (θ + 0.01 read 0.32
    # of the bound on an H100: the transport moves less than 1e-3 of max|X|
    # for it at the card's fit)
    fault21 = {"theta + 0.1": max(facade_rel(th21 + 0.1).values()) / TRAJ_TOL,
               "the start kernel": max(facade_rel(kern21_64.theta).values()) / TRAJ_TOL}
    if not min(fault21.values()) >= 1:
        raise AssertionError(f"the façade check passes a planted fault: error/bound {fault21}")
    print(f"fit_jit: the bench transport's residual n={N_MAIN} D=2 p=2, C(10)*RBF(4)+White(0.01) "
          f"with phase 13's bounds, f32, {JIT_RESTARTS} restarts ({lanes21} lanes), maxiter "
          f"{JIT_MAXITER}: {fit_text(opt21)}, small_lml_value_grad launches "
          f"{counts21['small_lml_value_grad']} a call; "
          f"LML (f64) start {l21_start:.6g} -> {l21_card:.6g}, the f64 CPU fit's {l21_cpu:.6g} "
          f"(within 1e-3 of it); {jit_ms:.4f} ms {jit_all} (median of {REPS}, CUDA events); the "
          f"façade with jit_fit=True on the bench inputs: {fit_text(opt21f)}, "
          f"{counts21f['small_lml_value_grad']} launches of #2, err/max|X| vs the f64 CPU "
          f"fit_and_transport at its fitted kernel "
          + ", ".join(f"{k}: {v:.3g}" for k, v in rel21.items()) + f" (< {TRAJ_TOL}); planted "
          f"faults rejected, error/bound " + ", ".join(f"{k} {v:.3g}" for k, v in fault21.items())
          + f" {tag}",
          flush=True)
    del tr21

    # 22. the active-learning GP at the original project's cap
    from gaussian_process_transportation_tpu_torch.models import gp_active as ga

    Xa_np, Ya_np = surface_inputs(AL_N)
    Xa, Ya = torch.as_tensor(Xa_np, device=device), torch.as_tensor(Ya_np, device=device)
    kern22 = al_kernel(**f32)
    noise22 = float(gp_core.white_noise_level(kern22))
    # the float32 picks against float64 ones at AL_CHECK_N
    m0c = AL_CHECK_M // 10
    seed_c = torch.randperm(AL_CHECK_N, generator=torch.Generator().manual_seed(0))[:m0c]
    i32 = ga.greedy_variance_select(kern22, Xa[:AL_CHECK_N], AL_CHECK_M, seed_c, noise=noise22)
    i64 = ga.greedy_variance_select(al_kernel(dtype=torch.float64, device=device),
                                    Xa[:AL_CHECK_N].double(), AL_CHECK_M, seed_c, noise=noise22)
    agree = (i32 == i64).cpu()
    first_diff = int((~agree).nonzero()[0]) if not bool(agree.all()) else AL_CHECK_M
    if first_diff < m0c + AL_CHECK_GREEDY:
        raise AssertionError(f"greedy_variance_select at N={AL_CHECK_N}: float32 and float64 picks "
                             f"part at {first_diff}, inside the seed and the first "
                             f"{AL_CHECK_GREEDY} greedy picks")
    sel22 = {}
    real_sel = ga.greedy_variance_select

    def timed_select(kernel, X_, m, seed_idx, noise=0.0):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        idx, d = ga._greedy_variance_select(kernel, X_, m, seed_idx, noise)
        ev[1].record()
        sel22.update(idx=idx, d=d, events=ev, host_s=time.perf_counter() - t22)
        return idx

    model22 = ga.GaussianProcessActiveLearning(
        kern22, n_samples_max=AL_M, blocked_kwargs=dict(maxiter=AL_MAXITER, block=BLOCK))
    ga.greedy_variance_select = timed_select
    try:
        torch.cuda.reset_peak_memory_stats(device)
        t22 = time.perf_counter()
        _, counts22, opt22 = drive_fit(lambda: model22.fit(Xa, Ya))
        fit_s22 = time.perf_counter() - t22
    finally:
        ga.greedy_variance_select = real_sel
    peak22 = torch.cuda.max_memory_allocated(device) / 2**30
    sel_ms = sel22["events"][0].elapsed_time(sel22["events"][1])
    n_eval22 = opt22["evaluations"]
    panels22 = -(-AL_M // BLOCK)
    expect_launches("GaussianProcessActiveLearning.fit", counts22, {  # evaluations + condition
        "stationary_gram_panels": n_eval22 + 1, "factor_panel": panels22 * (n_eval22 + 1),
        "stationary_gram": 0, "fused_gp_predict_mean": 0})
    gp22 = model22.state
    if gp22.chol is None or gp22.X.shape != (AL_M, 3):
        raise AssertionError("the active-learning fit did not take the blocked route on its subset")
    idx22 = sel22["idx"]
    if len(set(idx22.tolist())) != AL_M:
        raise AssertionError("the selection picked a point twice")
    kern22_64 = al_kernel(dtype=torch.float64, device=device)
    free22 = torch.ones(AL_N, dtype=torch.bool, device=device)
    free22[idx22] = False
    q22 = free22.nonzero()[:AL_SCHUR_POINTS, 0]
    schur22 = schur_f64(kern22_64, Xa, idx22, q22)
    ex22 = ((sel22["d"][q22].double() - schur22).abs().max()
            / (AL_SCHUR_TOL * (1.0 + noise22))).item()
    if not ex22 < 1:
        raise AssertionError(f"the selection's final variances vs the f64 Schur complement: "
                             f"error/bound {ex22:.3g}")
    Xsub64, Ysub64 = gp22.X.double(), gp22.Y.double()
    th22 = gp22.kernel.theta.double()
    lml22 = lambda k: gp_core.log_marginal_likelihood(k, Xsub64, Ysub64,
                                                      gp_core._eff_jitter(torch.float32, 1e-10))
    l22_start = lml22(kern22_64).item()
    l22_fit = lml22(gp22.kernel.with_theta(th22)).item()
    if not l22_fit >= l22_start:
        raise AssertionError(f"the active-learning fit's LML (f64) {l22_fit:.6g} is below its "
                             f"start {l22_start:.6g}")
    th22f = gp22.kernel.theta.to(**f32)
    step22_ms, step22_all = cuda_ms(lambda: bll.blocked_lml_value_and_grad(
        gp22.X, gp22.Y, "rbf", th22f[0], th22f[1:4], th22f[4],
        jitter=gp_core._eff_jitter(torch.float32, 1e-10), block=BLOCK), reps=3)
    Xq22 = torch.as_tensor(surface_inputs(AL_Q, seed=1)[0], device=device)
    (mean22, std22), counts22p = drive(lambda: model22.predict(Xq22))
    # a panel-form GP predicts with std through k_star, as JAX's does: no #5
    expect_launches("the active-learning predict", counts22p, {"fused_gp_predict_mean": 0})
    (dy22, ds22), counts22d = drive(lambda: model22.derivative(Xq22))
    if dy22.shape != (AL_Q, 3, 3) or ds22.shape != (AL_Q, 3, 1) or \
            not (torch.isfinite(dy22).all() and torch.isfinite(ds22).all()):
        raise AssertionError(f"derivative: {tuple(dy22.shape)}, {tuple(ds22.shape)} or not finite")
    gp22_64 = gp_core.condition(gp22.kernel.with_theta(th22), Xsub64, Ysub64,
                                gp_core._eff_jitter(torch.float32, 1e-10))
    mean64, std64 = gp_core.predict(gp22_64, Xq22.double(), return_std=True, epistemic_only=True)
    del gp22_64
    m_err22 = (mean22 - mean64).abs().max().item() / mean64.abs().max().item()
    s_err22 = (std22 - std64).abs().max().item()
    s_tol22 = 5e-3 * std64.abs().max().item() + 1e-3
    if not (m_err22 < 5e-3 and s_err22 < s_tol22):
        raise AssertionError(f"the active-learning predict vs f64: mean rel {m_err22:.3g} (tol "
                             f"5e-3), std {s_err22:.3g} (tol {s_tol22:.3g})")
    pred_ms, pred_all = cuda_ms(lambda: model22.predict(Xq22))
    der_ms, der_all = cuda_ms(lambda: model22.derivative(Xq22))
    print(f"active learning: GaussianProcessActiveLearning N={AL_N} (the cap {AL_M} + 20%) D=3 P=3 "
          f"on a smooth surface, C(1)*RBF(0.3)+White(0.01) f32, seed {AL_M // 10}: "
          f"greedy_variance_select {sel_ms:.1f} ms (CUDA events, one run; the host loop "
          f"{sel22['host_s']:.2f} s), float32 and float64 picks at N={AL_CHECK_N} m={AL_CHECK_M} "
          f"agree through {first_diff} (>= {m0c} seed + {AL_CHECK_GREEDY}); final variances at "
          f"{AL_SCHUR_POINTS} unselected points vs the f64 Schur complement error/bound "
          f"{ex22:.3g} (bound {AL_SCHUR_TOL}*(amp+noise)); fit_blocked on the subset (maxiter cut "
          f"to {AL_MAXITER}): {fit_text(opt22)}, stationary_gram_panels "
          f"{counts22['stationary_gram_panels']}, factor_panel "
          f"{counts22['factor_panel']} launches (condition_blocked's included), LML (f64) "
          f"{l22_start:.6g} -> {l22_fit:.6g}; one value+grad at N={AL_M} {step22_ms:.4f} ms "
          f"{step22_all} (median of 3, CUDA events); the whole fit {fit_s22:.3f} s wall, the fit after the "
          f"selection {fit_s22 - sel22['host_s']:.3f} s, peak memory {peak22:.3f} GiB; predict at "
          f"Q={AL_Q}: fused_gp_predict_mean {counts22p['fused_gp_predict_mean']}, mean rel "
          f"{m_err22:.3g} (< 5e-3), std {s_err22:.3g} (< {s_tol22:.3g}) vs the f64 predict from the "
          f"same subset, {pred_ms:.4f} ms {pred_all}; derivative (Q, 3, 3) and (Q, 3, 1) finite "
          f"({sum(counts22d.values())} hand-kernel launches), "
          f"{der_ms:.4f} ms {der_all} (medians of {REPS}, CUDA events) {tag}", flush=True)
    del model22, gp22, sel22, Xa, Ya, schur22, dy22, ds22
    torch.cuda.empty_cache()

    # 23. the diffeomorphism sweep with fit_jit, and the heteroscedastic field
    from gaussian_process_transportation_tpu_torch.transport import diffeo
    from gaussian_process_transportation_tpu_torch.transport import heteroscedastic as hs

    tr23 = diffeo.GaussianProcessTransportationDiffeo(jit_fit=True)
    tr23.source_distribution, tr23.target_distribution = S, S1
    tr23.training_traj, tr23.training_delta = X, dX
    trials23 = []  # (the trial's kernel, the kernel it fitted)
    each23 = tr23.diffeomorphism_error

    def recorded(c):
        err = each23(c)
        trials23.append((tr23.method.delta_map.kernel, tr23.method.delta_map.kernel_))
        return err

    tr23.diffeomorphism_error = recorded
    best23, counts23, sweep_ms, opt23 = drive_fit(
        lambda: tr23.optimize_diffeomorphism(n_trials=DIFFEO_TRIALS), runner=drive_timed)
    # a fit_jit a trial and one for the best: each evaluation one launch
    expect_launches("optimize_diffeomorphism", counts23, {
        "small_lml_value_grad": opt23["evaluations"], "small_lml_value_grad_md": 0})
    if opt23["iterations"] != (DIFFEO_TRIALS + 1) * JIT_MAXITER:
        raise AssertionError(f"the sweep's fits: {fit_text(opt23)}, expected "
                             f"{DIFFEO_TRIALS + 1} fits of {JIT_MAXITER} iterations")
    # each trial against the port's f64 CPU run at the kernel the card
    # fitted (float32's jitter floor included): the residual to 1e-3·(1 +
    # κ·ε32), κ the fitted Gram's condition number (a fit at the noise
    # floor reaches κ ~ 5e7, where float32 keeps a few digits); the fit's
    # LML (f64) at least its start's.  Two separate fits, float32 and
    # float64, part along the flat ridge at the noise floor (a CPU rehearsal:
    # residuals 8.5% apart at the largest bound), so the two are held to each
    # other only through the best candidate of a shorter sweep (below).
    S64, S164, X64 = (torch.as_tensor(a, **f64) for a in (S, S1, X))
    jit23 = gp_core._eff_jitter(torch.float32, 1e-10)

    def at_kernel(k_init, k_fit, inverse_at_init=True, shift=0.0):
        """The f64 CPU residual at the trial's fitted θ (+ ``shift``), the
        fitted Gram's condition number and the fit's LML rise (f64)."""
        k_init64 = k_init.with_theta(k_init.theta.double().cpu())
        k_at = k_init64.with_theta(k_fit.theta.double().cpu() + shift)
        ref = diffeo.GaussianProcessTransportationDiffeo(kernel_transport=k_at, device="cpu",
                                                         optimizer=None, alpha=jit23)
        ref.source_distribution, ref.target_distribution, ref.training_traj = S64, S164, X64
        ref.fit_transportation()
        if inverse_at_init:  # the inverse map's kernel, as in the sweep
            ref.method.delta_map.kernel = k_init64
        gp_ = ref.method.delta_map.state
        eig = torch.linalg.eigvalsh(gp_.L @ gp_.L.T)
        lml_ = lambda k: gp_core.log_marginal_likelihood(k, gp_.X, gp_.Y).item()
        return (ref._forward_inverse_residual(), (eig[-1] / eig[0]).item(),
                lml_(k_at) - lml_(k_init64))

    cands23 = list(tr23.diffeo_errors)
    err32 = np.array(list(tr23.diffeo_errors.values()))
    err_at, kappa23, lml_rise = (np.array(c) for c in zip(*(at_kernel(*t)
                                                             for t in trials23[:DIFFEO_TRIALS])))
    bound23 = 1e-3 * (1.0 + kappa23 * F32_EPS)
    ex23 = np.abs(err32 - err_at) / err_at / bound23
    best_at = cands23[int(np.argmin(err_at))]
    best_gap = err_at[cands23.index(best23)] - err_at.min()
    if not (ex23.max() < 1 and lml_rise.min() >= -1e-3
            and (best23 == best_at or best_gap <= 1e-3 * err_at.min())):
        raise AssertionError(f"the sweep vs f64 at its fitted kernels: residual error/bound "
                             f"{ex23.tolist()} (kappa {kappa23.tolist()}), LML rise "
                             f"{lml_rise.tolist()}, best {best23} vs {best_at}")
    # the bound must reject a wrong residual over the first trials: the
    # inverse map fitted with the fitted kernel instead of the trial's, or
    # the fitted θ moved by 0.01 in log space (a CPU rehearsal read 333 and 24)
    nf = DIFFEO_FAULT_TRIALS
    fault23 = {name: max(abs(err32[i] - r) / r / bound23[i] for i, (r, _, _) in enumerate(
        at_kernel(*t, **kw) for t in trials23[:nf]))
        for name, kw in (("inverse map at the fitted kernel", dict(inverse_at_init=False)),
                         ("theta + 0.01", dict(shift=0.01)))}
    if not min(fault23.values()) >= 1:
        raise AssertionError(f"the sweep's check passes a planted fault: error/bound {fault23}")

    # an independent sweep of DIFFEO_CHECK_TRIALS candidates on the card and
    # in float64 on the CPU: the card's best is the f64 best, or within 1e-3
    # of its residual in f64
    def short_sweep(device_, dtype):
        tr = diffeo.GaussianProcessTransportationDiffeo(jit_fit=True, device=device_)
        tr.source_distribution, tr.target_distribution, tr.training_traj, tr.training_delta = (
            torch.as_tensor(a, dtype=dtype, device=device_) for a in (S, S1, X, dX))
        return tr.optimize_diffeomorphism(n_trials=DIFFEO_CHECK_TRIALS), tr.diffeo_errors

    best_c, errs_c = short_sweep(device, torch.float32)
    t_cpu = time.perf_counter()
    best_f, errs_f = short_sweep("cpu", torch.float64)
    cpu_s23 = time.perf_counter() - t_cpu
    gap_f = (errs_f[best_c] - errs_f[best_f]) / errs_f[best_f]
    if not (best_c == best_f or gap_f <= 1e-3):
        raise AssertionError(f"the {DIFFEO_CHECK_TRIALS}-trial sweep: best {best_c} on the card, "
                             f"{best_f} in f64 on the CPU, f64 residual {gap_f:.3g} above the best")
    apart23 = max(abs(errs_c[c] - errs_f[c]) / errs_f[c] for c in errs_f)
    tr23.apply_transportation()
    traj23, vel23 = tr23.training_traj, tr23.training_delta
    dyn23 = gp_core.condition(tr23.method.delta_map.kernel_, traj23, vel23)
    alea23 = hs.fit_aleatoric_gp(traj23, tr23.var_vel_transported, n_restarts=0)
    lo23, hi23 = traj23.min(0).values, traj23.max(0).values
    g23 = torch.stack(torch.meshgrid(*(torch.linspace(float(a), float(b), 20, device=device)
                                       for a, b in zip(lo23, hi23)), indexing="ij"), -1)
    mean23, sig_h, sig_a = hs.heteroscedastic_field(dyn23, alea23, g23.reshape(-1, 2))
    if not all(torch.isfinite(t).all() and (t >= 0).all() for t in (sig_h, sig_a)) or \
            not torch.isfinite(mean23).all():
        raise AssertionError("the heteroscedastic field is not finite and non-negative")
    print(f"diffeomorphism sweep: GaussianProcessTransportationDiffeo(jit_fit=True) on the bench "
          f"inputs (Q={Q_MAIN}, n={N_MAIN}), {DIFFEO_TRIALS} trials and the refit, f32: the "
          f"fits' {fit_text(opt23)}, small_lml_value_grad launches "
          f"{counts23['small_lml_value_grad']}, "
          f"fused_gp_predict_mean {counts23['fused_gp_predict_mean']}; {sweep_ms:.1f} ms (CUDA "
          f"events, one run); each trial's residual vs the f64 CPU residual at the kernel it "
          f"fitted: rel max {np.max(np.abs(err32 - err_at) / err_at):.3g}, error/bound max "
          f"{ex23.max():.3g} (bound 1e-3*(1 + kappa*eps32), kappa up to {kappa23.max():.3g}); "
          f"planted faults on the first {nf} trials rejected, error/bound "
          + ", ".join(f"{k} {v:.3g}" for k, v in fault23.items())
          + f"; every fit's LML (f64) above its start (min rise {lml_rise.min():.4g}); "
          f"best_max_lengthscale {best23:.4f} (in f64 at the card's fits {best_at:.4f}); "
          f"{DIFFEO_CHECK_TRIALS}-trial sweeps: best {best_c:.4f} on the card, {best_f:.4f} in "
          f"f64 on the CPU ({cpu_s23:.1f} s), the card's best {gap_f:.3g} above the f64 best's "
          f"residual (<= 1e-3), separate fits' residuals up to {apart23:.3g} apart; "
          f"heteroscedastic_field on a 20x20 grid: sigma_hetero in [{sig_h.min().item():.4g}, "
          f"{sig_h.max().item():.4g}], sigma_aleatoric in [{sig_a.min().item():.4g}, "
          f"{sig_a.max().item():.4g}], finite and non-negative {tag}", flush=True)
    del tr23, trials23

    # 24. the mixed-precision solve at phase 8's inputs
    from gaussian_process_transportation_tpu_torch.ops import mixed_linalg as mx

    kern24 = K.Constant(2.0) * K.RBF(torch.ones(D_SOLVE, **f32)) + K.White(0.1)
    K24 = kern24(Xs)
    K64 = f64_gram(Xs, 2.0, 0.1)
    rel_8 = rel_residual_f64(K64, solve_path(), Ys)
    mixed24 = {}
    for prec in ("default", "high"):
        (alpha24, L24, rel24), counts24 = drive(lambda: mx.gram_chol_solve_mixed(
            kern24, Xs, Ys, jitter=0.0, syrk_precision=prec))
        if any(counts24.values()):
            raise AssertionError(f"the mixed-precision solve launched a hand kernel: {counts24}")
        definite = bool(torch.isfinite(L24).all())
        rels = ((rel_residual_f64(K64, mx._cho(L24, Ys), Ys), rel_residual_f64(K64, alpha24, Ys))
                if definite else (math.nan, math.nan))
        factor = cuda_ms(lambda: mx.blocked_cholesky(K24, syrk_precision=prec))
        pcg = cuda_ms(lambda: mx.pcg_solve(K24, L24, Ys)) if definite else (math.nan, [])
        mixed24[prec] = (definite, rels, rel24.item(), factor, pcg)
    del K64, L24, alpha24
    # "default" (bf16 operands) at this Gram's condition number may lose
    # definiteness in a diagonal block: the factor is NaN, which the solve's
    # residual carries for its caller to gate on.  "high" must factor, be
    # well above float32 precision alone and reach the float32 solve after PCG.
    ok24, (lo24, pcg24), _, _, _ = mixed24["high"]
    if not (ok24 and lo24 > 1e3 * F32_EPS and pcg24 <= 10 * rel_8 and pcg24 < lo24 / 3):
        raise AssertionError(f"mixed-precision solve, 'high': factor definite {ok24}, residual of "
                             f"the factor alone {lo24:.3g}, after PCG {pcg24:.3g}, phase 8's float32 "
                             f"solve {rel_8:.3g}")
    if mixed24["default"][0] and not math.isfinite(mixed24["default"][2]):
        raise AssertionError("the 'default' factor is finite but its solve's residual is not")
    # "default" on a Gram it factors: phase 8's points with the noise raised to
    # MIXED_NOISE (kappa ~5e2; a CPU emulation of the bf16 panels factors from
    # 3 on), against phase 8's float32 solve of the same Gram
    kern24w = K.Constant(2.0) * K.RBF(torch.ones(D_SOLVE, **f32)) + K.White(MIXED_NOISE)
    (alpha24w, L24w, _), counts24w = drive(lambda: mx.gram_chol_solve_mixed(
        kern24w, Xs, Ys, jitter=0.0, syrk_precision="default"))
    if any(counts24w.values()):
        raise AssertionError(f"the mixed-precision solve launched a hand kernel: {counts24w}")
    K64 = f64_gram(Xs, 2.0, MIXED_NOISE)
    rel_8w = rel_residual_f64(K64, bc.gram_cholesky_solve(Xs, Ys, ls3, 2.0, MIXED_NOISE,
                                                          block=BLOCK)[0], Ys)
    ok24w = bool(torch.isfinite(L24w).all())
    lo24w, pcg24w = ((rel_residual_f64(K64, mx._cho(L24w, Ys), Ys),
                      rel_residual_f64(K64, alpha24w, Ys)) if ok24w else (math.nan, math.nan))
    del K64, L24w, alpha24w
    if not (ok24w and lo24w > 1e3 * F32_EPS and pcg24w <= 10 * rel_8w):
        raise AssertionError(f"mixed-precision solve, 'default' at noise {MIXED_NOISE}: factor "
                             f"definite {ok24w}, residual of the factor alone {lo24w:.3g}, after "
                             f"PCG {pcg24w:.3g}, phase 8's float32 solve {rel_8w:.3g}")
    print(f"mixed-precision solve: gram_chol_solve_mixed N={N_SOLVE} (phase 8's inputs, kappa "
          f"~4.8e4) block 1024, no hand-kernel launch; relative residuals (f64) against phase 8's "
          f"float32 solve {rel_8:.3g}: "
          + "; ".join(f"syrk '{p}': " + (f"the factor alone {r[0]:.3g}, after 24 PCG iterations "
                                          f"{r[1]:.3g} (its own f32 reading {own:.3g}), the factor "
                                          f"{fa[0]:.4f} ms {fa[1]}, PCG {pc[0]:.4f} ms {pc[1]}"
                                          if ok else f"the factor not definite (NaN; the solve's "
                                          f"residual {own}), {fa[0]:.4f} ms {fa[1]}")
                     for p, (ok, r, own, fa, pc) in mixed24.items())
          + f" (medians of {REPS}, CUDA events) beside phase 8's whole solve {solve_ms:.4f} ms; "
          f"syrk 'default' at noise {MIXED_NOISE}: the factor alone {lo24w:.3g}, after PCG "
          f"{pcg24w:.3g}, phase 8's float32 solve of that Gram {rel_8w:.3g} {tag}",
          flush=True)
    del K24

    # 25. the variants: affine, KMP and Laplacian-editing transports
    var25 = {}
    for name in VARIANTS:
        tr64c = drive_variant(name, device, torch.float64, X, dX, S, S1)
        tr64 = drive_variant(name, "cpu", torch.float64, X, dX, S, S1)
        tr32, counts25f = drive(lambda: drive_variant(name, device, torch.float32, X, dX, S, S1))
        rel64 = max((getattr(tr64c, a).cpu() - getattr(tr64, a)).abs().max().item() / scale
                    for a in ("training_traj", "training_delta", "std"))
        rel32 = max((getattr(tr32, a).double().cpu() - getattr(tr64, a)).abs().max().item() / scale
                    for a in ("training_traj", "training_delta", "std"))
        if not (rel64 < 1e-6 and all(torch.isfinite(getattr(tr32, a)).all()
                                     for a in ("training_traj", "training_delta", "std"))):
            raise AssertionError(f"{name}: float64 on the card vs the CPU err/max|X| {rel64:.3g}, or "
                                 "the float32 run not finite")
        var25[name] = (rel64, rel32, counts25f["fused_gp_predict_mean"])
    print("variants on the bench inputs (Q=400, n=20), KMP's time GP without restarts: "
          + "; ".join(f"{k}: float64 on the card vs the f64 CPU run err/max|X| {a:.3g} (< 1e-6), "
                      f"float32 {b:.3g}, fused_gp_predict_mean {c} in f32"
                      for k, (a, b, c) in var25.items()) + f" {tag}", flush=True)

    # 26. the eight learned-map transports at the comparison suite's shapes
    phase26(device, tag)

    # 27. SVGP at the 3-D surface scale, and the multi-frame baselines
    phase27(device, tag)

    # 28-31. obstacle avoidance, the flow field, the GP dynamical system, the
    # metrics and the comparison suites
    phase28(device, tag)
    phase29(device, tag)
    counts30 = phase30(device, tag)
    phase31(device, tag)

    # 32-33. the multi-device slice: a one-rank NCCL group at full width, then
    # dryrun_multichip on eight gloo ranks sharing the card
    counts32 = phase32(device, tag, dict(
        transport=(kernel, Sd, S1d, targets, Xd, dXd), main_path=main_path, path_ms=path_ms,
        solve=(Xs, Ys, alpha, a64, solve_ms), solve_err=solve_err, jit16=jit16, ref16=ref16,
        lml_ms16=lml_ms16, hmc=(kern14, X14, Y14, hmc_kw, s14, hmc_ms), smc=(kern20, ll20)))
    counts33 = phase33(tag)

    # 34. the bench stages, bench.py's port, and its module
    counts34 = phase34(device, tag, a64, SOLVE_REL_TOL)

    # the launches of #2 and #3 in their paths' runs (phases 13 and 14)
    kernels_json["small_lml_value_grad"]["launches"] = counts14["small_lml_value_grad"]
    # the later paths' launches (phases 16, 17 and 19) beside the main path's
    kernels_json["small_lml_value_grad"].setdefault("extra", {}).update(
        nuts_launches=counts17["small_lml_value_grad"],
        checkpointed_resume_launches=counts19["small_lml_value_grad"],
        fit_jit_launches=counts21["small_lml_value_grad"],
        diffeo_sweep_launches=counts23["small_lml_value_grad"])
    for name in ("stationary_gram_panels", "factor_panel"):
        kernels_json[name].setdefault("extra", {}).update(
            blocked_lml_launches_per_evaluation=counts16a[name],
            fit_blocked_launches=counts16[name],
            active_learning_fit_launches=counts22[name])
    kernels_json["fused_gp_predict_mean"].setdefault("extra", {}).update(
        active_learning_predict_launches=counts22p["fused_gp_predict_mean"],
        diffeo_sweep_launches=counts23["fused_gp_predict_mean"],
        gp_ds_rollout_launches=counts30["fused_gp_predict_mean"])
    kernels_json["fused_gp_predict_mean_var"].setdefault("extra", {}).update(
        gp_ds_vector_field_launches=counts30["fused_gp_predict_mean_var"])
    kernels_json["small_lml_value_grad_md"].update(
        launches=counts13["small_lml_value_grad_md"], value_only_launches=counts13[VALUE_ONLY])
    # #8's launches in the later transports (phases 13, 32 and 33)
    kernels_json["transport_apply_rbf"].setdefault("extra", {}).update(
        refit_launches=counts13["transport_apply_rbf"],
        transport_ensemble_launches=counts32["transport"]["transport_apply_rbf"],
        dryrun_transport_launches_per_rank=counts33["transport"]["transport_apply_rbf"])
    # the multi-device paths' launches (phase 32 in one rank; phase 33 a rank)
    kernels_json["spd_inverse_elast_fused"].setdefault("extra", {}).update(
        transport_ensemble_launches=counts32["transport"]["spd_inverse_elast_fused"],
        dryrun_transport_launches_per_rank=counts33["transport"]["spd_inverse_elast_fused"])
    kernels_json["small_lml_value_grad"]["extra"].update(
        mesh_hmc_launches=counts32["hmc"]["small_lml_value_grad"],
        dryrun_hmc_launches_per_rank=counts33["hmc"]["small_lml_value_grad"])
    # the bench stages' launches (phase 34), a call or a solve
    kernels_json["spd_inverse_elast_fused"]["extra"].update(
        bench_transport_launches_per_call=counts34["transport"])
    kernels_json["small_lml_value_grad"]["extra"].update(
        bench_hmc_launches_per_call=counts34["hmc"])
    for name in ("stationary_gram_panels", "factor_panel"):
        kernels_json[name]["extra"].update(
            bench_cholesky_high_launches_per_solve=counts34["high"][name],
            bench_cholesky_highest_launches_per_solve=counts34["highest"][name])
    kernels_json["factor_panel"]["extra"].update(
        sharded_cholesky_launches=counts32["cholesky"]["factor_panel"],
        sharded_lml_launches_per_evaluation=counts32["lml"]["factor_panel"],
        fit_sharded_launches=counts32["fit"]["factor_panel"],
        dryrun_cholesky_launches_per_rank=counts33["cholesky"]["factor_panel"],
        dryrun_lml_launches_per_rank=counts33["lml"]["factor_panel"])

    # the record's times are the kernels' device times (CUPTI), named so by
    # "timing"; the CUDA-event times of the calls stand beside them
    dev = lambda t: None if t is None else t[0]
    event = lambda t: None if t is None else t[1]
    record = [{"name": name, "route": "cuda", "source": v["source"], "replaces": v["replaces"],
               "launches": v["launches"], "max_abs_err": v["max_abs_err"], "ms": dev(v["ms"]),
               "plain_ms": dev(v["plain_ms"]), "bound_ms": v["bound"][0],
               "bound_by": v["bound"][1], "library_ms": dev(v["library_ms"]),
               "timing": timing_of(v), "event_ms": event(v["ms"]),
               "plain_event_ms": event(v["plain_ms"]), "library_event_ms": event(v["library_ms"]),
               **({"value_only_ms": dev(v["value_only_ms"]),
                   "value_only_event_ms": event(v["value_only_ms"]),
                   "value_only_launches": v["value_only_launches"],
                   "value_only_bound_ms": v["value_only_bound"][0]}
                  if "value_only_ms" in v else {}),
               **({"parent_ms": dev(v["parent_ms"]), "parent_event_ms": event(v["parent_ms"])}
                  if "parent_ms" in v else {}),
               **({"instance": v["instance"]} if "instance" in v else {}),
               **({f"{k}_device_ms": g["kernel_ms"] for k, g in v["path_totals"].items()}
                  if "path_totals" in v else {}),
               **({f"{k}_launches": g["kernel_launches"] for k, g in v["path_totals"].items()}
                  if "path_totals" in v else {}),
               **({f"{k}_bound_ms": g["bound"][0] for k, g in v["path_totals"].items()}
                  if "path_totals" in v else {}),
               **({"ptxas": v["ptxas"]} if "ptxas" in v else {}),
               **v.get("extra", {})}
              for name, v in kernels_json.items()]
    # a time the profiler could not give (path_breakdown, panel_profile) is null
    record = [{k: None if isinstance(x, float) and math.isnan(x) else x for k, x in r.items()}
              for r in record]
    print(json.dumps({"kernels": record}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
