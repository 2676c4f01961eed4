#!/usr/bin/env python3
"""Time variants of the port's kernels built from copies of their ``csrc/``
sources with exact text substitutions, beside the shipped source, on one
CUDA card: where a kernel's time goes (one of its phases cut out) and
whether its block constants are at their best.

* ``spd``: kernel #1's warp instance for n <= 20 (``csrc/spd_inverse_elast.cu``,
  ``launch_warp<10, 2, 8>``) at n=20, E=16384 and E=4096: the shipped
  source; its staging alone (the factor and inverse cut out); its factor
  and inverse alone (the staging cut out); without the load; without the
  store; 2, 4 and 16 warps a block.
* ``mean``: kernel #5's two launches (``csrc/stationary_gram.cu``, the C
  entry, without the wrapper's scaling copies) at Nq=10⁴, N=2048, D=2, P=2:
  the shipped block constants and other threads a block, queries a thread
  and chunk widths.
* ``gram``: kernel #7's panel entry (``stationary_gram_panels_f32``) at the
  N=10240 solve's shape (B=512, D=3): the shipped source; evict-first
  (streaming, ``__stcs``) stores; the profile cut out (d² stored: the
  stores and the distances alone); 32- and 128-row tiles; 128 threads a
  block.

Every variant that keeps all phases is checked against the shipped build on
the same inputs (the largest difference is printed); each is timed in three
rounds by CUPTI device ms (``chip_smoke.device_ms``, mean of 5 after a
warm-up; "lost" where CUPTI kept no record) and by CUDA events over 20
launches back to back, with the card's name, power limit and SM clock.

Run from the repository root: ``python3 scripts/kernel_variants.py``
(``--what spd mean gram`` picks the parts).  The variants are built with the
package's nvcc flags into ``gaussian_process_transportation_tpu_torch/_build/variants/``.
"""
import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gaussian_process_transportation_tpu_torch.ops import _cuda  # noqa: E402

SPD_CALL = "    members<H, R>(sk + gs * M, si + gs * M, P, t, n, own);"
SPD_LOAD = "  stage<G, W * 32, true>(sk, K, nullptr, n, P, M, E, e0);"
SPD_STORE = ("  stage<G, W * 32, false>(sk, nullptr, L, n, P, M, E, e0);\n"
             "  stage<G, W * 32, false>(si, nullptr, Kinv, n, P, M, E, e0);")
SPD_INSTANCE = "case 20: return launch_warp<10, 2, 8>"
MEAN_CONSTANTS = "constexpr int kMThreads = 128, kMR = 2, kMQ = kMThreads * kMR, kMC = 128;"
GRAM_CONSTANTS = "constexpr int kTR = 64, kTC = 128, kGThreads = 256;"
GRAM_STORE = "*reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);"
GRAM_PROFILE = "v[j] = amp * profile_t<FAM>(d2);"


def spd_variants():
    """name -> (substitutions, keeps every phase)."""
    warps = lambda w: [(SPD_INSTANCE, SPD_INSTANCE.replace("<10, 2, 8>", f"<10, 2, {w}>"))]
    return {"shipped": ([], True),
            "staging only": ([(SPD_CALL, "")], False),
            "factor and inverse only": ([(SPD_LOAD, ""), (SPD_STORE, "")], False),
            "without the load": ([(SPD_LOAD, "")], False),
            "without the store": ([(SPD_STORE, "")], False),
            "2 warps a block": (warps(2), True),
            "4 warps a block": (warps(4), True),
            "16 warps a block": (warps(16), True)}


def mean_variants():
    """name -> (substitutions, chunk width)."""
    out = {}
    for threads, per_thread, chunk in ((128, 2, 128), (64, 2, 64), (128, 1, 128), (128, 4, 128),
                                       (64, 4, 128), (128, 2, 64), (128, 4, 64), (256, 2, 128),
                                       (128, 2, 256)):
        name = f"{threads} threads, {per_thread} queries a thread, chunks of {chunk}"
        if (threads, per_thread, chunk) == (128, 2, 128):
            name += " (shipped)"
        new = (f"constexpr int kMThreads = {threads}, kMR = {per_thread}, "
               f"kMQ = kMThreads * kMR, kMC = {chunk};")
        out[name] = ([(MEAN_CONSTANTS, new)], chunk)
    return out


def gram_variants():
    """name -> (substitutions, tile rows, keeps the result)."""
    tiles = lambda rows, threads: [(GRAM_CONSTANTS, GRAM_CONSTANTS.replace(
        "kTR = 64", f"kTR = {rows}").replace("kGThreads = 256", f"kGThreads = {threads}"))]
    return {"shipped (64 x 128 tiles, 256 threads)": ([], 64, True),
            "evict-first stores (__stcs)": ([(GRAM_STORE, "__stcs(reinterpret_cast<float4*>(o), "
                                              "make_float4(v[0], v[1], v[2], v[3]));")], 64, True),
            "profile cut out (d2 stored)": ([(GRAM_PROFILE, "v[j] = amp * d2;")], 64, False),
            "32-row tiles": (tiles(32, 256), 32, True),
            "128-row tiles": (tiles(128, 256), 128, True),
            "128 threads a block": (tiles(64, 128), 64, True)}


def build_variants(source, variants, tag):
    """Build each variant of ``csrc/<source>.cu``; name -> loaded library."""
    text = (_cuda.SRC_DIR / f"{source}.cu").read_text()
    out_dir = _cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(item):
        i, (name, subs) = item
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{source}.cu no longer holds {old!r}: update {__file__}")
            src = src.replace(old, new)
        cu, so = out_dir / f"{tag}{i}.cu", out_dir / f"lib{tag}{i}.so"
        cu.write_text(src)
        proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the variant {name!r}:\n{proc.stderr}")
        return name, ctypes.CDLL(str(so))

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(build, enumerate((n, v[0]) for n, v in variants.items())))


def stream_ms(fn, reps=20):
    """CUDA-event ms a call over ``reps`` calls launched back to back after a
    warm-up: the launches queue ahead of the card, so this is device time
    plus any gap the host leaves."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cupti_ms(fn, tries=3):
    """``chip_smoke.device_ms``, or None where CUPTI kept no kernel record in
    ``tries`` attempts (it drops records late in a long process)."""
    for _ in range(tries):
        try:
            return cs.device_ms(fn)
        except AssertionError:
            pass
    return None


def run_rounds(label, calls, rounds=3):
    fmt = lambda t: "lost" if t is None else f"{t:.4f}"
    for r in range(rounds):
        print(f"{label} round {r}, CUPTI / CUDA events back to back: " + "; ".join(
            f"{name} {fmt(cupti_ms(fn))} / {stream_ms(fn):.4f}" for name, fn in calls.items()),
            flush=True)


def time_spd(device):
    variants = spd_variants()
    libs = build_variants("spd_inverse_elast", variants, "spd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for E in (cs.E_MAIN, 4096):
        K = torch.from_numpy(np.transpose(cs.spd_batch(cs.N_MAIN, E), (1, 2, 0)))
        K = K.to(device).contiguous()
        outs, calls = {}, {}
        for name, lib in libs.items():
            fn = lib.spd_inverse_elast_warp_f32
            fn.argtypes = [p, p, p, i, ll, i, p]
            L, Kinv = torch.zeros_like(K), torch.zeros_like(K)
            outs[name] = (L, Kinv)
            calls[name] = (lambda fn=fn, L=L, Kinv=Kinv: fn(
                K.data_ptr(), L.data_ptr(), Kinv.data_ptr(), cs.N_MAIN, E, 20,
                torch.cuda.current_stream().cuda_stream))
            if calls[name]() != 0:
                raise RuntimeError(f"variant {name!r} failed to launch")
        torch.cuda.synchronize()
        ref = outs["shipped"]
        diffs = {name: max((a - b).abs().max().item() for a, b in zip(outs[name], ref))
                 for name, (_, whole) in variants.items() if whole and name != "shipped"}
        print(f"spd_inverse_elast warp20 n={cs.N_MAIN} E={E}: |variant - shipped| "
              + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()), flush=True)
        run_rounds(f"spd_inverse_elast warp20 n={cs.N_MAIN} E={E} (device ms)", calls)


def time_mean(device):
    variants = mean_variants()
    libs = build_variants("stationary_gram", variants, "mean")
    f32 = dict(dtype=torch.float32, device=device)
    X, Y, Xq = (torch.as_tensor(a, **f32) for a in cs.grid_inputs())
    Nq, N, D, P = Xq.shape[0], X.shape[0], X.shape[1], Y.shape[1]
    alpha = Y.contiguous()
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    outs, calls = {}, {}
    for name, lib in libs.items():
        chunk = variants[name][1]
        fn = lib.predict_mean_f32
        fn.argtypes = [p, p, p, i, i, i, i, p, fl, i, p, p, i, p]
        mean = torch.zeros(Nq, P, **f32)
        partial = torch.empty(-(-N // chunk), Nq, P, **f32)
        outs[name] = mean
        calls[name] = (lambda fn=fn, mean=mean, partial=partial, chunk=chunk: fn(
            Xq.data_ptr(), X.data_ptr(), alpha.data_ptr(), Nq, N, D, P, None, 2.0, 0,
            mean.data_ptr(), partial.data_ptr(), chunk, torch.cuda.current_stream().cuda_stream))
        if calls[name]() != 0:
            raise RuntimeError(f"variant {name!r} failed to launch")
    torch.cuda.synchronize()
    ref = next(outs[n] for n in outs if n.endswith("(shipped)"))
    print(f"predict_mean Nq={Nq} N={N} D={D} P={P}: |variant - shipped| max "
          f"{max((m - ref).abs().max().item() for m in outs.values()):.3g}", flush=True)
    run_rounds(f"predict_mean Nq={Nq} N={N} (device ms)", calls)


def time_gram(device):
    variants = gram_variants()
    libs = build_variants("stationary_gram", variants, "gram")
    f32 = dict(dtype=torch.float32, device=device)
    X = cs.solve_inputs(device)[0]
    n, D, B = X.shape[0], X.shape[1], cs.BLOCK
    size = B * B * (-(-n // B)) * (-(-n // B) + 1) // 2
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ls = (ctypes.c_float * D)(*([1.0] * D))
    outs, calls = {}, {}
    for name, lib in libs.items():
        fn = lib.stationary_gram_panels_f32
        fn.argtypes = [p, i, i, i, p, i, ctypes.POINTER(ctypes.c_float), p, fl, p, fl, i, p, i, i,
                       p]
        out = torch.full((size,), float("nan"), **f32)
        outs[name] = out
        calls[name] = (lambda fn=fn, out=out, rows=variants[name][1]: fn(
            X.data_ptr(), n, D, B, None, 0, ls, None, 2.0, None, 0.1, 0, out.data_ptr(), rows,
            128, torch.cuda.current_stream().cuda_stream))
        if calls[name]() != 0:
            raise RuntimeError(f"variant {name!r} failed to launch")
    torch.cuda.synchronize()
    ref = next(iter(outs.values()))
    print(f"stationary_gram_panels N={n} B={B} D={D}: |variant - shipped| "
          + ", ".join(f"{k} {(o - ref).abs().max().item():.3g}" for k, o in outs.items()
                      if variants[k][2]), flush=True)
    run_rounds(f"stationary_gram_panels N={n} B={B} (device ms)", calls)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", nargs="*", choices=("spd", "mean", "gram"),
                    default=["spd", "mean", "gram"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA card")
    device = torch.device("cuda", 0)
    print(f"{cs.card_line()}; clocks.sm, clocks.max.sm {cs.sm_clocks()}", flush=True)
    if "spd" in args.what:
        time_spd(device)
    if "mean" in args.what:
        time_mean(device)
    if "gram" in args.what:
        time_gram(device)
    print(f"clocks.sm, clocks.max.sm after: {cs.sm_clocks()}", flush=True)


if __name__ == "__main__":
    main()
