"""The least work of each measured layer, counted from the cell's shapes,
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit).

A layer's least time is the larger of its operations over the float32 rate
outside the tensor cores, its special-function results (exp) over the
special-function units' rate, and its bytes over the memory bandwidth.
The work is the least that any implementation of the same outputs needs:
each input byte read once and each output byte written once; an
(n, n) quadratic form counted as a triangular solve, n² a column, never as
a product with K⁻¹ (2n²); a Cholesky factor n³/3.  So a roofline share
reads the same whatever implements the layer and cannot pass 100% unless
the time leaves out part of the work.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# 16 results a clock on each of the 132 SMs (CUDA C++ Programming Guide,
# arithmetic instructions, compute capability 9.0) at the 1,980 MHz
# maximum SM clock
SFU_PER_S = 132 * 16 * 1.98e9
F32 = 4


def least_s(flops: float, bytes_moved: float, transcendentals: float = 0.0) -> float:
    """The least seconds the peaks allow for the work."""
    return max(flops / F32_FLOP_PER_S, transcendentals / SFU_PER_S, bytes_moved / HBM_BYTES_PER_S)


def gram_flops(rows: int, cols: int, D: int) -> float:
    """One stationary-kernel entry: D differences, squares and sums, the
    profile's scale and the amplitude."""
    return rows * cols * (3 * D + 6)


def chol_inverse(E: int, n: int) -> float:
    """Least seconds of the Cholesky factor and inverse of E SPD (n, n)
    matrices: read K, write L and K⁻¹; n³/3 for the factor and 2n³/3 for the
    inverse from it."""
    return least_s(E * n**3, 3 * E * n * n * F32)


def apply(E: int, n: int, Q: int, D: int, P: int) -> float:
    """Least seconds of ``transport_apply`` for E members of n points and a
    demo of Q points: the cross-Gram and its derivative, the mean and the
    Jacobian's contractions with α, the variance of the value and of the D
    derivatives as triangular solves (n² a column), J_Φ, its determinant and
    the velocity push-forward.  Bytes: the demo, the points, α and the
    factor read once, the four (E, Q, D) fields and the determinant written
    once."""
    gram = gram_flops(n, Q, D)
    mean = 2 * P * n * Q
    var = Q * n * n
    dk = 2 * D * n * Q
    jac = 2 * P * D * n * Q
    jvar = D * Q * n * n
    per_q = 2 * P * D * D + 2 * D * D + 4 * P * D + 10 * D  # J_Φ, det, push-forwards
    flops = E * (gram + mean + var + dk + jac + jvar + Q * per_q)
    read = F32 * (Q * 2 * D + E * (n * D + n * P + n * (n + 1) // 2))
    write = F32 * E * Q * 4 * D + F32 * E
    return least_s(flops, read + write, E * n * Q)
