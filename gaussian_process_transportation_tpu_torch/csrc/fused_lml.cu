// The small-N GP log marginal likelihood and its gradient in the
// log-hyperparameters, one warp per lane (a chain, a restart, an ensemble
// member), for the hyperparameter fits and the HMC hyperposterior.
//
// Replaces the two TPU Pallas kernels of
// gaussian_process_transportation_tpu/ops/fused_lml.py:
//   small_lml_value_grad    (body _lml_kernel)    -> entry small_lml_value_grad_f32,
//       one (X, Y) shared by every lane;
//   small_lml_value_grad_md (body _lml_kernel_md) -> entry small_lml_value_grad_md_f32,
//       each lane its own (X, Y), and its value-only instance
//       small_lml_value_md_f32 for the line search's candidates.
// Each computes, per lane with theta[:, e] = [log amp, log l (n_ls rows),
// log noise (if has_noise)]:
//   K = amp*phi(s) + (noise + jitter)*I,  s = sum_d (x_i,d - x_j,d)^2 / l_d^2,
//   its Cholesky, alpha = K^-1 Y, log|K|, the LML summed over the p columns,
//   and the trace-identity gradient 1/2 <alpha alpha^T - p K^-1, dK/dtheta>,
// for phi in {rbf, matern12, matern32, matern52}, with the JAX clamps
// sqrt(s + 1e-36) and max(d, 1e-18) (without them the diagonal gives 0*inf).
//
// Layout.  theta (T, E) and grad (T, E) lane-last, val (E,).  X is (n, D)
// and Y (n, p) for the shared entry, (E, n, D) and (E, n, p) for the
// per-lane ones: the kernel reads coordinates and forms the differences
// itself, instead of the TPU kernel's (D*n*n, E) slab of squared distances
// (about 40x the bytes at n = 20, D = 2).  Lanes past E are masked (their
// warps return), not padded with copies.
//
// What bounds it on an H100.  At 28,672 lanes, n = 20, D = 2, p = 2 (the
// per-member fit) a launch needs about 0.73 GFLOP of f32 work (~11 us at
// 67 TFLOP/s) and moves about 10 MB (~3 us): operations bound it.  On a
// warp that owns a lane, though, the time is one lane's chain of dependent
// steps (shuffle, reciprocal square root, multiply, shuffle, FMA for each
// column of the factor) times the waves of lanes, and the instructions the
// SM has to fetch and issue for it: fully unrolled code over registers is
// large, so the instances are cut to the shapes they serve.
//
// Design.  Thread t holds row t of the lane's matrices in registers.  An
// instance has compile-time capacities: NCAP rows, KD coordinates and KP
// columns of Y; the host takes the paths' instance (n <= 24, D <= 2,
// p <= 2: the HMC chains and the per-member fits) where it fits and the
// general one (n <= 32, D <= 8, p <= 8) otherwise.  Rows and columns
// n..NCAP-1 are an identity block (K padded to diag(K, I)), so loops run on
// static register indices and only coarse, warp-uniform tests of n, D and
// p cut the tail; the kernel family is switched once, outside the loops.
// Entries of other rows arrive by __shfl_sync; there is no shared memory
// and no __syncwarp.
//   Gram: thread t forms row t from its point and the others' (shuffled).
//   Factor, right-looking by columns as K = C D C^T (C unit lower): at
//     column j the pivot d_j is lane j's register j, thread t > j forms
//     C_tj = S_tj / d_j and updates its row with the others' unscaled S_kj,
//     so a step's critical path holds one shuffle; thread t also updates its
//     entries right of the diagonal, which stay the Schur complement's
//     S_tk = C_kt d_t: after the factor it holds row t of C left of the
//     diagonal and (rescaled) column t right of it, and the back
//     substitution needs no transpose.  Y's columns are eliminated in the
//     same loop (u = C^-1 y), so the value, -1/2 sum u^2/d - p/2 log|K| -
//     ..., needs no solve after the factor.
//   alpha = C^-T D^-1 u by back substitution, the solved entry broadcast.
//   Inverse, without n column solves: thread t forms column t of C^-1 by
//     one forward substitution against C's rows (broadcast once for all
//     threads, n^2/2 shuffles), then row t of K^-1 = C^-T D^-1 C^-1 as the
//     dot products of its column with the others' (n^2/2 more), n
//     independent sums instead of a back substitution's chain.
//   Gradient: row t of W = 1/2 (alpha alpha^T - p K^-1) against row t of
//     dK/dtheta, the Gram row recomputed, closed by fixed-order warp sums,
//     so repeat runs are bitwise equal.
// The value-only instance (kGrad = false) compiles out the inverse and the
// gradient; its value path is the same code with the same explicit
// roundings (fmaf, __fmul_rn), so its value equals the full instance's bit
// for bit.  D > 8 coordinates are walked in chunks of eight (a third
// instance, so the others keep their registers); a wider Y is split into
// launches of at most kMaxP columns by the wrapper (ops/fused_lml.py),
// whose values and gradients add up.  A lane whose pivot is not positive
// turns its own value and gradient into NaN and nothing else; the callers
// map that to 1e25.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // lanes per block
constexpr int kMaxD = 8;   // coordinates held at once by the general instances
constexpr int kMaxP = 8;   // columns of Y a launch takes
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.2360679774997898f;

// The instances: the paths' shapes (n <= 24, D <= 2, p <= 2: the HMC
// chains and the per-member fits, n = 20) with tight registers and code,
// and the general one (n <= 32, D <= 8 or chunked, p <= 8).
constexpr int kPathN = 24, kPathD = 2, kPathP = 2;

enum Family { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

__device__ __forceinline__ float shfl(float v, int src) { return __shfl_sync(kFull, v, src); }

// phi(s) of a unit-amplitude stationary kernel (fused_lml.py:_phi), with
// explicit roundings: the Gram is the same bits in every instance.
template <int FAM>
__device__ __forceinline__ float phi_of(float s) {
  if (FAM == kRbf) return expf(__fmul_rn(-0.5f, s));
  const float d = sqrtf(__fadd_rn(s, 1e-36f));
  if (FAM == kMatern12) return expf(-d);
  if (FAM == kMatern32) {
    const float sd = __fmul_rn(kSqrt3, d);
    return __fmul_rn(__fadd_rn(1.0f, sd), expf(-sd));
  }
  const float sd = __fmul_rn(kSqrt5, d);
  const float poly = __fadd_rn(__fadd_rn(1.0f, sd), __fmul_rn(__fmul_rn(sd, sd), 1.0f / 3.0f));
  return __fmul_rn(poly, expf(-sd));
}

// phi(s) and dphi/ds (fused_lml.py:_phi and _dphi), for the gradient pass.
template <int FAM>
__device__ __forceinline__ void phi_dphi(float s, float* phi, float* dphi) {
  if (FAM == kRbf) {
    const float e = expf(-0.5f * s);
    *phi = e;
    *dphi = -0.5f * e;
    return;
  }
  const float d = sqrtf(s + 1e-36f);
  if (FAM == kMatern12) {
    const float e = expf(-d);
    *phi = e;
    *dphi = -e / (2.0f * fmaxf(d, 1e-18f));
  } else if (FAM == kMatern32) {
    const float e = expf(-kSqrt3 * d);
    *phi = (1.0f + kSqrt3 * d) * e;
    *dphi = -1.5f * e;
  } else {
    const float sd = kSqrt5 * d;
    const float e = expf(-sd);
    *phi = (1.0f + sd + sd * sd * (1.0f / 3.0f)) * e;
    *dphi = -(5.0f / 6.0f) * (1.0f + sd) * e;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Coordinates [c0, c0 + KD) of point t into xt and their 1 / l_d^2 into il
// (zeros past D, and xt zeros for a padding row).
template <int KD>
__device__ __forceinline__ void load_chunk(const float* x, const float* theta, long long E,
                                           long long e, int D, int n_ls, int c0, int t, bool row,
                                           float xt[KD], float il[KD]) {
#pragma unroll
  for (int d = 0; d < KD; ++d) {
    const bool in = c0 + d < D;
    il[d] = in ? expf(__fmul_rn(-2.0f, theta[(1 + (n_ls > 1 ? c0 + d : 0)) * E + e])) : 0.0f;
    xt[d] = in && row ? x[t * D + c0 + d] : 0.0f;
  }
}

// s[j] (+)= sum over this chunk's coordinates of (x_t,d - x_j,d)^2 / l_d^2
// for j < n; the others' coordinates arrive by shuffle.
template <int NCAP, int KD>
__device__ __forceinline__ void add_scaled_dists(float s[NCAP], const float xt[KD],
                                                 const float il[KD], int n, int D, int c0) {
#pragma unroll
  for (int j = 0; j < NCAP; ++j) {
    if (j >= n) break;
#pragma unroll
    for (int d = 0; d < KD; ++d) {
      if (KD <= kPathD || c0 + d < D) {  // a zero coordinate adds nothing
        const float diff = xt[d] - shfl(xt[d], j);
        s[j] = fmaf(__fmul_rn(diff, diff), il[d], s[j]);
      }
    }
  }
}

// Gram row t from its scaled distances, the identity past n.
template <int NCAP, int FAM>
__device__ __forceinline__ void gram_row(float a[NCAP], float amp, float diag, int t, bool row,
                                         int n) {
#pragma unroll
  for (int j = 0; j < NCAP; ++j) {
    const float id = t == j ? 1.0f : 0.0f;
    if (j < n)
      a[j] = row ? fmaf(amp, phi_of<FAM>(a[j]), t == j ? diag : 0.0f) : id;
    else
      a[j] = id;
  }
}

// Row t of W = 1/2 (alpha alpha^T - p K^-1) against row t of dK/dtheta, the
// Gram row recomputed from the points (D <= KD): the amplitude, noise and
// per-coordinate sums of this thread.
template <int NCAP, int KD, int KP, int FAM>
__device__ __forceinline__ void grad_row(const float xt[KD], const float il[KD],
                                         const float z[KP], const float ki[NCAP], float amp,
                                         int t, int n, int D, int p, float* g_amp,
                                         float* g_noise, float g_ls[KD]) {
  const float fp = static_cast<float>(p);
#pragma unroll
  for (int j = 0; j < NCAP; ++j) {
    if (j >= n) break;
    float s = 0.0f, d2[KD];
#pragma unroll
    for (int d = 0; d < KD; ++d) {
      d2[d] = 0.0f;
      if (KD <= kPathD || d < D) {
        const float diff = xt[d] - shfl(xt[d], j);
        d2[d] = diff * diff;
        s += d2[d] * il[d];
      }
    }
    float ph, dph;
    phi_dphi<FAM>(s, &ph, &dph);
    float aa = 0.0f;
#pragma unroll
    for (int q = 0; q < KP; ++q)
      if (KP <= kPathP || q < p) aa += z[q] * shfl(z[q], j);
    const float w = 0.5f * (aa - fp * ki[j]);
    *g_amp += w * (amp * ph);
    const float wdk = w * (amp * dph);
#pragma unroll
    for (int d = 0; d < KD; ++d) g_ls[d] += wdk * d2[d];
    if (j == t) *g_noise += w;
  }
}

// The same for D > KD from the scaled distances s of row t (summed over
// every chunk): W_tj amp dphi_tj replaces s_tj, the amplitude and noise
// sums are returned.
template <int NCAP, int KP, int FAM>
__device__ __forceinline__ void wdk_row(float s[NCAP], const float z[KP], const float ki[NCAP],
                                        float amp, int t, int n, int p, float* g_amp,
                                        float* g_noise) {
  const float fp = static_cast<float>(p);
#pragma unroll
  for (int j = 0; j < NCAP; ++j) {
    if (j >= n) break;
    float ph, dph;
    phi_dphi<FAM>(s[j], &ph, &dph);
    float aa = 0.0f;
#pragma unroll
    for (int q = 0; q < KP; ++q)
      if (KP <= kPathP || q < p) aa += z[q] * shfl(z[q], j);
    const float w = 0.5f * (aa - fp * ki[j]);
    *g_amp += w * (amp * ph);
    s[j] = w * (amp * dph);
    if (j == t) *g_noise += w;
  }
}

// NCAP rows, KD coordinates and KP columns of Y held in registers (the
// instance takes n <= NCAP, D <= KD unless kChunked, p <= KP); kChunked:
// D > KD, the coordinates walked in chunks of KD; kGrad: the inverse and
// the gradient are compiled in.
template <int NCAP, int KD, int KP, bool kChunked, bool kGrad>
__global__ void __launch_bounds__(kWarps * 32)
lml_kernel(const float* __restrict__ X, const float* __restrict__ Y,
           const float* __restrict__ theta, float* __restrict__ val,
           float* __restrict__ grad, int n, int D, int p, int n_ls, int has_noise,
           int family, float jitter, long long E, long long x_stride, long long y_stride) {
  // The paths' instance runs its zero and identity tails (harmless: a zero
  // coordinate or column adds nothing, an identity row updates nothing)
  // instead of testing n, D and p in its inner loops.
  constexpr bool kGuard = NCAP > kPathN;
  const int t = threadIdx.x & 31;
  const long long e = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (e >= E) return;  // the whole warp: nothing below synchronises the block
  const bool row = t < n;

  const float amp = expf(theta[e]);
  const float noise = has_noise ? expf(theta[(1 + n_ls) * E + e]) : 0.0f;
  const float* x = X + e * x_stride;
  const float* y = Y + e * y_stride;

  // Gram row t, padded with the identity past n
  float a[NCAP];
  float xt[KD], il[KD];
#pragma unroll
  for (int j = 0; j < NCAP; ++j) a[j] = 0.0f;
  for (int c0 = 0; c0 < (kChunked ? D : 1); c0 += KD) {
    load_chunk<KD>(x, theta, E, e, D, n_ls, c0, t, row, xt, il);
    add_scaled_dists<NCAP, KD>(a, xt, il, n, D, c0);
  }
  const float diag = __fadd_rn(noise, jitter);
  switch (family) {
    case kRbf: gram_row<NCAP, kRbf>(a, amp, diag, t, row, n); break;
    case kMatern12: gram_row<NCAP, kMatern12>(a, amp, diag, t, row, n); break;
    case kMatern32: gram_row<NCAP, kMatern32>(a, amp, diag, t, row, n); break;
    default: gram_row<NCAP, kMatern52>(a, amp, diag, t, row, n); break;
  }

  // LDL^T, right-looking (see the design note above), with Y's columns
  // eliminated alongside: u = C^-1 y, so the value needs no solve after it
  float u[KP];
#pragma unroll
  for (int q = 0; q < KP; ++q) u[q] = (row && q < p) ? y[t * p + q] : 0.0f;
  float dt = 1.0f, dinv = 1.0f;  // d_t and 1/d_t of this thread's row
#pragma unroll
  for (int j = 0; j < NCAP; ++j) {
    if (j >= n) break;
    const float piv = shfl(a[j], j);
    const float inv = __frcp_rn(piv);
    const float ctj = t > j ? __fmul_rn(a[j], inv) : 0.0f;
#pragma unroll
    for (int q = 0; q < KP; ++q)
      if (!kGuard || q < p) u[q] = fmaf(-ctj, shfl(u[q], j), u[q]);
#pragma unroll
    for (int k0 = 0; k0 < NCAP; k0 += 4) {
      if (k0 + 3 > j && (!kGuard || k0 < n)) {
#pragma unroll
        for (int k = k0; k < k0 + 4; ++k)
          if (k > j) a[k] = fmaf(-ctj, shfl(a[j], k), a[k]);  // lane k's S_kj, unscaled
      }
    }
    if (t == j) {
      dt = piv;
      dinv = inv;
    }
    if (t > j) a[j] = ctj;
  }
  // each thread's own pivot: log|K| = sum_t log d_t, and a pivot that is
  // not positive makes the lane NaN
  const bool bad = __any_sync(kFull, row && !(dt > 0.0f));
  const float logdet = warp_sum(row ? logf(dt) : 0.0f);
  float quad = 0.0f;
#pragma unroll
  for (int q = 0; q < KP; ++q)
    if (row && q < p) quad = fmaf(__fmul_rn(u[q], dinv), u[q], quad);
  quad = warp_sum(quad);
  const float nan = __int_as_float(0x7fc00000);
  if (t == 0) {
    const float lp = fmaf(0.5f, logdet, __fmul_rn(0.5f * kLog2Pi, static_cast<float>(n)));
    val[e] = bad ? nan : fmaf(-0.5f, quad, -__fmul_rn(static_cast<float>(p), lp));
  }
  if constexpr (kGrad) {
    // column t of C right of the diagonal: C_kt = S_tk / d_t
#pragma unroll
    for (int k = 0; k < NCAP; ++k)
      if (k > t) a[k] *= dinv;
    // alpha = C^-T D^-1 u, by back substitution; thread t holds entry t
    float z[KP];
#pragma unroll
    for (int q = 0; q < KP; ++q) z[q] = u[q] * dinv;
#pragma unroll
    for (int k = NCAP - 1; k >= 0; --k) {
      if (k >= n) continue;
      const float l = t < k ? a[k] : 0.0f;
#pragma unroll
      for (int q = 0; q < KP; ++q)
        if (!kGuard || q < p) z[q] = fmaf(-l, shfl(z[q], k), z[q]);
    }
    // column t of C^-1: C x = e_t, row i of C broadcast from lane i
    float xc[NCAP];
#pragma unroll
    for (int i = 0; i < NCAP; ++i) xc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < NCAP; ++i) {
      if (i >= n) break;
      float acc = t == i ? 1.0f : 0.0f;
#pragma unroll
      for (int m = 0; m < i; ++m) acc = fmaf(-shfl(a[m], i), xc[m], acc);
      xc[i] = acc;
    }
    // row t of K^-1 = C^-T D^-1 C^-1: sum_k (C^-1)_kt (C^-1)_kj / d_k
    float ki[NCAP];
#pragma unroll
    for (int j = 0; j < NCAP; ++j) ki[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < NCAP; ++k) {
      if (k >= n) break;
      const float w = xc[k] * shfl(dinv, k);
#pragma unroll
      for (int j = 0; j <= k; ++j) ki[j] = fmaf(w, shfl(xc[k], j), ki[j]);
    }

    // gradient: row t of W against row t of dK/dtheta, closed by warp sums
    float g_amp = 0.0f, g_noise = 0.0f;
    if constexpr (!kChunked) {
      float g_ls[KD];
#pragma unroll
      for (int d = 0; d < KD; ++d) g_ls[d] = 0.0f;
      switch (family) {
        case kRbf:
          grad_row<NCAP, KD, KP, kRbf>(xt, il, z, ki, amp, t, n, D, p, &g_amp, &g_noise, g_ls);
          break;
        case kMatern12:
          grad_row<NCAP, KD, KP, kMatern12>(xt, il, z, ki, amp, t, n, D, p, &g_amp, &g_noise, g_ls);
          break;
        case kMatern32:
          grad_row<NCAP, KD, KP, kMatern32>(xt, il, z, ki, amp, t, n, D, p, &g_amp, &g_noise, g_ls);
          break;
        default:
          grad_row<NCAP, KD, KP, kMatern52>(xt, il, z, ki, amp, t, n, D, p, &g_amp, &g_noise, g_ls);
          break;
      }
      if (!row) {
        g_amp = g_noise = 0.0f;
#pragma unroll
        for (int d = 0; d < KD; ++d) g_ls[d] = 0.0f;
      }
      g_amp = warp_sum(g_amp);
      g_noise = warp_sum(g_noise);
#pragma unroll
      for (int d = 0; d < KD; ++d)
        if (d < D) g_ls[d] = warp_sum(g_ls[d]);
      if (t == 0) {
        grad[e] = bad ? nan : g_amp;
        if (n_ls > 1) {
#pragma unroll
          for (int d = 0; d < KD; ++d)
            if (d < D) grad[(1 + d) * E + e] = bad ? nan : g_ls[d] * (-2.0f * il[d]);
        } else {
          float g = 0.0f;
#pragma unroll
          for (int d = 0; d < KD; ++d) g += g_ls[d];
          grad[E + e] = bad ? nan : g * (-2.0f * il[0]);
        }
        if (has_noise) grad[(1 + n_ls) * E + e] = bad ? nan : noise * g_noise;
      }
    } else {
      // D > KD: s of row t over every chunk into a (L is no longer read),
      // then W_tj amp dphi_tj there, then the lengthscale sums chunk by chunk
#pragma unroll
      for (int j = 0; j < NCAP; ++j) a[j] = 0.0f;
      for (int c0 = 0; c0 < D; c0 += KD) {
        load_chunk<KD>(x, theta, E, e, D, n_ls, c0, t, row, xt, il);
        add_scaled_dists<NCAP, KD>(a, xt, il, n, D, c0);
      }
      switch (family) {
        case kRbf:
          wdk_row<NCAP, KP, kRbf>(a, z, ki, amp, t, n, p, &g_amp, &g_noise);
          break;
        case kMatern12:
          wdk_row<NCAP, KP, kMatern12>(a, z, ki, amp, t, n, p, &g_amp, &g_noise);
          break;
        case kMatern32:
          wdk_row<NCAP, KP, kMatern32>(a, z, ki, amp, t, n, p, &g_amp, &g_noise);
          break;
        default:
          wdk_row<NCAP, KP, kMatern52>(a, z, ki, amp, t, n, p, &g_amp, &g_noise);
          break;
      }
      if (!row) g_amp = g_noise = 0.0f;
      g_amp = warp_sum(g_amp);
      g_noise = warp_sum(g_noise);
      float g_iso = 0.0f;
      const float il0 = expf(-2.0f * theta[E + e]);
      for (int c0 = 0; c0 < D; c0 += KD) {
        load_chunk<KD>(x, theta, E, e, D, n_ls, c0, t, row, xt, il);
        float gl[KD];
#pragma unroll
        for (int d = 0; d < KD; ++d) gl[d] = 0.0f;
#pragma unroll
        for (int j = 0; j < NCAP; ++j) {
          if (j >= n) break;
#pragma unroll
          for (int d = 0; d < KD; ++d) {
            if (c0 + d < D) {
              const float diff = xt[d] - shfl(xt[d], j);
              gl[d] += a[j] * (diff * diff);
            }
          }
        }
#pragma unroll
        for (int d = 0; d < KD; ++d) {
          if (c0 + d < D) {
            gl[d] = warp_sum(row ? gl[d] : 0.0f);
            if (n_ls > 1) {
              if (t == 0) grad[(1 + c0 + d) * E + e] = bad ? nan : gl[d] * (-2.0f * il[d]);
            } else {
              g_iso += gl[d];
            }
          }
        }
      }
      if (t == 0) {
        grad[e] = bad ? nan : g_amp;
        if (n_ls == 1) grad[E + e] = bad ? nan : g_iso * (-2.0f * il0);
        if (has_noise) grad[(1 + n_ls) * E + e] = bad ? nan : noise * g_noise;
      }
    }
  }
}

template <bool kGrad>
int launch(const void* X, const void* Y, const void* theta, void* val, void* grad, int n, int D,
           int p, int n_ls, int has_noise, int family, float jitter, long long E,
           long long x_stride, long long y_stride, void* stream) {
  const dim3 blocks(static_cast<unsigned>((E + kWarps - 1) / kWarps));
  auto kernel = lml_kernel<32, kMaxD, kMaxP, false, kGrad>;
  if (D > kMaxD)
    kernel = lml_kernel<32, kMaxD, kMaxP, true, kGrad>;
  else if (n <= kPathN && D <= kPathD && p <= kPathP)
    kernel = lml_kernel<kPathN, kPathD, kPathP, false, kGrad>;
  kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(Y),
      static_cast<const float*>(theta), static_cast<float*>(val), static_cast<float*>(grad), n,
      D, p, n_ls, has_noise, family, jitter, E, x_stride, y_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Contiguous float32 device buffers: X (n, D), Y (n, p), theta (T, E),
// val (E,), grad (T, E) with T = 1 + n_ls + has_noise; n <= 32, any D,
// p <= 8; family 0 rbf, 1 matern12, 2 matern32, 3 matern52.
extern "C" int small_lml_value_grad_f32(const void* X, const void* Y, const void* theta,
                                        void* val, void* grad, int n, int D, int p, int n_ls,
                                        int has_noise, int family, float jitter, long long E,
                                        void* stream) {
  return launch<true>(X, Y, theta, val, grad, n, D, p, n_ls, has_noise, family, jitter, E, 0, 0,
                      stream);
}

// The same with one dataset per lane: X (E, n, D), Y (E, n, p).
extern "C" int small_lml_value_grad_md_f32(const void* X, const void* Y, const void* theta,
                                           void* val, void* grad, int n, int D, int p,
                                           int n_ls, int has_noise, int family, float jitter,
                                           long long E, void* stream) {
  return launch<true>(X, Y, theta, val, grad, n, D, p, n_ls, has_noise, family, jitter, E,
                      static_cast<long long>(n) * D, static_cast<long long>(n) * p, stream);
}

// The per-lane value alone (no inverse, no gradient; grad is not written),
// bit for bit the value small_lml_value_grad_md_f32 gives.
extern "C" int small_lml_value_md_f32(const void* X, const void* Y, const void* theta,
                                      void* val, int n, int D, int p, int n_ls, int has_noise,
                                      int family, float jitter, long long E, void* stream) {
  return launch<false>(X, Y, theta, val, nullptr, n, D, p, n_ls, has_noise, family, jitter, E,
                       static_cast<long long>(n) * D, static_cast<long long>(n) * p, stream);
}

// Registers and resident warps per SM of the instances (cudaFuncGetAttributes,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), for the on-card record:
// index 2*i + v for i = 0 the paths' instance (n <= 24, D <= 2, p <= 2),
// 1 the general one, 2 the general one past eight coordinates, and v = 0
// value and gradient, 1 value only.  Returns a cudaError_t.
extern "C" int small_lml_occupancy(int* regs, int* warps) {
  const void* fns[6] = {
      reinterpret_cast<const void*>(lml_kernel<kPathN, kPathD, kPathP, false, true>),
      reinterpret_cast<const void*>(lml_kernel<kPathN, kPathD, kPathP, false, false>),
      reinterpret_cast<const void*>(lml_kernel<32, kMaxD, kMaxP, false, true>),
      reinterpret_cast<const void*>(lml_kernel<32, kMaxD, kMaxP, false, false>),
      reinterpret_cast<const void*>(lml_kernel<32, kMaxD, kMaxP, true, true>),
      reinterpret_cast<const void*>(lml_kernel<32, kMaxD, kMaxP, true, false>)};
  for (int i = 0; i < 6; ++i) {
    cudaFuncAttributes attr;
    int blocks = 0;
    cudaError_t err = cudaFuncGetAttributes(&attr, fns[i]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i], kWarps * 32, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    regs[i] = attr.numRegs;
    warps[i] = blocks * kWarps;
  }
  return 0;
}
