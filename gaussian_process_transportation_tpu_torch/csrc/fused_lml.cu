// The small-N GP log marginal likelihood and its gradient in the
// log-hyperparameters, one warp per lane (a chain, a restart, an ensemble
// member), for the hyperparameter fits and the HMC hyperposterior.
//
// Replaces the two TPU Pallas kernels of
// gaussian_process_transportation_tpu/ops/fused_lml.py:
//   small_lml_value_grad    (body _lml_kernel)    -> entry small_lml_value_grad_f32,
//       one (X, Y) shared by every lane;
//   small_lml_value_grad_md (body _lml_kernel_md) -> entry small_lml_value_grad_md_f32,
//       each lane its own (X, Y).
// Both compute, per lane with theta[:, e] = [log amp, log l (n_ls rows),
// log noise (if has_noise)]:
//   K = amp*phi(s) + (noise + jitter)*I,  s = sum_d (x_i,d - x_j,d)^2 / l_d^2,
//   its Cholesky, alpha = K^-1 Y, log|K|, the LML summed over the p columns,
//   and the trace-identity gradient 1/2 <alpha alpha^T - p K^-1, dK/dtheta>,
// for phi in {rbf, matern12, matern32, matern52}, with the JAX clamps
// sqrt(s + 1e-36) and max(d, 1e-18) (without them the diagonal gives 0*inf).
//
// Layout.  theta (T, E) and grad (T, E) lane-last, val (E,).  X is (n, D)
// and Y (n, p) for the shared entry, (E, n, D) and (E, n, p) for the
// per-lane one: the kernel reads coordinates and forms the per-dimension
// differences itself, instead of the TPU kernel's (D*n*n, E) slab of
// squared distances (about 40x the bytes at n = 20, D = 2).  Lanes past E
// are masked (their warps return), not padded with copies.
//
// Design.  The TPU kernel unrolls n <= 32 over (n, lanes) VPU tiles; on
// Hopper one warp owns one lane and thread i owns row i.  The lane's K (then
// L, in place) and K^-1 sit in shared memory, 33 words a row so that a
// thread walking its own row and a warp reading one column are both free of
// bank conflicts; the Cholesky is right-looking by columns (thread i scales
// and updates row i), the solves for alpha run column-oriented with the
// solved entry broadcast by __shfl_sync, K^-1 is solved one column per
// thread against L, and the gradient is a row sum per thread closed by a
// fixed-order warp reduction, so runs are bitwise repeatable.  One kernel
// serves every n <= 32, D, p <= 8 and family (runtime arguments, no
// template per shape).  Up to kMaxD = 8 coordinates the points sit in
// shared memory whole; past that the Gram and gradient passes walk the
// coordinates in chunks of kMaxD through the same buffer: the Gram pass
// sums the scaled distance s over every chunk (in the row of K it will
// become) before phi(s), and the gradient pass sums s again into the rows
// of L, which are free by then, replaces it by W_tj dK_tj/ds, and then
// reduces the lengthscale gradient chunk by chunk.  So the shared memory
// a block takes does not grow with D.  A wider Y is split into launches of
// at most kMaxP columns by the wrapper (ops/fused_lml.py), whose values and
// gradients add up.  A lane whose pivot goes non-positive turns its own
// value and gradient into NaN and nothing else; the callers map that to
// 1e25.
//
// What bounds it on an H100.  At L = 28,672 lanes, n = 20, D = 2, p = 2
// (the per-member hyperparameter fit) a launch needs about 0.6 GFLOP of
// f32 work (Gram, Cholesky, K^-1, solves, gradient: ~9 us at 67 TFLOP/s)
// and moves about 10 MB (~3 us), so operations bound it.  This kernel does
// not reach that: each lane is a chain of O(n^2) dependent warp steps, and
// the 42.5 KB of shared memory a block of four lanes takes keeps about 20
// warps on an SM, so latency bounds it.  More lanes per warp, the matrices
// in registers, and fewer synchronised steps are the way to make it fast.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // lanes per block
constexpr int kMaxN = 32;
constexpr int kMaxD = 8;
constexpr int kMaxP = 8;
constexpr int kPad = kMaxN + 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.2360679774997898f;

enum Family { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

struct LaneScratch {
  float A[kMaxN][kPad];   // K, then its lower Cholesky factor in place
  float B[kMaxN][kPad];   // K^-1, B[i][c] = (K^-1)_ic
  float x[kMaxN][kMaxD];  // the lane's points
  float al[kMaxN][kMaxP]; // alpha = K^-1 Y
  float rd[kMaxN];        // 1 / L_jj
};

// phi(s) and dphi/ds of a unit-amplitude stationary kernel (the formulas
// of fused_lml.py:_phi and _dphi).
__device__ __forceinline__ void phi_dphi(float s, int family, float* phi, float* dphi) {
  if (family == kRbf) {
    const float e = expf(-0.5f * s);
    *phi = e;
    *dphi = -0.5f * e;
    return;
  }
  const float d = sqrtf(s + 1e-36f);
  if (family == kMatern12) {
    const float e = expf(-d);
    *phi = e;
    *dphi = -e / (2.0f * fmaxf(d, 1e-18f));
  } else if (family == kMatern32) {
    const float e = expf(-kSqrt3 * d);
    *phi = (1.0f + kSqrt3 * d) * e;
    *dphi = -1.5f * e;
  } else {
    const float sd = kSqrt5 * d;
    const float e = expf(-sd);
    *phi = (1.0f + sd + sd * sd / 3.0f) * e;
    *dphi = -(5.0f / 6.0f) * (1.0f + sd) * e;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Coordinates [c0, c0 + kMaxD) of the lane's points into w.x (zeros past
// D) and their 1 / l_d^2 into il (zeros past D), for D > kMaxD.  The first
// __syncwarp lets every thread finish reading the previous chunk.
__device__ __forceinline__ void stage_chunk(LaneScratch& w, const float* x, const float* theta,
                                            long long E, long long e, int D, int n_ls, int c0,
                                            int t, bool row, float il[kMaxD]) {
#pragma unroll
  for (int d = 0; d < kMaxD; ++d)
    il[d] = c0 + d < D ? expf(-2.0f * theta[(1 + (n_ls > 1 ? c0 + d : 0)) * E + e]) : 0.0f;
  __syncwarp();
  if (row) {
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) w.x[t][d] = c0 + d < D ? x[t * D + c0 + d] : 0.0f;
  }
  __syncwarp();
}

// rowbuf[j] = s(t, j) = sum over every coordinate of (x_t,d - x_j,d)^2 / l_d^2,
// chunk by chunk (D > kMaxD); rowbuf is row t of a lane matrix, which only
// thread t touches here.
__device__ __forceinline__ void scaled_dist_row(LaneScratch& w, float* rowbuf, const float* x,
                                                const float* theta, long long E, long long e,
                                                int n, int D, int n_ls, int t, bool row) {
  float il[kMaxD];
  for (int c0 = 0; c0 < D; c0 += kMaxD) {
    stage_chunk(w, x, theta, E, e, D, n_ls, c0, t, row, il);
    if (row) {
      for (int j = 0; j < n; ++j) {
        float s = c0 ? rowbuf[j] : 0.0f;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) {
          const float diff = w.x[t][d] - w.x[j][d];
          s += diff * diff * il[d];
        }
        rowbuf[j] = s;
      }
    }
  }
}

// kChunked: D > kMaxD, the coordinates walked in chunks; the D <= kMaxD
// instance compiles without that code, so it keeps its registers.
template <bool kChunked>
__global__ void __launch_bounds__(kWarps * 32)
lml_kernel(const float* __restrict__ X, const float* __restrict__ Y,
           const float* __restrict__ theta, float* __restrict__ val,
           float* __restrict__ grad, int n, int D, int p, int n_ls, int has_noise,
           int family, float jitter, long long E, long long x_stride, long long y_stride) {
  __shared__ LaneScratch scratch[kWarps];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const long long e = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (e >= E) return;  // the whole warp: nothing below synchronises the block
  LaneScratch& w = scratch[warp];
  const bool row = t < n;

  // hyperparameters of this lane
  const float amp = expf(theta[e]);
  float inv_ls2[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d)
    inv_ls2[d] = d < D ? expf(-2.0f * theta[(1 + (n_ls > 1 ? d : 0)) * E + e]) : 0.0f;
  const float noise = has_noise ? expf(theta[(1 + n_ls) * E + e]) : 0.0f;

  // the lane's data: thread t holds point t's targets
  const float* x = X + e * x_stride;
  const float* y = Y + e * y_stride;
  float yt[kMaxP];
#pragma unroll
  for (int q = 0; q < kMaxP; ++q) yt[q] = (row && q < p) ? y[t * p + q] : 0.0f;
  if (row) {
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) w.x[t][d] = x[t * D + d];
  }
  __syncwarp();

  // Gram row t
  if (kChunked) {
    scaled_dist_row(w, w.A[t], x, theta, E, e, n, D, n_ls, t, row);
    if (row) {
      for (int j = 0; j < n; ++j) {
        float ph, dph;
        phi_dphi(w.A[t][j], family, &ph, &dph);
        w.A[t][j] = amp * ph + (t == j ? noise + jitter : 0.0f);
      }
    }
  } else if (row) {
    for (int j = 0; j < n; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
          const float diff = w.x[t][d] - w.x[j][d];
          s += diff * diff * inv_ls2[d];
        }
      }
      float ph, dph;
      phi_dphi(s, family, &ph, &dph);
      w.A[t][j] = amp * ph + (t == j ? noise + jitter : 0.0f);
    }
  }

  // right-looking Cholesky in place, thread t scaling and updating row t
  float logdet = 0.0f;
  for (int j = 0; j < n; ++j) {
    __syncwarp();
    const float piv = w.A[j][j];
    const float r = rsqrtf(piv);
    logdet += logf(piv);
    if (t == j) {
      w.A[j][j] = piv * r;
      w.rd[j] = r;
    } else if (t > j && row) {
      w.A[t][j] *= r;
    }
    __syncwarp();
    if (t > j && row) {
      const float ltj = w.A[t][j];
      for (int k = j + 1; k <= t; ++k) w.A[t][k] -= ltj * w.A[k][j];
    }
  }
  __syncwarp();

  // alpha: L z = y, then L^T alpha = z; thread t holds entry t, the solved
  // entry of each step is broadcast from its owner
  float z[kMaxP];
#pragma unroll
  for (int q = 0; q < kMaxP; ++q) z[q] = yt[q];
  for (int k = 0; k < n; ++k) {
    if (t == k) {
#pragma unroll
      for (int q = 0; q < kMaxP; ++q) z[q] *= w.rd[k];
    }
    const float l = (t > k && row) ? w.A[t][k] : 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxP; ++q) {
      if (q < p) z[q] -= l * __shfl_sync(kFull, z[q], k);
    }
  }
  for (int k = n - 1; k >= 0; --k) {
    if (t == k) {
#pragma unroll
      for (int q = 0; q < kMaxP; ++q) z[q] *= w.rd[k];
    }
    const float l = t < k ? w.A[k][t] : 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxP; ++q) {
      if (q < p) z[q] -= l * __shfl_sync(kFull, z[q], k);
    }
  }
  float quad = 0.0f;
  if (row) {
#pragma unroll
    for (int q = 0; q < kMaxP; ++q) {
      if (q < p) {
        w.al[t][q] = z[q];
        quad += yt[q] * z[q];
      }
    }
  }
  quad = warp_sum(quad);
  if (t == 0) val[e] = -0.5f * quad - p * (0.5f * logdet + 0.5f * n * kLog2Pi);

  // K^-1, column t: L u = e_t, then L^T v = u
  if (row) {
    for (int i = 0; i < n; ++i) {
      float acc = i == t ? 1.0f : 0.0f;
      for (int k = 0; k < i; ++k) acc -= w.A[i][k] * w.B[k][t];
      w.B[i][t] = acc * w.rd[i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float acc = w.B[i][t];
      for (int k = i + 1; k < n; ++k) acc -= w.A[k][i] * w.B[k][t];
      w.B[i][t] = acc * w.rd[i];
    }
  }
  __syncwarp();

  // gradient: row t of W = 1/2 (alpha alpha^T - p K^-1) against dK/dtheta
  if (kChunked) {
    // s of row t into row t of L (no longer read), then W_tj amp dphi_tj there
    float g_amp = 0.0f, g_noise = 0.0f, g_iso = 0.0f;
    scaled_dist_row(w, w.A[t], x, theta, E, e, n, D, n_ls, t, row);
    if (row) {
      for (int j = 0; j < n; ++j) {
        float ph, dph;
        phi_dphi(w.A[t][j], family, &ph, &dph);
        float aa = 0.0f;
#pragma unroll
        for (int q = 0; q < kMaxP; ++q) {
          if (q < p) aa += z[q] * w.al[j][q];
        }
        const float wtj = 0.5f * (aa - p * w.B[t][j]);
        g_amp += wtj * (amp * ph);
        w.A[t][j] = wtj * (amp * dph);
        if (j == t) g_noise += wtj;
      }
    }
    g_amp = warp_sum(g_amp);
    g_noise = warp_sum(g_noise);
    float il[kMaxD];
    for (int c0 = 0; c0 < D; c0 += kMaxD) {
      stage_chunk(w, x, theta, E, e, D, n_ls, c0, t, row, il);
      float gl[kMaxD];
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) gl[d] = 0.0f;
      if (row) {
        for (int j = 0; j < n; ++j) {
          const float wdk = w.A[t][j];
#pragma unroll
          for (int d = 0; d < kMaxD; ++d) {
            const float diff = w.x[t][d] - w.x[j][d];
            gl[d] += wdk * (diff * diff);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (c0 + d < D) {
          gl[d] = warp_sum(gl[d]);
          if (n_ls > 1) {
            if (t == 0) grad[(1 + c0 + d) * E + e] = gl[d] * (-2.0f * il[d]);
          } else {
            g_iso += gl[d];
          }
        }
      }
    }
    if (t == 0) {
      grad[e] = g_amp;
      if (n_ls == 1) grad[E + e] = g_iso * (-2.0f * inv_ls2[0]);
      if (has_noise) grad[(1 + n_ls) * E + e] = noise * g_noise;
    }
    return;
  }
  float g_amp = 0.0f, g_noise = 0.0f;
  float g_ls[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) g_ls[d] = 0.0f;
  if (row) {
    for (int j = 0; j < n; ++j) {
      float s = 0.0f;
      float d2[kMaxD];
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        d2[d] = 0.0f;
        if (d < D) {
          const float diff = w.x[t][d] - w.x[j][d];
          d2[d] = diff * diff;
          s += d2[d] * inv_ls2[d];
        }
      }
      float ph, dph;
      phi_dphi(s, family, &ph, &dph);
      float aa = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxP; ++q) {
        if (q < p) aa += z[q] * w.al[j][q];
      }
      const float wtj = 0.5f * (aa - p * w.B[t][j]);
      g_amp += wtj * (amp * ph);
      const float wdk = wtj * (amp * dph);
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) g_ls[d] += wdk * d2[d];
      if (j == t) g_noise += wtj;
    }
  }
  g_amp = warp_sum(g_amp);
  g_noise = warp_sum(g_noise);
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    if (d < D) g_ls[d] = warp_sum(g_ls[d]);
  }
  if (t == 0) {
    grad[e] = g_amp;
    if (n_ls > 1) {
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) grad[(1 + d) * E + e] = g_ls[d] * (-2.0f * inv_ls2[d]);
      }
    } else {
      float g = 0.0f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) g += g_ls[d];
      grad[E + e] = g * (-2.0f * inv_ls2[0]);
    }
    if (has_noise) grad[(1 + n_ls) * E + e] = noise * g_noise;
  }
}

int launch(const void* X, const void* Y, const void* theta, void* val, void* grad, int n,
           int D, int p, int n_ls, int has_noise, int family, float jitter, long long E,
           long long x_stride, long long y_stride, void* stream) {
  const long long blocks = (E + kWarps - 1) / kWarps;
  auto kernel = D > kMaxD ? lml_kernel<true> : lml_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(Y),
      static_cast<const float*>(theta), static_cast<float*>(val), static_cast<float*>(grad),
      n, D, p, n_ls, has_noise, family, jitter, E, x_stride, y_stride);
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
  return launch(X, Y, theta, val, grad, n, D, p, n_ls, has_noise, family, jitter, E, 0, 0,
                stream);
}

// The same with one dataset per lane: X (E, n, D), Y (E, n, p).
extern "C" int small_lml_value_grad_md_f32(const void* X, const void* Y, const void* theta,
                                           void* val, void* grad, int n, int D, int p,
                                           int n_ls, int has_noise, int family, float jitter,
                                           long long E, void* stream) {
  return launch(X, Y, theta, val, grad, n, D, p, n_ls, has_noise, family, jitter, E,
                static_cast<long long>(n) * D, static_cast<long long>(n) * p, stream);
}
