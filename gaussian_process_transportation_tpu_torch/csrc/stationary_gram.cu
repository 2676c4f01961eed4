// Stationary-kernel Gram tiles for the exact GP, float32, three kernels on
// one shared distance routine:
//
//   stationary_gram    out = amp * phi(|x - z|^2)               (N, M)
//   predict_mean       mean = k(Xq, X) alpha                    (Nq, P)
//   predict_mean_var   mean, and var = max(prior - diag(k K^-1 k^T), 0)
//
// with phi the unit-amplitude RBF or Matern 1/2, 3/2, 5/2 profile of the
// squared distance between lengthscale-scaled points (the wrapper divides
// by the lengthscales).  They replace the TPU Pallas kernels of
// gaussian_process_transportation_tpu/ops/pallas_gram.py: the inner kernel
// of stationary_gram, _mean_kernel (fused_gp_predict_mean) and
// _mean_var_kernel (fused_gp_predict_mean_var).
//
// d^2 is summed from per-dimension differences (exact; the |x|^2+|z|^2-2x.z
// expansion cancels in float32), and the Matern profiles take
// sqrt(d^2 + 1e-36) as the JAX code does.  Ragged edges are masked: a
// training point past N contributes 0, a query past Nq is not written.
//
// Design and bounds on an H100 (3.35 TB/s, 67 TFLOP/s f32):
// * stationary_gram writes each output once from 32 x 32 tiles whose points
//   sit in shared memory: memory-bound, e.g. the lower Gram panels at
//   N = 10240, B = 512 are 210 MB, a 63 us bound.
// * predict_mean: a block owns 64 queries, 4 slices of 64 threads walk the
//   training points in shared-memory chunks of 128 and the slices' sums are
//   added in a fixed order, so the (Nq, N) Gram never reaches device memory.
//   2 Nq N P FMAs plus Nq N profile evaluations: a few us at Nq = 10^4,
//   N = 2048.
// * predict_mean_var: the TPU kernel carried a (tile_q, N) row of
//   W = k K^-1 in scratch across sequential grid steps; CUDA blocks run in
//   no order and 64 x 2048 floats is 512 KB.  So a block owns a 64-query by
//   64-column tile of W, loops over the training points a in chunks of 16
//   (k tile and K^-1 tile in shared memory, a 4 x 4 register tile of W per
//   thread), and closes its columns at once: partial[b_tile, q] =
//   sum_{b in tile} W[q, b] k[q, b].  A second kernel adds the partials over
//   the column tiles in a fixed order: no atomics, so repeated runs agree
//   bitwise.  The mean is accumulated by the blocks of column tile 0.
//   About 2 Nq N^2 FLOP: 84 GFLOP, 1.25 ms at Nq = 10^4, N = 2048.  Shared
//   memory does not grow with N (about 21 KB a block), so unlike the TPU
//   kernel there is no N cap; the limits are D <= 16 and P <= 8, the sizes
//   of the per-thread coordinate and output arrays.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;
constexpr int kMaxP = 8;
constexpr int kDP = kMaxD + 1;  // shared-memory pitch of a point's coordinates

__device__ __forceinline__ float profile(float d2, int family) {
  if (family == 0) return expf(-0.5f * d2);
  const float d = sqrtf(d2 + 1e-36f);
  if (family == 1) return expf(-d);
  if (family == 2) {
    const float s = 1.7320508075688772f * d;
    return (1.f + s) * expf(-s);
  }
  const float s = 2.23606797749979f * d;
  return (1.f + s + s * s / 3.f) * expf(-s);
}

__device__ __forceinline__ float sqdist(const float* x, const float* z, int D) {
  float d2 = 0.f;
  for (int d = 0; d < D; ++d) {
    const float diff = x[d] - z[d];
    d2 = fmaf(diff, diff, d2);
  }
  return d2;
}

// load rows [r0, r0 + rows) of a (n, D) array into dst[rows][kDP], 0 past n
__device__ void load_points(float* dst, const float* src, int r0, int rows, int n, int D) {
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    dst[r * kDP + d] = (r0 + r < n) ? src[static_cast<long long>(r0 + r) * D + d] : 0.f;
  }
}

// ---- stationary_gram: 32 x 32 output tiles, 256 threads -------------------
constexpr int kGT = 32;

__global__ void __launch_bounds__(256)
gram_kernel(const float* __restrict__ X, const float* __restrict__ Z, int N, int M, int D,
            float amp, int family, float* __restrict__ out, long long ldo) {
  __shared__ float xs[kGT * kDP], zs[kGT * kDP];
  const int i0 = blockIdx.y * kGT, j0 = blockIdx.x * kGT;
  load_points(xs, X, i0, kGT, N, D);
  load_points(zs, Z, j0, kGT, M, D);
  __syncthreads();
  const int tx = threadIdx.x % kGT, ty = threadIdx.x / kGT;
  const int j = j0 + tx;
  if (j >= M) return;
  for (int r = ty; r < kGT; r += 256 / kGT) {
    const int i = i0 + r;
    if (i < N) out[i * ldo + j] = amp * profile(sqdist(xs + r * kDP, zs + tx * kDP, D), family);
  }
}

// ---- predict_mean: 64 queries x 4 training slices, 256 threads ------------
constexpr int kMQ = 64, kMS = 4, kMK = 128;

__global__ void __launch_bounds__(kMQ * kMS)
mean_kernel(const float* __restrict__ Xq, const float* __restrict__ X,
            const float* __restrict__ alpha, int Nq, int N, int D, int P, float amp, int family,
            float* __restrict__ mean) {
  __shared__ float xk[kMK * kDP], ak[kMK * kMaxP], red[kMS * kMQ * kMaxP];
  const int q = threadIdx.x % kMQ, sl = threadIdx.x / kMQ;
  const int gq = blockIdx.x * kMQ + q;
  float xq[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d)
    xq[d] = (d < D && gq < Nq) ? Xq[static_cast<long long>(gq) * D + d] : 0.f;
  float acc[kMaxP];
#pragma unroll
  for (int p = 0; p < kMaxP; ++p) acc[p] = 0.f;
  for (int a0 = 0; a0 < N; a0 += kMK) {
    __syncthreads();
    load_points(xk, X, a0, kMK, N, D);
    for (int e = threadIdx.x; e < kMK * P; e += blockDim.x) {
      const int a = e / P, p = e % P;
      ak[a * kMaxP + p] = (a0 + a < N) ? alpha[static_cast<long long>(a0 + a) * P + p] : 0.f;
    }
    __syncthreads();
    const int na = min(kMK, N - a0);
    for (int a = sl; a < na; a += kMS) {
      float d2 = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) {
          const float diff = xq[d] - xk[a * kDP + d];
          d2 = fmaf(diff, diff, d2);
        }
      const float kv = amp * profile(d2, family);
#pragma unroll
      for (int p = 0; p < kMaxP; ++p)
        if (p < P) acc[p] = fmaf(kv, ak[a * kMaxP + p], acc[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < kMaxP; ++p) red[(sl * kMQ + q) * kMaxP + p] = acc[p];
  __syncthreads();
  if (sl == 0 && gq < Nq) {
    for (int p = 0; p < P; ++p) {
      float s = 0.f;
      for (int t = 0; t < kMS; ++t) s += red[(t * kMQ + q) * kMaxP + p];
      mean[static_cast<long long>(gq) * P + p] = s;
    }
  }
}

// ---- predict_mean_var: 64 queries x 64 columns of K^-1, 256 threads -------
constexpr int kVQ = 64, kVB = 64, kVA = 16, kVPad = 68;

__global__ void __launch_bounds__(256)
mean_var_kernel(const float* __restrict__ Xq, const float* __restrict__ X,
                const float* __restrict__ alpha, const float* __restrict__ Kinv, int Nq, int N,
                int D, int P, float amp, int family, float* __restrict__ mean,
                float* __restrict__ partial) {
  __shared__ float xq_s[kVQ * kDP], xb_s[kVB * kDP], xa_s[kVA * kDP];
  __shared__ float ks[kVA * kVPad], kinv_s[kVA * kVPad], al_s[kVA * kMaxP];
  __shared__ float red[kVQ * 17];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kVQ, b0 = blockIdx.y * kVB;
  const bool with_mean = blockIdx.y == 0;
  load_points(xq_s, Xq, q0, kVQ, Nq, D);
  load_points(xb_s, X, b0, kVB, N, D);
  float w[4][4] = {};
  float macc[kMaxP];
#pragma unroll
  for (int p = 0; p < kMaxP; ++p) macc[p] = 0.f;

  for (int a0 = 0; a0 < N; a0 += kVA) {
    __syncthreads();
    load_points(xa_s, X, a0, kVA, N, D);
    for (int e = tid; e < kVA * kVB; e += 256) {
      const int a = e / kVB, b = e % kVB;
      kinv_s[a * kVPad + b] = (a0 + a < N && b0 + b < N)
                                  ? Kinv[static_cast<long long>(a0 + a) * N + b0 + b] : 0.f;
    }
    if (with_mean)
      for (int e = tid; e < kVA * P; e += 256) {
        const int a = e / P, p = e % P;
        al_s[a * kMaxP + p] = (a0 + a < N) ? alpha[static_cast<long long>(a0 + a) * P + p] : 0.f;
      }
    __syncthreads();
    for (int e = tid; e < kVA * kVQ; e += 256) {
      const int a = e / kVQ, qq = e % kVQ;
      ks[a * kVPad + qq] = (a0 + a < N)
                               ? amp * profile(sqdist(xq_s + qq * kDP, xa_s + a * kDP, D), family)
                               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kVA; ++a) {
      float kv[4], iv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = ks[a * kVPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) iv[j] = kinv_s[a * kVPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[i][j] = fmaf(kv[i], iv[j], w[i][j]);
    }
    if (with_mean && tid < kVQ)
      for (int a = 0; a < kVA; ++a) {
        const float kv = ks[a * kVPad + tid];
#pragma unroll
        for (int p = 0; p < kMaxP; ++p)
          if (p < P) macc[p] = fmaf(kv, al_s[a * kMaxP + p], macc[p]);
      }
  }

  // close this block's columns: sum_b W[q, b] k[q, b]
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qq = ty + 16 * i, b = tx + 16 * j;
      if (b0 + b < N)
        part[i] = fmaf(w[i][j],
                       amp * profile(sqdist(xq_s + qq * kDP, xb_s + b * kDP, D), family),
                       part[i]);
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[(ty + 16 * i) * 17 + tx] = part[i];
  __syncthreads();
  if (tid < kVQ && q0 + tid < Nq) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[tid * 17 + t];
    partial[static_cast<long long>(blockIdx.y) * Nq + q0 + tid] = s;
    if (with_mean)
      for (int p = 0; p < P; ++p) mean[static_cast<long long>(q0 + tid) * P + p] = macc[p];
  }
}

__global__ void combine_var_kernel(const float* __restrict__ partial, int tiles, int Nq,
                                   float prior, float* __restrict__ var) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Nq) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += partial[static_cast<long long>(t) * Nq + q];
  var[q] = fmaxf(prior - s, 0.f);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Each entry launches on `stream` and returns the CUDA error after its
// launches (0 = ok).  Points are contiguous (rows, D) float32 device
// buffers already divided by the lengthscales; family 0..3 is rbf,
// matern12, matern32, matern52.  The wrapper checks D <= 16, P <= 8.

extern "C" int stationary_gram_f32(const void* X, const void* Z, int N, int M, int D, float amp,
                                   int family, void* out, long long ldo, void* stream) {
  const dim3 grid(cdiv(M, kGT), cdiv(N, kGT));
  gram_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(Z), N, M, D, amp, family,
      static_cast<float*>(out), ldo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int predict_mean_f32(const void* Xq, const void* X, const void* alpha, int Nq, int N,
                                int D, int P, float amp, int family, void* mean, void* stream) {
  mean_kernel<<<cdiv(Nq, kMQ), kMQ * kMS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Xq), static_cast<const float*>(X),
      static_cast<const float*>(alpha), Nq, N, D, P, amp, family, static_cast<float*>(mean));
  return static_cast<int>(cudaGetLastError());
}

// partial is a (ceil(N / 64), Nq) float32 scratch buffer.
extern "C" int predict_mean_var_f32(const void* Xq, const void* X, const void* alpha,
                                    const void* Kinv, int Nq, int N, int D, int P, float amp,
                                    float prior, int family, void* mean, void* var,
                                    void* partial, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = cdiv(N, kVB);
  mean_var_kernel<<<dim3(cdiv(Nq, kVQ), tiles), 256, 0, s>>>(
      static_cast<const float*>(Xq), static_cast<const float*>(X),
      static_cast<const float*>(alpha), static_cast<const float*>(Kinv), Nq, N, D, P, amp, family,
      static_cast<float*>(mean), static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_var_kernel<<<cdiv(Nq, 256), 256, 0, s>>>(static_cast<const float*>(partial), tiles, Nq,
                                                   prior, static_cast<float*>(var));
  return static_cast<int>(cudaGetLastError());
}
