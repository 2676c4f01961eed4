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
// * predict_mean: Nq N profile evaluations (one expf each) and 2 Nq N P
//   FMAs, so the f32 pipes and the SFU's exponentials bound it: about 5 us
//   each at Nq = 10^4, N = 2048, D = 2, P = 2.  The training axis is split
//   over a second grid dimension: block (i, c) takes 256 queries (two a
//   thread, in registers) against the 128 training points of chunk c, whose
//   coordinates and alpha rows sit in shared memory and are read as
//   broadcasts, and writes the chunk's partial sums; at that shape 640
//   blocks of four warps, about 19 warps an SM.  A second kernel adds the
//   partials in chunk order and scales by the amplitude: no atomics, so
//   repeated runs agree bitwise, and the (Nq, N) Gram never reaches device
//   memory.  The family, D = 2 and D = 3 (other D up to 16 at run time) and
//   the capacity of P (2 or 8) are template parameters, so the innermost
//   loop holds no switch and unrolls over the point's coordinates.
// * predict_mean_var: the TPU kernel carried a (tile_q, N) row of
//   W = k K^-1 in scratch across sequential grid steps; CUDA blocks run in
//   no order, so a block owns a 128-query by 128-column tile of W and loops
//   over the training points a in slices of 16.  About 2 Nq N^2 FLOP (84
//   GFLOP, a 1.25 ms bound at Nq = 10^4, N = 2048) against 16 MB of K^-1:
//   bound by the f32 FMA rate, so the design spends as few other instructions
//   per FMA as it can:
//   - 256 threads, an 8 x 8 register tile of W a thread, laid out as two
//     groups of 4 neighbouring rows and columns, so the operands of 64 FMAs
//     are four 16-byte shared-memory loads, free of bank conflicts;
//   - two stages of operand slices in shared memory and one __syncthreads a
//     slice: the K^-1 slice of step t + 1 arrives by cp.async (16 bytes a
//     copy, zero-filled past N; 4 bytes a copy when the rows of K^-1 are not
//     16-byte aligned) while the FMAs of step t run, and the k slice of
//     step t + 1 (8 profile evaluations a thread) is computed between the
//     copy's start and its wait;
//   - each k entry is evaluated once per column tile, N / 128 times in all,
//     and amortised over 128 FMAs; for D = 2 and D = 3 the kernel is compiled
//     with the dimension fixed, so the distance unrolls and a thread's query
//     stays in registers; other D read it at run time, which is slower.
//   The block closes its columns at once: partial[b_tile, q] =
//   sum_{b in tile} W[q, b] k[q, b], reduced in a fixed order inside the
//   block.  A second kernel adds the partials over the column tiles in tile
//   order: no atomics, so repeated runs agree bitwise.  The mean is
//   accumulated by the blocks of column tile 0.  Shared memory does not grow
//   with N (about 56 KB a block, two blocks an SM), so unlike the TPU kernel
//   there is no N cap; the limits are D <= 16 and P <= 8, the sizes of the
//   shared coordinate and output arrays.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;
constexpr int kMaxP = 8;
constexpr int kDP = kMaxD + 1;  // shared-memory pitch of a point's coordinates

// the unit-amplitude profile of family FAM (0..3: rbf, matern12, matern32,
// matern52) at squared distance d2
template <int FAM>
__device__ __forceinline__ float profile_t(float d2) {
  if (FAM == 0) return expf(-0.5f * d2);
  const float d = sqrtf(d2 + 1e-36f);
  if (FAM == 1) return expf(-d);
  if (FAM == 2) {
    const float s = 1.7320508075688772f * d;
    return (1.f + s) * expf(-s);
  }
  const float s = 2.23606797749979f * d;
  return (1.f + s + s * s / 3.f) * expf(-s);
}

__device__ __forceinline__ float profile(float d2, int family) {
  switch (family) {
    case 0: return profile_t<0>(d2);
    case 1: return profile_t<1>(d2);
    case 2: return profile_t<2>(d2);
    default: return profile_t<3>(d2);
  }
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

// ---- predict_mean: the training axis in chunks over blocks, 128 threads ----
constexpr int kMThreads = 128, kMR = 2, kMQ = kMThreads * kMR, kMC = 128;

// partial[c, q, p] = sum over the points a of chunk c, in order, of
// phi(|xq - xa|^2) alpha[a, p].  KD > 0 fixes D; KD == 0 reads D_any
// (<= kMaxD).  KP bounds P (2 or 8).
template <int FAM, int KD, int KP>
__global__ void __launch_bounds__(kMThreads)
mean_chunk_kernel(const float* __restrict__ Xq, const float* __restrict__ X,
                  const float* __restrict__ alpha, int Nq, int N, int D_any, int P,
                  float* __restrict__ partial) {
  constexpr int kD = KD > 0 ? KD : kMaxD;
  const int D = KD > 0 ? KD : D_any;
  __shared__ float xs[kMC * kD], as[kMC * KP];
  const int a0 = blockIdx.y * kMC, na = min(kMC, N - a0);
  for (int e = threadIdx.x; e < kMC * kD; e += kMThreads) {
    const int a = e / kD, d = e % kD;
    xs[e] = (a < na && d < D) ? X[static_cast<long long>(a0 + a) * D + d] : 0.f;
  }
  for (int e = threadIdx.x; e < kMC * KP; e += kMThreads) {
    const int a = e / KP, p = e % KP;
    as[e] = (a < na && p < P) ? alpha[static_cast<long long>(a0 + a) * P + p] : 0.f;
  }
  float xq[kMR][kD], acc[kMR][KP];
#pragma unroll
  for (int r = 0; r < kMR; ++r) {
    const int q = blockIdx.x * kMQ + r * kMThreads + threadIdx.x;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      xq[r][d] = (q < Nq && (KD > 0 || d < D)) ? Xq[static_cast<long long>(q) * D + d] : 0.f;
#pragma unroll
    for (int p = 0; p < KP; ++p) acc[r][p] = 0.f;
  }
  __syncthreads();
#pragma unroll 2
  for (int a = 0; a < na; ++a) {
    float xa[kD], al[KP];
#pragma unroll
    for (int d = 0; d < kD; ++d) xa[d] = (KD > 0 || d < D) ? xs[a * kD + d] : 0.f;
#pragma unroll
    for (int p = 0; p < KP; ++p) al[p] = as[a * KP + p];
#pragma unroll
    for (int r = 0; r < kMR; ++r) {
      float d2 = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        if (KD > 0 || d < D) {
          const float diff = xq[r][d] - xa[d];
          d2 = fmaf(diff, diff, d2);
        }
      }
      const float k = profile_t<FAM>(d2);
#pragma unroll
      for (int p = 0; p < KP; ++p)
        if (KP <= 2 || p < P) acc[r][p] = fmaf(k, al[p], acc[r][p]);
    }
  }
#pragma unroll
  for (int r = 0; r < kMR; ++r) {
    const int q = blockIdx.x * kMQ + r * kMThreads + threadIdx.x;
    if (q < Nq) {
      float* out = partial + (static_cast<long long>(blockIdx.y) * Nq + q) * P;
#pragma unroll
      for (int p = 0; p < KP; ++p)
        if (p < P) out[p] = acc[r][p];
    }
  }
}

// mean[i] = amp * sum over the chunks c, in order, of partial[c, i]
__global__ void combine_mean_kernel(const float* __restrict__ partial, int chunks,
                                    long long NqP, float amp, float* __restrict__ mean) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= NqP) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[c * NqP + i];
  mean[i] = amp * s;
}

using MeanKernel = void (*)(const float*, const float*, const float*, int, int, int, int, float*);

template <int FAM>
MeanKernel mean_instance(int D, int P) {
  if (P <= 2)
    return D == 2 ? mean_chunk_kernel<FAM, 2, 2>
                  : D == 3 ? mean_chunk_kernel<FAM, 3, 2> : mean_chunk_kernel<FAM, 0, 2>;
  return D == 2 ? mean_chunk_kernel<FAM, 2, kMaxP>
                : D == 3 ? mean_chunk_kernel<FAM, 3, kMaxP> : mean_chunk_kernel<FAM, 0, kMaxP>;
}

// ---- predict_mean_var: 128 queries x 128 columns of K^-1, 256 threads -----
constexpr int kVQ = 128, kVB = 128, kVA = 16, kVThreads = 256;

struct VarSmem {
  float ks[2][kVA * kVQ];     // k slice, ks[a][q]; the epilogue's scratch
  float kinv[2][kVA * kVB];   // K^-1 slice, kinv[a][b]
  float xa[2][kVA * kDP];     // the slice's training points
  float al[2][kVA * kMaxP];   // the slice's alpha rows (column tile 0 only)
  float xq[kVQ * kDP];        // the block's queries
  float xb[kVB * kDP];        // the training points of the block's columns
  float mean[kVQ * kMaxP];    // mean accumulators (column tile 0 only)
};

// row or column g < 8 of a thread's register tile: two groups of 4 neighbours
__device__ __forceinline__ int tile_index(int t, int g) { return 4 * t + (g & 3) + 64 * (g >> 2); }

// kD > 0 fixes the dimension at compile time (the distance loops unroll and
// a thread keeps its query's coordinates in registers); kD == 0 reads it
// from D_any.
template <int kD>
__global__ void __launch_bounds__(kVThreads, 2)
mean_var_kernel(const float* __restrict__ Xq, const float* __restrict__ X,
                const float* __restrict__ alpha, const float* __restrict__ Kinv, long long ldk,
                int Nq, int N, int D_any, int P, float amp, int family, float* __restrict__ mean,
                float* __restrict__ partial) {
  const int D = kD > 0 ? kD : D_any;
  extern __shared__ __align__(16) unsigned char var_smem_raw[];
  VarSmem& s = *reinterpret_cast<VarSmem*>(var_smem_raw);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kVQ, b0 = blockIdx.y * kVB;
  const bool with_mean = blockIdx.y == 0;
  const bool aligned = reinterpret_cast<unsigned long long>(Kinv) % 16 == 0 && ldk % 4 == 0;
  const int slices = (N + kVA - 1) / kVA;

  // K^-1 rows [a0, a0 + 16) of the block's columns into stage st, as one
  // group of asynchronous copies; entries past N are filled with 0
  auto copy_kinv = [&](int st, int a0) {
    if (aligned) {
      const bool inside = a0 + kVA <= N && b0 + kVB <= N;
      for (int e = tid; e < kVA * kVB / 4; e += kVThreads) {
        const int a = e / (kVB / 4), c = 4 * (e % (kVB / 4));
        const int row = a0 + a, col = b0 + c;
        float* dst = &s.kinv[st][a * kVB + c];
        if (inside) {
          __pipeline_memcpy_async(dst, Kinv + row * ldk + col, 16);
        } else {
          const int valid = row < N ? min(max(N - col, 0), 4) : 0;
          __pipeline_memcpy_async(dst, valid ? Kinv + row * ldk + col : Kinv, 16, 16 - 4 * valid);
        }
      }
    } else {
      for (int e = tid; e < kVA * kVB; e += kVThreads) {
        const int a = e / kVB, b = e % kVB;
        const int row = a0 + a, col = b0 + b;
        float* dst = &s.kinv[st][a * kVB + b];
        if (row < N && col < N) {
          __pipeline_memcpy_async(dst, Kinv + row * ldk + col, 4);
        } else {
          __pipeline_memcpy_async(dst, Kinv, 4, 4);
        }
      }
    }
    __pipeline_commit();
  };
  // k(query, training point) of the slice whose points are in s.xa[st]:
  // query tid % 128, every second training point
  auto eval_k = [&](int st, int a0) {
    const int q = tid % kVQ;
    if (kD > 0) {
      float xr[kD > 0 ? kD : 1];
#pragma unroll
      for (int d = 0; d < kD; ++d) xr[d] = s.xq[q * kDP + d];
#pragma unroll
      for (int i = 0; i < kVA * kVQ / kVThreads; ++i) {
        const int a = tid / kVQ + i * (kVThreads / kVQ);
        s.ks[st][a * kVQ + q] =
            (a0 + a < N) ? amp * profile(sqdist(xr, s.xa[st] + a * kDP, kD), family) : 0.f;
      }
    } else {
      for (int a = tid / kVQ; a < kVA; a += kVThreads / kVQ)
        s.ks[st][a * kVQ + q] =
            (a0 + a < N) ? amp * profile(sqdist(s.xq + q * kDP, s.xa[st] + a * kDP, D), family)
                         : 0.f;
    }
  };
  auto load_alpha = [&](int st, int a0) {
    for (int e = tid; e < kVA * P; e += kVThreads) {
      const int a = e / P, p = e % P;
      s.al[st][a * kMaxP + p] =
          (a0 + a < N) ? alpha[static_cast<long long>(a0 + a) * P + p] : 0.f;
    }
  };

  load_points(s.xq, Xq, q0, kVQ, Nq, D);
  load_points(s.xb, X, b0, kVB, N, D);
  load_points(s.xa[0], X, 0, kVA, N, D);
  load_points(s.xa[1], X, kVA, kVA, N, D);
  if (with_mean) {
    load_alpha(0, 0);
    for (int e = tid; e < kVQ * kMaxP; e += kVThreads) s.mean[e] = 0.f;
  }
  copy_kinv(0, 0);
  __syncthreads();
  eval_k(0, 0);
  __pipeline_wait_prior(0);
  __syncthreads();

  float w[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) w[i][j] = 0.f;

  // Step t multiplies stage t % 2 while stage (t + 1) % 2 is filled.  The one
  // barrier at the end of a step orders both: what step t writes (the k,
  // K^-1 and alpha of slice t + 1, the points of slice t + 2) lies in
  // buffers whose last readers ran in step t - 1.
  for (int t = 0; t < slices; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (t + 1 < slices) {
      copy_kinv(nxt, (t + 1) * kVA);
      eval_k(nxt, (t + 1) * kVA);
      if (with_mean) load_alpha(nxt, (t + 1) * kVA);
    }
    if (t + 2 < slices) load_points(s.xa[cur], X, (t + 2) * kVA, kVA, N, D);
#pragma unroll
    for (int a = 0; a < kVA; ++a) {
      const float4 k0 = *reinterpret_cast<const float4*>(&s.ks[cur][a * kVQ + 4 * ty]);
      const float4 k1 = *reinterpret_cast<const float4*>(&s.ks[cur][a * kVQ + 64 + 4 * ty]);
      const float4 i0 = *reinterpret_cast<const float4*>(&s.kinv[cur][a * kVB + 4 * tx]);
      const float4 i1 = *reinterpret_cast<const float4*>(&s.kinv[cur][a * kVB + 64 + 4 * tx]);
      const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float iv[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) w[i][j] = fmaf(kv[i], iv[j], w[i][j]);
    }
    if (with_mean && tid < kVQ)
      for (int p = 0; p < P; ++p) {
        float m = s.mean[tid * kMaxP + p];
        for (int a = 0; a < kVA; ++a)
          m = fmaf(s.ks[cur][a * kVQ + tid], s.al[cur][a * kMaxP + p], m);
        s.mean[tid * kMaxP + p] = m;
      }
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  // close this block's columns: sum_b W[q, b] k[q, b], first over a thread's
  // 8 columns, then over the 16 threads of a row in a fixed order
  float part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    part[i] = 0.f;
    const float* xq = s.xq + tile_index(ty, i) * kDP;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = tile_index(tx, j);
      if (b0 + b < N)
        part[i] = fmaf(w[i][j], amp * profile(sqdist(xq, s.xb + b * kDP, D), family), part[i]);
    }
  }
  float* red = &s.ks[0][0];  // (128, 17) floats; every stage has been consumed
#pragma unroll
  for (int i = 0; i < 8; ++i) red[tile_index(ty, i) * 17 + tx] = part[i];
  __syncthreads();
  if (tid < kVQ && q0 + tid < Nq) {
    float sum = 0.f;
    for (int t = 0; t < 16; ++t) sum += red[tid * 17 + t];
    partial[static_cast<long long>(blockIdx.y) * Nq + q0 + tid] = sum;
    if (with_mean)
      for (int p = 0; p < P; ++p)
        mean[static_cast<long long>(q0 + tid) * P + p] = s.mean[tid * kMaxP + p];
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

// partial is a (ceil(N / chunk), Nq, P) float32 scratch buffer sized by the
// caller, who passes the chunk width it sized it for: another width than
// the kernel's is refused (cudaErrorInvalidValue).
extern "C" int predict_mean_f32(const void* Xq, const void* X, const void* alpha, int Nq, int N,
                                int D, int P, float amp, int family, void* mean, void* partial,
                                int chunk, void* stream) {
  if (chunk != kMC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = cdiv(N, kMC);
  if (chunks > 0) {
    const MeanKernel kernel = family == 0   ? mean_instance<0>(D, P)
                              : family == 1 ? mean_instance<1>(D, P)
                              : family == 2 ? mean_instance<2>(D, P)
                                            : mean_instance<3>(D, P);
    kernel<<<dim3(cdiv(Nq, kMQ), chunks), kMThreads, 0, s>>>(
        static_cast<const float*>(Xq), static_cast<const float*>(X),
        static_cast<const float*>(alpha), Nq, N, D, P, static_cast<float*>(partial));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long NqP = static_cast<long long>(Nq) * P;
  combine_mean_kernel<<<static_cast<unsigned>((NqP + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), chunks, NqP, amp, static_cast<float*>(mean));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block of the mean-and-variance kernel, which
// ptxas does not report.
extern "C" int predict_mean_var_smem_bytes() { return static_cast<int>(sizeof(VarSmem)); }

// Kinv is (N, N) with unit column stride and row stride ldk (in floats), at
// any alignment.  partial is a (ceil(N / tile_b), Nq) float32 scratch buffer
// sized by the caller, who passes the column-tile width it sized it for:
// another width than the kernel's is refused (cudaErrorInvalidValue).
extern "C" int predict_mean_var_f32(const void* Xq, const void* X, const void* alpha,
                                    const void* Kinv, long long ldk, int Nq, int N, int D, int P,
                                    float amp, float prior, int family, void* mean, void* var,
                                    void* partial, int tile_b, void* stream) {
  if (tile_b != kVB) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(sizeof(VarSmem));
  const int tiles = cdiv(N, kVB);
  auto kernel = D == 2 ? mean_var_kernel<2> : D == 3 ? mean_var_kernel<3> : mean_var_kernel<0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(cdiv(Nq, kVQ), tiles), kVThreads, smem, s>>>(
      static_cast<const float*>(Xq), static_cast<const float*>(X),
      static_cast<const float*>(alpha), static_cast<const float*>(Kinv), ldk, Nq, N, D, P, amp,
      family, static_cast<float*>(mean), static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_var_kernel<<<cdiv(Nq, 256), 256, 0, s>>>(static_cast<const float*>(partial), tiles, Nq,
                                                   prior, static_cast<float*>(var));
  return static_cast<int>(cudaGetLastError());
}
