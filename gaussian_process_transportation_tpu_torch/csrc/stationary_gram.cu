// Stationary-kernel Gram tiles for the exact GP, float32, on one shared
// distance routine:
//
//   stationary_gram         out = amp * phi(|x - z|^2)            (N, M)
//   stationary_gram_panels  the lower column panels of the padded
//                           amp * phi + noise * I of one point set
//   predict_mean            mean = k(Xq, X) alpha                  (Nq, P)
//   predict_mean_var        mean, and var = max(prior - diag(k K^-1 k^T), 0)
//
// with phi the unit-amplitude RBF or Matern 1/2, 3/2, 5/2 profile of the
// squared distance between lengthscale-scaled points.  They replace the TPU
// Pallas kernels of gaussian_process_transportation_tpu/ops/pallas_gram.py:
// the inner kernel of stationary_gram (both Gram entries),
// _mean_kernel (fused_gp_predict_mean) and _mean_var_kernel
// (fused_gp_predict_mean_var).
//
// d^2 is summed from per-dimension differences (exact; the |x|^2+|z|^2-2x.z
// expansion cancels in float32), and the Matern profiles take
// sqrt(d^2 + 1e-36) as the JAX code does.  Ragged edges are masked: a
// training point past N contributes 0, a query past Nq is not written.
//
// Design and bounds on an H100 (3.35 TB/s, 67 TFLOP/s f32):
// * the two Gram entries write each output entry once and read a few
//   bytes of points: bound by the stores, e.g. the lower panels of the
//   N = 10240, B = 512 Gram are 220 MB, a 66 us bound, against 0.013 ms of
//   exponentials at the special-function units' rate.  One block writes a
//   64-row by 128-column tile with 256 threads: a thread keeps the points
//   of 4 adjacent columns in registers and writes one 16-byte float4 a row
//   over 8 rows, whose points it reads from shared memory as broadcasts, so
//   a warp stores 512 contiguous bytes a row.  The grid is flat over the
//   tiles (no 65,535 limit of a y dimension) and every offset is 64-bit (at
//   N = 65536 the panel buffer has 2.2e9 entries).  The family and D = 1, 2,
//   3 are template parameters (other D up to 16 at run time), so the entry
//   loop holds no switch.  The points are divided by the lengthscales as
//   the tile loads them, the same correctly rounded x / l as the twin's,
//   so the wrappers make no scaled copies.
//   The panel entry writes every lower column panel of the Gram padded to
//   Np = P B points into one buffer: panel k, (Np - k B, B) row-major, at
//   float B^2 (k P - k (k - 1) / 2).  A block finds its (panel, row tile,
//   column tile) from its index with a loop over the panels.  Point p >= n
//   is the far pseudo-point 1e6 (1 + p - n) in every (already scaled)
//   coordinate, so padding couples to every other point by exactly 0, and
//   noise is added where the global row equals the global column: the
//   JAX code's padded copy, concatenation and diagonal pass in one launch.
//   The lengthscales, amplitude and noise are read from device memory when
//   the caller holds them there, so the host never waits on the card.
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

// ---- stationary_gram(_panels): 64 x 128 tiles, 256 threads, float4 stores ---
constexpr int kTR = 64, kTC = 128, kGThreads = 256;
constexpr int kGCols = 4;                              // adjacent columns a thread
constexpr int kGColThreads = kTC / kGCols;             // 32: a warp spans a tile row
constexpr int kGRowStep = kGThreads / kGColThreads;    // 8: rows between a thread's rows
constexpr float kFar = 1e6f;                           // padding: 1e6 (1 + p - n)

// The lengthscales, amplitude and noise: each read from device memory where
// its pointer is set (a CUDA tensor: no host read), else the value.
struct GramScalars {
  const float* ls;     // D lengthscales, or one for all (ls_stride 0)
  const float* amp;
  const float* noise;
  int ls_stride;
  float ls_v[kMaxD];
  float amp_v, noise_v;
};

// Rectangular: rows X (N, D), columns Z (M, D), out (N, M) at row stride
// ldo.  Panels: the n points Z (X == Z, N == M == n) padded to P blocks of B.
struct GramShape {
  const float* X;
  const float* Z;
  float* out;
  long long ldo;
  int N, M, D, B, P;
  bool vec;  // rows start 16-byte aligned: float4 stores
};

// coordinate d of point p of pts (n, D), divided by the lengthscale l;
// past n the far pseudo-point (panels) or 0 (a masked edge)
template <bool PANELS>
__device__ __forceinline__ float gram_coord(const float* pts, int n, int D, int p, int d, float l) {
  if (p < n) return pts[static_cast<long long>(p) * D + d] / l;
  return PANELS ? kFar * static_cast<float>(1 + p - n) : 0.f;
}

template <bool PANELS>
__device__ void load_gram_points(float* dst, const float* src, int p0, int count, int n, int D,
                                 const float* ls) {
  for (int e = threadIdx.x; e < count * D; e += kGThreads) {
    const int r = e / D, d = e % D;
    dst[r * kDP + d] = gram_coord<PANELS>(src, n, D, p0 + r, d, ls[d]);
  }
}

template <int FAM, int KD, bool PANELS>
__global__ void __launch_bounds__(kGThreads)
gram_tile_kernel(GramShape g, GramScalars s) {
  constexpr int kD = KD > 0 ? KD : kMaxD;
  const int D = KD > 0 ? KD : g.D;
  __shared__ float ls[kMaxD];
  __shared__ float xs[kTR * kDP], zs[kTC * kDP];
  const int tid = threadIdx.x;

  // the block's tile: the output matrix (rows x cols at row stride ld), the
  // tile's first row r0 and column c0 in it, and the point index p0 of the
  // matrix's row 0 and column 0 (the same in a panel: its diagonal block)
  long long t = blockIdx.x;
  float* out = g.out;
  long long ld = g.ldo;
  int rows = g.N, cols = g.M, p0 = 0, ctiles = (g.M + kTC - 1) / kTC;
  if (PANELS) {
    ctiles = (g.B + kTC - 1) / kTC;
    int k = 0;
    for (;; ++k) {
      const long long tiles = static_cast<long long>(((g.P - k) * g.B + kTR - 1) / kTR) * ctiles;
      if (t < tiles) break;
      t -= tiles;
    }
    out += static_cast<long long>(g.B) * g.B *
           (static_cast<long long>(k) * g.P - static_cast<long long>(k) * (k - 1) / 2);
    ld = g.B;
    rows = (g.P - k) * g.B;
    cols = g.B;
    p0 = k * g.B;
  }
  const int r0 = static_cast<int>(t / ctiles) * kTR, c0 = static_cast<int>(t % ctiles) * kTC;

  if (tid < D) {
    float l = 0.f;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d == tid) l = s.ls ? s.ls[d * s.ls_stride] : s.ls_v[d];
    ls[tid] = l;
  }
  __syncthreads();
  load_gram_points<PANELS>(xs, g.X, p0 + r0, kTR, g.N, D, ls);
  load_gram_points<PANELS>(zs, g.Z, p0 + c0, kTC, g.M, D, ls);
  __syncthreads();

  const int tx = tid % kGColThreads, ty = tid / kGColThreads;
  const int c = c0 + kGCols * tx;  // the first of the thread's columns
  if (c >= cols) return;
  float zc[kGCols][kD];
#pragma unroll
  for (int j = 0; j < kGCols; ++j)
#pragma unroll
    for (int d = 0; d < kD; ++d)
      zc[j][d] = (KD > 0 || d < D) ? zs[(kGCols * tx + j) * kDP + d] : 0.f;
  const float amp = s.amp ? *s.amp : s.amp_v;
  const float noise = PANELS ? (s.noise ? *s.noise : s.noise_v) : 0.f;

#pragma unroll
  for (int i = 0; i < kTR / kGRowStep; ++i) {
    const int rl = ty + kGRowStep * i, r = r0 + rl;
    if (r < rows) {
      float xr[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) xr[d] = (KD > 0 || d < D) ? xs[rl * kDP + d] : 0.f;
      float v[kGCols];
#pragma unroll
      for (int j = 0; j < kGCols; ++j) {
        float d2 = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          if (KD > 0 || d < D) {
            const float diff = xr[d] - zc[j][d];
            d2 = fmaf(diff, diff, d2);
          }
        }
        v[j] = amp * profile_t<FAM>(d2);
        if (PANELS && r == c + j) v[j] += noise;  // global row == global column
      }
      float* o = out + static_cast<long long>(r) * ld + c;
      if (g.vec && c + kGCols <= cols) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kGCols; ++j)
          if (c + j < cols) o[j] = v[j];
      }
    }
  }
}

using GramKernel = void (*)(GramShape, GramScalars);

template <int FAM, bool PANELS>
GramKernel gram_instance(int D) {
  return D == 1   ? gram_tile_kernel<FAM, 1, PANELS>
         : D == 2 ? gram_tile_kernel<FAM, 2, PANELS>
         : D == 3 ? gram_tile_kernel<FAM, 3, PANELS>
                  : gram_tile_kernel<FAM, 0, PANELS>;
}

template <bool PANELS>
int launch_gram(const GramShape& g, const GramScalars& s, int family, long long tiles,
                cudaStream_t stream) {
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  const GramKernel kernel = family == 0   ? gram_instance<0, PANELS>(g.D)
                            : family == 1 ? gram_instance<1, PANELS>(g.D)
                            : family == 2 ? gram_instance<2, PANELS>(g.D)
                                          : gram_instance<3, PANELS>(g.D);
  kernel<<<static_cast<unsigned>(tiles), kGThreads, 0, stream>>>(g, s);
  return static_cast<int>(cudaGetLastError());
}

GramScalars gram_scalars(const void* ls_dev, int ls_stride, const float* ls_host, int D,
                         const void* amp_dev, float amp, const void* noise_dev, float noise) {
  GramScalars s{};
  s.ls = static_cast<const float*>(ls_dev);
  s.ls_stride = ls_stride;
  if (!ls_dev)
    for (int d = 0; d < D; ++d) s.ls_v[d] = ls_host[d];
  s.amp = static_cast<const float*>(amp_dev);
  s.amp_v = amp;
  s.noise = static_cast<const float*>(noise_dev);
  s.noise_v = noise;
  return s;
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

// mean[i] = amp * sum over the chunks c, in order, of partial[c, i]; amp is
// read from amp_dev where that is not null
__global__ void combine_mean_kernel(const float* __restrict__ partial, int chunks,
                                    long long NqP, const float* __restrict__ amp_dev,
                                    float amp_v, float* __restrict__ mean) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= NqP) return;
  const float amp = amp_dev ? *amp_dev : amp_v;
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
                int Nq, int N, int D_any, int P, const float* __restrict__ amp_dev, float amp_v,
                int family, float* __restrict__ mean, float* __restrict__ partial) {
  const int D = kD > 0 ? kD : D_any;
  const float amp = amp_dev ? *amp_dev : amp_v;
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
                                   const float* __restrict__ prior_dev, float prior_v,
                                   float* __restrict__ var) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Nq) return;
  const float prior = prior_dev ? *prior_dev : prior_v;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += partial[static_cast<long long>(t) * Nq + q];
  var[q] = fmaxf(prior - s, 0.f);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Each entry launches on `stream` and returns the CUDA error after its
// launches (0 = ok).  Points are contiguous (rows, D) float32 device
// buffers; the predicts take them already divided by the lengthscales.
// family 0..3 is rbf, matern12, matern32, matern52.  The wrappers check
// D <= 16, P <= 8.

// The Gram entries take the points as they are and divide them by the
// lengthscales themselves: ls_dev, a device pointer to D float32 values
// (ls_stride 1) or to one for every dimension (ls_stride 0), or, where it
// is null, the D values at the host pointer ls_host.  amp_dev and noise_dev
// are device pointers to one float32 value each or null, and then amp and
// noise are used.  tile_rows and tile_cols are the tile the caller mapped
// the output with: another tile than the kernel's is refused
// (cudaErrorInvalidValue), as is a grid of more than 2^31 - 1 tiles.

// out (N, M) with unit column stride and row stride ldo (in floats).
extern "C" int stationary_gram_f32(const void* X, const void* Z, int N, int M, int D,
                                   const void* ls_dev, int ls_stride, const float* ls_host,
                                   const void* amp_dev, float amp, int family, void* out,
                                   long long ldo, int tile_rows, int tile_cols, void* stream) {
  if (tile_rows != kTR || tile_cols != kTC) return static_cast<int>(cudaErrorInvalidValue);
  GramShape g{};
  g.X = static_cast<const float*>(X);
  g.Z = static_cast<const float*>(Z);
  g.out = static_cast<float*>(out);
  g.ldo = ldo;
  g.N = N;
  g.M = M;
  g.D = D;
  g.vec = reinterpret_cast<unsigned long long>(out) % 16 == 0 && ldo % 4 == 0;
  const long long tiles = static_cast<long long>(cdiv(N, kTR)) * cdiv(M, kTC);
  return launch_gram<false>(g, gram_scalars(ls_dev, ls_stride, ls_host, D, amp_dev, amp,
                                            nullptr, 0.f),
                            family, tiles, static_cast<cudaStream_t>(stream));
}

// The lower column panels of the Gram of the n points Z (n, D), padded to
// P = ceil(n / B) blocks, plus noise on the diagonal, into out: B^2 P (P + 1)
// / 2 floats, panel k (P B - k B, B) at float B^2 (k P - k (k - 1) / 2).
extern "C" int stationary_gram_panels_f32(const void* Z, int n, int D, int B,
                                          const void* ls_dev, int ls_stride,
                                          const float* ls_host, const void* amp_dev, float amp,
                                          const void* noise_dev, float noise, int family,
                                          void* out, int tile_rows, int tile_cols,
                                          void* stream) {
  if (tile_rows != kTR || tile_cols != kTC || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  GramShape g{};
  g.X = g.Z = static_cast<const float*>(Z);
  g.out = static_cast<float*>(out);
  g.N = g.M = n;
  g.D = D;
  g.B = B;
  g.P = cdiv(n, B);
  g.vec = reinterpret_cast<unsigned long long>(out) % 16 == 0 && B % 4 == 0;
  long long tiles = 0;
  for (int k = 0; k < g.P; ++k)
    tiles += static_cast<long long>(cdiv((g.P - k) * B, kTR)) * cdiv(B, kTC);
  return launch_gram<true>(g, gram_scalars(ls_dev, ls_stride, ls_host, D, amp_dev, amp,
                                           noise_dev, noise),
                           family, tiles, static_cast<cudaStream_t>(stream));
}

// The predicts' amp_dev and prior_dev are device pointers to one float32
// value each or null, and then amp and prior are used: a value on the card
// is read there, with no copy to the host.

// partial is a (ceil(N / chunk), Nq, P) float32 scratch buffer sized by the
// caller, who passes the chunk width it sized it for: another width than
// the kernel's is refused (cudaErrorInvalidValue).
extern "C" int predict_mean_f32(const void* Xq, const void* X, const void* alpha, int Nq, int N,
                                int D, int P, const void* amp_dev, float amp, int family,
                                void* mean, void* partial, int chunk, void* stream) {
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
      static_cast<const float*>(partial), chunks, NqP, static_cast<const float*>(amp_dev), amp,
      static_cast<float*>(mean));
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
                                    const void* amp_dev, float amp, const void* prior_dev,
                                    float prior, int family, void* mean, void* var, void* partial,
                                    int tile_b, void* stream) {
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
      static_cast<const float*>(alpha), static_cast<const float*>(Kinv), ldk, Nq, N, D, P,
      static_cast<const float*>(amp_dev), amp, family, static_cast<float*>(mean),
      static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_var_kernel<<<cdiv(Nq, 256), 256, 0, s>>>(static_cast<const float*>(partial), tiles, Nq,
                                                   static_cast<const float*>(prior_dev), prior,
                                                   static_cast<float*>(var));
  return static_cast<int>(cudaGetLastError());
}
