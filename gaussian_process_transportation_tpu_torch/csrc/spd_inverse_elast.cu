// Cholesky factor and inverse of a batch of small SPD matrices, for the
// ensemble transport's fit stage.
//
// Replaces the TPU Pallas kernel _spd_inv_kernel behind
// gaussian_process_transportation_tpu/ops/batched_linalg.py::
// spd_inverse_elast_fused.  It computes the same thing: for each member e
// of K (n, n, E), the lower Cholesky factor L (zeros above the diagonal)
// and K^-1 = L^-T L^-1.
//
// Layout.  The ensemble axis is innermost: entry (i, j) of member e lies
// at (i*n + j)*E + e.  Members past E are masked, not padded with
// identities.
//
// What bounds it on an H100.  At n = 20, E = 16384 it reads 26 MB and
// writes 52 MB: about 23 us at 3.35 TB/s.  Its ~n^3 FMAs per member are
// 0.26 GFLOP, a few us of fp32.  So the bytes bound it, provided every
// load and store is coalesced and enough members are in flight to hide
// the latency of each member's chain of dependent steps (a factor, a
// forward substitution and the dot products, each with its shuffles).
//
// Two designs, chosen by the host from n and the dtype alone (the wrapper
// in ops/batched_linalg.py names them; neither is a fallback):
//
// * The warp instances (float32, n <= NCAP for NCAP in 8, 16, 20, 24, 32):
//   H = NCAP / 2 lanes a member, two rows a lane in registers (lane l holds
//   rows l and l + H), so a warp takes 32 / H members at once (three at
//   n <= 20); entries of other rows arrive by __shfl_sync, and one shuffle
//   feeds both rows of every member of the warp.
//   - Staging.  A block of W warps takes G = W * 32 / H consecutive members
//     (24 at NCAP = 20).  It copies their (n, n, G) slab into shared memory
//     with loads contiguous along E (the G members of one entry are one
//     segment of whole 32-byte sectors), four entries of a row a thread and
//     one 16-byte shared store.  In shared memory member g's row i starts
//     at g*M + i*P floats, P and M multiples of 4 whose quarter is odd:
//     the staging stores (eight members a phase) and the row reads (eight
//     rows a phase, 16 bytes a thread) are free of bank conflicts.  L and
//     K^-1 go back the same way from two such slabs (L in place of K).
//   - Factor, as in csrc/fused_lml.cu: right-looking K = C D C^T (C unit
//     lower); at column j the pivot d_j is register j of row j's lane, each
//     row t > j forms C_tj = S_tj / d_j and updates itself with the others'
//     unscaled S_kj, so the critical path of a column holds one shuffle.
//     L_tj = C_tj sqrt(d_j).
//   - Inverse without n column solves: each lane forms its columns of
//     C^-1 by one forward substitution against C's rows (broadcast, n^2/2
//     shuffles), then its rows of K^-1 = C^-T D^-1 C^-1 as dot products of
//     its columns with the others' (n^2/2 more): n independent sums.
//   - A member with a pivot that is not positive has L and K^-1 all NaN;
//     the other members of its warp are untouched.
//   Rows n..NCAP-1 are an identity block, so the unrolled loops index
//   registers statically and only warp-uniform tests of n cut their tails.
//   On an H100 at n = 20, E = 16384 the staging alone takes about 0.041 ms
//   and the shuffles and FMAs alone about 0.045 ms (scripts/
//   kernel_variants.py), and a block does one after the other: overlapping
//   them (a persistent block that loads the next members while it factors
//   these) is the next step.
// * The thread instance (float64 at any n <= 64, float32 at n in 33..64):
//   one thread per member, left-looking, the factor written into L in
//   place and K^-1 formed column by column in place (a forward and a back
//   substitution each), every intermediate in global memory; a warp's 32
//   threads touch 32 consecutive words on every access.  Its register use
//   does not grow with n.  It is latency-bound (one lone chain a member,
//   a few warps an SM at E = 16384).
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- the thread instance ---------------------------------------------------

constexpr int kThreads = 64;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
spd_inverse_elast_kernel(const T* __restrict__ K, T* __restrict__ L,
                         T* __restrict__ Kinv, int n, long long E) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= E) return;
  const T* k = K + e;
  T* l = L + e;
  T* ki = Kinv + e;
  // offset of entry (i, j) of this member
  auto at = [n, E](int i, int j) { return (static_cast<long long>(i) * n + j) * E; };

  // Left-looking Cholesky, column j from the columns before it.
  for (int j = 0; j < n; ++j) {
    T d = k[at(j, j)];
    for (int p = 0; p < j; ++p) {
      const T v = l[at(j, p)];
      d -= v * v;
    }
    const T r = rsqrt_t(d);
    l[at(j, j)] = d * r;
    for (int i = j + 1; i < n; ++i) {
      T v = k[at(i, j)];
      for (int p = 0; p < j; ++p) v -= l[at(i, p)] * l[at(j, p)];
      l[at(i, j)] = v * r;
    }
    for (int i = 0; i < j; ++i) l[at(i, j)] = T(0);
  }

  // K^-1 column by column: L u = e_c, then L^T v = u, in place in column c.
  for (int c = 0; c < n; ++c) {
    for (int i = 0; i < c; ++i) ki[at(i, c)] = T(0);
    for (int i = c; i < n; ++i) {
      T acc = (i == c) ? T(1) : T(0);
      for (int p = c; p < i; ++p) acc -= l[at(i, p)] * ki[at(p, c)];
      ki[at(i, c)] = acc / l[at(i, i)];
    }
    for (int i = n - 1; i >= 0; --i) {
      T acc = ki[at(i, c)];
      for (int p = i + 1; p < n; ++p) acc -= l[at(p, i)] * ki[at(p, c)];
      ki[at(i, c)] = acc / l[at(i, i)];
    }
  }
}

template <typename T>
int launch_thread(const void* K, void* L, void* Kinv, int n, long long E, void* stream) {
  const long long blocks = (E + kThreads - 1) / kThreads;
  spd_inverse_elast_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<T*>(L), static_cast<T*>(Kinv), n, E);
  return static_cast<int>(cudaGetLastError());
}

// ---- the warp instances ----------------------------------------------------

// The smallest multiple of 4 that is at least x and whose quarter is odd:
// rows (and members) that far apart fall in distinct 16-byte bank groups
// for eight consecutive rows (members).
__host__ __device__ __forceinline__ int odd_quad_pitch(int x) {
  const int p = (x + 3) / 4 * 4;
  return (p / 4) % 2 == 1 ? p : p + 4;
}

__device__ __forceinline__ float shfl(float v, int src) { return __shfl_sync(kFull, v, src); }

// One block-wide pass of kThreads threads between the (n, n, E) array and
// the slab: load (kLoad) or store the G members [e0, e0 + G), a row's four
// consecutive entries a thread, entries past n and members past E skipped
// (zeros in the slab when loading).
template <int G, int kThreads_, bool kLoad>
__device__ __forceinline__ void stage(float* slab, const float* gin, float* gout, int n, int P,
                                      int M, long long E, long long e0) {
  const int nc = (n + 3) / 4;  // 4-entry chunks a row
  const int items = G * n * nc;
  for (int it = threadIdx.x; it < items; it += kThreads_) {
    const int g = it % G, rc = it / G, i = rc / nc, c = rc - i * nc;
    const long long e = e0 + g;
    float4* s = reinterpret_cast<float4*>(slab + g * M + i * P + 4 * c);
    const long long off = (static_cast<long long>(i) * n + 4 * c) * E + e;
    const int valid = e < E ? min(n - 4 * c, 4) : 0;
    if (kLoad) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid > 0) v.x = gin[off];
      if (valid > 1) v.y = gin[off + E];
      if (valid > 2) v.z = gin[off + 2 * E];
      if (valid > 3) v.w = gin[off + 3 * E];
      *s = v;
    } else {
      const float4 v = *s;
      if (valid > 0) gout[off] = v.x;
      if (valid > 1) gout[off + E] = v.y;
      if (valid > 2) gout[off + 2 * E] = v.z;
      if (valid > 3) gout[off + 3 * E] = v.w;
    }
  }
}

// Row `row` of a member's matrix (its first n entries, 16 bytes a read)
// into r[0, NCAP), zeros past n; a row past n, or of a lane with no member
// (`own` false), is row `row` of the identity.
template <int NCAP>
__device__ __forceinline__ void load_row(float r[NCAP], const float* ptr, int row, int n,
                                         bool own) {
  const int nc = (n + 3) / 4;
#pragma unroll
  for (int c = 0; c < NCAP / 4; ++c) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (own && row < n && c < nc) v = *reinterpret_cast<const float4*>(ptr + 4 * c);
    r[4 * c] = v.x;
    r[4 * c + 1] = v.y;
    r[4 * c + 2] = v.z;
    r[4 * c + 3] = v.w;
  }
  if (!own || row >= n) {
#pragma unroll
    for (int j = 0; j < NCAP; ++j) r[j] = row == j ? 1.f : 0.f;
  }
}

template <int NCAP>
__device__ __forceinline__ void store_row(float* ptr, const float r[NCAP], int row, int n,
                                          bool own) {
  const int nc = (n + 3) / 4;
  if (!own || row >= n) return;
#pragma unroll
  for (int c = 0; c < NCAP / 4; ++c)
    if (c < nc)
      *reinterpret_cast<float4*>(ptr + 4 * c) =
          make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
}

// L and K^-1 of the 32 / H members of one warp, H lanes a member and R
// rows a lane: lane l of member slot m holds rows l, l + H, ... of member
// m, whose K rows (then L's, in place) start at kin and K^-1's at kiout.
// A row j lives in lane j % H, register half j / H, both known at compile
// time once the loops unroll; one shuffle from lane base + j % H serves the
// R rows of every member of the warp.  `own`: the lane has a member.
template <int H, int R>
__device__ __forceinline__ void members(float* kin, float* kiout, int P, int t, int n,
                                        bool own) {
  constexpr int NCAP = H * R;
  const int m = t / H, l = t - m * H, base = m * H;
  float a[R][NCAP];
#pragma unroll
  for (int r = 0; r < R; ++r) load_row<NCAP>(a[r], kin + (l + r * H) * P, l + r * H, n, own);

  // K = C D C^T, right-looking; each row keeps S_tk right of its diagonal
  float dt[R], dinv[R];  // d_t and 1/d_t of this lane's rows
#pragma unroll
  for (int r = 0; r < R; ++r) dt[r] = dinv[r] = 1.f;
#pragma unroll
  for (int j = 0; j < NCAP; ++j) {
    if (j >= n) break;
    const float piv = shfl(a[j / H][j], base + j % H);
    const float inv = __frcp_rn(piv);
    float c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = l + r * H > j ? __fmul_rn(a[r][j], inv) : 0.f;
#pragma unroll
    for (int k0 = 0; k0 < NCAP; k0 += 4) {
      if (k0 + 3 > j && k0 < n) {
#pragma unroll
        for (int k = k0; k < k0 + 4; ++k) {
          if (k > j) {
            const float skj = shfl(a[k / H][j], base + k % H);  // row k's S_kj, unscaled
#pragma unroll
            for (int r = 0; r < R; ++r) a[r][k] = fmaf(-c[r], skj, a[r][k]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (l + r * H == j) {
        dt[r] = piv;
        dinv[r] = inv;
      }
      if (l + r * H > j) a[r][j] = c[r];
    }
  }
  bool mine_bad = false;
#pragma unroll
  for (int r = 0; r < R; ++r) mine_bad |= own && l + r * H < n && !(dt[r] > 0.f);
  const unsigned lanes = (H == 32 ? kFull : (1u << H) - 1u) << base;
  const bool bad = (__ballot_sync(kFull, mine_bad) & lanes) != 0;
  const float nan = __int_as_float(0x7fc00000);

  // rows of L = C D^1/2: C_tj sqrt(d_j) left of the diagonal, sqrt(d_t) on it
  float sq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sq[r] = sqrtf(dt[r]);
  float lrow[R][NCAP];
#pragma unroll
  for (int j = 0; j < NCAP; ++j) {
    const float sj = j < n ? shfl(sq[j / H], base + j % H) : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = l + r * H;
      lrow[r][j] = bad ? nan : j < row ? __fmul_rn(a[r][j], sj) : j == row ? sq[r] : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) store_row<NCAP>(kin + (l + r * H) * P, lrow[r], l + r * H, n, own);

  // columns l + r H of C^-1: C x = e_t, row i of C broadcast from its lane
  float xc[R][NCAP];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < NCAP; ++i) xc[r][i] = 0.f;
#pragma unroll
  for (int i = 0; i < NCAP; ++i) {
    if (i >= n) break;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = l + r * H == i ? 1.f : 0.f;
#pragma unroll
    for (int mm = 0; mm < i; ++mm) {
      const float cim = shfl(a[i / H][mm], base + i % H);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(-cim, xc[r][mm], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) xc[r][i] = acc[r];
  }
  // rows l + r H of K^-1 = C^-T D^-1 C^-1: sum_k (C^-1)_kt (C^-1)_kj / d_k
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NCAP; ++j) a[r][j] = 0.f;
#pragma unroll
  for (int k = 0; k < NCAP; ++k) {
    if (k >= n) break;
    const float dk = shfl(dinv[k / H], base + k % H);
    float w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = xc[r][k] * dk;
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      const float xkj = shfl(xc[j / H][k], base + j % H);
#pragma unroll
      for (int r = 0; r < R; ++r) a[r][j] = fmaf(w[r], xkj, a[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (bad) {
#pragma unroll
      for (int j = 0; j < NCAP; ++j) a[r][j] = nan;
    }
    store_row<NCAP>(kiout + (l + r * H) * P, a[r], l + r * H, n, own);
  }
}

// The instance of H lanes and R rows a member, W warps a block, each warp
// taking 32 / H members at once: G = W * (32 / H) members a block.
// Dynamic shared memory: two slabs of G * M floats (K then L in place; K^-1).
template <int H, int R, int W>
__global__ void __launch_bounds__(W * 32)
spd_inverse_warp_kernel(const float* __restrict__ K, float* __restrict__ L,
                        float* __restrict__ Kinv, int n, long long E) {
  constexpr int kPerWarp = 32 / H, G = W * kPerWarp;
  extern __shared__ __align__(16) float slab[];
  const int P = odd_quad_pitch(n), M = odd_quad_pitch(n * P);
  float* sk = slab;          // K, then L in place
  float* si = slab + G * M;  // K^-1
  const long long e0 = static_cast<long long>(blockIdx.x) * G;
  stage<G, W * 32, true>(sk, K, nullptr, n, P, M, E, e0);
  __syncthreads();
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g0 = w * kPerWarp;
  if (e0 + g0 < E) {  // the whole warp
    const int g = g0 + t / H;
    const bool own = t < kPerWarp * H && e0 + g < E;
    const int gs = own ? g : g0;  // a lane without a member reads nothing
    members<H, R>(sk + gs * M, si + gs * M, P, t, n, own);
  }
  __syncthreads();
  stage<G, W * 32, false>(sk, nullptr, L, n, P, M, E, e0);
  stage<G, W * 32, false>(si, nullptr, Kinv, n, P, M, E, e0);
}

template <int H, int R, int W>
int launch_warp(const void* K, void* L, void* Kinv, int n, long long E, void* stream) {
  constexpr int G = W * (32 / H);
  const int P = odd_quad_pitch(n), M = odd_quad_pitch(n * P);
  const int smem = 2 * G * M * static_cast<int>(sizeof(float));
  auto kernel = spd_inverse_warp_kernel<H, R, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (E + G - 1) / G;
  kernel<<<static_cast<unsigned>(blocks), W * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(K), static_cast<float*>(L), static_cast<float*>(Kinv), n, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() after the
// launch (0 = ok).  K, L and Kinv are contiguous (n, n, E) device buffers
// of the entry's type.

// The thread instance.
extern "C" int spd_inverse_elast_f32(const void* K, void* L, void* Kinv, int n,
                                     long long E, void* stream) {
  return launch_thread<float>(K, L, Kinv, n, E, stream);
}

extern "C" int spd_inverse_elast_f64(const void* K, void* L, void* Kinv, int n,
                                     long long E, void* stream) {
  return launch_thread<double>(K, L, Kinv, n, E, stream);
}

// The warp instance of `ncap` register rows a member (8, 16, 20, 24 or
// 32; two a lane) for 1 <= n <= ncap; another ncap or n is refused
// (cudaErrorInvalidValue).
extern "C" int spd_inverse_elast_warp_f32(const void* K, void* L, void* Kinv, int n,
                                          long long E, int ncap, void* stream) {
  if (n < 1 || n > ncap) return static_cast<int>(cudaErrorInvalidValue);
  switch (ncap) {
    case 8: return launch_warp<4, 2, 4>(K, L, Kinv, n, E, stream);
    case 16: return launch_warp<8, 2, 4>(K, L, Kinv, n, E, stream);
    case 20: return launch_warp<10, 2, 8>(K, L, Kinv, n, E, stream);
    case 24: return launch_warp<12, 2, 8>(K, L, Kinv, n, E, stream);
    case 32: return launch_warp<16, 2, 4>(K, L, Kinv, n, E, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
