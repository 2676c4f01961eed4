// Lower Cholesky factor L and its inverse L^-1 of one (B, B) SPD block,
// B a multiple of 128, float32: the panel step of the blocked Cholesky
// (ops/blocked_chol.py::cholesky_panels).
//
// Replaces the TPU Pallas kernel _panel_kernel (with _factor_invert_base_rk)
// behind gaussian_process_transportation_tpu/ops/blocked_chol.py::factor_panel.
// Same result, both outputs exactly lower-triangular; the order of the work
// is Hopper's own.
//
// Launch sequence.  The entry factor_panel_f32 issues ordinary kernels in
// stream order on the caller's stream (no cluster, no cooperative launch, no
// grid-wide barrier); with NB = B / 128 sub-blocks, right-looking over s:
//   init         L = A on and below the diagonal blocks, 0 above them; the
//                blocks of L^-1 above the diagonal blocks = 0.  L is the
//                working copy A' from here on, updated in place.
//   for s = 0 .. NB-1:
//     diag       (one CTA) L_ss, X_ss = chol, inverse of A'_ss, exact zeros
//                above the diagonal;
//     col_solve  L_is = A'_is X_ss^T for every i > s, CTAs of 32 whole rows
//                (a CTA reads its rows before it writes them);
//     trail      A'_ij -= L_is L_js^T for s < j <= i, tiles of 32 x 64 of the
//                lower blocks (the next diagonal block included).
//   for w = 128, 256, ... < B (recursive doubling of L^-1, the pairs of one
//   level batched over blockIdx.z):
//     dbl_t      T = L_21 X_11 into the scratch T, k over X_11's nonzeros;
//     dbl_x      X_21 = -X_22 T.
// At B = 512 that is 1 + 4 + 3 + 3 + 2 * 2 = 15 launches.
//
// What bounds it on an H100.  At B = 512: about B^3/3 + B^3/3 = 89.5 MFLOP
// of f32 (1.3 us at 67 TFLOP/s) and 1 MB read, 2 MB written (0.9 us at
// 3.35 TB/s).  The products (col_solve, trail, the doubling) run as 4-32
// CTAs a launch, each a 32 x 64 tile of FMAs (2 x 4 registers a thread,
// operands staged through shared memory in slices of 32), so the panel is
// no longer one SM's work: together about 0.1 ms.  What stays serial is the
// diagonal step, one CTA for each of the B / 128 sub-blocks, about 0.04 ms
// each: inside it, warp 0's factor and inverse of each 32 x 32 tile
// (shuffle and FMA chains, no block barrier) take over half of its cycles,
// the other panels' solves and updates, the doubling and the 64 KB in and
// 128 KB out the rest.  So latency bounds it (the diagonal chain and ~15
// launches in a row), far above the FLOP bound; PERF.md has the readings.
#include <cuda_runtime.h>

namespace {

constexpr int kSB = 128;         // sub-block edge
constexpr int kPitch = kSB + 1;  // shared-memory row pitch of the diagonal block
constexpr int kThreads = 256;
constexpr int kTM = 32;          // rows of a product tile
constexpr int kTN = 64;          // columns of a product tile
constexpr int kRM = kTM / 16;    // rows a thread owns (16 x 16 threads)
constexpr int kKC = 32;          // depth of one staged operand slice
constexpr int kApitch = kTM + 4;
constexpr int kBpitch = kTN + 4;
constexpr unsigned kFull = 0xffffffffu;

// ---- the diagonal block: factor and invert one 128 x 128 block ------------

struct DiagSmem {
  float M[kSB * kPitch];           // the block being factored, L in its lower part
  float X[kSB * kSB];              // L^-1
  float T[(kSB / 2) * (kSB / 2)];  // scratch of the doubling
  float rd[kSB];                   // 1 / L_ii
};

// One warp: factor the 32 x 32 tile of s.M at (c, c) in registers (lane i
// holds row i), right-looking by columns, each pivot and column entry
// passed by __shfl_sync, with no block barrier; writes L_cc and its 1/L_ii.
__device__ __forceinline__ void factor_tile(DiagSmem& s, int c, int lane) {
  float r[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) r[k] = s.M[(c + lane) * kPitch + c + k];
  float rd = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float piv = __shfl_sync(kFull, r[j], j);
    const float rs = rsqrtf(piv);
    if (lane == j) rd = rs;
    r[j] = lane == j ? piv * rs : r[j] * rs;
#pragma unroll
    for (int k = j + 1; k < 32; ++k) {
      const float lkj = __shfl_sync(kFull, r[j], k);
      if (lane >= k) r[k] = fmaf(-r[j], lkj, r[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k <= lane) s.M[(c + lane) * kPitch + c + k] = r[k];
  s.rd[c + lane] = rd;
}

// One warp: X_cc = L_cc^-1 of a factored tile, in registers, row by row,
// X_m. = (e_m - sum_{m'<m} L_mm' X_m'.) / L_mm, each finished row passed
// from its lane to the lanes below it.
__device__ __forceinline__ void invert_tile(DiagSmem& s, int c, int lane) {
  float r[32], acc[32], xf[32];  // row i of L, sum_{m < i} L_im X_m., row i of X
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    r[k] = k < lane ? s.M[(c + lane) * kPitch + c + k] : 0.f;
    acc[k] = xf[k] = 0.f;
  }
  const float rd = s.rd[c + lane];
#pragma unroll
  for (int m = 0; m < 32; ++m) {
#pragma unroll
    for (int k = 0; k <= m; ++k) {
      const float x = ((k == m ? 1.f : 0.f) - acc[k]) * rd;  // final in lane m
      const float xm = __shfl_sync(kFull, x, m);
      if (lane == m) xf[k] = x;
      if (lane > m) acc[k] = fmaf(r[m], xm, acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) s.X[(c + lane) * kSB + c + k] = xf[k];
}

// L_21 = A_21 L_11^-T for the R rows below tile c, a row a thread, by
// forward substitution against the factored tile (two partial sums a
// step), in place.
__device__ __forceinline__ void solve_rows(DiagSmem& s, int c, int R, int tid) {
  if (tid >= R) return;
  float* row = &s.M[(c + 32 + tid) * kPitch + c];
  float x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float a0 = row[j], a1 = 0.f;
#pragma unroll
    for (int m = 0; m + 1 < j; m += 2) {
      a0 = fmaf(-x[m], s.M[(c + j) * kPitch + c + m], a0);
      a1 = fmaf(-x[m + 1], s.M[(c + j) * kPitch + c + m + 1], a1);
    }
    if (j % 2) a0 = fmaf(-x[j - 1], s.M[(c + j) * kPitch + c + j - 1], a0);
    x[j] = (a0 + a1) * s.rd[c + j];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) row[j] = x[j];
}

// A_22 -= L_21 L_21^T over the (16 NR)^2 trailing block below panel c;
// thread (ty, tx) owns rows ty + 16u and columns tx + 16v, and skips the
// sub-blocks u < v, which lie above the diagonal.
template <int NR>
__device__ __forceinline__ void trail_block(DiagSmem& s, int c, int tid) {
  const int tx = tid % 16, ty = tid / 16, r0 = c + 32;
  float acc[NR][NR];
#pragma unroll
  for (int u = 0; u < NR; ++u)
#pragma unroll
    for (int v = 0; v < NR; ++v) acc[u][v] = 0.f;
#pragma unroll 8
  for (int m = 0; m < 32; ++m) {
    float a[NR], b[NR];
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      a[u] = s.M[(r0 + ty + 16 * u) * kPitch + c + m];
      b[u] = s.M[(r0 + tx + 16 * u) * kPitch + c + m];
    }
#pragma unroll
    for (int u = 0; u < NR; ++u)
#pragma unroll
      for (int v = 0; v <= u; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < NR; ++u)
#pragma unroll
    for (int v = 0; v <= u; ++v) s.M[(r0 + ty + 16 * u) * kPitch + r0 + tx + 16 * v] -= acc[u][v];
}

// One level of the doubling of X inside the block, pairs of width W (W = 32:
// two pairs of 128 threads; W = 64: one of 256): T = L_21 X_11, then
// X_21 = -X_22 T, each thread a W/16 x 4 register tile.
template <int W>
__device__ __forceinline__ void double_level(DiagSmem& s, int tid) {
  constexpr int kTPP = 4 * W, kRPT = W / 16;
  const int pr = tid / kTPP, t = tid % kTPP, st = pr * 2 * W;
  const int c0 = (t % (W / 4)) * 4, r0 = (t / (W / 4)) * kRPT;
  float acc[kRPT][4];
#pragma unroll
  for (int r = 0; r < kRPT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 8
  for (int k = 0; k < W; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(&s.X[(st + k) * kSB + st + c0]);
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const float a = s.M[(st + W + r0 + r) * kPitch + st + k];
      acc[r][0] = fmaf(a, b.x, acc[r][0]);
      acc[r][1] = fmaf(a, b.y, acc[r][1]);
      acc[r][2] = fmaf(a, b.z, acc[r][2]);
      acc[r][3] = fmaf(a, b.w, acc[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    *reinterpret_cast<float4*>(&s.T[(pr * W + r0 + r) * W + c0]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  __syncthreads();
#pragma unroll 8
  for (int k = 0; k < W; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(&s.T[(pr * W + k) * W + c0]);
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const float a = s.X[(st + W + r0 + r) * kSB + st + W + k];
      acc[r][0] = fmaf(a, b.x, acc[r][0]);
      acc[r][1] = fmaf(a, b.y, acc[r][1]);
      acc[r][2] = fmaf(a, b.z, acc[r][2]);
      acc[r][3] = fmaf(a, b.w, acc[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRPT; ++r)
    *reinterpret_cast<float4*>(&s.X[(st + W + r0 + r) * kSB + st + c0]) =
        make_float4(-acc[r][0], -acc[r][1], -acc[r][2], -acc[r][3]);
  __syncthreads();
}

// Factor s.M in place (lower part -> L) and build s.X = L^-1.  Right-looking
// over four 32-wide column panels: warp 0 factors the panel's 32 x 32
// diagonal tile in registers (factor_tile); the rows below it are solved
// against the tile a row a thread (solve_rows), and all 256 threads update
// the trailing block.  Then four warps invert the four tiles at once
// (invert_tile), and X's off-diagonal tiles follow by recursive doubling in
// shared memory (W = 32, then 64).  Three block barriers a panel and two a
// doubling level, where a rank-1 column loop takes two for each of the 128
// columns.
__device__ void factor_invert_block(DiagSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll 8
  for (int e = tid; e < kSB * kSB; e += kThreads) s.X[e] = 0.f;
  for (int c = 0; c < kSB; c += 32) {
    __syncthreads();
    if (warp == 0) factor_tile(s, c, lane);
    __syncthreads();
    const int R = kSB - c - 32;  // rows below the tile
    if (R == 0) break;
    solve_rows(s, c, R, tid);
    __syncthreads();
    if (R == 96) trail_block<6>(s, c, tid);
    else if (R == 64) trail_block<4>(s, c, tid);
    else trail_block<2>(s, c, tid);
  }
  if (warp < kSB / 32) invert_tile(s, 32 * warp, lane);
  __syncthreads();
  double_level<32>(s, tid);
  double_level<64>(s, tid);
}

__global__ void __launch_bounds__(kThreads) diag_kernel(float* __restrict__ L,
                                                        float* __restrict__ Linv, int B, int sb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DiagSmem& s = *reinterpret_cast<DiagSmem*>(smem_raw);
  const long long off = static_cast<long long>(sb) * kSB * B + sb * kSB;
  constexpr int kQuads = kSB * kSB / 4 / kThreads;  // float4s a thread moves
#pragma unroll
  for (int t = 0; t < kQuads; ++t) {
    const int q = threadIdx.x + t * kThreads, i = q / (kSB / 4), j = 4 * (q % (kSB / 4));
    const float4 v = *reinterpret_cast<const float4*>(L + off + i * static_cast<long long>(B) + j);
    float* m = &s.M[i * kPitch + j];
    m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w;
  }
  factor_invert_block(s);
  // L's entries above the diagonal are zeroed here; X's are zero already
#pragma unroll
  for (int t = 0; t < kQuads; ++t) {
    const int q = threadIdx.x + t * kThreads, i = q / (kSB / 4), j = 4 * (q % (kSB / 4));
    const float* m = &s.M[i * kPitch + j];
    const long long g = off + i * static_cast<long long>(B) + j;
    *reinterpret_cast<float4*>(L + g) = make_float4(j <= i ? m[0] : 0.f, j + 1 <= i ? m[1] : 0.f,
                                                    j + 2 <= i ? m[2] : 0.f, j + 3 <= i ? m[3] : 0.f);
    *reinterpret_cast<float4*>(Linv + g) = *reinterpret_cast<const float4*>(&s.X[i * kSB + j]);
  }
}

// ---- the products: one 32 x 64 tile per call -------------------------------

struct TileSmem {
  float As[kKC * kApitch];  // k-major slices of A
  float Bs[kKC * kBpitch];  // and of B
};

// acc(a, b) = sum_{k0 <= k < k1} A(ty*kRM + a, k) B(k, tx*4 + b), with
// A(i, k) = A[i * a_i + k * a_k] and B(k, j) = Bm[k * b_k + j * b_j]; k1 - k0
// a multiple of kKC.  Global loads follow whichever stride is 1, so they
// coalesce.  Ends with a __syncthreads, so the caller may overwrite what it
// read.
__device__ void tile_gemm(float (&acc)[kRM][4], const float* __restrict__ A, long long a_i,
                          long long a_k, const float* __restrict__ Bm, long long b_k,
                          long long b_j, int k0, int k1, TileSmem& s) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int a = 0; a < kRM; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int kk = k0; kk < k1; kk += kKC) {
#pragma unroll
    for (int t = 0; t < (kTM * kKC) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      int i, k;
      if (a_k == 1) { k = e % kKC; i = e / kKC; } else { i = e % kTM; k = e / kTM; }
      s.As[k * kApitch + i] = A[i * a_i + (kk + k) * a_k];
    }
#pragma unroll
    for (int t = 0; t < (kTN * kKC) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      int j, k;
      if (b_j == 1) { j = e % kTN; k = e / kTN; } else { k = e % kKC; j = e / kKC; }
      s.Bs[k * kBpitch + j] = Bm[(kk + k) * b_k + j * b_j];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKC; ++k) {
      const float2 av = *reinterpret_cast<const float2*>(&s.As[k * kApitch + ty * kRM]);
      const float4 bv = *reinterpret_cast<const float4*>(&s.Bs[k * kBpitch + tx * 4]);
      const float a[kRM] = {av.x, av.y};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
}

// C(i, j) = base * C(i, j) + alpha * acc for the thread's 2 x 4 entries of
// the tile at C (row pitch ldc); base 0 overwrites.
__device__ __forceinline__ void tile_store(const float (&acc)[kRM][4], float alpha, float base,
                                           float* C, long long ldc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    float4* p = reinterpret_cast<float4*>(C + (ty * kRM + r) * ldc + tx * 4);
    float4 v = base != 0.f ? *p : make_float4(0.f, 0.f, 0.f, 0.f);
    v.x = base * v.x + alpha * acc[r][0];
    v.y = base * v.y + alpha * acc[r][1];
    v.z = base * v.z + alpha * acc[r][2];
    v.w = base * v.w + alpha * acc[r][3];
    *p = v;
  }
}

// L = A on and below the diagonal blocks, 0 above them; L^-1 = 0 above them.
// One float4 a thread.
__global__ void __launch_bounds__(kThreads) init_kernel(const float* __restrict__ A,
                                                        float* __restrict__ L,
                                                        float* __restrict__ Linv, int B) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long e = q * 4;
  if (e >= static_cast<long long>(B) * B) return;
  const int i = static_cast<int>(e / B), j = static_cast<int>(e % B);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j / kSB > i / kSB) {
    reinterpret_cast<float4*>(L)[q] = zero;
    reinterpret_cast<float4*>(Linv)[q] = zero;
  } else {
    reinterpret_cast<float4*>(L)[q] = reinterpret_cast<const float4*>(A)[q];
  }
}

// L_is = A'_is X_ss^T for the 32 rows of this CTA below block s, both
// 64-column halves, written in place once every read of the rows is done.
// X_ss is lower-triangular, so half c takes k < 64 (c + 1).
__global__ void __launch_bounds__(kThreads) col_solve_kernel(float* __restrict__ L,
                                                             const float* __restrict__ Linv,
                                                             int B, int sb) {
  __shared__ __align__(16) TileSmem s;
  const long long ld = B;
  const long long r0 = static_cast<long long>(sb + 1) * kSB + kTM * blockIdx.x;
  float* rows = L + r0 * ld + sb * kSB;
  const float* Xss = Linv + static_cast<long long>(sb) * kSB * ld + sb * kSB;
  float acc0[kRM][4], acc1[kRM][4];
  tile_gemm(acc0, rows, ld, 1, Xss, 1, ld, 0, kTN, s);
  tile_gemm(acc1, rows, ld, 1, Xss + kTN * ld, 1, ld, 0, 2 * kTN, s);
  tile_store(acc0, 1.f, 0.f, rows, ld);
  tile_store(acc1, 1.f, 0.f, rows + kTN, ld);
}

// A'_ij -= L_is L_js^T over the lower blocks s < j <= i; eight 32 x 64 tiles
// a block pair, of which the two wholly above the diagonal of a diagonal
// block return at once.
__global__ void __launch_bounds__(kThreads) trail_kernel(float* __restrict__ L, int B, int sb) {
  __shared__ __align__(16) TileSmem s;
  const int NB = B / kSB;
  int pair = blockIdx.x / 8;
  const int tile = blockIdx.x % 8;
  int i = sb + 1, j = sb + 1;  // the pair-th lower block pair, row by row
  for (;;) {
    if (pair <= i - (sb + 1)) { j = sb + 1 + pair; break; }
    pair -= i - sb;
    ++i;
  }
  if (i >= NB) return;
  const int r0 = (tile / 2) * kTM, c0 = (tile % 2) * kTN;
  if (i == j && c0 > r0 + kTM - 1) return;
  const long long ld = B;
  float acc[kRM][4];
  tile_gemm(acc, L + (i * kSB + r0) * ld + sb * kSB, ld, 1,
            L + (j * kSB + c0) * ld + sb * kSB, 1, ld, 0, kSB, s);
  tile_store(acc, -1.f, 1.f, L + (i * kSB + r0) * ld + j * kSB + c0, ld);
}

// Level w of the doubling, pair z: first half [st, st + w), second half
// [st + w, st + w + h2), h2 = min(w, B - st - w).  T (row pitch w, rows
// indexed from 0 = row st + w of the panel) = L_21 X_11.
__global__ void __launch_bounds__(kThreads) dbl_t_kernel(const float* __restrict__ L,
                                                         const float* __restrict__ Linv,
                                                         float* __restrict__ T, int B, int w) {
  __shared__ __align__(16) TileSmem s;
  const long long st = 2LL * w * blockIdx.z;
  const int h2 = static_cast<int>(min(static_cast<long long>(w), B - st - w));
  const int r0 = kTM * blockIdx.y, c0 = kTN * blockIdx.x;
  if (r0 >= h2) return;
  const long long ld = B;
  float acc[kRM][4];
  tile_gemm(acc, L + (st + w + r0) * ld + st, ld, 1, Linv + st * ld + st + c0, ld, 1, c0, w, s);
  tile_store(acc, 1.f, 0.f, T + (st + r0) * w + c0, w);
}

// X_21 = -X_22 T; X_22 is lower-triangular, so rows r0.. take k < r0 + 32.
__global__ void __launch_bounds__(kThreads) dbl_x_kernel(float* __restrict__ Linv,
                                                         const float* __restrict__ T, int B,
                                                         int w) {
  __shared__ __align__(16) TileSmem s;
  const long long st = 2LL * w * blockIdx.z;
  const int h2 = static_cast<int>(min(static_cast<long long>(w), B - st - w));
  const int r0 = kTM * blockIdx.y, c0 = kTN * blockIdx.x;
  if (r0 >= h2) return;
  const long long ld = B;
  float acc[kRM][4];
  tile_gemm(acc, Linv + (st + w + r0) * ld + st + w, ld, 1, T + st * w + c0, w, 1, 0,
            min(r0 + kTM, h2), s);
  tile_store(acc, -1.f, 0.f, Linv + (st + w + r0) * ld + st + c0, ld);
}

}  // namespace

// Issue the launch sequence on `stream`; returns the first CUDA error (0 =
// ok).  A, L and Linv are contiguous (B, B) float32 device buffers, B % 128
// == 0; T is float32 scratch of at least B * B / 4 words (the doubling's
// level w keeps fewer than (B - w) * w there).
extern "C" int factor_panel_f32(const void* A, void* L, void* Linv, void* T, int B,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(L);
  float* x = static_cast<float*>(Linv);
  float* t = static_cast<float*>(T);
  const int NB = B / kSB;
  const int smem = static_cast<int>(sizeof(DiagSmem));
  cudaError_t err = cudaFuncSetAttribute(diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long quads = static_cast<long long>(B) * B / 4;
  init_kernel<<<static_cast<unsigned>((quads + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(A), l, x, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int sb = 0; sb < NB; ++sb) {
    diag_kernel<<<1, kThreads, smem, st>>>(l, x, B, sb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int m = NB - 1 - sb;  // block rows below s
    if (m == 0) break;
    col_solve_kernel<<<m * (kSB / kTM), kThreads, 0, st>>>(l, x, B, sb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    trail_kernel<<<m * (m + 1) / 2 * 8, kThreads, 0, st>>>(l, B, sb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  for (int w = kSB; w < B; w *= 2) {
    const dim3 grid(w / kTN, w / kTM, (B - w + 2 * w - 1) / (2 * w));
    dbl_t_kernel<<<grid, kThreads, 0, st>>>(l, x, t, B, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dbl_x_kernel<<<grid, kThreads, 0, st>>>(x, t, B, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
