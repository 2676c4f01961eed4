// Lower Cholesky factor L and its inverse L^-1 of one (B, B) SPD block,
// B a multiple of 128, float32, in one CUDA block: the panel step of the
// blocked Cholesky (ops/blocked_chol.py::cholesky_panels).
//
// Replaces the TPU Pallas kernel _panel_kernel (with _factor_invert_base_rk)
// behind gaussian_process_transportation_tpu/ops/blocked_chol.py::factor_panel.
// Same math: left-looking over 128 x 128 sub-blocks,
//   D_ss   = A_ss - sum_{m<s} L_sm L_sm^T,   (L_ss, X_ss) = chol+inverse(D_ss)
//   L_is   = (A_is - sum_{m<s} L_im L_sm^T) X_ss^T            (i > s)
//   X_is   = -X_ii sum_{m=s}^{i-1} L_im X_ms                    (i > s)
// with X = L^-1.  Both outputs are exactly lower-triangular.
//
// Design.  At B = 512 the block is 1 MB, far over the 227 KB a CUDA block
// can hold in shared memory, so only the 128 x 128 diagonal sub-block being
// factored (M, 66 KB) and its inverse (X, 64 KB) live in shared memory;
// the finished sub-blocks of L and L^-1 are written to the outputs and
// re-read from there (L2).  The diagonal sub-block is factored and inverted
// by a rank-1 column loop: 128 dependent steps, each a rank-1 update of the
// trailing part of M and the Gauss-Jordan update of X, shared out over the
// 256 threads (threads on columns k > j update M, those on k <= j update X,
// so the two halves of the work balance at every step).  The TPU kernel's
// rank-R pivot hid the VPU's per-step latency; here a step costs two
// __syncthreads and a few shared-memory FMAs per thread, so the plain
// rank-1 loop is kept.  The sub-block products are one FMA-loop GEMM
// routine (128 x 128 output, an 8 x 8 register tile per thread, operands
// staged through shared memory in slices of 16), written here rather than
// called from a library.
//
// What bounds it on an H100.  At B = 512: about B^3/3 + B^3/3 = 89.5 MFLOP
// of f32 (1.3 us at 67 TFLOP/s) and 1 MB read, 2 MB written (0.9 us at
// 3.35 TB/s).  One CTA runs on one of the 132 SMs, and 4 x 128 dependent
// column steps sit on its critical path, so the kernel is latency-bound,
// far above that bound.  Factoring several panels at once, or splitting the
// trailing GEMMs over many CTAs, is the way to make it fast.
#include <cuda_runtime.h>

namespace {

constexpr int kSB = 128;       // sub-block edge
constexpr int kPitch = kSB + 1;  // shared-memory row pitch of M (no bank conflicts on columns)
constexpr int kThreads = 256;  // 16 x 16 threads, each an 8 x 8 tile of a 128 x 128 result
constexpr int kKC = 16;        // depth of one staged operand slice
constexpr int kStage = kSB + 4;

struct Smem {
  float M[kSB * kPitch];      // diagonal sub-block being factored; also scratch
  float X[kSB * kSB];         // its inverse
  float As[kKC * kStage];     // staged GEMM operands, k-major
  float Bs[kKC * kStage];
  float col[kSB];             // the current column of L
  float xrow[kSB];            // the current row of X
};

// acc(i, j) = sum_k A(i, k) B(j, k), i, j < 128, k < K (K a multiple of kKC),
// with A(i, k) = A[i * a_i + k * a_k] and B(j, k) = B[j * b_j + k * b_k].
// Operands may lie in global or shared memory.  Thread (ty, tx) owns rows
// ty + 16 a and columns tx + 16 b, a, b < 8.
__device__ __forceinline__ void gemm_nt(float acc[8][8], const float* A, long long a_i, long long a_k,
                        const float* B, long long b_j, long long b_k, int K, Smem& s) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    // stage 128 x 16 slices of A and B, k-major; the fast index follows
    // whichever operand stride is 1, so global loads coalesce
#pragma unroll
    for (int t = 0; t < (kSB * kKC) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      int i, k;
      if (a_k == 1) { k = e % kKC; i = e / kKC; } else { i = e % kSB; k = e / kSB; }
      s.As[k * kStage + i] = A[i * a_i + (k0 + k) * a_k];
      int j, kb;
      if (b_k == 1) { kb = e % kKC; j = e / kKC; } else { j = e % kSB; kb = e / kSB; }
      s.Bs[kb * kStage + j] = B[j * b_j + (k0 + kb) * b_k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) av[a] = s.As[k * kStage + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 8; ++b) bv[b] = s.Bs[k * kStage + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
}

// dst(i, j) = src(i, j) + alpha * acc(i, j); src may be null (then 0).
__device__ __forceinline__ void store_tile(const float acc[8][8], float alpha, const float* src, long long src_ld,
                           float* dst, long long dst_ld) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int i = ty + 16 * a, j = tx + 16 * b;
      const float base = src ? src[i * src_ld + j] : 0.f;
      dst[i * dst_ld + j] = base + alpha * acc[a][b];
    }
}

// Factor s.M in place (lower part -> L) and build s.X = L^-1, rank-1 steps.
__device__ void factor_invert_base(Smem& s) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kSB * kSB; e += kThreads) s.X[e] = (e / kSB == e % kSB) ? 1.f : 0.f;
  const int k = tid % kSB;   // this thread's column
  const int r0 = tid / kSB;  // and its first row offset (0 or 1)
  for (int j = 0; j < kSB; ++j) {
    __syncthreads();
    const float d = rsqrtf(s.M[j * kPitch + j]);
    if (tid < kSB) {
      s.col[tid] = tid >= j ? s.M[tid * kPitch + j] * d : 0.f;
    } else {
      s.xrow[k] = s.X[j * kSB + k] * d;
    }
    __syncthreads();
    if (tid < kSB && tid >= j) s.M[tid * kPitch + j] = s.col[tid];
    if (tid >= kSB) s.X[j * kSB + k] = s.xrow[k];
    const float ck = s.col[k], xk = s.xrow[k];
    for (int i = j + 1 + r0; i < kSB; i += kThreads / kSB) {
      const float ci = s.col[i];
      if (k > j) {
        s.M[i * kPitch + k] -= ci * ck;   // trailing rank-1 update
      } else {
        s.X[i * kSB + k] -= ci * xk;      // Gauss-Jordan on the identity
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
factor_panel_kernel(const float* __restrict__ A, float* __restrict__ L, float* __restrict__ Linv,
                    int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int NB = B / kSB;
  const int tid = threadIdx.x;
  const long long ld = B;
  auto blk = [ld](const float* p, int i, int j) { return p + (i * kSB) * ld + j * kSB; };
  auto blkw = [ld](float* p, int i, int j) { return p + (i * kSB) * ld + j * kSB; };
  float acc[8][8];

  // blocks above the diagonal are zero in both outputs
  for (int i = 0; i < NB; ++i)
    for (int j = i + 1; j < NB; ++j)
      for (int e = tid; e < kSB * kSB; e += kThreads) {
        const long long off = (e / kSB) * ld + e % kSB;
        blkw(L, i, j)[off] = 0.f;
        blkw(Linv, i, j)[off] = 0.f;
      }

  for (int sblk = 0; sblk < NB; ++sblk) {
    // D = A_ss - L_s,<s L_s,<s^T  into s.M
    gemm_nt(acc, blk(L, sblk, 0), ld, 1, blk(L, sblk, 0), ld, 1, sblk * kSB, s);
    store_tile(acc, -1.f, blk(A, sblk, sblk), ld, s.M, kPitch);
    factor_invert_base(s);
    // write L_ss and X_ss, exact zeros above the diagonal
    for (int e = tid; e < kSB * kSB; e += kThreads) {
      const int i = e / kSB, j = e % kSB;
      blkw(L, sblk, sblk)[i * ld + j] = j <= i ? s.M[i * kPitch + j] : 0.f;
      blkw(Linv, sblk, sblk)[i * ld + j] = j <= i ? s.X[i * kSB + j] : 0.f;
    }
    __syncthreads();
    for (int i = sblk + 1; i < NB; ++i) {
      // R = A_is - L_i,<s L_s,<s^T into s.M, then L_is = R X_ss^T
      gemm_nt(acc, blk(L, i, 0), ld, 1, blk(L, sblk, 0), ld, 1, sblk * kSB, s);
      store_tile(acc, -1.f, blk(A, i, sblk), ld, s.M, kPitch);
      __syncthreads();
      gemm_nt(acc, s.M, kPitch, 1, s.X, kSB, 1, kSB, s);
      store_tile(acc, 1.f, nullptr, 0, blkw(L, i, sblk), ld);
      __syncthreads();
    }
  }

  // off-diagonal blocks of L^-1, by block rows below each diagonal block
  for (int sblk = 0; sblk < NB; ++sblk) {
    for (int i = sblk + 1; i < NB; ++i) {
      // T = sum_{m=s}^{i-1} L_im X_ms: one GEMM over the K = (i - s) 128 columns
      gemm_nt(acc, blk(L, i, sblk), ld, 1, blk(Linv, sblk, sblk), 1, ld, (i - sblk) * kSB, s);
      store_tile(acc, 1.f, nullptr, 0, s.M, kPitch);
      __syncthreads();
      // X_is = -X_ii T
      gemm_nt(acc, blk(Linv, i, i), ld, 1, s.M, 1, kPitch, kSB, s);
      store_tile(acc, -1.f, nullptr, 0, blkw(Linv, i, sblk), ld);
      __syncthreads();
    }
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error after the launch (0 = ok).
// A, L and Linv are contiguous (B, B) float32 device buffers, B % 128 == 0.
extern "C" int factor_panel_f32(const void* A, void* L, void* Linv, int B, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(factor_panel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factor_panel_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<float*>(L), static_cast<float*>(Linv), B);
  return static_cast<int>(cudaGetLastError());
}
