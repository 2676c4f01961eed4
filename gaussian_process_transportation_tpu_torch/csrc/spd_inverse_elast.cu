// Cholesky factor and inverse of a batch of small SPD matrices, one CUDA
// thread per matrix, for the ensemble transport's fit stage.
//
// Replaces the TPU Pallas kernel _spd_inv_kernel behind
// gaussian_process_transportation_tpu/ops/batched_linalg.py::
// spd_inverse_elast_fused.  It computes the same thing: for each member e
// of K (n, n, E), the lower Cholesky factor L (left-looking, zeros above
// the diagonal) and K^-1 = L^-T L^-1, by a forward solve L u = e_c and a
// backward solve L^T v = u for each column c of the identity.
//
// Layout.  The ensemble axis is innermost: entry (i, j) of member e lies
// at (i*n + j)*E + e.  Thread e owns member e, so the 32 threads of a warp
// touch 32 consecutive words on every load and store (coalesced), without
// the TPU kernel's (n*n, lanes) reshaping.  Members past E are masked, not
// padded with identities.
//
// Design.  The factor is written into L in place and re-read from there,
// and the solves work in place in K^-1: every intermediate lives in global
// memory (served by L1/L2), none in a per-thread array.  So register use
// does not grow with n and one kernel serves every n the batched transport
// sends (n <= 64; the TPU kernel's n <= 32 was a VMEM limit).
//
// What bounds it on an H100.  At n = 20, E = 16384 it reads 26 MB and
// writes 52 MB: about 23 us at 3.35 TB/s.  Its ~5n^3/6 FMAs per member are
// 0.2 GFLOP, a few us of fp32.  But only 16384 threads are in flight (256
// blocks of 64 on 132 SMs) and each runs O(n^3) dependent load-FMA steps,
// with a per-thread working set (2 n^2 words) that overflows L1 at that
// occupancy, so memory latency is the likely bound.  A warp per member with
// the matrix staged in shared memory is the way to make it fast.
#include <cuda_runtime.h>

namespace {

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
int launch(const void* K, void* L, void* Kinv, int n, long long E, void* stream) {
  const long long blocks = (E + kThreads - 1) / kThreads;
  spd_inverse_elast_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<T*>(L), static_cast<T*>(Kinv), n, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// K, L and Kinv are contiguous (n, n, E) device buffers of the entry's type.
extern "C" int spd_inverse_elast_f32(const void* K, void* L, void* Kinv, int n,
                                     long long E, void* stream) {
  return launch<float>(K, L, Kinv, n, E, stream);
}

extern "C" int spd_inverse_elast_f64(const void* K, void* L, void* Kinv, int n,
                                     long long E, void* stream) {
  return launch<double>(K, L, Kinv, n, E, stream);
}
