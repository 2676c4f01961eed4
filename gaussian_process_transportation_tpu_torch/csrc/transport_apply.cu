// The batched transport apply of E residual GPs under C*RBF(+White), in one
// launch, float32.
//
// For every member e (the Kabsch fit gamma_e(x) = s R (x - c_S) + c_T and the
// GP Psi_e conditioned on n points X_e, with alpha_e = K^-1 Y_e and the lower
// Cholesky factor L_e of K) and every demo point x_q with velocity v_q:
//
//   pos   = gamma_e(x_q),                    J_g = s R
//   k_i   = amp exp(-|X_i / l - pos / l|^2 / 2)           (i < n)
//   dk_di = (X_id - pos_d) / l_d^2 k_i                     (d < D)
//   traj  = pos + sum_i alpha_i k_i
//   std   = sqrt(max(amp + noise - |L^-1 k|^2, 0)) - sqrt(noise)
//   J_psi = alpha^T dk,      Jvar_d = amp / l_d^2 - |L^-1 dk_d|^2
//   J_phi = J_g + J_psi J_g, min_abs_det_e = min_q |det J_phi|
//   w     = J_g v_q,         delta = w + J_psi w,   dvar = sum_d Jvar_d w_d^2
//
// the fields of transport/gpt.py::transport_apply's plain route, which
// writes an (E, D, n, Q) derivative Gram and a second one as large (K^-1 dk)
// to device memory and runs its 2-wide contractions as gemv launches.  This
// kernel replaces no TPU kernel: the JAX package left apply to XLA.  It was
// added because the port's profile showed apply at ~33 of a ~35 ms ensemble
// call (E = 16384, n = 20, Q = 400, D = 2) at 0.54% of its roofline.
//
// Bound on an H100 (port_bench/counts.py::apply): 11.9 GFLOP at that shape,
// the quadratic forms counted as triangular solves (n^2 a column), 0.178 ms
// at 67 TFLOP/s; its bytes (the demo, the members' points, alpha and factor
// read once, the four (E, Q, D) fields written once, 157 MB) allow 0.047 ms,
// its exponentials 0.031 ms.  So the float32 pipes bound it, and the design
// keeps every intermediate in registers and spends the FMAs on the
// quadratic forms' n(n-1)/2 products a right-hand side, as counted:
//
// * A block of eight warps takes eight neighbouring members, a warp each.
//   It stages what a member needs (2.0 KB at n = 20, D = 2) in shared
//   memory: L^T with its diagonal taken out (strictly-lower entries, rows
//   padded to a multiple of four floats, read as 16-byte broadcasts), the
//   reciprocals of L's diagonal, X / l, alpha, and the member's affine map
//   and hyperparameters.  L is the (E, n, n) permuted view of the
//   Cholesky kernel's (n, n, E) output and is read through its strides, the
//   eight members of one entry in one 32-byte sector: no copy of it is made.
// * Each lane of the warp takes the member's query points in turn (q =
//   lane, lane + 32, ...).  It holds k and the D derivative vectors in
//   registers (n (1 + D) floats), forms the mean and J_psi as it computes
//   them, then solves L v = k and L v_d = dk_d in place by columns: each
//   16-byte broadcast of four entries of L^T feeds 4 (1 + D) FMAs, and the n
//   running sums of a column are independent, so the chain of one solve is
//   its n pivots, not its n^2 / 2 products.  The variances are |v|^2.
// * The warp reduces its lanes' least |det J_phi| by shuffles and writes one
//   value a member: no atomics, no second pass.
// * D (2, 3) and the capacity of n (24 in 2-D, 32, 64) are template
//   parameters, so the unrolled loops index registers statically; a
//   warp-uniform test of n at every fourth point cuts their tails.  Padded
//   points are at 1e18 (scaled coordinates), where k and dk are exactly 0,
//   and the padded entries of L^T and of the reciprocal diagonal are 0.
//   Registers bound the occupancy: in 2-D the capacity-24 instance takes 128
//   a thread, so two blocks (16 warps) share an SM, and the capacity-32 one
//   181, one block; at the floor's shape the first takes 0.58 ms, the second
//   1.10 (H100, 700 W).  A bound of two blocks an SM on the larger
//   instances spills (12.9 KB at capacity 64) and is slower.
// * The amplitude, the lengthscales and the noise are read from device
//   memory with a member stride (0 shared, 1 or D per member) where the
//   caller holds them there, else passed by value: the host never waits.
// * Each output is written once: traj and delta (E, Q, D), std and dvar
//   (E, Q), min_abs_det (E,).  NaN in a member (a factor that failed) comes
//   out NaN in its fields and its min|det|, as the plain route's amin does.
#include <cuda_runtime.h>

#include <math.h>

// Mirrored field by field by ops/transport_apply.py::_Args (ctypes).
struct ApplyArgs {
  const float* X;  // (E, n, D), each member's (n, D) rows contiguous
  long long x_es;
  const float* alpha;  // (E, n, D), the same
  long long a_es;
  const float* L;  // (E, n, n), any strides
  long long l_es, l_is, l_js;
  const float* rot;  // (E, D, D), each member's contiguous
  long long r_es;
  const float* scale;  // (E,)
  long long s_es;
  const float* src_c;  // (E, D), each member's contiguous
  long long sc_es;
  const float* tgt_c;  // (E, D)
  long long tc_es;
  const float* traj;  // (Q, D) contiguous
  const float* delta;
  const float* amp_dev;  // null: amp
  long long amp_es;
  float amp;
  const float* ls_dev;  // null: ls[d]
  long long ls_es, ls_ds;
  float ls[3];
  const float* noise_dev;  // null: noise
  long long noise_es;
  float noise;
  float* traj_out;  // (E, Q, D)
  float* std_out;   // (E, Q)
  float* delta_out;  // (E, Q, D)
  float* dvar_out;  // (E, Q)
  float* min_det_out;  // (E,)
  int E, n, Q, D;
};

namespace {

constexpr int kMembers = 8;  // members a block, one warp each
constexpr int kThreads = 32 * kMembers;
constexpr float kFar = 1e18f;  // a padded point's scaled coordinate
constexpr int kScalars = 32;   // floats of one member's affine map and hyperparameters
// offsets in a member's scalars
constexpr int kR = 0, kS = 9, kCS = 10, kCT = 13, kLS = 16, kJPR = 19, kAMP = 22, kPRIOR = 23,
              kSQN = 24, kIL = 25;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// floats of one member's slot: L^T (np4 rows of np4), the reciprocal
// diagonal, X / l and alpha (np4 rows of D)
__host__ __device__ inline int slot_floats(int np4, int D) { return np4 * np4 + np4 + 2 * np4 * D; }

inline size_t smem_bytes(int n, int D) {
  return sizeof(float) * (static_cast<size_t>(kMembers) * slot_floats(pad4(n), D) +
                          kMembers * kScalars);
}

__device__ inline float member_ls(const ApplyArgs& a, long long e, int d) {
  return a.ls_dev ? a.ls_dev[e * a.ls_es + d * a.ls_ds] : a.ls[d];
}

// min that keeps a NaN, as torch.amin does
__device__ inline float nan_min(float a, float b) { return (b < a || b != b) ? b : a; }

template <int D, int NCAP>
__global__ void __launch_bounds__(kThreads) transport_apply_kernel(const ApplyArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = a.n, np4 = pad4(n), slot = slot_floats(np4, D);
  const long long e0 = static_cast<long long>(blockIdx.x) * kMembers;
  float* scalars = smem + kMembers * slot;

  // -- staging: member fastest, so the eight members of an entry share a sector
  for (int t = threadIdx.x; t < kMembers * np4 * np4; t += kThreads) {
    const int m = t % kMembers, ij = t / kMembers, i = ij / np4, j = ij % np4;
    const long long e = e0 + m;
    float v = 0.f;  // L's strictly lower entries, into L^T
    if (e < a.E && i < n && j < i) v = a.L[e * a.l_es + i * a.l_is + j * a.l_js];
    smem[m * slot + j * np4 + i] = v;
  }
  for (int t = threadIdx.x; t < kMembers * np4; t += kThreads) {
    const int m = t % kMembers, j = t / kMembers;
    const long long e = e0 + m;
    float v = 0.f;
    if (e < a.E && j < n) v = 1.f / a.L[e * a.l_es + j * (a.l_is + a.l_js)];
    smem[m * slot + np4 * np4 + j] = v;
  }
  for (int t = threadIdx.x; t < kMembers * np4 * D; t += kThreads) {
    const int m = t % kMembers, r = t / kMembers, i = r / D, d = r % D;
    const long long e = e0 + m;
    float xs = kFar, al = 0.f;
    if (e < a.E && i < n) {
      xs = a.X[e * a.x_es + i * D + d] / member_ls(a, e, d);
      al = a.alpha[e * a.a_es + i * D + d];
    }
    float* pts = smem + m * slot + np4 * np4 + np4;
    pts[i * D + d] = xs;
    pts[np4 * D + i * D + d] = al;
  }
  if (threadIdx.x < kMembers) {
    const int m = threadIdx.x;
    const long long e = e0 + m;
    if (e < a.E) {
      float* c = scalars + m * kScalars;
      const float amp = a.amp_dev ? a.amp_dev[e * a.amp_es] : a.amp;
      const float noise = a.noise_dev ? a.noise_dev[e * a.noise_es] : a.noise;
#pragma unroll
      for (int p = 0; p < D * D; ++p) c[kR + p] = a.rot[e * a.r_es + p];
      c[kS] = a.scale[e * a.s_es];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float l = member_ls(a, e, d);
        c[kCS + d] = a.src_c[e * a.sc_es + d];
        c[kCT + d] = a.tgt_c[e * a.tc_es + d];
        c[kLS + d] = l;
        c[kIL + d] = 1.f / l;
        c[kJPR + d] = amp * (1.f / (l * l));  // amp dxdz_diag of the RBF
      }
      c[kAMP] = amp;
      c[kPRIOR] = amp + noise;
      c[kSQN] = sqrtf(noise);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long e = e0 + warp;
  if (e >= a.E) return;
  const float* lt = smem + warp * slot;  // L^T
  const float* rd = lt + np4 * np4;      // 1 / L_jj
  const float* xs = rd + np4;            // X / l
  const float* al = xs + np4 * D;        // alpha
  const float* c = scalars + warp * kScalars;

  float R[D][D], cS[D], cT[D], ls[D], il[D], jpr[D], Jg[D][D];
  const float s = c[kS], amp = c[kAMP], prior = c[kPRIOR], sqn = c[kSQN];
#pragma unroll
  for (int p = 0; p < D; ++p) {
    cS[p] = c[kCS + p];
    cT[p] = c[kCT + p];
    ls[p] = c[kLS + p];
    il[p] = c[kIL + p];
    jpr[p] = c[kJPR + p];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      R[p][d] = c[kR + p * D + d];
      Jg[p][d] = s * R[p][d];
    }
  }

  float least = INFINITY;
  for (int q = lane; q < a.Q; q += 32) {
    float x[D], v[D], y[D], pos[D], ps[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = a.traj[q * D + d];
      v[d] = a.delta[q * D + d];
      y[d] = s * (x[d] - cS[d]);
    }
#pragma unroll
    for (int p = 0; p < D; ++p) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(y[d], R[p][d], acc);
      pos[p] = acc + cT[p];
      ps[p] = pos[p] / ls[p];
    }

    // k, dk, and as they come the mean and J_psi
    float k[NCAP], g[D][NCAP], mean[D], jp[D][D];
#pragma unroll
    for (int p = 0; p < D; ++p) {
      mean[p] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) jp[p][d] = 0.f;
    }
#pragma unroll
    for (int i4 = 0; i4 < NCAP; i4 += 4) {
      if (i4 < n) {
#pragma unroll
        for (int i = i4; i < i4 + 4; ++i) {
          float df[D], d2 = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            df[d] = xs[i * D + d] - ps[d];
            d2 = fmaf(df[d], df[d], d2);
          }
          const float kv = amp * expf(-0.5f * d2);
          k[i] = kv;
#pragma unroll
          for (int d = 0; d < D; ++d) g[d][i] = df[d] * il[d] * kv;
#pragma unroll
          for (int p = 0; p < D; ++p) {
            const float ap = al[i * D + p];
            mean[p] = fmaf(ap, kv, mean[p]);
#pragma unroll
            for (int d = 0; d < D; ++d) jp[p][d] = fmaf(ap, g[d][i], jp[p][d]);
          }
        }
      }
    }

    // L v = k and L v_d = dk_d by columns, in place; the variances are |v|^2
    float q0 = 0.f, qd[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qd[d] = 0.f;
#pragma unroll
    for (int j = 0; j < NCAP; ++j) {
      if (j < n) {
        const float r = rd[j];
        k[j] *= r;
        q0 = fmaf(k[j], k[j], q0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          g[d][j] *= r;
          qd[d] = fmaf(g[d][j], g[d][j], qd[d]);
        }
        const float* col = lt + j * np4;
        // entries of L^T's row j at and before j are 0: the rows before j take
        // nothing, and the group of four that holds j starts the loop
#pragma unroll
        for (int i4 = ((j + 1) / 4) * 4; i4 < NCAP; i4 += 4) {
          if (i4 < n) {
            const float4 l4 = *reinterpret_cast<const float4*>(col + i4);
            const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (i4 + u > j) {  // static after unrolling
                k[i4 + u] = fmaf(-lv[u], k[j], k[i4 + u]);
#pragma unroll
                for (int d = 0; d < D; ++d) g[d][i4 + u] = fmaf(-lv[u], g[d][j], g[d][i4 + u]);
              }
            }
          }
        }
      }
    }

    const float var = prior - q0;
    const float sd = sqrtf(var < 0.f ? 0.f : var) - sqn;  // a NaN stays NaN

    float Jphi[D][D], w[D];
#pragma unroll
    for (int p = 0; p < D; ++p) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float acc = 0.f;
#pragma unroll
        for (int f = 0; f < D; ++f) acc = fmaf(jp[p][f], Jg[f][d], acc);
        Jphi[p][d] = Jg[p][d] + acc;
      }
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(Jg[p][d], v[d], acc);
      w[p] = acc;
    }
    float det;
    if constexpr (D == 2) {
      det = Jphi[0][0] * Jphi[1][1] - Jphi[0][1] * Jphi[1][0];
    } else {
      det = Jphi[0][0] * (Jphi[1][1] * Jphi[2][2] - Jphi[1][2] * Jphi[2][1]) -
            Jphi[0][1] * (Jphi[1][0] * Jphi[2][2] - Jphi[1][2] * Jphi[2][0]) +
            Jphi[0][2] * (Jphi[1][0] * Jphi[2][1] - Jphi[1][1] * Jphi[2][0]);
    }
    least = nan_min(least, fabsf(det));

    float dvar = 0.f;
    const long long out = (e * a.Q + q) * D;
#pragma unroll
    for (int p = 0; p < D; ++p) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(jp[p][d], w[d], acc);
      a.traj_out[out + p] = pos[p] + mean[p];
      a.delta_out[out + p] = w[p] + acc;
      dvar = fmaf(jpr[p] - qd[p], w[p] * w[p], dvar);
    }
    a.std_out[e * a.Q + q] = sd;
    a.dvar_out[e * a.Q + q] = dvar;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) least = nan_min(least, __shfl_xor_sync(0xffffffffu, least, off));
  if (lane == 0) a.min_det_out[e] = least;
}

template <int D, int NCAP>
int launch(const ApplyArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.n, a.D);
  const auto kernel = transport_apply_kernel<D, NCAP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(a.E) + kMembers - 1) / kMembers);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over every member; E >= 1, Q >= 1, 1 <= n <= 64, D in {2, 3}
// (cudaErrorInvalidValue otherwise).
extern "C" int transport_apply_f32(const ApplyArgs* args, void* stream) {
  const ApplyArgs& a = *args;
  if (a.E < 1 || a.Q < 1 || a.n < 1 || a.n > 64 || (a.D != 2 && a.D != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.D == 2)
    return a.n <= 24 ? launch<2, 24>(a, s) : a.n <= 32 ? launch<2, 32>(a, s) : launch<2, 64>(a, s);
  return a.n <= 32 ? launch<3, 32>(a, s) : launch<3, 64>(a, s);
}

// sizeof(ApplyArgs), which the wrapper checks against its ctypes mirror
extern "C" int transport_apply_args_bytes() { return static_cast<int>(sizeof(ApplyArgs)); }
