// Whole-solve ADMM kernel for a batch of small dense QPs on Hopper (sm_90a),
// float and double:   min 1/2 x'Px + q'x   s.t.  l <= Ax <= u,
// each instance with its own P (n, n) and A (m, n).
//
// Replaces the Pallas TPU kernel libmpc_tpu/ops/qp_inner_pallas.py::_kernel
// (pallas_call at qp_inner_pallas.py:362).  Per instance it assembles
// M = P + sigma I + A' diag(rho) A, factors it (Cholesky, pivots floored at
// 1e-30), forms the explicit inverse, sets z0 = A x0, and iterates ADMM
// (x-update through M^-1 with one refinement pass against M,
// over-relaxation alpha, box projection, exactly-zero inactive duals).  Every
// check_every iterations it tests convergence on the UNSCALED residuals (the
// data arrives Ruiz-scaled with D^-1, E^-1 and c^-1 beside it), and when the
// residual ratio of an unconverged instance leaves [0.2, 5] it rescales the
// whole per-row rho vector (clipped to [1e-6, 1e6]) and refactors.
//
// What bounds it on this card: an instance is ~14 KB of matrices and ~1e4
// operations per iteration, so bytes and arithmetic both amount to tens of
// microseconds for a batch of thousands.  The work is five small
// matrix-vector products per iteration, one after the other, and each
// multiply-add reads two operands from shared memory: measured, one instance
// alone takes 2.8 us per iteration and thirteen per SM 5.0 us each, about
// 675 cycles per iteration per SM against the 374 shared-memory loads it
// issues, so at full residency the kernel is bound by shared-memory load
// throughput.  The TPU kernel lays 128 instances side by side in the vector
// lanes, runs a tile until all 128 are done and refactors all 128 when one
// adapts rho; none of that is mathematics.  Here ONE WARP OWNS ONE INSTANCE:
//   * A, M, the factor workspace, M^-1 and all vectors stay in shared memory
//     for the whole solve; P is read from global memory (once per
//     factorization, once per check);
//   * matrices are row-major with an odd leading dimension ld = n | 1, so a
//     product with lanes over rows (stride ld) and one with lanes over
//     columns (stride 1) are both free of bank conflicts;
//   * the warp leaves the loop when ITS instance converges, and refactors
//     only when ITS rho moves;
//   * a block holds `warps` such warps (the wrapper passes 1: instances
//     finish at different times, and the smallest block schedules best) and
//     masks the ragged end of the batch; nothing is padded.  A dozen blocks
//     are resident per SM and hide each other's latency.
// Shared memory per warp: (m ld + 3 n ld + 6 n + 7 m) elements.

#include <cuda_runtime.h>

#include "chol_warp.cuh"

namespace {

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use

// max that keeps a NaN (jnp.max semantics: a NaN residual never converges)
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

template <typename T>
__device__ __forceinline__ T warp_nanmax(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__device__ __forceinline__ T abs_t(T v) { return v < T(0) ? -v : v; }

template <typename T>
__device__ __forceinline__ T clamp_t(T v, T lo, T hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

template <typename T>
struct Params {
  T sigma, alpha, one_minus_alpha, eps_abs, eps_rel;
  int n_blocks, check_every, refine;
};

template <typename T>
__global__ void qp_inner_kernel(
    const T* __restrict__ P, const T* __restrict__ A, const T* __restrict__ q,
    const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ x0, const T* __restrict__ y0,
    const T* __restrict__ dinv, const T* __restrict__ einv,
    const T* __restrict__ cinv, T* __restrict__ xo, T* __restrict__ yo,
    T* __restrict__ zo, int* __restrict__ iters_o, int* __restrict__ done_o,
    T* __restrict__ pri_o, T* __restrict__ dua_o, int B, int n, int m,
    Params<T> par) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ld = n | 1;
  const size_t per_warp = (size_t)m * ld + 3 * (size_t)n * ld + 6 * n + 7 * m;
  T* sA = reinterpret_cast<T*>(smem_raw) + warp * per_warp;
  T* sM = sA + (size_t)m * ld;
  T* sL = sM + n * ld;
  T* sMinv = sL + n * ld;
  T* sx = sMinv + n * ld;
  T* sq = sx + n;
  T* srhs = sq + n;
  T* sxt = srhs + n;
  T* sres = sxt + n;
  T* sdinv = sres + n;
  T* sz = sdinv + n;
  T* sy = sz + m;
  T* srho = sy + m;
  T* sl = srho + m;
  T* su = sl + m;
  T* sw = su + m;
  T* seinv = sw + m;

  const int inst = blockIdx.x * warps + warp;
  if (inst >= B) return;  // the whole warp leaves; only warp-level syncs below

  const T* Pg = P + (size_t)inst * n * n;
  const T* Ag = A + (size_t)inst * m * n;
  for (int e = lane; e < m * n; e += 32) {
    const int r = e / n;
    sA[r * ld + (e - r * n)] = Ag[e];
  }
  for (int j = lane; j < n; j += 32) {
    sx[j] = x0[(size_t)inst * n + j];
    sq[j] = q[(size_t)inst * n + j];
    sdinv[j] = dinv[(size_t)inst * n + j];
  }
  for (int r = lane; r < m; r += 32) {
    const size_t g = (size_t)inst * m + r;
    sy[r] = y0[g];
    srho[r] = rho[g];
    sl[r] = l[g];
    su[r] = u[g];
    seinv[r] = einv[g];
  }
  const T ci = cinv[inst];
  __syncwarp();

  // (re)build M from srho, factor a copy and store the explicit inverse
  auto factorize = [&]() {
    for (int i = 0; i < n; ++i) {
      for (int j = lane; j < n; j += 32) {
        T acc = T(0);
        for (int r = 0; r < m; ++r)
          acc += (sA[r * ld + j] * srho[r]) * sA[r * ld + i];
        const T mij = (Pg[i * n + j] + (i == j ? par.sigma : T(0))) + acc;
        sM[i * ld + j] = mij;
        sL[i * ld + j] = mij;
      }
    }
    __syncwarp();
    libmpc::warp_chol_inverse(sL, sMinv, n, ld, lane);
  };
  factorize();

  // z0 = A x0
  for (int r = lane; r < m; r += 32) {
    T acc = T(0);
    for (int j = 0; j < n; ++j) acc += sA[r * ld + j] * sx[j];
    sz[r] = acc;
  }
  __syncwarp();

  int iters = 0, done = 0;
  T pri = T(0), dua = T(0);
  for (int blk = 0; blk < par.n_blocks; ++blk) {
    for (int it = 0; it < par.check_every; ++it) {
      for (int r = lane; r < m; r += 32) sw[r] = srho[r] * sz[r] - sy[r];
      __syncwarp();
      // rhs = sigma x - q + A'(rho z - y)
      for (int j = lane; j < n; j += 32) {
        T acc = T(0);
        for (int r = 0; r < m; ++r) acc += sA[r * ld + j] * sw[r];
        srhs[j] = par.sigma * sx[j] - sq[j] + acc;
      }
      __syncwarp();
      // xt = M^-1 rhs, then one refinement pass against M
      for (int i = lane; i < n; i += 32) {
        T acc = T(0);
        for (int j = 0; j < n; ++j) acc += sMinv[i * ld + j] * srhs[j];
        sxt[i] = acc;
      }
      __syncwarp();
      if (par.refine) {
        for (int i = lane; i < n; i += 32) {
          T acc = T(0);
          for (int j = 0; j < n; ++j) acc += sM[i * ld + j] * sxt[j];
          sres[i] = srhs[i] - acc;
        }
        __syncwarp();
        for (int i = lane; i < n; i += 32) {
          T acc = T(0);
          for (int j = 0; j < n; ++j) acc += sMinv[i * ld + j] * sres[j];
          sxt[i] += acc;
        }
        __syncwarp();
      }
      // zt = A xt; relaxation, projection and dual update row by row
      for (int r = lane; r < m; r += 32) {
        T zt = T(0);
        for (int j = 0; j < n; ++j) zt += sA[r * ld + j] * sxt[j];
        const T y = sy[r], rh = srho[r], lo = sl[r], hi = su[r];
        const T z_relax = par.alpha * zt + par.one_minus_alpha * sz[r];
        const T z_unc = z_relax + y / rh;
        const T z_new = clamp_t(z_unc, lo, hi);
        const bool clipped = (z_unc < lo) || (z_unc > hi);
        sz[r] = z_new;
        sy[r] = clipped ? y + rh * (z_relax - z_new) : T(0);
      }
      for (int j = lane; j < n; j += 32)
        sx[j] = par.alpha * sxt[j] + par.one_minus_alpha * sx[j];
      __syncwarp();
    }

    // convergence check on the unscaled residuals
    T p_res = T(0), ax_max = T(0), ez_max = T(0);
    for (int r = lane; r < m; r += 32) {
      T acc = T(0);
      for (int j = 0; j < n; ++j) acc += sA[r * ld + j] * sx[j];
      const T ax = seinv[r] * acc;
      const T ez = seinv[r] * sz[r];
      p_res = nanmax(p_res, abs_t(ax - ez));
      ax_max = nanmax(ax_max, abs_t(ax));
      ez_max = nanmax(ez_max, abs_t(ez));
    }
    T d_res = T(0), px_max = T(0), aty_max = T(0), q_max = T(0);
    for (int i = lane; i < n; i += 32) {
      T accp = T(0);
      for (int j = 0; j < n; ++j) accp += Pg[i * n + j] * sx[j];
      T acca = T(0);
      for (int r = 0; r < m; ++r) acca += sA[r * ld + i] * sy[r];
      const T px = sdinv[i] * accp;
      const T aty = sdinv[i] * acca;
      const T dq = sdinv[i] * sq[i];
      d_res = nanmax(d_res, abs_t(px + dq + aty));
      px_max = nanmax(px_max, abs_t(px));
      aty_max = nanmax(aty_max, abs_t(aty));
      q_max = nanmax(q_max, abs_t(dq));
    }
    pri = warp_nanmax(p_res);
    dua = ci * warp_nanmax(d_res);
    const T pri_rel = nanmax(warp_nanmax(ax_max), warp_nanmax(ez_max));
    const T dua_rel =
        ci * nanmax(nanmax(warp_nanmax(px_max), warp_nanmax(aty_max)),
                    warp_nanmax(q_max));
    const bool conv = (pri <= par.eps_abs + par.eps_rel * pri_rel) &&
                      (dua <= par.eps_abs + par.eps_rel * dua_rel);
    // the counter advances by a whole block up to and including the block
    // in which the instance converges
    iters += par.check_every;
    if (conv) {
      done = 1;
      break;
    }
    if (blk + 1 < par.n_blocks) {
      // adaptive rho (OSQP 5.2): scale the whole per-row vector
      const T tiny = T(1e-30);
      T ratio = sqrt((pri / nanmax(pri_rel, tiny)) /
                     nanmax(dua / nanmax(dua_rel, tiny), tiny));
      ratio = clamp_t(ratio, T(1e-4), T(1e4));
      if (ratio > T(5) || ratio < T(0.2)) {
        for (int r = lane; r < m; r += 32)
          srho[r] = clamp_t(srho[r] * ratio, T(1e-6), T(1e6));
        __syncwarp();
        factorize();
      }
    }
  }

  for (int j = lane; j < n; j += 32) xo[(size_t)inst * n + j] = sx[j];
  for (int r = lane; r < m; r += 32) {
    yo[(size_t)inst * m + r] = sy[r];
    zo[(size_t)inst * m + r] = sz[r];
  }
  if (lane == 0) {
    iters_o[inst] = iters;
    done_o[inst] = done;
    pri_o[inst] = pri;
    dua_o[inst] = dua;
  }
}

template <typename T>
int launch(const T* P, const T* A, const T* q, const T* l, const T* u,
           const T* rho, const T* x0, const T* y0, const T* dinv, const T* einv,
           const T* cinv, T* xo, T* yo, T* zo, int* iters, int* done, T* pri,
           T* dua, int B, int n, int m, double sigma, double alpha,
           double eps_abs, double eps_rel, int n_blocks, int check_every,
           int refine, int warps, cudaStream_t stream) {
  if (B < 1 || n < 1 || m < 1 || warps < 1 || warps > 32 || n_blocks < 1 ||
      check_every < 1)
    return (int)cudaErrorInvalidValue;
  const size_t ld = (size_t)(n | 1);
  const size_t per_warp = ((size_t)m * ld + 3 * (size_t)n * ld + 6 * (size_t)n +
                           7 * (size_t)m) * sizeof(T);
  const size_t smem = per_warp * warps;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      qp_inner_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // ask for the largest shared-memory carve-out, so that as many blocks as
  // fit 227 KB are resident per SM (a hint; the default may settle for less)
  err = cudaFuncSetAttribute(qp_inner_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  Params<T> par;
  par.sigma = (T)sigma;
  par.alpha = (T)alpha;
  par.one_minus_alpha = (T)(1.0 - alpha);
  par.eps_abs = (T)eps_abs;
  par.eps_rel = (T)eps_rel;
  par.n_blocks = n_blocks;
  par.check_every = check_every;
  par.refine = refine;
  const dim3 grid((B + warps - 1) / warps);
  qp_inner_kernel<T><<<grid, 32 * warps, smem, stream>>>(
      P, A, q, l, u, rho, x0, y0, dinv, einv, cinv, xo, yo, zo, iters, done,
      pri, dua, B, n, m, par);
  return (int)cudaGetLastError();
}

}  // namespace

#define LIBMPC_QP_INNER(NAME, T)                                              \
  extern "C" int NAME(                                                        \
      const T* P, const T* A, const T* q, const T* l, const T* u,             \
      const T* rho, const T* x0, const T* y0, const T* dinv, const T* einv,   \
      const T* cinv, T* xo, T* yo, T* zo, int* iters, int* done, T* pri,      \
      T* dua, int B, int n, int m, double sigma, double alpha,                \
      double eps_abs, double eps_rel, int n_blocks, int check_every,          \
      int refine, int warps, void* stream) {                                  \
    return launch<T>(P, A, q, l, u, rho, x0, y0, dinv, einv, cinv, xo, yo,    \
                     zo, iters, done, pri, dua, B, n, m, sigma, alpha,        \
                     eps_abs, eps_rel, n_blocks, check_every, refine, warps,  \
                     static_cast<cudaStream_t>(stream));                      \
  }

LIBMPC_QP_INNER(libmpc_qp_inner_f32, float)
LIBMPC_QP_INNER(libmpc_qp_inner_f64, double)
