// Fused ADMM iteration blocks for Hopper (sm_90a), float and double.
//
// Replaces the Pallas TPU kernel libmpc_tpu/ops/admm_pallas.py::_kernel
// (pallas_call at admm_pallas.py:143).  One call runs `k_iters` ADMM
// iterations for a batch of QPs that share A (m, n), the KKT matrix M and
// its explicit inverse Minv (n, n), and the row penalties rho (m,):
//
//   w   = rho z - y
//   rhs = sigma x - q + w A
//   xt  = rhs Minv                       (+ xt += (rhs - xt M) Minv if refine)
//   zt  = xt A'
//   x   = alpha xt + (1 - alpha) x
//   zr  = alpha zt + (1 - alpha) z
//   zu  = zr + y / rho
//   z   = clip(zu, l, u)
//   y   = clipped ? y + rho (zr - z) : 0
//
// Lanes whose `done` flag is set keep x/z/y bitwise untouched.
//
// What bounds it on this card: the TPU kernel keeps A, M and Minv in VMEM;
// at the quadrotor size (n=216, m=535) they take 462 + 187 + 187 KB in
// float32, more than the 227 KB of shared memory a Hopper block can use.
// So here one block owns a tile of BT lanes for all k_iters iterations and
// keeps the tile's x/z/y and the rhs/xt/w scratch in shared memory,
// while the read-only A, its transpose, M and Minv stream from the 50 MB L2
// through the read-only path.  Every matrix element fetched is reused for
// all BT lanes of the tile, so the kernel's L2 traffic per lane-iteration is
// (2 m n + (1 or 3) n n) / BT elements.  Each product is a "column product":
// thread j walks the contraction index k and reads Mat[k][j] (coalesced
// across the warp) and v[k][0..BT) (a shared-memory broadcast), keeping BT
// accumulators in registers.  Products are plain FFMA/DFMA; no tensor-core
// (TF32) arithmetic is used.  Vectors live lane-minor in shared memory
// (v[k * BT + b]) so one k step reads BT consecutive values.
//
// The products are bound by the latency of those L2 reads, not by L2
// bandwidth: at the quadrotor size a block has to keep many reads in flight.
// Three choices do that (measured at B=16384, n=216, m=535, 10 iterations,
// float32, on an H100): 16 independent reads per thread (the unrolled k
// loop), 384 threads per block, and a block small enough for three blocks
// per SM — 8 lanes in float32 (72 KB), 4 in float64, with the refinement
// residual sharing w's buffer.  Together they took a block of iterations
// from 14.7 ms (256 threads, 4 reads in flight, 16 lanes) to 6.6 ms.
//
// The grid is ceil(B / BT): the last tile masks its missing lanes itself,
// so unlike the TPU kernel the batch needs no power-of-two divisor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return ::fma(a, b, c);
}

template <typename T, int BT>
__device__ __forceinline__ void column_product(const T* __restrict__ mat, int ld,
                                               const T* __restrict__ v, int K,
                                               int j, T (&acc)[BT]) {
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = T(0);
#pragma unroll 16
  for (int k = 0; k < K; ++k) {
    const T a = __ldg(mat + (size_t)k * ld + j);
    const T* vk = v + k * BT;
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = fma_t(vk[b], a, acc[b]);
  }
}

template <typename T, int BT>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, T* s, int B,
                                          int b0, int width) {
  for (int e = threadIdx.x; e < BT * width; e += blockDim.x) {
    const int b = e / width;
    const int c = e - b * width;
    const int gb = b0 + b;
    s[c * BT + b] = gb < B ? g[(size_t)gb * width + c] : T(0);
  }
}

template <typename T, int BT>
__device__ __forceinline__ void store_tile(const T* s, T* __restrict__ g, int B,
                                           int b0, int width) {
  for (int e = threadIdx.x; e < BT * width; e += blockDim.x) {
    const int b = e / width;
    const int c = e - b * width;
    const int gb = b0 + b;
    if (gb < B) g[(size_t)gb * width + c] = s[c * BT + b];
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
admm_fused_kernel(const T* __restrict__ x, const T* __restrict__ z,
                  const T* __restrict__ y, const uint8_t* __restrict__ done,
                  const T* __restrict__ q, const T* __restrict__ l,
                  const T* __restrict__ u, const T* __restrict__ A,
                  const T* __restrict__ At, const T* __restrict__ M,
                  const T* __restrict__ Minv, const T* __restrict__ rho,
                  T* __restrict__ ox, T* __restrict__ oz, T* __restrict__ oy,
                  int B, int n, int m, int k_iters, T sigma, T alpha,
                  T one_minus_alpha, int refine) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (n, BT) each
  T* rhs = xs + n * BT;
  T* xt = rhs + n * BT;
  T* zs = xt + n * BT;  // (m, BT) each
  T* ys = zs + m * BT;
  // w is dead once rhs is formed, so the refinement residual reuses its
  // buffer: (max(n, m), BT)
  T* ws = ys + m * BT;
  T* res = ws;
  __shared__ bool frozen[BT];

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BT;
  if (tid < BT) {
    const int gb = b0 + tid;
    frozen[tid] = gb >= B || done[gb] != 0;
  }
  load_tile<T, BT>(x, xs, B, b0, n);
  load_tile<T, BT>(z, zs, B, b0, m);
  load_tile<T, BT>(y, ys, B, b0, m);
  __syncthreads();

  T acc[BT];
  for (int it = 0; it < k_iters; ++it) {
    for (int e = tid; e < m * BT; e += blockDim.x) {
      ws[e] = __ldg(rho + e / BT) * zs[e] - ys[e];
    }
    __syncthreads();
    // rhs = sigma x - q + w A
    for (int j = tid; j < n; j += blockDim.x) {
      column_product<T, BT>(A, n, ws, m, j, acc);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const int gb = b0 + b;
        const T qv = gb < B ? __ldg(q + (size_t)gb * n + j) : T(0);
        rhs[j * BT + b] = sigma * xs[j * BT + b] - qv + acc[b];
      }
    }
    __syncthreads();
    // xt = rhs Minv (Minv symmetric)
    for (int j = tid; j < n; j += blockDim.x) {
      column_product<T, BT>(Minv, n, rhs, n, j, acc);
#pragma unroll
      for (int b = 0; b < BT; ++b) xt[j * BT + b] = acc[b];
    }
    __syncthreads();
    if (refine) {
      // one refinement pass against M: xt += (rhs - xt M) Minv
      for (int j = tid; j < n; j += blockDim.x) {
        column_product<T, BT>(M, n, xt, n, j, acc);
#pragma unroll
        for (int b = 0; b < BT; ++b) res[j * BT + b] = rhs[j * BT + b] - acc[b];
      }
      __syncthreads();
      for (int j = tid; j < n; j += blockDim.x) {
        column_product<T, BT>(Minv, n, res, n, j, acc);
#pragma unroll
        for (int b = 0; b < BT; ++b) xt[j * BT + b] = xt[j * BT + b] + acc[b];
      }
      __syncthreads();
    }
    // zt = xt A' (row i of A is column i of At), then the projection and the
    // dual update of row i; every thread owns its rows
    for (int i = tid; i < m; i += blockDim.x) {
      column_product<T, BT>(At, m, xt, n, i, acc);
      const T r = __ldg(rho + i);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (frozen[b]) continue;
        const size_t g = (size_t)(b0 + b) * m + i;
        const T zo = zs[i * BT + b];
        const T yo = ys[i * BT + b];
        const T zr = alpha * acc[b] + one_minus_alpha * zo;
        const T zu = zr + yo / r;
        const T lo = __ldg(l + g);
        const T hi = __ldg(u + g);
        T zn = zu < lo ? lo : zu;
        zn = zn > hi ? hi : zn;
        const bool clipped = (zu < lo) || (zu > hi);
        zs[i * BT + b] = zn;
        ys[i * BT + b] = clipped ? yo + r * (zr - zn) : T(0);
      }
    }
    for (int e = tid; e < n * BT; e += blockDim.x) {
      if (!frozen[e % BT]) xs[e] = alpha * xt[e] + one_minus_alpha * xs[e];
    }
    __syncthreads();
  }

  store_tile<T, BT>(xs, ox, B, b0, n);
  store_tile<T, BT>(zs, oz, B, b0, m);
  store_tile<T, BT>(ys, oy, B, b0, m);
}

template <typename T, int BT>
cudaError_t launch(const T* x, const T* z, const T* y, const uint8_t* done,
                   const T* q, const T* l, const T* u, const T* A, const T* At,
                   const T* M, const T* Minv, const T* rho, T* ox, T* oz, T* oy,
                   int B, int n, int m, int k_iters, double sigma, double alpha,
                   int refine, cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * n + 2 * m + (n > m ? n : m)) * BT * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      admm_fused_kernel<T, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT);
  admm_fused_kernel<T, BT><<<grid, kThreads, smem, stream>>>(
      x, z, y, done, q, l, u, A, At, M, Minv, rho, ox, oz, oy, B, n, m,
      k_iters, T(sigma), T(alpha), T(1.0 - alpha), refine);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const T* z, const T* y, const uint8_t* done,
             const T* q, const T* l, const T* u, const T* A, const T* At,
             const T* M, const T* Minv, const T* rho, T* ox, T* oz, T* oy,
             int B, int n, int m, int k_iters, double sigma, double alpha,
             int refine, int bt, cudaStream_t stream) {
#define LIBMPC_ADMM_CASE(BT_)                                                 \
  case BT_:                                                                   \
    return (int)launch<T, BT_>(x, z, y, done, q, l, u, A, At, M, Minv, rho,   \
                               ox, oz, oy, B, n, m, k_iters, sigma, alpha,    \
                               refine, stream);
  switch (bt) {
    LIBMPC_ADMM_CASE(16)
    LIBMPC_ADMM_CASE(8)
    LIBMPC_ADMM_CASE(4)
    LIBMPC_ADMM_CASE(2)
    LIBMPC_ADMM_CASE(1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LIBMPC_ADMM_CASE
}

}  // namespace

extern "C" int libmpc_admm_fused_f32(
    const float* x, const float* z, const float* y, const uint8_t* done,
    const float* q, const float* l, const float* u, const float* A,
    const float* At, const float* M, const float* Minv, const float* rho,
    float* ox, float* oz, float* oy, int B, int n, int m, int k_iters,
    double sigma, double alpha, int refine, int bt, void* stream) {
  return dispatch<float>(x, z, y, done, q, l, u, A, At, M, Minv, rho, ox, oz,
                         oy, B, n, m, k_iters, sigma, alpha, refine, bt,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int libmpc_admm_fused_f64(
    const double* x, const double* z, const double* y, const uint8_t* done,
    const double* q, const double* l, const double* u, const double* A,
    const double* At, const double* M, const double* Minv, const double* rho,
    double* ox, double* oz, double* oy, int B, int n, int m, int k_iters,
    double sigma, double alpha, int refine, int bt, void* stream) {
  return dispatch<double>(x, z, y, done, q, l, u, A, At, M, Minv, rho, ox, oz,
                          oy, B, n, m, k_iters, sigma, alpha, refine, bt,
                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* libmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
