// Solve of a batch of factored bordered block-tridiagonal trajectory KKT
// systems for one right-hand side each, for Hopper (sm_90a), float and double.
//
// Replaces the two Pallas TPU kernels of
// libmpc_tpu/ops/trajectory_sweeps.py::batched_sweep_solve (_fwd_kernel,
// pallas_call at trajectory_sweeps.py:337, and _bwd_kernel, :375) and the
// einsum between them (:372).  Per instance:
//   forward   u_k = S_k^-1 (r_k - L_{k-1} u_{k-1}),  xtr = sum_k X_k' r_k
//   border    g = Ghat^-1 (r_g - xtr)
//   backward  xT_{ph-1} = u_{ph-1},  xT_k = u_k - S_k^-1 (L_k' xT_{k+1}),
//             x_k = xT_k - X_k g
//
// What bounds it on this card: two operations per word read, so the bytes of
// S^-1, L and X (each read once forward and once backward).  The TPU version
// needs two kernels and a product between them because its grid runs in
// order over (tile, stage) with 128 instances in the vector lanes; here one
// warp owns one instance and runs all three phases in one launch.  The
// running vectors u_0..u_{ph-1} stay in shared memory; each stage's matrices
// are copied into shared memory by coalesced loads (odd leading dimension),
// then lane i computes row i (or column i) of each product without bank
// conflicts.  Several warps share a block, each on its own slice of shared
// memory with warp-level synchronisation only; a warp past the end of a
// ragged batch leaves at once.

#include <cuda_runtime.h>

namespace {

constexpr size_t kSmemLimit = 232448;

// shared-memory words of one warp; the Python gate
// (ops/trajectory_sweeps.py::sweep_smem_bytes) restates this sum
__host__ __device__ inline size_t sweep_words(int ph, int bs, int w) {
  const int ld = bs | 1;
  return (size_t)2 * bs * ld + (size_t)bs * w + (size_t)ph * bs + (size_t)3 * bs +
         (size_t)2 * w;
}

template <typename T>
__device__ __forceinline__ void load_matrix(T* dst, const T* __restrict__ src, int bs,
                                            int ld, int lane) {
  for (int e = lane; e < bs * bs; e += 32) {
    const int r = e / bs;
    dst[r * ld + (e - r * bs)] = src[e];
  }
}

template <typename T>
__global__ void traj_sweep_kernel(const T* __restrict__ Sinv, const T* __restrict__ L,
                                  const T* __restrict__ X, const T* __restrict__ Gi,
                                  const T* __restrict__ r, const T* __restrict__ rg,
                                  T* __restrict__ xs, T* __restrict__ g_out,
                                  int B, int ph, int bs, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;  // the whole warp leaves; only warp-level syncs below
  const int ld = bs | 1;

  T* Ml = reinterpret_cast<T*>(smem_raw) + (size_t)warp * sweep_words(ph, bs, w);
  T* Ms = Ml + bs * ld;   // S_k^-1
  T* Xs = Ms + bs * ld;   // X_k (bs, w)
  T* u = Xs + bs * w;     // u_0 .. u_{ph-1}
  T* rk = u + ph * bs;    // r_k
  T* v = rk + bs;         // work vector
  T* xn = v + bs;         // xT_{k+1}
  T* xtr = xn + bs;       // sum_k X_k' r_k
  T* g = xtr + w;         // border solution

  const size_t mat = (size_t)bs * bs, bord = (size_t)bs * w;
  const T* Sb = Sinv + (size_t)b * ph * mat;
  const T* Lb = L + (size_t)b * (ph - 1) * mat;
  const T* Xb = X + (size_t)b * ph * bord;
  const T* rb = r + (size_t)b * ph * bs;
  T* xb = xs + (size_t)b * ph * bs;

  for (int j = lane; j < w; j += 32) xtr[j] = T(0);

  // forward
  for (int k = 0; k < ph; ++k) {
    load_matrix(Ms, Sb + k * mat, bs, ld, lane);
    if (k > 0) load_matrix(Ml, Lb + (k - 1) * mat, bs, ld, lane);
    for (int e = lane; e < bs * w; e += 32) Xs[e] = Xb[k * bord + e];
    for (int i = lane; i < bs; i += 32) rk[i] = rb[k * bs + i];
    __syncwarp();
    for (int i = lane; i < bs; i += 32) {
      T acc = T(0);
      if (k > 0) {
        const T* up = u + (k - 1) * bs;
        for (int q = 0; q < bs; ++q) acc += Ml[i * ld + q] * up[q];
      }
      v[i] = rk[i] - acc;
    }
    __syncwarp();
    for (int i = lane; i < bs; i += 32) {
      T acc = T(0);
      for (int q = 0; q < bs; ++q) acc += Ms[i * ld + q] * v[q];
      u[k * bs + i] = acc;
    }
    for (int j = lane; j < w; j += 32) {
      T acc = T(0);
      for (int q = 0; q < bs; ++q) acc += Xs[q * w + j] * rk[q];
      xtr[j] += acc;
    }
    __syncwarp();
  }

  // border: g = Ghat^-1 (r_g - xtr)
  for (int a = lane; a < w; a += 32) {
    const T* row = Gi + (size_t)b * w * w + (size_t)a * w;
    T acc = T(0);
    for (int c = 0; c < w; ++c) acc += row[c] * (rg[(size_t)b * w + c] - xtr[c]);
    g[a] = acc;
    g_out[(size_t)b * w + a] = acc;
  }
  for (int i = lane; i < bs; i += 32) xn[i] = u[(ph - 1) * bs + i];
  __syncwarp();
  // Xs still holds X_{ph-1}
  for (int i = lane; i < bs; i += 32) {
    T acc = T(0);
    for (int c = 0; c < w; ++c) acc += Xs[i * w + c] * g[c];
    xb[(ph - 1) * bs + i] = xn[i] - acc;
  }
  __syncwarp();

  // backward
  for (int k = ph - 2; k >= 0; --k) {
    load_matrix(Ms, Sb + k * mat, bs, ld, lane);
    load_matrix(Ml, Lb + k * mat, bs, ld, lane);
    for (int e = lane; e < bs * w; e += 32) Xs[e] = Xb[k * bord + e];
    __syncwarp();
    for (int j = lane; j < bs; j += 32) {  // v = L_k' xT_{k+1}
      T acc = T(0);
      for (int q = 0; q < bs; ++q) acc += Ml[q * ld + j] * xn[q];
      v[j] = acc;
    }
    __syncwarp();
    for (int i = lane; i < bs; i += 32) {
      T acc = T(0);
      for (int q = 0; q < bs; ++q) acc += Ms[i * ld + q] * v[q];
      rk[i] = u[k * bs + i] - acc;  // xT_k
    }
    __syncwarp();
    for (int i = lane; i < bs; i += 32) {
      const T xt = rk[i];
      xn[i] = xt;
      T acc = T(0);
      for (int c = 0; c < w; ++c) acc += Xs[i * w + c] * g[c];
      xb[k * bs + i] = xt - acc;
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const T* Sinv, const T* L, const T* X, const T* Gi, const T* r, const T* rg,
           T* xs, T* g, int B, int ph, int bs, int w, int warps, cudaStream_t stream) {
  if (B < 1 || ph < 1 || bs < 1 || w < 1 || warps < 1 || warps > 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * sweep_words(ph, bs, w) * sizeof(T);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      traj_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + warps - 1) / warps);
  traj_sweep_kernel<T><<<grid, 32 * warps, smem, stream>>>(Sinv, L, X, Gi, r, rg, xs, g,
                                                          B, ph, bs, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int libmpc_traj_sweep_f32(const float* Sinv, const float* L, const float* X,
                                     const float* Gi, const float* r, const float* rg,
                                     float* xs, float* g, int B, int ph, int bs, int w,
                                     int warps, void* stream) {
  return launch<float>(Sinv, L, X, Gi, r, rg, xs, g, B, ph, bs, w, warps,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int libmpc_traj_sweep_f64(const double* Sinv, const double* L, const double* X,
                                     const double* Gi, const double* r, const double* rg,
                                     double* xs, double* g, int B, int ph, int bs, int w,
                                     int warps, void* stream) {
  return launch<double>(Sinv, L, X, Gi, r, rg, xs, g, B, ph, bs, w, warps,
                        static_cast<cudaStream_t>(stream));
}
