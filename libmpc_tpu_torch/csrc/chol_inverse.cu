// Explicit inverse of a batch of small SPD matrices for Hopper (sm_90a),
// float and double.
//
// Replaces the Pallas TPU kernel
// libmpc_tpu/ops/batched_linalg.py::_chol_inv_kernel (pallas_call at
// batched_linalg.py:110): a right-looking Cholesky factorization C = L L',
// then the forward solve L Y = I and the backward solve L' X = Y, with the
// same max(d, 1e-30) guard on each pivot.
//
// What bounds it on this card: each factorization is a chain of k dependent
// steps on a few KB of data, so the cost is latency, not bytes or FLOPs.
// The TPU kernel puts 128 matrices side by side in the vector lanes; that
// layout is a TPU device and does not carry over.  Here one warp owns one
// matrix, held in shared memory with an odd row stride (k + 1) so that the
// lanes' strided row accesses hit distinct banks:
//   * factorization: at step p the lanes scale column p below the pivot,
//     then each lane updates one trailing row (lane-parallel rank-1 update);
//   * solves: each lane owns columns of the right-hand side I and runs both
//     triangular solves on them alone, reading the factor by broadcast.
// A block holds several warps (as many as fit in 48 KB) and masks the
// ragged end of the batch itself; nothing is padded.  k <= 64 (two rows or
// columns per lane at most).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 64;

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

template <typename T>
__global__ void chol_inverse_kernel(const T* __restrict__ C, T* __restrict__ out,
                                    int B, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ld = k + 1;
  T* L = reinterpret_cast<T*>(smem_raw) + (size_t)warp * 2 * k * ld;
  T* X = L + k * ld;
  const int mat = blockIdx.x * warps + warp;
  if (mat >= B) return;  // the whole warp leaves; only warp-level syncs below

  const T* Cm = C + (size_t)mat * k * k;
  for (int e = lane; e < k * k; e += 32) {
    const int r = e / k;
    L[r * ld + (e - r * k)] = Cm[e];
  }
  __syncwarp();

  // right-looking Cholesky on the lower triangle
  for (int p = 0; p < k; ++p) {
    const T d = L[p * ld + p];
    const T guard = T(1e-30);
    const T dg = d != d ? d : (d > guard ? d : guard);  // max(d, 1e-30)
    const T inv = rsqrt_t(dg);
    __syncwarp();
    for (int i = p + lane; i < k; i += 32) L[i * ld + p] *= inv;
    __syncwarp();
    for (int i = p + 1 + lane; i < k; i += 32) {
      const T li = L[i * ld + p];
      for (int j = p + 1; j <= i; ++j) L[i * ld + j] -= li * L[j * ld + p];
    }
    __syncwarp();
  }

  // X = L^-T L^-1, one right-hand-side column per lane
  for (int c = lane; c < k; c += 32) {
    // forward: L Y = I (Y is lower triangular, so rows above c stay 0)
    for (int p = 0; p < k; ++p) {
      T acc = T(0);
      for (int j = 0; j < p; ++j) acc += L[p * ld + j] * X[j * ld + c];
      X[p * ld + c] = ((p == c ? T(1) : T(0)) - acc) / L[p * ld + p];
    }
    // backward: L' X = Y, in place
    for (int p = k - 1; p >= 0; --p) {
      T acc = T(0);
      for (int j = p + 1; j < k; ++j) acc += L[j * ld + p] * X[j * ld + c];
      X[p * ld + c] = (X[p * ld + c] - acc) / L[p * ld + p];
    }
  }
  __syncwarp();

  T* Om = out + (size_t)mat * k * k;
  for (int e = lane; e < k * k; e += 32) {
    const int r = e / k;
    Om[e] = X[r * ld + (e - r * k)];
  }
}

template <typename T>
int launch(const T* C, T* out, int B, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)2 * k * (k + 1) * sizeof(T);
  int warps = (int)((48 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = per_warp * warps;
  cudaError_t err = cudaFuncSetAttribute(
      chol_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + warps - 1) / warps);
  chol_inverse_kernel<T><<<grid, 32 * warps, smem, stream>>>(C, out, B, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int libmpc_chol_inverse_f32(const float* C, float* out, int B, int k,
                                       void* stream) {
  return launch<float>(C, out, B, k, static_cast<cudaStream_t>(stream));
}

extern "C" int libmpc_chol_inverse_f64(const double* C, double* out, int B,
                                       int k, void* stream) {
  return launch<double>(C, out, B, k, static_cast<cudaStream_t>(stream));
}
