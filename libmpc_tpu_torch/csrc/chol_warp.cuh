// Warp-level Cholesky factorization and explicit inverse of one small SPD
// matrix held in shared memory.  Shared by chol_inverse.cu (a batch of bare
// matrices) and qp_inner.cu (the KKT matrix of each small QP).
#pragma once

#include <cuda_runtime.h>

namespace libmpc {

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

// One warp factors the k x k matrix in L (leading dimension ld; only the
// lower triangle is read) in place as L L' and writes X = (L L')^-1 (full,
// leading dimension ld).  Each pivot is floored as max(d, 1e-30), like the
// Pallas kernels this replaces; a NaN pivot stays NaN.  The caller has
// synchronised the warp after filling L; the warp is synchronised on return.
//   * factorization: at step p the lanes scale column p below the pivot,
//     then each lane updates one trailing row (lane-parallel rank-1 update);
//   * solves: each lane owns columns of the right-hand side I and runs both
//     triangular solves on them alone, reading the factor by broadcast.
template <typename T>
__device__ void warp_chol_inverse(T* L, T* X, int k, int ld, int lane) {
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
}

}  // namespace libmpc
