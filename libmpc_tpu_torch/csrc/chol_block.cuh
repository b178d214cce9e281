// Cholesky factorization and triangular inverse of one small SPD matrix in
// shared memory by all threads of a block.  Used by traj_factor.cu, where
// the two SPD inverses of every stage's quasi-definite pivot lie on the
// chain of dependent stages; the formulation is the JAX package's own
// value-level kernel (libmpc_tpu/ops/trajectory_sweeps.py::_chol_inv_vals).
#pragma once

#include <cuda_runtime.h>

#include "chol_warp.cuh"

namespace libmpc {

// f(r, c, e) for e = r cols + c over rows x cols, dealt out to the block's
// threads; row and column advance by constant steps, so the loop divides no
// index and a thread meets the same entries on every call
template <typename F>
__device__ __forceinline__ void for_each_rc(int rows, int cols, int tid, int nt, F f) {
  const int dr = nt / cols, dc = nt - dr * cols;
  int r = tid / cols, c = tid - r * cols;
  for (int e = tid; e < rows * cols; e += nt) {
    f(r, c, e);
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Two warps of the block factor the k x k matrix whose lower triangle is in
// M (leading dimension ldm, best odd) as L L' and write Yt = (L^-1)' (k x k,
// leading dimension ldy, best odd; zeros below the diagonal); the inverse of
// the matrix is then Yt Yt', which the caller forms.  Each pivot is floored
// as max(d, 1e-30), as in chol_warp.cuh; a NaN pivot stays NaN.  M's strict
// upper triangle receives L'; piv (2 k values) the scratch of
// 1 / sqrt(max(d, 1e-30)) and 1 / L(j, j) per pivot.  The caller has
// synchronised the block after filling M; the block is synchronised on
// return.  k + 1 barrier phases, in each:
//   * warp 0, factorization step j (right-looking): lane r takes row r of
//     the trailing triangle and its rank-1 update, and writes L(r, j) to
//     row j of the upper triangle (nothing in that phase reads it); the lane
//     of row j + 1 computes the next pivot's reciprocals as soon as it has
//     updated it, so no phase waits on a square root or a division;
//   * warp 1 (warp 0 if the block has one), the triangular inverse one pivot
//     behind: rows below i take L(r, i) Y(i, :) / L(i, i), lane r row r, and
//     a row is scaled by 1 / L(i, i) once nothing reads it any more.
// The other warps wait at the barriers.  A phase's loads are issued four
// columns at a time before its stores.
template <typename T>
__device__ void block_chol_lower_inverse(T* M, int ldm, T* Yt, int ldy, T* piv, int k,
                                         int tid, int nt) {
  T* pinv = piv;     // 1 / sqrt(max(d_j, 1e-30))
  T* rdg = piv + k;  // 1 / L(j, j)
  const T guard = T(1e-30);
  const int warp = tid / 32, lane = tid % 32;
  const int sweeper = nt > 32 ? 1 : 0;
  for_each_rc(k, k, tid, nt, [&](int r, int c, int) { Yt[r * ldy + c] = r == c ? T(1) : T(0); });
  if (tid == 0) {
    const T d = M[0];
    const T pi = rsqrt_t(d != d ? d : (d > guard ? d : guard));  // max(d, 1e-30)
    pinv[0] = pi;
    rdg[0] = T(1) / (d * pi);
  }
  __syncthreads();
  for (int j = 0; j <= k; ++j) {
    if (warp == 0 && j < k) {
      const T inv = pinv[j];
      for (int r = j + 1 + lane; r < k; r += 32) {
        T* row = M + r * ldm;
        const T lr = row[j] * inv;
        M[j * ldm + r] = lr;
        for (int c = j + 1; c <= r; c += 4) {
          T lc[4], v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c + u <= r) {
              lc[u] = M[(c + u) * ldm + j];
              v[u] = row[c + u];
            }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c + u <= r) row[c + u] = v[u] - lr * (lc[u] * inv);
        }
        if (r == j + 1) {  // the next pivot, just updated by this lane
          const T v = row[r];
          const T pi = rsqrt_t(v != v ? v : (v > guard ? v : guard));
          pinv[r] = pi;
          rdg[r] = T(1) / (v * pi);
        }
      }
    }
    if (warp == sweeper && j >= 1) {
      const int i = j - 1;  // sweep step i: L(:, i) and rdg[i] are final
      const T ri = rdg[i];
      for (int r = i + 1 + lane; r < k; r += 32) {
        const T l = M[i * ldm + r];  // L(r, i)
        for (int c = 0; c <= i; c += 4) {
          T yi[4], v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c + u <= i) {
              yi[u] = Yt[(c + u) * ldy + i];
              v[u] = Yt[(c + u) * ldy + r];
            }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c + u <= i) Yt[(c + u) * ldy + r] = v[u] - l * (yi[u] * ri);
        }
      }
      // row j-2 of Y was last read at step j-2; at the end rows k-2 and k-1
      const int lo = j - 2 >= 0 ? j - 2 : 0, hi = j == k ? k - 1 : j - 2;
      for (int r = lo; r <= hi; ++r) {
        const T sc = rdg[r];
        for (int c = lane; c <= r; c += 32) Yt[c * ldy + r] *= sc;
      }
    }
    __syncthreads();
  }
}

}  // namespace libmpc
