// Bordered block-tridiagonal quasi-definite factorization of a batch of
// trajectory KKT matrices for Hopper (sm_90a), float and double.
//
// Replaces the two Pallas TPU kernels of
// libmpc_tpu/ops/trajectory_sweeps.py::batched_factor (_factor_kernel,
// pallas_call at trajectory_sweeps.py:201, and _xsweep_kernel, :233).  Per
// instance, over the ph stages in order:
//   S_k = D_k - L_{k-1} S_{k-1}^-1 L_{k-1}',  Z_k = C_k - L_{k-1} S_{k-1}^-1 Z_{k-1},
//   S_k^-1 by the quasi-definite block inverse (two SPD inverses, of the
//   leading p primal slots and of the Schur complement of the n dual slots,
//   each symmetrized first and with max(d, 1e-30) pivots),
//   U_k = S_k^-1 Z_k,  Ghat = G - sum_k Z_k' U_k,
// then backward X_{ph-1} = U_{ph-1}, X_k = U_k - S_k^-1 (L_k' X_{k+1}).
// The caller inverts Ghat.
//
// What bounds it on this card.  One instance is a chain of ph dependent
// stages of about 4 bs^3 multiply-adds each on a working set of some 25 KB;
// one block of 128 threads owns one instance (eight blocks an SM at the
// oscillators' shape, 1,024 instances in one wave).  Its time is the
// latency of one instance's chain, some forty barrier phases a stage,
// stretched by what the eight blocks of an SM issue between them; device
// memory is far from its limit.  The design:
//   * every product goes through one register-tiled routine (tile_mm): a
//     thread owns a TM x TN tile of the output (up to 3 x 4) and per term
//     loads TM values of the left operand and one vector of TN of the right,
//     instead of two shared-memory words per multiply-add;
//   * matrices sit in shared memory with leading dimensions that are a
//     multiple of the vector width plus an offset (float: 4 mod 8, double:
//     2 mod 4), so rows of the right operand are aligned vector loads and the
//     few rows of the left operand a warp reads fall in distinct banks;
//     padding rows and columns are read but never stored (stores are masked),
//     so their contents do not matter;
//   * S_k and Z_k are one pass: [S_k | Z_k] -= (L S^-1) [L' | Z_{k-1}], the
//     right operand held as one matrix (L is stored transposed on load);
//   * the two SPD inverses (chol_block.cuh) pipeline a right-looking
//     factorization on one warp and the triangular inverse one pivot behind
//     it on another, one barrier a pivot, each pivot's reciprocals computed
//     a phase ahead; then S^-1 = L^-T L^-1 through the tiles;
//   * the next stage's D, C and L' (on the way back L, S^-1 and U) arrive by
//     cp.async while the current stage computes.
// The forward pass writes S_k^-1 and U_k to their outputs; the backward pass
// of the same block reads them back (visible after __syncthreads) and
// overwrites U_k by X_k.  Tensors are batch-first as PyTorch holds them; the
// grid is the batch, so a ragged batch needs no padding.

#include <cuda_runtime.h>

#include <type_traits>

#include "chol_block.cuh"

namespace {

constexpr size_t kSmemLimit = 232448;
constexpr int kMaxThreads = 256;

// leading dimension of a matrix with n columns: a multiple of the vector
// width, offset so that rows a few apart fall in distinct banks
__host__ __device__ inline int ld_of(int n, int elem) {
  return elem == 4 ? (n + 7) / 8 * 8 + 4 : (n + 3) / 4 * 4 + 2;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The shared-memory layout of one instance, in elements; the Python gate
// (ops/trajectory_sweeps.py::factor_smem_bytes) restates it.
//   Sp   S_{k-1}^-1, then S_k^-1 (bs x ldS); while the inverse is built, the
//        factor and triangular inverse of each SPD block
//   LS   L_{k-1} S_{k-1}^-1 (bs x ldS); then Ai, W = Bl Ai and S2^-1; then
//        U_k; in the backward pass X_{k+1} and L_k' X_{k+1}
//   SZ0, SZ1  [S_k | Z_k] (bs x ldZ, Z at column bsP), one per stage parity
//   LZ   [L_{k-1}' | Z_{k-1}] (bs x ldZ)
//   Gs   the border sum (w x w), then pivot scratch, then a tail that the
//        padded tiles of the last matrices may read
struct Layout {
  int bsP, ldS, ldZ, ldp, ldn, ldw;
  int sp, ls, sz0, sz1, lz, gs, total;
};

__host__ __device__ inline Layout factor_layout(int bs, int p, int w, int elem) {
  Layout o;
  const int n = bs - p;
  o.bsP = (bs + 3) / 4 * 4;
  o.ldS = ld_of(bs, elem);
  o.ldZ = ld_of(o.bsP + w, elem);
  o.ldp = ld_of(p, elem);
  o.ldn = ld_of(n, elem);
  o.ldw = ld_of(w, elem);
  const int sp = imax(bs * o.ldS, imax(2 * p * o.ldp, 3 * n * o.ldn));
  const int ls = imax(bs * o.ldS, imax(p * o.ldp + n * o.ldp + n * o.ldn, 2 * bs * o.ldw));
  o.sp = 0;
  o.ls = o.sp + sp;
  o.sz0 = o.ls + ls;
  o.sz1 = o.sz0 + bs * o.ldZ;
  o.lz = o.sz1 + bs * o.ldZ;
  o.gs = o.lz + bs * o.ldZ;
  o.total = o.gs + (w * w + 2 * imax(p, n) + 3) / 4 * 4 + 4 * o.ldZ;
  return o;
}

// load TN consecutive elements (aligned to the vector width) into b
template <typename T, int TN>
__device__ __forceinline__ void load_row(const T* p, T (&b)[TN]) {
  if constexpr (std::is_same<T, float>::value && TN == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
  } else if constexpr (std::is_same<T, float>::value && TN == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    b[0] = v.x; b[1] = v.y;
  } else if constexpr (std::is_same<T, double>::value && TN % 2 == 0) {
#pragma unroll
    for (int t = 0; t < TN; t += 2) {
      const double2 v = *reinterpret_cast<const double2*>(p + t);
      b[t] = v.x; b[t + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < TN; ++t) b[t] = p[t];
  }
}

// asynchronous copy of one element from device to shared memory (cp.async,
// which also serves L's transposed scatter); wait_all then a barrier
// publishes what the block copied
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

using libmpc::for_each_rc;

// C = beta Cin + alpha A B over M x N outputs and K terms, by all threads of
// the block.  A(i, q) is A[i lda + q], or A[q lda + i] when TA; B(q, j) is
// B[q ldb + j], TN of them one vector load (B and ldb aligned to it), or
// B[j ldb + q] when TB.  Cin may be C itself, or null (beta ignored).  When
// tri, A and B are lower triangular in (q, i) and (q, j) (A(i, q) = 0 for
// q < i, B(q, j) = 0 for q < j) and the sum starts at max(i, j) of the tile.
// C2 (optional) takes the transpose, G (optional, device memory) a copy.
// Each thread owns TM x TN outputs; tiles are dealt out row-major.
template <typename T, int TM, int TN, bool TA, bool TB>
__device__ __forceinline__ void tile_mm(int M, int N, int K, const T* A, int lda,
                                        const T* B, int ldb, T* C, int ldc,
                                        const T* Cin, int ldcin, T beta, T alpha,
                                        bool tri, T* C2, int ldc2, T* G, int ldg,
                                        int tid, int nt) {
  const int nrt = (M + TM - 1) / TM, nct = (N + TN - 1) / TN;
  for (int t = tid; t < nrt * nct; t += nt) {
    const int rt = t / nct, ct = t - rt * nct;
    const int i0 = rt * TM, j0 = ct * TN;
    T acc[TM][TN];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[m][c] = T(0);
    const int q0 = tri ? imax(i0, j0) : 0;
#pragma unroll 4
    for (int q = q0; q < K; ++q) {
      T a[TM], b[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = TA ? A[q * lda + i0 + m] : A[(i0 + m) * lda + q];
      if constexpr (TB) {
#pragma unroll
        for (int c = 0; c < TN; ++c) b[c] = B[(j0 + c) * ldb + q];
      } else {
        load_row<T, TN>(B + q * ldb + j0, b);
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[m][c] = fma(a[m], b[c], acc[m][c]);
    }
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int i = i0 + m;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int j = j0 + c;
        if (i < M && j < N) {
          T v = alpha == T(-1) ? -acc[m][c] : alpha * acc[m][c];
          if (Cin) v = (beta == T(-1) ? -Cin[i * ldcin + j] : beta * Cin[i * ldcin + j]) + v;
          C[i * ldc + j] = v;
          if (C2) C2[j * ldc2 + i] = v;
          if (G) G[(size_t)i * ldg + j] = v;
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 4)
traj_factor_kernel(const T* __restrict__ D, const T* __restrict__ L,
                   const T* __restrict__ C, const T* __restrict__ G, T* Sinv, T* X,
                   T* __restrict__ Ghat, int ph, int bs, int p, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = bs - p;
  const Layout o = factor_layout(bs, p, w, (int)sizeof(T));
  const int bsP = o.bsP, ldS = o.ldS, ldZ = o.ldZ, ldp = o.ldp, ldn = o.ldn, ldw = o.ldw;

  T* Sp = sm + o.sp;
  T* LS = sm + o.ls;
  T* SZb[2] = {sm + o.sz0, sm + o.sz1};
  T* LZ = sm + o.lz;
  T* Gs = sm + o.gs;
  T* piv = Gs + w * w;  // pivot reciprocals of the Cholesky factors
  // the quasi-definite inverse's workspaces
  // (the Cholesky routine's matrices take odd leading dimensions, within
  // the room of ldp and ldn)
  const int ldm1 = p | 1, ldm2 = n | 1;
  T* M1 = Sp;                // primal block, factored in place (p x ldm1)
  T* Y1 = Sp + p * ldp;      // its factor's inverse, transposed (p x ldm1)
  T* T2 = Sp;                // C + W Bl', not yet symmetric (n x ldn)
  T* M2 = Sp + n * ldn;      // dual Schur complement (n x ldm2)
  T* Y2 = M2 + n * ldn;      // its factor's inverse, transposed (n x ldm2)
  T* Ai = LS;                // primal block's inverse (p x ldp)
  T* W = Ai + p * ldp;       // Bl Ai (n x ldp)
  T* S2i = W + n * ldp;      // dual Schur complement's inverse (n x ldn)
  T* U = LS;                 // U_k (bs x ldw)

  const size_t mat = (size_t)bs * bs, bord = (size_t)bs * w;
  const T* Db = D + (size_t)b * ph * mat;
  const T* Lb = L + (size_t)b * (ph - 1) * mat;
  const T* Cb = C + (size_t)b * ph * bord;
  T* Sb = Sinv + (size_t)b * ph * mat;
  T* Xb = X + (size_t)b * ph * bord;

  // prefetches: D_k and C_k into [S | Z] of buffer SZ, L_k transposed into LZ
  auto load_dc = [&](int k, T* SZ) {
    const T* Dk = Db + k * mat;
    const T* Ck = Cb + k * bord;
    for_each_rc(bs, bs, tid, nt, [&](int r, int c, int e) { copy_async(SZ + r * ldZ + c, Dk + e); });
    for_each_rc(bs, w, tid, nt,
                [&](int r, int c, int e) { copy_async(SZ + r * ldZ + bsP + c, Ck + e); });
  };
  auto load_lt = [&](int k) {
    const T* Lk = Lb + k * mat;
    for_each_rc(bs, bs, tid, nt, [&](int r, int c, int e) { copy_async(LZ + c * ldZ + r, Lk + e); });
  };

  for (int e = tid; e < w * w; e += nt) Gs[e] = G[(size_t)b * w * w + e];
  load_dc(0, SZb[0]);

  for (int k = 0; k < ph; ++k) {
    T* SZ = SZb[k & 1];
    copy_async_wait();  // D_k, C_k and L_{k-1}'
    __syncthreads();
    if (k + 1 < ph) load_dc(k + 1, SZb[(k + 1) & 1]);

    if (k > 0) {
      // LS = L_{k-1} S_{k-1}^-1 (L from its transpose in LZ)
      tile_mm<T, 2, 4, true, false>(bs, bs, bs, LZ, ldZ, Sp, ldS, LS, ldS, nullptr, 0,
                                          T(0), T(1), false, nullptr, 0, nullptr, 0, tid, nt);
      __syncthreads();
      // [S_k | Z_k] -= LS [L_{k-1}' | Z_{k-1}]
      tile_mm<T, 3, 4, false, false>(bs, bsP + w, bs, LS, ldS, LZ, ldZ, SZ, ldZ, SZ, ldZ,
                                           T(1), T(-1), false, nullptr, 0, nullptr, 0, tid, nt);
      __syncthreads();
    }
    const T* Sk = SZ;
    const T* Zk = SZ + bsP;

    // Z_k to LZ for the next stage, L_k' into LZ, the primal block symmetrized
    for_each_rc(bs, w, tid, nt,
                [&](int r, int c, int) { LZ[r * ldZ + bsP + c] = Zk[r * ldZ + c]; });
    if (k + 1 < ph) load_lt(k);
    for_each_rc(p, p, tid, nt, [&](int i, int j, int) {
      M1[i * ldm1 + j] = T(0.5) * (Sk[i * ldZ + j] + Sk[j * ldZ + i]);
    });
    __syncthreads();
    libmpc::block_chol_lower_inverse(M1, ldm1, Y1, ldm1, piv, p, tid, nt);
    // Ai = Y1 Y1' (Y1 is upper triangular)
    tile_mm<T, 2, 2, false, true>(p, p, p, Y1, ldm1, Y1, ldm1, Ai, ldp, nullptr, 0, T(0),
                                         T(1), true, nullptr, 0, nullptr, 0, tid, nt);
    __syncthreads();
    // W = Bl Ai
    tile_mm<T, 1, 2, false, false>(n, p, p, Sk + p * ldZ, ldZ, Ai, ldp, W, ldp, nullptr, 0,
                                         T(0), T(1), false, nullptr, 0, nullptr, 0, tid, nt);
    __syncthreads();
    // T2 = -C22 + W Bl'
    tile_mm<T, 1, 2, false, true>(n, n, p, W, ldp, Sk + p * ldZ, ldZ, T2, ldn,
                                         Sk + p * ldZ + p, ldZ, T(-1), T(1), false, nullptr, 0,
                                         nullptr, 0, tid, nt);
    __syncthreads();
    for_each_rc(n, n, tid, nt, [&](int r, int c, int) {
      M2[r * ldm2 + c] = T(0.5) * (T2[r * ldn + c] + T2[c * ldn + r]);
    });
    __syncthreads();
    libmpc::block_chol_lower_inverse(M2, ldm2, Y2, ldm2, piv, n, tid, nt);
    tile_mm<T, 1, 2, false, true>(n, n, n, Y2, ldm2, Y2, ldm2, S2i, ldn, nullptr, 0, T(0),
                                         T(1), true, nullptr, 0, nullptr, 0, tid, nt);
    __syncthreads();
    // TR = W' S2i into S^-1's upper right block and, transposed, its lower left;
    // -S2i into its lower right
    tile_mm<T, 1, 2, true, false>(p, n, n, W, ldp, S2i, ldn, Sp + p, ldS, nullptr, 0,
                                        T(0), T(1), false, Sp + p * ldS, ldS, nullptr, 0, tid, nt);
    for_each_rc(n, n, tid, nt,
                [&](int r, int c, int) { Sp[(p + r) * ldS + p + c] = -S2i[r * ldn + c]; });
    __syncthreads();
    // TL = Ai - TR W into the upper left block
    tile_mm<T, 2, 2, false, false>(p, p, n, Sp + p, ldS, W, ldp, Sp, ldS, Ai, ldp, T(1),
                                         T(-1), false, nullptr, 0, nullptr, 0, tid, nt);
    __syncthreads();
    T* Sbk = Sb + k * mat;
    for_each_rc(bs, bs, tid, nt, [&](int r, int c, int e) { Sbk[e] = Sp[r * ldS + c]; });
    // U_k = S_k^-1 Z_k, to U and to X
    tile_mm<T, 1, 2, false, false>(bs, w, bs, Sp, ldS, Zk, ldZ, U, ldw, nullptr, 0, T(0),
                                         T(1), false, nullptr, 0, Xb + k * bord, w, tid, nt);
    __syncthreads();
    // Ghat -= Z_k' U_k
    tile_mm<T, 1, 2, true, false>(w, w, bs, Zk, ldZ, U, ldw, Gs, w, Gs, w, T(1), T(-1),
                                        false, nullptr, 0, nullptr, 0, tid, nt);
  }
  __syncthreads();
  for (int e = tid; e < w * w; e += nt) Ghat[(size_t)b * w * w + e] = Gs[e];

  // backward sweep: Xn holds X_{k+1} (U_{ph-1} = X_{ph-1} is already out);
  // L_k, S_k^-1 and U_k are read back from device memory one stage ahead,
  // into two buffer sets: [L_k | U_k] in SZ0 or SZ1, S_k^-1 in LZ or Sp
  T* Xn = U;
  T* Tk = U + bs * ldw;  // L_k' X_{k+1}
  T* LU[2] = {SZb[0], SZb[1]};
  T* Sk[2] = {LZ, Sp};
  const int ldSk[2] = {ldZ, ldS};
  auto load_back = [&](int k, int s) {
    const T* Lg = Lb + k * mat;
    const T* Sg = Sb + k * mat;
    const T* Ug = Xb + k * bord;
    T* lu = LU[s];
    T* sk = Sk[s];
    const int ld = ldSk[s];
    for_each_rc(bs, bs, tid, nt, [&](int r, int c, int e) {
      copy_async(lu + r * ldZ + c, Lg + e);
      copy_async(sk + r * ld + c, Sg + e);
    });
    for_each_rc(bs, w, tid, nt, [&](int r, int c, int e) { copy_async(lu + r * ldZ + bsP + c, Ug + e); });
  };
  if (ph >= 2) load_back(ph - 2, 0);
  for (int k = ph - 2; k >= 0; --k) {
    const int s = (ph - 2 - k) & 1;
    copy_async_wait();
    __syncthreads();
    if (k >= 1) load_back(k - 1, s ^ 1);
    tile_mm<T, 1, 2, true, false>(bs, w, bs, LU[s], ldZ, Xn, ldw, Tk, ldw, nullptr, 0, T(0),
                                        T(1), false, nullptr, 0, nullptr, 0, tid, nt);
    __syncthreads();
    tile_mm<T, 1, 2, false, false>(bs, w, bs, Sk[s], ldSk[s], Tk, ldw, Xn, ldw,
                                         LU[s] + bsP, ldZ, T(1), T(-1), false, nullptr, 0,
                                         Xb + k * bord, w, tid, nt);
  }
}

template <typename T>
int launch(const T* D, const T* L, const T* C, const T* G, T* Sinv, T* X, T* Ghat,
           int B, int ph, int bs, int bs_p, int w, int threads, cudaStream_t stream) {
  if (B < 1 || ph < 1 || bs_p < 1 || bs_p >= bs || w < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)factor_layout(bs, bs_p, w, (int)sizeof(T)).total * sizeof(T);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      traj_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  traj_factor_kernel<T><<<B, threads, smem, stream>>>(D, L, C, G, Sinv, X, Ghat, ph, bs,
                                                      bs_p, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int libmpc_traj_factor_f32(const float* D, const float* L, const float* C,
                                      const float* G, float* Sinv, float* X,
                                      float* Ghat, int B, int ph, int bs, int bs_p,
                                      int w, int threads, void* stream) {
  return launch<float>(D, L, C, G, Sinv, X, Ghat, B, ph, bs, bs_p, w, threads,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int libmpc_traj_factor_f64(const double* D, const double* L, const double* C,
                                      const double* G, double* Sinv, double* X,
                                      double* Ghat, int B, int ph, int bs, int bs_p,
                                      int w, int threads, void* stream) {
  return launch<double>(D, L, C, G, Sinv, X, Ghat, B, ph, bs, bs_p, w, threads,
                        static_cast<cudaStream_t>(stream));
}
