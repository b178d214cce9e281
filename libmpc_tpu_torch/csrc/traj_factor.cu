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
// What bounds it on this card: about 4 bs^3 multiply-adds per stage on a
// working set of some 25 KB, ph stages one after the other; its bytes and its
// operations take about the same time at the card's peaks, and one instance
// alone is a latency chain.  The TPU kernel puts 128 instances in the vector
// lanes and steps a grid over (tile, stage) with scratch carried between grid
// steps; that is a TPU device.  Here one block owns one instance and loops
// over the stages itself: the stage's matrices sit in shared memory with odd
// leading dimensions (rows and columns both read without bank conflicts),
// every thread computes entries of the matrix products, and warp 0 runs the
// two Cholesky inverses (chol_warp.cuh).  The forward pass writes S_k^-1 and
// U_k to their outputs; the backward pass of the same block reads them back
// (visible after __syncthreads) and overwrites U_k by X_k.  Tensors are
// batch-first as PyTorch holds them; the grid is the batch, so a ragged batch
// needs no padding.

#include <cuda_runtime.h>

#include "chol_warp.cuh"

namespace {

constexpr size_t kSmemLimit = 232448;

// shared-memory words of one instance; the Python gate
// (ops/trajectory_sweeps.py::factor_smem_bytes) restates this sum
__host__ __device__ inline size_t factor_words(int bs, int p, int w) {
  const int n = bs - p;
  const int ld = bs | 1, ldp = p | 1, ldn = n | 1;
  return (size_t)4 * bs * ld + (size_t)3 * bs * w + (size_t)2 * p * ldp +
         (size_t)n * ldp + (size_t)2 * n * ldn + (size_t)p * ldn + (size_t)w * w;
}

template <typename T>
__global__ void traj_factor_kernel(const T* __restrict__ D, const T* __restrict__ L,
                                   const T* __restrict__ C, const T* __restrict__ G,
                                   T* Sinv, T* X, T* __restrict__ Ghat,
                                   int ph, int bs, int p, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32;
  const int n = bs - p;
  const int ld = bs | 1, ldp = p | 1, ldn = n | 1;

  T* Sp = reinterpret_cast<T*>(smem_raw);  // S_{k-1}^-1, then S_k^-1
  T* Sk = Sp + bs * ld;                    // S_k
  T* Lk = Sk + bs * ld;                    // L_{k-1}
  T* LS = Lk + bs * ld;                    // L_{k-1} S_{k-1}^-1
  T* Zp = LS + bs * ld;                    // Z_{k-1}   (bs, w)
  T* Zk = Zp + bs * w;                     // Z_k
  T* Uk = Zk + bs * w;                     // U_k
  T* Aw = Uk + bs * w;                     // primal block, factored in place
  T* Ai = Aw + p * ldp;                    // its inverse
  T* W = Ai + p * ldp;                     // Bl Ai            (n, p)
  T* S2 = W + n * ldp;                     // dual Schur complement (n, n)
  T* S2i = S2 + n * ldn;                   // its inverse
  T* TR = S2i + n * ldn;                   // W' S2i           (p, n)
  T* Gs = TR + p * ldn;                    // border sum       (w, w)

  const size_t mat = (size_t)bs * bs, bord = (size_t)bs * w;
  const T* Db = D + (size_t)b * ph * mat;
  const T* Lb = L + (size_t)b * (ph - 1) * mat;
  const T* Cb = C + (size_t)b * ph * bord;
  T* Sb = Sinv + (size_t)b * ph * mat;
  T* Xb = X + (size_t)b * ph * bord;

  for (int e = tid; e < w * w; e += nt) Gs[e] = G[(size_t)b * w * w + e];

  for (int k = 0; k < ph; ++k) {
    for (int e = tid; e < bs * bs; e += nt) {
      const int r = e / bs, c = e - r * bs;
      Sk[r * ld + c] = Db[k * mat + e];
      if (k > 0) Lk[r * ld + c] = Lb[(k - 1) * mat + e];
    }
    for (int e = tid; e < bs * w; e += nt) Zk[e] = Cb[k * bord + e];
    __syncthreads();

    if (k > 0) {
      for (int e = tid; e < bs * bs; e += nt) {
        const int i = e / bs, j = e - i * bs;
        T acc = T(0);
        for (int q = 0; q < bs; ++q) acc += Lk[i * ld + q] * Sp[q * ld + j];
        LS[i * ld + j] = acc;
      }
      __syncthreads();
      for (int e = tid; e < bs * bs; e += nt) {
        const int i = e / bs, j = e - i * bs;
        T acc = T(0);
        for (int q = 0; q < bs; ++q) acc += LS[i * ld + q] * Lk[j * ld + q];
        Sk[i * ld + j] -= acc;
      }
      for (int e = tid; e < bs * w; e += nt) {
        const int i = e / w, c = e - i * w;
        T acc = T(0);
        for (int q = 0; q < bs; ++q) acc += LS[i * ld + q] * Zp[q * w + c];
        Zk[e] -= acc;
      }
      __syncthreads();
    }

    // quasi-definite inverse of S_k into Sp
    for (int e = tid; e < p * p; e += nt) {
      const int i = e / p, j = e - i * p;
      Aw[i * ldp + j] = T(0.5) * (Sk[i * ld + j] + Sk[j * ld + i]);
    }
    __syncthreads();
    if (tid < 32) libmpc::warp_chol_inverse(Aw, Ai, p, ldp, lane);
    __syncthreads();
    for (int e = tid; e < n * p; e += nt) {  // W = Bl Ai
      const int r = e / p, j = e - r * p;
      T acc = T(0);
      for (int q = 0; q < p; ++q) acc += Sk[(p + r) * ld + q] * Ai[q * ldp + j];
      W[r * ldp + j] = acc;
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += nt) {  // C + W Bl', not yet symmetric
      const int r = e / n, c = e - r * n;
      T acc = T(0);
      for (int q = 0; q < p; ++q) acc += W[r * ldp + q] * Sk[(p + c) * ld + q];
      S2i[r * ldn + c] = -Sk[(p + r) * ld + (p + c)] + acc;
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += nt) {
      const int r = e / n, c = e - r * n;
      S2[r * ldn + c] = T(0.5) * (S2i[r * ldn + c] + S2i[c * ldn + r]);
    }
    __syncthreads();
    if (tid < 32) libmpc::warp_chol_inverse(S2, S2i, n, ldn, lane);
    __syncthreads();
    for (int e = tid; e < p * n; e += nt) {  // TR = W' S2i
      const int i = e / n, c = e - i * n;
      T acc = T(0);
      for (int q = 0; q < n; ++q) acc += W[q * ldp + i] * S2i[q * ldn + c];
      TR[i * ldn + c] = acc;
    }
    __syncthreads();
    for (int e = tid; e < bs * bs; e += nt) {  // [[Ai - TR W, TR], [TR', -S2i]]
      const int i = e / bs, j = e - i * bs;
      T v;
      if (i < p && j < p) {
        T acc = T(0);
        for (int q = 0; q < n; ++q) acc += TR[i * ldn + q] * W[q * ldp + j];
        v = Ai[i * ldp + j] - acc;
      } else if (i < p) {
        v = TR[i * ldn + (j - p)];
      } else if (j < p) {
        v = TR[j * ldn + (i - p)];
      } else {
        v = -S2i[(i - p) * ldn + (j - p)];
      }
      Sp[i * ld + j] = v;
      Sb[k * mat + e] = v;
    }
    __syncthreads();
    for (int e = tid; e < bs * w; e += nt) {  // U_k = S_k^-1 Z_k
      const int i = e / w, c = e - i * w;
      T acc = T(0);
      for (int q = 0; q < bs; ++q) acc += Sp[i * ld + q] * Zk[q * w + c];
      Uk[e] = acc;
      Xb[k * bord + e] = acc;
    }
    __syncthreads();
    for (int e = tid; e < w * w; e += nt) {  // Ghat -= Z_k' U_k
      const int a = e / w, c = e - a * w;
      T acc = T(0);
      for (int q = 0; q < bs; ++q) acc += Zk[q * w + a] * Uk[q * w + c];
      Gs[e] -= acc;
    }
    T* swap = Zp;
    Zp = Zk;
    Zk = swap;
    __syncthreads();
  }

  for (int e = tid; e < w * w; e += nt) Ghat[(size_t)b * w * w + e] = Gs[e];

  // backward sweep: Uk holds X_{k+1} (U_{ph-1} = X_{ph-1} is already out)
  T* Xn = Uk;
  T* Tk = Zk;  // L_k' X_{k+1}
  T* Xc = Zp;  // U_k, then X_k
  for (int k = ph - 2; k >= 0; --k) {
    for (int e = tid; e < bs * bs; e += nt) {
      const int r = e / bs, c = e - r * bs;
      Lk[r * ld + c] = Lb[k * mat + e];
      Sk[r * ld + c] = Sb[k * mat + e];
    }
    for (int e = tid; e < bs * w; e += nt) Xc[e] = Xb[k * bord + e];
    __syncthreads();
    for (int e = tid; e < bs * w; e += nt) {
      const int j = e / w, c = e - j * w;
      T acc = T(0);
      for (int q = 0; q < bs; ++q) acc += Lk[q * ld + j] * Xn[q * w + c];
      Tk[e] = acc;
    }
    __syncthreads();
    for (int e = tid; e < bs * w; e += nt) {
      const int i = e / w, c = e - i * w;
      T acc = T(0);
      for (int q = 0; q < bs; ++q) acc += Sk[i * ld + q] * Tk[q * w + c];
      const T v = Xc[e] - acc;
      Xc[e] = v;
      Xb[k * bord + e] = v;
    }
    T* swap = Xn;
    Xn = Xc;
    Xc = swap;
    __syncthreads();
  }
}

template <typename T>
int launch(const T* D, const T* L, const T* C, const T* G, T* Sinv, T* X, T* Ghat,
           int B, int ph, int bs, int bs_p, int w, int threads, cudaStream_t stream) {
  if (B < 1 || ph < 1 || bs_p < 1 || bs_p >= bs || w < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = factor_words(bs, bs_p, w) * sizeof(T);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      traj_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  traj_factor_kernel<T><<<B, threads, smem, stream>>>(D, L, C, G, Sinv, X, Ghat, ph,
                                                      bs, bs_p, w);
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
