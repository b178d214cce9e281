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
// What bounds it on this card.  Two operations per word read, so bytes: S^-1,
// L and X, read once forward and once backward (324 KB an instance in
// float32 at ph=20, bs=30, w=8; 332 MB at B=1024, 0.099 ms at 3.35 TB/s,
// against 0.050 ms for each byte read once).  One instance is a chain of
// 2 ph - 1 dependent steps, so the card is filled by many instances at
// once, each with its next stage already on the way.  The kernel before this
// design loaded each stage synchronously, element by element with an
// integer division, then computed: it ran at a sixth of the memory rate,
// bound by load latency.  The design:
//   * one warp owns one instance, on its own slice of shared memory with
//     warp-level synchronisation only; one instance a block (19,040 bytes
//     in float32, eleven an SM; 38,048 in float64, five an SM);
//   * each step's S_k^-1, L and X_k sit contiguous in one of two stage
//     buffers; while step s computes, step s+1's buffer fills by cp.async,
//     in runs of 16-byte chunks, or 8 or 4 bytes where the launch finds a
//     base pointer or a stride that is not 16-byte aligned.  The steps run
//     forward k = 0..ph-1, then backward k = ph-2..0, through one pipeline;
//   * r is loaded whole at the start and r_k is replaced by u_k in place;
//     the border solve reads Ghat^-1 and r_g from device memory, and the
//     backward pass writes x_k straight out;
//   * lane i computes row i of a product.  Row products (S^-1 v, L u) read
//     their rows two elements a load (float2, double2), which at an even
//     row length of 2 mod 4 words (bs = 30) keeps each phase of the load on
//     distinct banks of the unpadded layout; transposed products (X' r,
//     L' xT) read by columns, consecutive across lanes; X g starts each row
//     at its own column, rotated, so that rows which begin on one bank do
//     not collide.  S^-1 is read as stored (it is not bitwise symmetric).
// Measured on an NVIDIA H100 80GB HBM3 (700 W) at B=1024, ph=20, bs=30, w=8
// (chip_smoke.py --phases k5): float32 0.119 ms (0.549 before), float64
// 0.233 ms (0.477 before); 2.8 TB/s of the bytes with the re-read.  One
// instance an SM alone (B=132) takes 0.074 ms: the chain, 1.9 us a step.
// A third stage buffer, scalar row reads and 2, 4 or 8 instances a block
// each changed the time by 3 % or less (PERF.md).
// Tensors are batch-first as PyTorch holds them; a warp past the end of a
// ragged batch leaves at once.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr size_t kSmemLimit = 232448;
constexpr int kMaxWarps = 8;
constexpr int kStages = 2;  // stage buffers of the ring

__host__ __device__ inline int round16(int n, int elem) {
  const int a = 16 / elem;
  return (n + a - 1) / a * a;
}

// The shared-memory layout of one instance, in elements, every piece on a
// 16-byte boundary; the Python gate (ops/trajectory_sweeps.py::
// sweep_smem_bytes) restates it.
//   kStages stage buffers: S^-1 (bs x bs) at 0, L (bs x bs) at l, X (bs x w) at x
//   U    r_0 .. r_{ph-1}, each r_k replaced by u_k in the forward pass
//   V    work vector (bs);  XN  xT_{k+1} (bs);  XTR  sum X_k' r_k (w);  G  g (w)
struct Layout {
  int l, x, stage, u, v, xn, xtr, g, total;
};

__host__ __device__ inline Layout sweep_layout(int ph, int bs, int w, int elem) {
  Layout o;
  const int mat = round16(bs * bs, elem);
  o.l = mat;
  o.x = 2 * mat;
  o.stage = 2 * mat + round16(bs * w, elem);
  o.u = kStages * o.stage;
  o.v = o.u + round16(ph * bs, elem);
  o.xn = o.v + round16(bs, elem);
  o.xtr = o.xn + round16(bs, elem);
  o.g = o.xtr + round16(w, elem);
  o.total = o.g + round16(w, elem);
  return o;
}

// asynchronous copy of `bytes` from device to shared memory in chunks of cw
// bytes (16, 8 or 4; both ends and bytes multiples of cw), spread over the lanes
__device__ __forceinline__ void copy_run(void* dst, const void* src, int bytes, int cw,
                                         int lane) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const char* s = static_cast<const char*>(src);
  if (cw == 16) {
    for (int o = lane * 16; o < bytes; o += 32 * 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + o), "l"(s + o)
                   : "memory");
  } else if (cw == 8) {
    for (int o = lane * 8; o < bytes; o += 32 * 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d + o), "l"(s + o)
                   : "memory");
  } else {
    for (int o = lane * 4; o < bytes; o += 32 * 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + o), "l"(s + o)
                   : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest N has landed (this lane's copies; a
// __syncwarp after it publishes the warp's)
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// sum_q M[i bs + q] x[q]: a row of the unpadded bs x bs matrix M, two
// elements a load where bs is even (rows and x then aligned to the pair)
template <typename T>
__device__ __forceinline__ T row_dot(const T* M, const T* x, int i, int bs) {
  const T* row = M + i * bs;
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  if ((bs & 1) == 0) {
    using V2 = typename Vec2<T>::type;
    const V2* r2 = reinterpret_cast<const V2*>(row);
    const V2* x2 = reinterpret_cast<const V2*>(x);
    const int n2 = bs >> 1;
    int q = 0;
    for (; q + 1 < n2; q += 2) {
      const V2 m0 = r2[q], m1 = r2[q + 1], y0 = x2[q], y1 = x2[q + 1];
      a0 = fma(m0.x, y0.x, a0);
      a1 = fma(m0.y, y0.y, a1);
      a2 = fma(m1.x, y1.x, a2);
      a3 = fma(m1.y, y1.y, a3);
    }
    if (q < n2) {
      const V2 m0 = r2[q], y0 = x2[q];
      a0 = fma(m0.x, y0.x, a0);
      a1 = fma(m0.y, y0.y, a1);
    }
  } else {
    int q = 0;
    for (; q + 1 < bs; q += 2) {
      a0 = fma(row[q], x[q], a0);
      a1 = fma(row[q + 1], x[q + 1], a1);
    }
    if (q < bs) a2 = row[q] * x[q];
  }
  return (a0 + a2) + (a1 + a3);
}

// sum_q M[q ld + j] x[q] over `rows` rows: a column, consecutive across lanes
template <typename T>
__device__ __forceinline__ T col_dot(const T* M, const T* x, int j, int rows, int ld) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int q = 0;
  for (; q + 3 < rows; q += 4) {
    a0 = fma(M[q * ld + j], x[q], a0);
    a1 = fma(M[(q + 1) * ld + j], x[q + 1], a1);
    a2 = fma(M[(q + 2) * ld + j], x[q + 2], a2);
    a3 = fma(M[(q + 3) * ld + j], x[q + 3], a3);
  }
  for (; q < rows; ++q) a0 = fma(M[q * ld + j], x[q], a0);
  return (a0 + a1) + (a2 + a3);
}

// sum_c X[i w + c] g[c], row i starting at column (i w / 32) mod w in
// 4-byte words, so that lanes whose rows begin on one bank read different
// columns
template <typename T>
__device__ __forceinline__ T xg_dot(const T* X, const T* g, int i, int w) {
  const T* row = X + i * w;
  int c = (i * w * (int)(sizeof(T) / 4) / 32) % w;
  T a0 = T(0), a1 = T(0);
  int t = 0;
  for (; t + 1 < w; t += 2) {
    a0 = fma(row[c], g[c], a0);
    if (++c == w) c = 0;
    a1 = fma(row[c], g[c], a1);
    if (++c == w) c = 0;
  }
  if (t < w) a0 = fma(row[c], g[c], a0);
  return a0 + a1;
}

// 128 registers a thread: left to choose, ptxas took 64 and spilled (296
// bytes in float64), 15 % slower in float64 and 2 % in float32
// (chip_smoke.py --phases k5 on an H100)
template <typename T>
__global__ void __maxnreg__(128)
traj_sweep_kernel(const T* __restrict__ Sinv, const T* __restrict__ L,
                  const T* __restrict__ X, const T* __restrict__ Gi,
                  const T* __restrict__ r, const T* __restrict__ rg, T* __restrict__ xs,
                  T* __restrict__ g_out, int B, int ph, int bs, int w, int cw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;  // the whole warp leaves; only warp-level syncs below
  const Layout o = sweep_layout(ph, bs, w, (int)sizeof(T));

  T* base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * o.total;
  T* U = base + o.u;
  T* V = base + o.v;
  T* XN = base + o.xn;
  T* XTR = base + o.xtr;
  T* G = base + o.g;

  const int mat = bs * bs, bord = bs * w;
  const int sz = (int)sizeof(T);
  const T* Sb = Sinv + (size_t)b * ph * mat;
  const T* Lb = L + (size_t)b * (ph - 1) * mat;
  const T* Xb = X + (size_t)b * ph * bord;
  T* xb = xs + (size_t)b * ph * bs;

  // step s < ph is forward stage k = s (S_k, L_{k-1}, X_k); step s >= ph is
  // backward stage k = 2 ph - 2 - s (S_k, L_k, X_k)
  const int steps = 2 * ph - 1;
  auto load_step = [&](int s) {
    T* dst = base + (s % kStages) * o.stage;
    const int k = s < ph ? s : 2 * ph - 2 - s;
    const int kl = s < ph ? k - 1 : k;
    copy_run(dst, Sb + (size_t)k * mat, mat * sz, cw, lane);
    if (kl >= 0) copy_run(dst + o.l, Lb + (size_t)kl * mat, mat * sz, cw, lane);
    copy_run(dst + o.x, Xb + (size_t)k * bord, bord * sz, cw, lane);
  };

  // steps 0 .. kStages-2 ahead, one commit group each (r with step 0)
  copy_run(U, r + (size_t)b * ph * bs, ph * bs * sz, cw, lane);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s);
    copy_commit();
  }
  for (int j = lane; j < w; j += 32) XTR[j] = T(0);

  for (int s = 0; s < steps; ++s) {
    copy_wait<kStages - 2>();  // step s has landed
    __syncwarp();  // for every lane; and step s-1 has left its buffer
    if (s + kStages - 1 < steps) load_step(s + kStages - 1);
    copy_commit();
    const T* Sm = base + (s % kStages) * o.stage;
    const T* Lm = Sm + o.l;
    const T* Xm = Sm + o.x;
    if (s < ph) {
      const int k = s;
      T* rk = U + k * bs;
      // xtr += X_k' r_k
      for (int j = lane; j < w; j += 32) XTR[j] += col_dot(Xm, rk, j, bs, w);
      // v = r_k - L_{k-1} u_{k-1}
      for (int i = lane; i < bs; i += 32)
        V[i] = k > 0 ? rk[i] - row_dot(Lm, U + (k - 1) * bs, i, bs) : rk[i];
      __syncwarp();
      // u_k = S_k^-1 v, in place of r_k
      for (int i = lane; i < bs; i += 32) rk[i] = row_dot(Sm, V, i, bs);
      if (k == ph - 1) {
        __syncwarp();
        // border: g = Ghat^-1 (r_g - xtr); then x_{ph-1} = u_{ph-1} - X_{ph-1} g
        for (int a = lane; a < w; a += 32) {
          const T* row = Gi + ((size_t)b * w + a) * w;
          const T* rgb = rg + (size_t)b * w;
          T acc = T(0);
          for (int c = 0; c < w; ++c) acc = fma(row[c], rgb[c] - XTR[c], acc);
          G[a] = acc;
          g_out[(size_t)b * w + a] = acc;
        }
        __syncwarp();
        for (int i = lane; i < bs; i += 32) {
          const T xt = rk[i];
          XN[i] = xt;
          xb[(size_t)k * bs + i] = xt - xg_dot(Xm, G, i, w);
        }
      }
    } else {
      const int k = 2 * ph - 2 - s;
      // v = L_k' xT_{k+1}
      for (int j = lane; j < bs; j += 32) V[j] = col_dot(Lm, XN, j, bs, bs);
      __syncwarp();
      // xT_k = u_k - S_k^-1 v;  x_k = xT_k - X_k g
      for (int i = lane; i < bs; i += 32) {
        const T xt = U[k * bs + i] - row_dot(Sm, V, i, bs);
        XN[i] = xt;
        xb[(size_t)k * bs + i] = xt - xg_dot(Xm, G, i, w);
      }
    }
    __syncwarp();  // the vectors of this step are written
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the widest chunk (16, 8 or 4 bytes, at least one element) that divides
// every base pointer and every stride the copies step by
template <typename T>
int chunk_width(const void* const* ptrs, int n_ptrs, int ph, int bs, int w) {
  const size_t sz = sizeof(T);
  const size_t strides[3] = {(size_t)bs * bs * sz, (size_t)bs * w * sz, (size_t)ph * bs * sz};
  size_t cw = 16;
  auto fit = [&](uintptr_t v) {
    while (cw > sz && v % cw) cw >>= 1;
  };
  for (int i = 0; i < n_ptrs; ++i) fit(reinterpret_cast<uintptr_t>(ptrs[i]));
  for (size_t s : strides) fit(s);
  return (int)cw;
}

template <typename T>
int launch(const T* Sinv, const T* L, const T* X, const T* Gi, const T* r, const T* rg,
           T* xs, T* g, int B, int ph, int bs, int w, int warps, cudaStream_t stream) {
  if (B < 1 || ph < 1 || bs < 1 || w < 1 || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * sweep_layout(ph, bs, w, (int)sizeof(T)).total * sizeof(T);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      traj_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(traj_sweep_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // L holds no stage when ph = 1, and then its pointer is not read
  const void* ptrs[4] = {Sinv, X, r, L};
  const int cw = chunk_width<T>(ptrs, ph > 1 ? 4 : 3, ph, bs, w);
  const dim3 grid((B + warps - 1) / warps);
  traj_sweep_kernel<T><<<grid, 32 * warps, smem, stream>>>(Sinv, L, X, Gi, r, rg, xs, g,
                                                          B, ph, bs, w, cw);
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
