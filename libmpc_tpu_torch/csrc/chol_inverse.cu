// Explicit inverse of a batch of small SPD matrices for Hopper (sm_90a),
// float and double.
//
// Replaces the Pallas TPU kernel
// libmpc_tpu/ops/batched_linalg.py::_chol_inv_kernel (pallas_call at
// batched_linalg.py:110): the Cholesky factorization C = L L', each pivot
// floored as max(d, 1e-30) (a NaN pivot stays NaN), then the inverse
// C^-1 = L^-T L^-1.
//
// What bounds it on this card: at the main path's shapes (16384 x 24 x 24,
// 4096 x 20 x 20) the least time is the bytes (B k^2 words read, as many
// written) and the arithmetic is about k^3 / 2 multiply-adds a matrix, so
// the kernel must keep its work off the memory's way: no shared-memory
// barrier chain, no division in an inner loop, and the few broadcasts a
// matrix needs shared by several matrices an instruction.  At (1024, 8, 8)
// the launch itself is most of the time.  The TPU kernel puts 128 matrices
// side by side in the vector lanes; that layout does not carry over.  Two
// tiers, chosen by the caller (ops/batched_linalg.py::layout); the launcher
// only checks the layout it is given and refuses one that does not apply:
//
//   * register tier, k <= 32: G lanes a matrix (G a power of two, chosen by
//     k and type: as many as share the rows without more padding, 32
//     elements of the matrix a lane at least, within a budget of
//     registers), each lane holding rows t, t + G, t + 2G, ... of the
//     matrix's lower triangle in registers (row s G + t keeps positions
//     [0, (s + 1) G): the kernel is instantiated for a padded size KP, rows
//     k..KP-1 of the identity).  Three in-place passes over those
//     registers, chains of KP steps whose step broadcasts one row or column
//     with __shfl_sync inside the group (one shuffle instruction serves
//     32 / G matrices):
//       1. right-looking Cholesky: step p broadcasts the pivot and column p;
//          row i > p keeps L(i, p) and subtracts c_i col' from its row, with
//          c_i = C(i, p) / d (one reciprocal square root a pivot, no
//          division in the update); the pivot's slot receives 1 / L(p, p);
//       2. the triangular inverse by forward substitution, in place:
//          T(i, :) = e_i - sum L(i, m) L^-1(m, :), with L^-1(m, :) = T(m, :) /
//          L(m, m), step q updating the rows below q by the finished row q;
//       3. X = L^-T L^-1 as a sum of outer products of the rows of L^-1,
//          step q adding row q's product to the rows above it and turning
//          row q itself into its first term, in place.
//     Passes 2 and 3 run as one: step q broadcasts the finished row q once,
//     for the rows below it (2) and above it (3), so a matrix costs two
//     broadcasts of a triangle, not three.
//     Rows come straight from global memory into registers, 16 bytes a
//     lane where k = KP and the pointer allow it.  The output is written
//     row by row from registers, the upper triangle by the lane that holds
//     its mirror (G consecutive elements a group); where the layout stages
//     it (a large batch: the lanes' scattered pieces would hold the kernel
//     to a fraction of the memory's rate), into the warp's part of shared
//     memory, laid out as in global memory (a pad between matrices keeps the
//     groups' stores in distinct banks), and then out as one contiguous
//     copy, 16 bytes a lane where the pointer and k allow it; straight into
//     global memory otherwise (a small batch, whose time is latency).  One
//     __syncwarp orders the staging; nothing waits on a barrier inside the
//     passes.
//   * block tier, any k <= 64 (the path runs it for 33 <= k <= 64): one
//     block a matrix, the block-parallel factorization and triangular
//     inverse of chol_block.cuh (two warps, one barrier a pivot), then
//     X = Yt Yt' with Yt = (L^-1)' as 4 x 4 register tiles of the lower
//     triangle, each tile written with its mirror.
//
// A launch masks the ragged end of the batch itself (the register tier
// computes the identity for a group past B and stores nothing); nothing is
// padded in memory.  A kernel's dynamic shared-memory attribute is set once
// for each device, not on every launch.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "chol_block.cuh"

// A build for measurement only may define K2_ABLATE: bit 0 skips the
// register tier's passes, bit 1 its stores (chip_smoke.py --k2-ablate)
#ifndef K2_ABLATE
#define K2_ABLATE 0
#endif

namespace {

constexpr int kMaxK = 64;
constexpr int kRegMaxK = 32;
constexpr int kRegMaxThreads = 128;
constexpr int kBlockMinThreads = 64;
constexpr int kBlockMaxThreads = 256;
constexpr int kTierRegister = 0;
constexpr int kTierBlock = 1;
constexpr int kTile = 4;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block can use

// the register tier's instances (KP, G) for each type: the layout's choices,
// no others; ops/batched_linalg.py restates these lists (REG_INSTANCES), and
// a card test holds its rules to libmpc_chol_inverse_plan's
#define LIBMPC_K2_REG_F32(X) \
  X(4, 1) X(8, 2) X(12, 4) X(16, 8) X(20, 4) X(24, 8) X(32, 8)
#define LIBMPC_K2_REG_F64(X) \
  X(4, 1) X(8, 2) X(12, 4) X(16, 8) X(20, 4) X(24, 8) X(32, 16)

// value of v in lane `src` of this lane's group of G (G = 1: the lane's own)
template <int G, typename T>
__device__ __forceinline__ T bcast(T v, int src) {
  if constexpr (G == 1) {
    return v;
  } else {
    return __shfl_sync(0xffffffffu, v, src, G);
  }
}

// 1 / v rounded correctly (as the division is), without the division's
// slow path
__device__ __forceinline__ float recip(float v) { return __frcp_rn(v); }
__device__ __forceinline__ double recip(double v) { return __drcp_rn(v); }

template <typename T>
__device__ __forceinline__ void load16(const T* p, T* e) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    e[0] = v.x; e[1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const T* e) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(e[0], e[1], e[2], e[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(e[0], e[1]);
  }
}

// ---------------------------------------------------------------------------
// register tier.  Every loop is unrolled and every register index is a
// constant; a position p of a row exists where p < (s + 1) G for its slot s,
// and the positions past the row's diagonal hold values nothing reads.

// elements of shared memory between two staged matrices: k^2 and a pad (a
// multiple of the vector width) that puts the groups of a warp in distinct
// banks where k allows it (the rows of G lanes' mirror stores are then
// conflict-free); ops/batched_linalg.py::stage_stride restates it
__host__ __device__ inline int stage_stride(int k, int g, int elem) {
  const int v = 16 / elem, wpe = elem / 4;
  for (int p = 0; p < 32; p += v)
    if (((k * k + p) * wpe) % 32 == (g * wpe) % 32) return k * k + p;
  return k * k;
}

// a lane's walk over n matrices of kk elements, V at a time, 32 V apart:
// its (matrix, offset) advance without a division
template <int V>
struct StageWalk {
  int m = 0, off;
  int n, kk;
  __device__ StageWalk(int n_, int kk_, int lane) : off(lane * V), n(n_), kk(kk_) { settle(); }
  __device__ void settle() {
    while (off >= kk) {
      off -= kk;
      ++m;
    }
  }
  __device__ bool more() const { return m < n; }
  __device__ void next() {
    off += 32 * V;
    settle();
  }
};

// n matrices from a warp's staging area out to global memory, four pieces
// of V elements read before they are written
template <typename T, int V>
__device__ __forceinline__ void stage_out(T* gmem, const T* smem, int n, int kk, int stride,
                                          int lane) {
  StageWalk<V> w(n, kk, lane);
  while (w.more()) {
    T e[4][V];
    size_t at[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ok[u] = w.more();
      if (ok[u]) {
        const T* sp = smem + w.m * stride + w.off;
        if constexpr (V == 1) e[u][0] = *sp; else load16(sp, e[u]);
        at[u] = (size_t)w.m * kk + w.off;
        w.next();
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (ok[u]) {
        if constexpr (V == 1) gmem[at[u]] = e[u][0]; else store16(gmem + at[u], e[u]);
      }
    }
  }
}

template <typename T, int KP, int G>
__global__ void __launch_bounds__(kRegMaxThreads)
chol_inverse_reg_kernel(const T* __restrict__ C, T* __restrict__ out, int B, int k, int flags) {
  constexpr int R = KP / G;
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int MW = 32 / G;  // matrices a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1);
  const int first_mat = (int)((blockIdx.x * blockDim.x + (threadIdx.x & ~31)) / G);
  const int mat = first_mat + lane / G;
  const bool valid = mat < B;
  const int kk = k * k;
  const int stride = stage_stride(k, G, (int)sizeof(T));
  const int n_mats = B - first_mat < MW ? B - first_mat : MW;
  T* S = reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * MW * stride;
  T* Sm = S + (lane / G) * stride;  // this group's matrix
  T a[R][KP];

  // rows s G + t of the lower triangle straight into registers (whole
  // 16-byte chunks where flag bit 0 says the rows allow them; the identity
  // past k and past B)
  const T* __restrict__ Cm = C + (size_t)(valid ? mat : 0) * kk;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int row = s * G + t;
    if (flags & 1) {
#pragma unroll
      for (int c = 0; c < KP / V; ++c) {
        if (c * V < (s + 1) * G) {
          T e[V];
          if (valid) {
            load16(Cm + row * k + c * V, e);
          } else {
#pragma unroll
            for (int u = 0; u < V; ++u) e[u] = T(row == c * V + u ? 1 : 0);
          }
#pragma unroll
          for (int u = 0; u < V; ++u)
            if (c * V + u < (s + 1) * G) a[s][c * V + u] = e[u];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < KP; ++j)
        if (j < (s + 1) * G)
          a[s][j] = (valid && row < k && j < k) ? Cm[row * k + j] : T(row == j ? 1 : 0);
    }
  }

  // Each pass below treats a slot by where its rows lie against the step's
  // row: all above it (nothing to do, or no predicate), all below it (no
  // predicate), or around it (the step's own slot: predicated by the row).
  if constexpr ((K2_ABLATE & 1) == 0) {
    // 1. Cholesky: row i > p holds L(i, p) at p; row p holds 1 / L(p, p)
    const T guard = T(1e-30);
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const int ps = p / G;
      const T d = bcast<G>(a[ps][p], p % G);
      const T dg = d != d ? d : (d > guard ? d : guard);  // max(d, 1e-30)
      const T inv = libmpc::rsqrt_t(dg);
      const T inv2 = inv * inv;
      T col[KP];
#pragma unroll
      for (int j = 0; j < KP; ++j)
        if (j > p) col[j] = bcast<G>(a[j / G][p], j % G);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (s < ps) continue;
        const T raw = a[s][p];
        T c;
        if (s > ps) {
          c = raw * inv2;
          a[s][p] = raw * inv;
        } else {
          const int row = s * G + t;
          const bool below = row > p;
          c = below ? raw * inv2 : T(0);
          a[s][p] = below ? raw * inv : (row == p ? recip(d * inv) : raw);
        }
#pragma unroll
        for (int j = 0; j < KP; ++j)
          if (j > p && j < (s + 1) * G) a[s][j] = fma(-c, col[j], a[s][j]);
      }
    }

    // 2 and 3 in one pass of KP steps.  Row q of T = L^-1 scaled by the
    // rows' L(i, i) (T(i, :) = e_i - sum_m L(i, m) L^-1(m, :), with
    // L^-1(m, :) = T(m, :) / L(m, m); the diagonal keeps 1 / L(i, i)) is
    // final once the steps before q have updated it, so step q broadcasts
    // it once for both of its uses:
    //   * rows i > q (2): T(i, :) -= L(i, q) / L(q, q) T(q, :), T(i, q) = -L(i, q) / L(q, q);
    //   * rows i < q (3): X(i, :) += T(q, i) T(q, :) / L(q, q)^2, in place of T(i, :)
    //     (the lane's own column of the broadcast row picked by its index in
    //     the group);
    //   * row q: X(q, :) = T(q, :) / L(q, q)^2, its first term.
#pragma unroll
    for (int q = 0; q < KP; ++q) {
      const int qs = q / G;
      const T rd = bcast<G>(a[qs][q], q % G);
      const T r2 = rd * rd;
      T tr[KP];
#pragma unroll
      for (int j = 0; j < KP; ++j)
        if (j < q) tr[j] = bcast<G>(a[qs][j], q % G);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (s > qs) {  // every row below q
          const T c = a[s][q] * rd;
          a[s][q] = -c;
#pragma unroll
          for (int j = 0; j < KP; ++j)
            if (j < q) a[s][j] = fma(-c, tr[j], a[s][j]);
          continue;
        }
        T tq = T(0);
#pragma unroll
        for (int u = 0; u < G; ++u)
          if (s * G + u < q) tq = t == u ? tr[s * G + u] : tq;
        if (s < qs) {  // every row above q
          const T c = r2 * tq;
#pragma unroll
          for (int j = 0; j < KP; ++j)
            if (j < (s + 1) * G) a[s][j] = fma(c, tr[j], a[s][j]);
        } else {  // q's own slot: rows above, at and below q
          const int row = s * G + t;
          const bool first = row == q, below = row > q;
          const T c = row < q ? r2 * tq : (first ? r2 : -(a[s][q] * rd));
#pragma unroll
          for (int j = 0; j < KP; ++j)
            if (j < q) a[s][j] = fma(c, tr[j], first ? T(0) : a[s][j]);
          a[s][q] = below ? c : (first ? r2 : a[s][q]);
        }
      }
    }
  }

  if constexpr ((K2_ABLATE & 2) != 0) {  // no stores; the result is kept alive
    T sum = T(0);
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
      for (int j = 0; j < KP; ++j)
        if (j < (s + 1) * G) sum += a[s][j];
    if (valid && sum == T(-1.25e-29)) out[(size_t)mat * kk] = sum;
    return;
  }

  // X as the output lies, into the staging area (flag bit 2) or straight
  // into global memory: row s G + t's lower part X(i, 0..i) from the lane
  // (whole 16-byte chunks where they fall inside it and the rows allow
  // them), its mirror X(j, i), j < i, into row j (G consecutive elements a
  // group); a staged warp then copies its matrices out (16-byte accesses
  // where flag bit 1 says the output allows them)
  const bool staged = (flags & 4) != 0;
  T* dst = staged ? Sm : out + (size_t)mat * kk;
  const bool rows16 = staged ? k % V == 0 : (flags & 2) != 0;
  if (valid) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int row = s * G + t;
      if (row >= k) continue;
#pragma unroll
      for (int c = 0; c < KP / V; ++c) {
        if (c * V >= (s + 1) * G) continue;
        if (rows16 && c * V + V - 1 <= row) {
          T e[V];
#pragma unroll
          for (int u = 0; u < V; ++u) e[u] = c * V + u < (s + 1) * G ? a[s][c * V + u] : T(0);
          store16(dst + row * k + c * V, e);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u)
            if (c * V + u < (s + 1) * G && c * V + u <= row) dst[row * k + c * V + u] = a[s][c * V + u];
        }
      }
#pragma unroll
      for (int j = 0; j < KP; ++j)
        if (j < (s + 1) * G && j < row) dst[j * k + row] = a[s][j];
    }
  }
  if (!staged) return;
  __syncwarp();
  if (n_mats > 0) {
    if (flags & 2) {
      stage_out<T, V>(out + (size_t)first_mat * kk, S, n_mats, kk, stride, lane);
    } else {
      stage_out<T, 1>(out + (size_t)first_mat * kk, S, n_mats, kk, stride, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// block tier: one matrix a block

template <typename T>
__host__ __device__ inline size_t block_smem_bytes(int k) {
  return (size_t)(2 * k * (k | 1) + 2 * k) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kBlockMaxThreads)
chol_inverse_block_kernel(const T* __restrict__ C, T* __restrict__ out, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = k | 1;  // odd: a warp's column accesses fall in distinct banks
  T* M = reinterpret_cast<T*>(smem_raw);
  T* Yt = M + k * ld;
  T* piv = Yt + k * ld;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = (size_t)blockIdx.x * k * k;
  const T* __restrict__ Cm = C + base;
  libmpc::for_each_rc(k, k, tid, nt, [&](int r, int c, int e) { M[r * ld + c] = Cm[e]; });
  __syncthreads();
  libmpc::block_chol_lower_inverse(M, ld, Yt, ld, piv, k, tid, nt);

  // X(i, j) = sum_{q >= max(i, j)} Yt(i, q) Yt(j, q) on tiles at or below
  // the diagonal; rows past k read row k - 1 and are not stored
  T* __restrict__ Om = out + base;
  const int nrt = (k + kTile - 1) / kTile;
  for (int tt = tid; tt < nrt * (nrt + 1) / 2; tt += nt) {
    int rt = 0;
    while ((rt + 1) * (rt + 2) / 2 <= tt) ++rt;
    const int ct = tt - rt * (rt + 1) / 2;
    const int i0 = rt * kTile, j0 = ct * kTile;
    T acc[kTile][kTile];
#pragma unroll
    for (int m = 0; m < kTile; ++m)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[m][c] = T(0);
    const T* ya[kTile];
    const T* yb[kTile];
#pragma unroll
    for (int m = 0; m < kTile; ++m) {
      ya[m] = Yt + (i0 + m < k ? i0 + m : k - 1) * ld;
      yb[m] = Yt + (j0 + m < k ? j0 + m : k - 1) * ld;
    }
#pragma unroll 4
    for (int q = i0; q < k; ++q) {
      T x[kTile], y[kTile];
#pragma unroll
      for (int m = 0; m < kTile; ++m) {
        x[m] = ya[m][q];
        y[m] = yb[m][q];
      }
#pragma unroll
      for (int m = 0; m < kTile; ++m)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[m][c] = fma(x[m], y[c], acc[m][c]);
    }
#pragma unroll
    for (int m = 0; m < kTile; ++m) {
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int i = i0 + m, j = j0 + c;
        if (i < k && j < k) {
          Om[i * k + j] = acc[m][c];
          if (rt != ct) Om[j * k + i] = acc[m][c];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the layout.  The caller chooses it (ops/batched_linalg.py::layout); the
// launcher checks that the tier, the lanes a matrix and the threads a block
// apply to (B, k) and the type, and refuses them otherwise.

struct Layout {
  int tier, g, kp, threads, grid, stage;
  size_t smem;
};

template <typename T>
bool reg_instance(int kp, int g) {
#define LIBMPC_K2_HAS(KP_, G_) if (kp == KP_ && g == G_) return true;
  if constexpr (std::is_same<T, float>::value) {
    LIBMPC_K2_REG_F32(LIBMPC_K2_HAS)
  } else {
    LIBMPC_K2_REG_F64(LIBMPC_K2_HAS)
  }
#undef LIBMPC_K2_HAS
  return false;
}

template <typename T>
Layout check_layout(int B, int k, int tier, int g, int threads, int stage) {
  const Layout refused{-1, 0, 0, 0, 0, 0, 0};
  if (B < 0 || k < 1 || k > kMaxK || threads < 32 || threads % 32 != 0) return refused;
  if (tier == kTierRegister) {
    if (k > kRegMaxK || g < 1 || g > 32 || (g & (g - 1)) != 0 || threads > kRegMaxThreads)
      return refused;
    const int m = g > 4 ? g : 4;
    const int kp = (k + m - 1) / m * m;
    if (!reg_instance<T>(kp, g)) return refused;
    if (stage != 0 && stage != 1) return refused;
    const int per_block = threads / g;
    const size_t smem =
        stage ? (size_t)per_block * stage_stride(k, g, sizeof(T)) * sizeof(T) : 0;
    return Layout{tier, g, kp, threads, (B + per_block - 1) / per_block, stage, smem};
  }
  if (tier == kTierBlock) {
    if (g != 0 || stage != 0 || threads < kBlockMinThreads || threads > kBlockMaxThreads)
      return refused;
    return Layout{tier, 0, k, threads, B, 0, block_smem_bytes<T>(k)};
  }
  return refused;
}

// a kernel's dynamic shared-memory attribute, set to the most a block can
// have once for each device (`ready`, one for each kernel, holds a bit a
// device), not on every launch
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemLimit);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int KP, int G>
int launch_reg(const T* C, T* out, int B, int k, const Layout& lay, cudaStream_t stream) {
  static std::atomic<uint64_t> ready{0};
  const cudaError_t err = allow_smem(chol_inverse_reg_kernel<T, KP, G>, ready);
  if (err != cudaSuccess) return (int)err;
  // bit 0: the input's rows in 16-byte pieces; bit 1: the output's
  // matrices (staged) or rows (not) in 16-byte pieces; bit 2: staged
  const int v = 16 / (int)sizeof(T);
  const bool out16 = aligned16(out) && (lay.stage ? (k * k) % v == 0 : k % v == 0);
  const int flags = (k == KP && aligned16(C) ? 1 : 0) | (out16 ? 2 : 0) | (lay.stage ? 4 : 0);
  chol_inverse_reg_kernel<T, KP, G><<<lay.grid, lay.threads, lay.smem, stream>>>(C, out, B, k,
                                                                                 flags);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* C, T* out, int B, int k, int tier, int g, int threads, int stage,
           cudaStream_t stream) {
  const Layout lay = check_layout<T>(B, k, tier, g, threads, stage);
  if (lay.tier < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (lay.tier == kTierBlock) {
    static std::atomic<uint64_t> ready{0};
    const cudaError_t err = allow_smem(chol_inverse_block_kernel<T>, ready);
    if (err != cudaSuccess) return (int)err;
    chol_inverse_block_kernel<T><<<lay.grid, lay.threads, lay.smem, stream>>>(C, out, k);
    return (int)cudaGetLastError();
  }
#define LIBMPC_K2_CASE(KP_, G_) \
  case KP_ * 64 + G_:           \
    return launch_reg<T, KP_, G_>(C, out, B, k, lay, stream);
  if constexpr (std::is_same<T, float>::value) {
    switch (lay.kp * 64 + lay.g) {
      LIBMPC_K2_REG_F32(LIBMPC_K2_CASE)
      default:
        break;
    }
  } else {
    switch (lay.kp * 64 + lay.g) {
      LIBMPC_K2_REG_F64(LIBMPC_K2_CASE)
      default:
        break;
    }
  }
#undef LIBMPC_K2_CASE
  return (int)cudaErrorInvalidValue;
}

__global__ void empty_kernel() {}

}  // namespace

// The layout: tier 0 (register; k <= 32) with g lanes a matrix, g a power of
// two for which the instance (KP = k rounded up to a multiple of max(4, g),
// g) exists, 32-128 threads a block, and stage 1 to copy the output out
// through shared memory or 0 to store it straight; or tier 1 (block;
// k <= 64) with g = 0, stage 0 and 64-256 threads a block, one matrix a
// block.  A layout that does not apply returns cudaErrorInvalidValue.
extern "C" int libmpc_chol_inverse_f32(const float* C, float* out, int B, int k, int tier,
                                       int g, int threads, int stage, void* stream) {
  return launch<float>(C, out, B, k, tier, g, threads, stage,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int libmpc_chol_inverse_f64(const double* C, double* out, int B, int k,
                                       int tier, int g, int threads, int stage, void* stream) {
  return launch<double>(C, out, B, k, tier, g, threads, stage,
                        static_cast<cudaStream_t>(stream));
}

// The launch a layout gives (out: KP, grid, dynamic shared-memory bytes),
// or cudaErrorInvalidValue where the launcher would refuse it; nothing is
// launched.  ops/batched_linalg.py computes the same from its own copy of
// the rules, and a card test holds the two equal.
extern "C" int libmpc_chol_inverse_plan(int f64, int B, int k, int tier, int g, int threads,
                                        int stage, long long* out) {
  const Layout lay = f64 ? check_layout<double>(B, k, tier, g, threads, stage)
                         : check_layout<float>(B, k, tier, g, threads, stage);
  if (lay.tier < 0) return (int)cudaErrorInvalidValue;
  out[0] = lay.kp;
  out[1] = lay.grid;
  out[2] = (long long)lay.smem;
  return 0;
}

// A kernel that does nothing, launched with K2's grid: the yardstick of a
// launch's own device time in chip_smoke.py's K2-speed line.
extern "C" int libmpc_empty_launch(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
