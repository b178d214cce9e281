// Whole-solve ADMM kernel for a batch of small dense QPs on Hopper (sm_90a),
// float and double:   min 1/2 x'Px + q'x   s.t.  l <= Ax <= u,
// each instance with its own P (n, n) and A (m, n).
//
// Replaces the Pallas TPU kernel libmpc_tpu/ops/qp_inner_pallas.py::_kernel
// (pallas_call at qp_inner_pallas.py:362).  Per instance it assembles
// M = P + sigma I + A' diag(rho) A, inverts it (pivots floored at 1e-30),
// sets z0 = A x0, and iterates ADMM (x-update through M^-1 with one
// refinement pass against M, over-relaxation alpha, box projection,
// exactly-zero inactive duals).  Every check_every iterations it tests
// convergence on the UNSCALED residuals (the data arrives Ruiz-scaled with
// D^-1, E^-1 and c^-1 beside it), and when the residual ratio of an
// unconverged instance leaves [0.2, 5] it rescales the whole per-row rho
// vector (clipped to [1e-6, 1e6]) and refactors.  ONE WARP OWNS ONE
// INSTANCE: it leaves the loop when ITS instance converges and refactors
// only when ITS rho moves; a block holds `warps` such warps (the wrapper
// passes 1) and masks the ragged end of the batch.  The TPU kernel's
// 128-lane tile, which runs until all 128 are done and refactors all of
// them together, has no counterpart.
//
// What bounds it on this card: an instance is ~14 KB of matrices and ~1e4
// operations per iteration, so bytes and arithmetic both amount to tens of
// microseconds for a batch of thousands.  The work is five small
// matrix-vector products per iteration, one after the other; what costs is
// how each multiply-add gets its operands and how long one product's chain
// is.  Two layouts of the same algorithm, chosen by shape at launch:
//
// * Register tier (n <= 32, m <= 64; the SQP's Van der Pol subproblem is
//   n = 26, m = 57).  A and M^-1 live in registers as 2-D tiles: lane l
//   holds a 16 x 4 tile of A (rows 16(l&3).., columns 4(l>>2)..) and a
//   4 x 8 tile of M^-1 (rows 4(l>>2).., columns 8(l&3)..); M, used once an
//   iteration by the refinement, is read as the same 4 x 8 tile from shared
//   memory, and the refinement residual rhs - M x is summed error-free in
//   float32 (a plain float32 sum is mostly rounding there, and a sixth of
//   the lanes ran to the iteration cap; see smem_residual).  A product
//   reads its vector operand from shared memory (two 16-byte loads, or four
//   words), does 32 or 64 independent multiply-adds,
//   and sums the partials of the lanes that share its rows (or columns)
//   with a butterfly of shuffles: 3 for M and M^-1, 14 for A x, 3 for A'w.
//   The tile rows are stored XOR-permuted by the lane's position in the
//   butterfly, so every lane sends and keeps the same registers (no
//   selects), and each result lands where the next step wants it: x-like
//   vectors one element a lane, row vectors two rows a lane.  A
//   shared-memory load per multiply-add (the shared tier below: 374 loads
//   an iteration, measured 675 cycles per iteration per SM) becomes 26
//   loads and 26 shuffles an iteration, and the chain of one product is
//   4-8 multiply-adds and 2-3 shuffle steps instead of 26-57 dependent
//   multiply-adds.  What is left on one instance's chain is five such
//   steps, each a shared-memory round trip and its shuffles, about 2,000
//   cycles an iteration alone, 885 of them the error-free residual
//   (chip_smoke.py --k3-clocks).  The dual update's
//   y / rho skips the division where y is zero (the inactive rows, most of
//   them): a zero numerator sends the IEEE division to its slow path, a
//   call that cost ~600 cycles an iteration, and for rho > 0 the quotient
//   is that zero.  M is assembled with a tile of it per lane from A in
//   shared memory and inverted by Gauss-Jordan elimination with one row per
//   lane, a rolled loop whose rows rotate so that the pivot column is
//   always the same register (unrolled over the pivots, the two copies of
//   the elimination were ~170 KB of code and ran at ~800 cycles a pivot);
//   the SPD pivots are those of the Cholesky factor and carry its 1e-30
//   floor.  Shared memory per warp: A (m x 32), M and the elimination's
//   workspace (32 x 36 each), a two-row pivot buffer, four vectors of 32,
//   the row vector (72), rho and einv (64 each): (32 m + 2696) words.
//   float32 fits 168 registers without spilling, so 12 warps are resident
//   per SM; float64 runs the same template, its tiles need twice the
//   registers and spill.
//
// * Shared-memory tier (every other shape the gate admits, up to n = 56 or
//   m ~ 860).  A, M, the factor workspace, M^-1 and all vectors stay in
//   shared memory for the whole solve (P is read from global memory);
//   matrices are row-major with an odd leading dimension ld = n | 1, so a
//   product with lanes over rows (stride ld) and one with lanes over
//   columns (stride 1) are both free of bank conflicts; each multiply-add
//   reads two operands from shared memory.  Shared memory per warp:
//   (m ld + 3 n ld + 6 n + 7 m) elements.

#include <cuda_runtime.h>

#include "chol_warp.cuh"

// Cycle counters of the register tier's phases: chip_smoke.py --k3-clocks
// builds a copy of this file that defines these to read clock() at each
// K3_CLOCK(site); here they compile to nothing.
#ifndef K3_CLOCK
#define K3_CLOCK_START
#define K3_CLOCK(site)
#define K3_CLOCK_FLUSH(inst)
#endif

namespace {

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use
constexpr unsigned kFull = 0xffffffffu;

// register tier: capacities, the leading dimension of the n x n matrices
// in shared memory (a multiple of 4 whose rows fall in distinct banks for
// 16-byte loads), the length of the row-vector buffer (64 rows and a skew
// of 8 words for rows 32-63, see wpos) and the most warps a block may hold
constexpr int kRegN = 32;
constexpr int kRegM = 64;
constexpr int kLdm = 36;
constexpr int kWLen = kRegM + 8;
constexpr int kRegMaxWarps = 4;
// Blocks of 4 warps an SM the register budget must allow: float 3, i.e.
// 168 registers a thread and 12 resident warps (left to itself ptxas takes
// 173 and 11 warps fit, 16 % slower); double 1 (255 registers: its tiles
// need twice as many, and a cap of 168 made it twice as slow)
template <typename T>
struct RegMinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 3 : 1;
};

// The layout of one warp's instance, chosen by shape: the tier and the
// shared-memory words of each (exported below as libmpc_qp_inner_layout)
__host__ __device__ constexpr bool reg_tier(int n, int m) { return n <= kRegN && m <= kRegM; }

__host__ __device__ constexpr size_t reg_words(int m) {
  return (size_t)m * kRegN + 2 * kRegN * kLdm + 2 * kRegN + 4 * kRegN + kWLen + 2 * kRegM;
}

__host__ __device__ constexpr size_t shared_words(int n, int m) {
  return (size_t)m * (n | 1) + 3 * (size_t)n * (n | 1) + 6 * (size_t)n + 7 * (size_t)m;
}

// max that keeps a NaN (jnp.max semantics: a NaN residual never converges)
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

template <typename T>
__device__ __forceinline__ T warp_nanmax(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nanmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <typename T>
__device__ __forceinline__ T abs_t(T v) { return v < T(0) ? -v : v; }

// clamp(v, lo, hi), NaN where a bound is NaN, as the twin's torch.clamp
// (lo != lo tests for NaN)
template <typename T>
__device__ __forceinline__ T clamp_t(T v, T lo, T hi) {
  v = (v < lo || lo != lo) ? lo : v;
  return (v > hi || hi != hi) ? hi : v;
}

template <typename T>
struct Params {
  T sigma, alpha, one_minus_alpha, eps_abs, eps_rel;
  int n_blocks, check_every, refine;
};

// 16-byte (float) or 2 x 16-byte (double) loads and stores of 4 elements,
// and 8- or 16-byte ones of 2; p aligned to the vector
__device__ __forceinline__ void ld4(const float* p, float& a, float& b, float& c, float& d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a = v.x; b = v.y; c = v.z; d = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double& a, double& b, double& c,
                                    double& d) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  const double2 w = *reinterpret_cast<const double2*>(p + 2);
  a = v.x; b = v.y; c = w.x; d = w.y;
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(double* p, double a, double b, double c, double d) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
  *reinterpret_cast<double2*>(p + 2) = make_double2(c, d);
}
__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x; b = v.y;
}
__device__ __forceinline__ void ld2(const double* p, double& a, double& b) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  a = v.x; b = v.y;
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// ---------------------------------------------------------------------------
// Register tier.  Lane l's places (a = l & 3, b = l >> 2):
//   x-like vectors (x, q, dinv, rhs, x tilde): element l;
//   row vectors (z, y, rho, l, u, einv): rows r0 = 16 a + 2 b and r0 + 1;
//   A tile  at[t][c] = A[16 a + (t ^ 2b)][4 b + (c ^ a)],  t < 16, c < 4;
//   M, M^-1 tiles g[t][c] = G[4 b + (t ^ a)][8 a + c],      t < 4,  c < 8;
// zero outside (m, n).  The XOR keeps the butterfly free of selects: at
// each halving every lane keeps registers [0, h) and sends [h, 2h), and
// the partner's register t + h holds the same row or column as this
// lane's register t.

// row r of the row-vector buffer: rows 32-63 skewed by 8 words, so the
// pair loads of tile_atw (lanes over a, pairs over b) are conflict-free
__device__ __forceinline__ int wpos(int r) { return r + ((r >> 5) << 3); }

// (G v)_l on lane l for an n x n matrix G held as 4 x 8 tiles; v (32
// elements, zero past n) in shared memory
template <typename T>
__device__ __forceinline__ T tile_matvec(const T (&g)[4][8], const T* v, int lane) {
  const T* va = v + 8 * (lane & 3);
  T v0, v1, v2, v3, v4, v5, v6, v7;
  ld4(va, v0, v1, v2, v3);
  ld4(va + 4, v4, v5, v6, v7);
  T p[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const T lo = fma(g[t][3], v3, fma(g[t][2], v2, fma(g[t][1], v1, g[t][0] * v0)));
    const T hi = fma(g[t][7], v7, fma(g[t][6], v6, fma(g[t][5], v5, g[t][4] * v4)));
    p[t] = lo + hi;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) p[t] += __shfl_xor_sync(kFull, p[t + 2], 2);
  return p[0] + __shfl_xor_sync(kFull, p[1], 1);
}

// this lane's tile of the n x n matrix in shared memory (32 x kLdm)
template <typename T>
__device__ __forceinline__ void load_g_tile(const T* G, int lane, T (&g)[4][8]) {
  const int a = lane & 3, b = lane >> 2;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const T* row = G + (4 * b + (t ^ a)) * kLdm + 8 * a;
    ld4(row, g[t][0], g[t][1], g[t][2], g[t][3]);
    ld4(row + 4, g[t][4], g[t][5], g[t][6], g[t][7]);
  }
}

// The refinement residual rhs - G v on lane l, G's tile read from shared
// memory (32 x kLdm).  rhs and G v agree to the solve's error, so a
// float32 product leaves a residual that is mostly its own rounding (the
// eight-term partials round at the size of their largest term), and the
// refinement pass adds noise instead of a correction: on the path's timing
// inputs 769 of 4,096 lanes ran to the 300-iteration cap (chip_smoke.py
// --phases k3, K3-caps).  In float32 the products are therefore split
// exactly (h + r = g v) and summed with the rounding of each addition kept
// (Dot2 of Ogita, Rump and Oishi), which is as accurate as a double sum;
// double partials cost conversions and spilled under the register budget.
// In double the residual is the plain product.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float z = s - a;
  e = (a - (s - z)) + (b - z);
}

__device__ __forceinline__ float smem_residual(const float* G, const float* v, float rhs,
                                               int lane) {
  const int a = lane & 3, b = lane >> 2;
  float vv[8];
  ld4(v + 8 * a, vv[0], vv[1], vv[2], vv[3]);
  ld4(v + 8 * a + 4, vv[4], vv[5], vv[6], vv[7]);
  float hi[4], lo[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float* row = G + (4 * b + (t ^ a)) * kLdm + 8 * a;
    float g[8];
    ld4(row, g[0], g[1], g[2], g[3]);
    ld4(row + 4, g[4], g[5], g[6], g[7]);
    float p = g[0] * vv[0], c = fmaf(g[0], vv[0], -p);
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float h = g[k] * vv[k];
      const float r = fmaf(g[k], vv[k], -h);
      float q;
      two_sum(p, h, p, q);
      c += q + r;
    }
    hi[t] = p;
    lo[t] = c;
  }
  // the same butterfly as tile_matvec, on (hi, lo) pairs
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float ph = __shfl_xor_sync(kFull, hi[t + 2], 2);
    const float pl = __shfl_xor_sync(kFull, lo[t + 2], 2);
    float q;
    two_sum(hi[t], ph, hi[t], q);
    lo[t] += pl + q;
  }
  const float ph = __shfl_xor_sync(kFull, hi[1], 1);
  const float pl = __shfl_xor_sync(kFull, lo[1], 1);
  float s, q;
  two_sum(hi[0], ph, s, q);
  return (rhs - s) - (lo[0] + pl + q);
}

__device__ __forceinline__ double smem_residual(const double* G, const double* v,
                                                double rhs, int lane) {
  double g[4][8];
  load_g_tile(G, lane, g);
  return rhs - tile_matvec(g, v, lane);
}

// (A x) at rows r0, r0 + 1 of lane l; x (32 elements, zero past n) in
// shared memory
template <typename T>
__device__ __forceinline__ void tile_ax(const T (&at)[16][4], const T* x, int lane, T& z0,
                                        T& z1) {
  const int a = lane & 3, b = lane >> 2;
  T xv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) xv[c] = x[4 * b + (c ^ a)];
  T p[16];
#pragma unroll
  for (int t = 0; t < 16; ++t)
    p[t] = fma(at[t][3], xv[3], fma(at[t][2], xv[2], fma(at[t][1], xv[1], at[t][0] * xv[0])));
#pragma unroll
  for (int t = 0; t < 8; ++t) p[t] += __shfl_xor_sync(kFull, p[t + 8], 16);
#pragma unroll
  for (int t = 0; t < 4; ++t) p[t] += __shfl_xor_sync(kFull, p[t + 4], 8);
#pragma unroll
  for (int t = 0; t < 2; ++t) p[t] += __shfl_xor_sync(kFull, p[t + 2], 4);
  z0 = p[0];
  z1 = p[1];
}

// (A' w)_l on lane l; w (64 rows at wpos, zero past m) in shared memory
template <typename T>
__device__ __forceinline__ T tile_atw(const T (&at)[16][4], const T* w, int lane) {
  const int a = lane & 3, b = lane >> 2;
  const T* wa = w + wpos(16 * a);
  T p[4] = {T(0), T(0), T(0), T(0)}, s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // tile rows 2k and 2k + 1 are the rows 16 a + 2 (k ^ b) + {0, 1}
    T w0, w1;
    ld2(wa + 2 * (k ^ b), w0, w1);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      p[c] = fma(at[2 * k][c], w0, p[c]);
      s[c] = fma(at[2 * k + 1][c], w1, s[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) p[c] += s[c];
#pragma unroll
  for (int c = 0; c < 2; ++c) p[c] += __shfl_xor_sync(kFull, p[c + 2], 2);
  return p[0] + __shfl_xor_sync(kFull, p[1], 1);
}

// this lane's A tile from sA (m x 32, zero past n)
template <typename T>
__device__ __forceinline__ void load_a_tile(const T* sA, int m, int lane, T (&at)[16][4]) {
  const int a = lane & 3, b = lane >> 2;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int r = 16 * a + (t ^ (2 * b));
#pragma unroll
    for (int c = 0; c < 4; ++c) at[t][c] = r < m ? sA[r * kRegN + 4 * b + (c ^ a)] : T(0);
  }
}

// M = P + sigma I + A' diag(rho) A into sM (32 x kLdm, zero outside
// n x n, kept for the refinement products) and its inverse as this lane's
// tile.  sA holds A (m x 32, zero past n), rho the m penalties; sW
// (32 x kLdm) and sPiv (2 x 32) are workspace.  The warp is synchronised
// on entry and on return.  Nothing of the caller's tiles is live here (the
// A tile is loaded again after it), so the elimination has the registers
// to itself.
template <typename T>
__device__ void reg_factorize(const T* sA, const T* rho, T* sM, T* sW, T* sPiv, const T* Pg,
                              int n, int m, T sigma, int lane, T (&mi)[4][8]) {
  const int a = lane & 3, b = lane >> 2;
  {
    // this lane's 4 x 8 tile of M, rows 4 b + t, columns 8 a + c: P + sigma I
    // (its loads in flight during the sum), then A' diag(rho) A
    T pd[4][8], acc[4][8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = 4 * b + t;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = 8 * a + c;
        const bool in = i < n && j < n;
        pd[t][c] = in ? Pg[i * n + j] : T(0);
        acc[t][c] = T(0);
      }
    }
#pragma unroll 4
    for (int r = 0; r < m; ++r) {
      const T* row = sA + r * kRegN;
      T ai[4], aj[8];
      ld4(row + 4 * b, ai[0], ai[1], ai[2], ai[3]);
      ld4(row + 8 * a, aj[0], aj[1], aj[2], aj[3]);
      ld4(row + 8 * a + 4, aj[4], aj[5], aj[6], aj[7]);
      const T rh = rho[r];
#pragma unroll
      for (int c = 0; c < 8; ++c) aj[c] *= rh;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[t][c] = fma(aj[c], ai[t], acc[t][c]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = 4 * b + t;
      T v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = 8 * a + c;
        v[c] = (pd[t][c] + (i < n && i == j ? sigma : T(0))) + acc[t][c];
      }
      st4(sM + i * kLdm + 8 * a, v[0], v[1], v[2], v[3]);
      st4(sM + i * kLdm + 8 * a + 4, v[4], v[5], v[6], v[7]);
    }
  }
  __syncwarp();
  // this lane's row of M to eliminate
  T g[kRegN];
#pragma unroll
  for (int k = 0; k < kRegN / 4; ++k)
    ld4(sM + lane * kLdm + 4 * k, g[4 * k], g[4 * k + 1], g[4 * k + 2], g[4 * k + 3]);

  // Gauss-Jordan inversion in place, one row a lane.  At step p the pivot
  // row goes through shared memory as it stands (two buffers, one sync a
  // step), while every lane forms 1/pivot; row i subtracts (a_ip/pivot)
  // times it, its pivot column becoming -a_ip / pivot, and the pivot row
  // is scaled by 1/pivot with 1/pivot in its pivot column.  Each step
  // also rotates every row left by one position, so that the pivot column
  // is always register 0 and the loop is one short body (a loop unrolled
  // over 32 pivots overflows the instruction cache): after step p,
  // position j holds column (j + p + 1) mod 32.  For an SPD matrix the
  // pivots are the Schur complements' diagonals, i.e. the squared diagonal
  // of the Cholesky factor, floored as there.
  for (int p = 0; p < n; ++p) {
    T* pr = sPiv + (p & 1) * kRegN;
    if (lane == p) {
#pragma unroll
      for (int k = 0; k < kRegN / 4; ++k)
        st4(pr + 4 * k, g[4 * k], g[4 * k + 1], g[4 * k + 2], g[4 * k + 3]);
    }
    const T d = __shfl_sync(kFull, g[0], p);
    const T floor_ = T(1e-30);
    const T inv = T(1) / (d != d ? d : (d > floor_ ? d : floor_));
    __syncwarp();
    const bool me = lane == p;
    const T f = me ? T(0) : g[0] * inv;  // a_ip / pivot
    T r[kRegN];
#pragma unroll
    for (int k = 0; k < kRegN / 4; ++k)
      ld4(pr + 4 * k, r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
#pragma unroll
    for (int j = 0; j < kRegN - 1; ++j)
      g[j] = me ? r[j + 1] * inv : fma(-f, r[j + 1], g[j + 1]);
    g[kRegN - 1] = me ? inv : -f;
  }
  // undo the rotation: position j holds column (j + n) mod 32
#pragma unroll
  for (int j = 0; j < kRegN; ++j) sW[lane * kLdm + ((j + n) & (kRegN - 1))] = g[j];
  __syncwarp();
  load_g_tile(sW, lane, mi);
  __syncwarp();  // sW may be written again
}

template <typename T>
__global__ void __launch_bounds__(32 * kRegMaxWarps, RegMinBlocks<T>::value) qp_inner_reg_kernel(
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
  T* sA = reinterpret_cast<T*>(smem_raw) + warp * reg_words(m);
  T* sM = sA + (size_t)m * kRegN;  // M, for the refinement products
  T* sW = sM + kRegN * kLdm;        // elimination workspace
  T* sPiv = sW + kRegN * kLdm;
  T* vr = sPiv + 2 * kRegN;  // rhs (and x for the check)
  T* vt = vr + kRegN;        // x tilde
  T* vs = vt + kRegN;        // refinement residual
  T* vt2 = vs + kRegN;       // refined x tilde
  T* vw = vt2 + kRegN;       // rho z - y (and y for the check), at wpos
  T* vrho = vw + kWLen;      // rho, for the assembly of M
  T* vei = vrho + kRegM;     // einv, for the check

  const int inst = blockIdx.x * warps + warp;
  if (inst >= B) return;  // the whole warp leaves; only warp-level syncs below
  K3_CLOCK_START

  const T* Pg = P + (size_t)inst * n * n;
  const T* Ag = A + (size_t)inst * m * n;
  const bool col_ok = lane < n;
#pragma unroll 8
  for (int r = 0; r < m; ++r) sA[r * kRegN + lane] = col_ok ? Ag[r * n + lane] : T(0);
  const size_t gn = (size_t)inst * n + lane;
  T x = col_ok ? x0[gn] : T(0);
  const T qv = col_ok ? q[gn] : T(0);
  const T di = col_ok ? dinv[gn] : T(0);
  const int r0 = 16 * (lane & 3) + 2 * (lane >> 2);
  bool row_ok[2];
  T y[2], rh[2], lo[2], hi[2], z[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = r0 + k;
    row_ok[k] = r < m;
    const size_t g = (size_t)inst * m + r;
    y[k] = row_ok[k] ? y0[g] : T(0);
    rh[k] = row_ok[k] ? rho[g] : T(1);
    lo[k] = row_ok[k] ? l[g] : T(0);
    hi[k] = row_ok[k] ? u[g] : T(0);
    vei[r] = row_ok[k] ? einv[g] : T(0);
    if (row_ok[k]) vrho[r] = rh[k];
  }
  const T ci = cinv[inst];
  __syncwarp();
  K3_CLOCK(0);  // setup: A and the vectors loaded

  T mi[4][8], at[16][4];
  int blk = 0, done = 0;
  T pri = T(0), dua = T(0);
  bool factor = true;  // (re)factorize before this block
  for (; blk < par.n_blocks; ++blk) {
    if (factor) {
      // one call site: the factorization's code is in the kernel once
      reg_factorize(sA, vrho, sM, sW, sPiv, Pg, n, m, par.sigma, lane, mi);
      load_a_tile(sA, m, lane, at);
      factor = false;
      if (blk == 0) {
        // z0 = A x0
        vr[lane] = x;
        __syncwarp();
        tile_ax(at, vr, lane, z[0], z[1]);
      }
      K3_CLOCK(1);  // factorization and inverse (and z0 = A x0)
    }
    for (int it = 0; it < par.check_every; ++it) {
      // rhs = sigma x - q + A'(rho z - y)
      st2(vw + wpos(r0), row_ok[0] ? rh[0] * z[0] - y[0] : T(0),
          row_ok[1] ? rh[1] * z[1] - y[1] : T(0));
      __syncwarp();
      const T rhs = par.sigma * x - qv + tile_atw(at, vw, lane);
      vr[lane] = col_ok ? rhs : T(0);
      __syncwarp();
      K3_CLOCK(2);  // w = rho z - y, A'w, rhs
      // xt = M^-1 rhs, then one refinement pass against M
      T xt = tile_matvec(mi, vr, lane);
      if (par.refine) {
        vt[lane] = col_ok ? xt : T(0);
        __syncwarp();
        K3_CLOCK(3);  // M^-1 rhs
        const T res = smem_residual(sM, vt, rhs, lane);
        vs[lane] = col_ok ? res : T(0);
        __syncwarp();
        K3_CLOCK(4);  // refinement residual rhs - M x tilde
        xt += tile_matvec(mi, vs, lane);
      }
      xt = col_ok ? xt : T(0);
      vt2[lane] = xt;
      __syncwarp();
      K3_CLOCK(5);  // M^-1 res
      // zt = A xt; relaxation, projection and dual update row by row
      T zt[2];
      tile_ax(at, vt2, lane, zt[0], zt[1]);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const T z_relax = par.alpha * zt[k] + par.one_minus_alpha * z[k];
        // y / rho, whose division takes its slow path for y = 0, the
        // inactive rows: for rho > 0 the quotient of a zero is that zero
        const T z_unc = z_relax + (y[k] == T(0) && rh[k] > T(0) ? y[k] : y[k] / rh[k]);
        const T z_new = clamp_t(z_unc, lo[k], hi[k]);
        const bool clipped = (z_unc < lo[k]) || (z_unc > hi[k]);
        y[k] = row_ok[k] && clipped ? y[k] + rh[k] * (z_relax - z_new) : T(0);
        z[k] = row_ok[k] ? z_new : T(0);
      }
      x = par.alpha * xt + par.one_minus_alpha * x;
      K3_CLOCK(6);  // A x tilde, relaxation, projection, dual update
    }

    // convergence check on the unscaled residuals
    vr[lane] = x;
    st2(vw + wpos(r0), y[0], y[1]);
    __syncwarp();
    T axr[2];
    tile_ax(at, vr, lane, axr[0], axr[1]);
    T p_res = T(0), ax_max = T(0), ez_max = T(0);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (row_ok[k]) {
        const T ax = vei[r0 + k] * axr[k];
        const T ez = vei[r0 + k] * z[k];
        p_res = nanmax(p_res, abs_t(ax - ez));
        ax_max = nanmax(ax_max, abs_t(ax));
        ez_max = nanmax(ez_max, abs_t(ez));
      }
    }
    const T acca = tile_atw(at, vw, lane);
    T d_res = T(0), px_max = T(0), aty_max = T(0), q_max = T(0);
    if (col_ok) {
      // P x, row l, four partial sums
      const T* Pl = Pg + lane * n;
      T acc4[4] = {T(0), T(0), T(0), T(0)};
      int j = 0;
      for (; j + 4 <= n; j += 4)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc4[c] = fma(Pl[j + c], vr[j + c], acc4[c]);
      for (; j < n; ++j) acc4[0] = fma(Pl[j], vr[j], acc4[0]);
      const T px = di * ((acc4[0] + acc4[1]) + (acc4[2] + acc4[3]));
      const T aty = di * acca;
      const T dq = di * qv;
      d_res = abs_t(px + dq + aty);
      px_max = abs_t(px);
      aty_max = abs_t(aty);
      q_max = abs_t(dq);
    }
    __syncwarp();  // every lane has read vr and vw
    pri = warp_nanmax(p_res);
    dua = ci * warp_nanmax(d_res);
    const T pri_rel = nanmax(warp_nanmax(ax_max), warp_nanmax(ez_max));
    const T dua_rel =
        ci * nanmax(nanmax(warp_nanmax(px_max), warp_nanmax(aty_max)),
                    warp_nanmax(q_max));
    const bool conv = (pri <= par.eps_abs + par.eps_rel * pri_rel) &&
                      (dua <= par.eps_abs + par.eps_rel * dua_rel);
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
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (row_ok[k]) {
            rh[k] = clamp_t(rh[k] * ratio, T(1e-6), T(1e6));
            vrho[r0 + k] = rh[k];
          }
        }
        __syncwarp();
        factor = true;
      }
    }
    K3_CLOCK(7);  // convergence check and adaptive rho
  }

  K3_CLOCK_FLUSH(inst);
  if (col_ok) xo[(size_t)inst * n + lane] = x;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (row_ok[k]) {
      const size_t g = (size_t)inst * m + r0 + k;
      yo[g] = y[k];
      zo[g] = z[k];
    }
  }
  if (lane == 0) {
    // the counter advances by a whole block up to and including the block
    // in which the instance converges
    iters_o[inst] = (done ? blk + 1 : par.n_blocks) * par.check_every;
    done_o[inst] = done;
    pri_o[inst] = pri;
    dua_o[inst] = dua;
  }
}

// ---------------------------------------------------------------------------
// Shared-memory tier.

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
  T* sA = reinterpret_cast<T*>(smem_raw) + warp * shared_words(n, m);
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

template <typename K>
int configure(K kernel, size_t smem) {
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // ask for the largest shared-memory carve-out, so that as many blocks as
  // fit 227 KB are resident per SM (a hint; the default may settle for less)
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
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
  // the tier is a function of the shape alone
  const bool reg = reg_tier(n, m);
  if (reg && warps > kRegMaxWarps) return (int)cudaErrorInvalidValue;
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
  if (reg) {
    const size_t smem = reg_words(m) * sizeof(T) * warps;
    const int err = configure(qp_inner_reg_kernel<T>, smem);
    if (err != 0) return err;
    qp_inner_reg_kernel<T><<<grid, 32 * warps, smem, stream>>>(
        P, A, q, l, u, rho, x0, y0, dinv, einv, cinv, xo, yo, zo, iters, done,
        pri, dua, B, n, m, par);
  } else {
    const size_t smem = shared_words(n, m) * sizeof(T) * warps;
    const int err = configure(qp_inner_kernel<T>, smem);
    if (err != 0) return err;
    qp_inner_kernel<T><<<grid, 32 * warps, smem, stream>>>(
        P, A, q, l, u, rho, x0, y0, dinv, einv, cinv, xo, yo, zo, iters, done,
        pri, dua, B, n, m, par);
  }
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

// The launcher's layout for an (n, m) subproblem with elements of
// elem_bytes: returns the tier (1 register, 0 shared) and stores the shared
// memory of one warp's instance in *bytes.  ops/qp_inner_fused.py restates
// it for the gate, which must also answer where no library is built (the
// CPU); tests/test_torch_cuda.py holds the two equal.
extern "C" int libmpc_qp_inner_layout(int n, int m, int elem_bytes, long long* bytes) {
  *bytes = (long long)((reg_tier(n, m) ? reg_words(m) : shared_words(n, m)) * elem_bytes);
  return reg_tier(n, m) ? 1 : 0;
}
