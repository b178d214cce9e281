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
// Lanes whose `done` flag is set keep x/z/y bitwise untouched.  A NaN bound
// gives a NaN z, as the twin's torch.clamp and the JAX package's jnp.clip do
// (a lane whose state is NaN must end NaN, which the controller reports as
// an error and answers by holding its last command).
//
// What bounds it on this card.  The TPU kernel keeps A, M and Minv in VMEM;
// at the quadrotor size (n=216, m=535) they take 836 KB in float32, more
// than the 227 KB of shared memory a Hopper block can use, so a block owns a
// tile of lanes for all k_iters iterations, keeps their vectors in shared
// memory and streams the shared matrices from the 50 MB L2, using each
// element it fetches for every lane of the tile.  The work is 2 m n + 3 n^2
// multiply-adds a lane-iteration with refinement: 1.815 ms at B=16384, 10
// iterations, at the card's 67 TFLOP/s of FP32.  Two layouts (tiers) of
// that scheme; the caller chooses one by shape and batch
// (ops/admm_fused.py::layout) and the launcher checks that it applies:
//
// The stream tier (any shape; the kernel's first layout): 8 lanes a block in
// float32, 4 in float64, 384 threads, three blocks an SM; thread j walks
// the contraction and reads Mat[k][j] through the read-only path, A twice
// an iteration (A, and a transposed copy for zt).  Measured on an NVIDIA
// H100 80GB HBM3 (700 W, chip_smoke.py --phases k1): 6.57 ms at B=16384
// in float32, 11.95 in float64; its 30.4 GB of L2 reads a launch arrive at
// 4.6 TB/s against the 7.1 TB/s a probe reads the L2 at (the loads of
// co-resident blocks also share the L1).  One global and two shared loads
// for every 8 multiply-adds.
//
// The staged tier (float32, n <= 256 and a multiple of 4, aligned matrices):
//   * one pass over A an iteration.  A streams by slabs of KC rows; for each
//     slab the block forms zt of those rows from the complete xt, projects
//     z and updates y of those rows, forms w of those rows and adds w A_slab
//     into the next iteration's rhs.  A is read k_iters + 1 times a launch
//     (a leading pass for the first rhs; the last iteration's pass forms no
//     w A), Minv twice and M once an iteration; no transposed copy of A;
//   * every slab is one bulk copy (TMA) into a ring of up to 4 stages in
//     shared memory, requested by thread 0 `stages` - 1 slabs ahead and
//     counted on the stage's mbarrier;
//   * 4 to 16 lanes (BT) a block, 16 BT threads; vectors lane-major with
//     rows padded so that a warp's 16-byte loads fall on distinct banks; w
//     exists one slab at a time and the refinement residual overwrites rhs
//     in place: (3 n + 2 m) words a lane;
//   * products as 4 x 4 register tiles, four 16-byte loads of lanes and
//     four of the matrix for 64 FMAs; zt of a slab is a dot product split
//     SP ways and combined by a shuffle reduce-scatter that leaves each
//     thread the (lane, row) pairs it projects; l, u and rho of those pairs
//     are fetched before the product, q of the rhs during the last slab.
//   Measured (same card): 8.3 ms at B=16384 with 16 lanes, and a 16-lane
//   block alone on the card takes the same 210k cycles an iteration as at
//   full load, so neither L2 nor device memory holds it but what one SM
//   does: thread 0's cycles go to zt 30 %, the n x n products 27 %, w A
//   20 %, projection 13 %, slab waits 5 %.  The products move about 100
//   bytes a cycle an SM from shared memory into registers, counting every
//   thread's load whether or not the warp shares its address, at 2 bytes a
//   multiply-add with 4 x 4 tiles; 4 x 2 tiles at twice the threads (3
//   bytes) were slower, 8 x 8 tiles with the contraction split across
//   lanes slower still, and a producer warp, operands loaded a step ahead
//   and l, u a slab ahead changed nothing (PERF.md).  Issuing the copies as
//   per-thread cp.async took a quarter of the cycles; the bulk copies do
//   not.  It wins where a batch fits one wave of 8-lane tiles, where the
//   stream tier leaves SMs short of blocks: 0.74 against 0.90 ms at
//   B=1,024, 0.69 against 0.77 at B=1.  In float64 the stream tier was
//   faster at every batch measured (the staged tier 1.9-2.2x slower), so
//   float64 runs it alone.
// ops/admm_fused.py::layout compares the two tiers' costs, with constants
// from those timings at the quadrotor shape (no other shape was timed).
// Products are plain FFMA/DFMA; no
// tensor-core (TF32) arithmetic is used.
//
// The grid is ceil(B / BT): the last tile masks its missing lanes itself,
// so unlike the TPU kernel the batch needs no power-of-two divisor.

#include <cuda_runtime.h>
#include <stdint.h>

// `chip_smoke.py --k1-clocks` builds a copy of this file that defines these
// to count thread 0's cycles of each block between the marks
// K1_CLOCK(site); here they compile to nothing.
#ifndef K1_CLOCK
#define K1_CLOCK_START
#define K1_CLOCK(site)
#define K1_CLOCK_FLUSH()
#endif

namespace {

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use
constexpr int kStreamThreads = 384;
constexpr int kMaxStagedN = 256;    // 64 column groups of 4 a lane group
constexpr int kMaxStages = 4;       // ring stages, as many as fit up to this

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return ::fma(a, b, c);
}

// ---------------------------------------------------------------------------
// the staged tier

// float32 only: float64 runs faster on the stream tier at every batch
// measured (PERF.md)
constexpr int kSlabRows = 32;  // matrix rows a slab (KC)
constexpr int kSplits = 8;     // partial sums of a zt entry (SP threads)

// row stride (elements) of a lane vector or a slab row of k elements: k
// rounded up to 4, then padded so that a row is 16 mod 32 bytes long (rows
// 4 apart start on opposite halves of the banks)
__host__ __device__ constexpr int staged_ld(int k, int elem) {
  return ((k + 3) / 4 * 4 * elem) % 32 == 0 ? (k + 3) / 4 * 4 + 16 / elem
                                            : (k + 3) / 4 * 4;
}

// floats of a staged block: the tile's vectors, `stages` ring stages and a
// slack of 8
__host__ __device__ constexpr long long staged_words(int bt, int n, int m, int stages) {
  return (long long)bt * (3 * staged_ld(n, 4) + 2 * staged_ld(m, 4) + staged_ld(kSlabRows, 4)) +
         (long long)stages * kSlabRows * n + 8;
}

// clip(v, lo, hi), NaN where a bound is NaN (lo != lo tests for NaN)
template <typename T>
__device__ __forceinline__ T clip_bounds(T v, T lo, T hi) {
  v = (v < lo || lo != lo) ? lo : v;
  return (v > hi || hi != hi) ? hi : v;
}

__host__ __device__ constexpr bool staged_shape(int n, int m, int elem) {
  return elem == 4 && n >= 1 && m >= 1 && n <= kMaxStagedN && n % 4 == 0;
}

template <typename T>
__device__ __forceinline__ void ld4(const T* p, T (&v)[4]);
template <>
__device__ __forceinline__ void ld4<float>(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// the bulk copy engine (TMA): one instruction copies a run of bytes from
// device to shared memory and counts them on an mbarrier
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// generic-proxy writes of this thread before later bulk copies into them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// acc[b][c] += sum_k V[b][k] S[k][c] for k in [0, kcount): V's rows are the
// thread's 4 lanes (stride ldv), S's rows the slab's (stride lds), 4 columns
template <typename T>
__device__ __forceinline__ void nt_product(const T* V, int ldv, const T* S, int lds,
                                           int kcount, T (&acc)[4][4]) {
#pragma unroll 2
  for (int k = 0; k < kcount; k += 4) {
    T v[4][4], s[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) ld4(V + b * ldv + k, v[b]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ld4(S + (k + kk) * lds, s[kk]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[b][c] = fma_t(v[b][kk], s[kk][c], acc[b][c]);
  }
}

// d[b][r] += sum_j V[b][j] S[r][j] over the groups of 4 columns j/4 = sp,
// sp + SP, ... below `chunks`
template <typename T, int SP>
__device__ __forceinline__ void dot_product(const T* V, int ldv, const T* S, int lds,
                                            int chunks, int sp, T (&d)[4][4]) {
#pragma unroll 2
  for (int c = sp; c < chunks; c += SP) {
    T v[4][4], s[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) ld4(V + b * ldv + 4 * c, v[b]);
#pragma unroll
    for (int r = 0; r < 4; ++r) ld4(S + r * lds + 4 * c, s[r]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[b][r] = fma_t(v[b][j], s[r][j], d[b][r]);
  }
}

// the SP threads sp = 0..SP-1 (consecutive lanes of a warp) hold partial
// sums of the same 16 values; after this, thread sp holds the complete sums
// of 16 / SP of them in v[0..16/SP), values own0<SP>(sp) + e
template <typename T, int SP>
__device__ __forceinline__ void reduce_scatter(T (&v)[16], int sp) {
  constexpr int kRounds = SP == 16 ? 4 : SP == 8 ? 3 : SP == 4 ? 2 : SP == 2 ? 1 : 0;
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    const int o = SP >> (rd + 1);
    const int half = 8 >> rd;
    const bool up = (sp & o) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const T send = up ? v[k] : v[k + half];
      const T keep = up ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
}

template <int SP>
__device__ __forceinline__ int own0(int sp) {
  int base = 0, cnt = 16;
#pragma unroll
  for (int o = SP / 2; o >= 1; o >>= 1) {
    cnt /= 2;
    if (sp & o) base += cnt;
  }
  return base;
}

enum PhaseKind { kLead = 0, kMinv1 = 1, kM = 2, kMinv2 = 3, kApass = 4 };

// registers a thread of a staged block may use: the block's 16 BT threads
// have the SM's 65,536 to themselves
template <int BT>
struct StagedRegs {
  static constexpr int value = 65536 / (16 * BT) / 8 * 8 > 255 ? 255 : 65536 / (16 * BT) / 8 * 8;
};

template <int BT>
__global__ void __maxnreg__(StagedRegs<BT>::value)
admm_staged_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ y, const uint8_t* __restrict__ done,
                   const float* __restrict__ q, const float* __restrict__ l,
                   const float* __restrict__ u, const float* __restrict__ A,
                   const float* __restrict__ M, const float* __restrict__ Minv,
                   const float* __restrict__ rho, float* __restrict__ ox, float* __restrict__ oz,
                   float* __restrict__ oy, int B, int n, int m, int k_iters, float sigma,
                   float alpha, float one_minus_alpha, int refine, int stages) {
  using T = float;
  constexpr int KC = kSlabRows, SP = kSplits;
  constexpr int RG = KC / 4;  // row groups of a slab
  constexpr int G = BT / 4;   // lane groups of the tile
  constexpr int NT = 16 * BT;
  constexpr int VPT = 16 / SP;     // zt entries a thread owns
  constexpr int ldk = staged_ld(KC, sizeof(T));
  const int ldn = staged_ld(n, sizeof(T));
  const int ldm = staged_ld(m, sizeof(T));
  const int n4 = (n + 3) / 4 * 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* X = reinterpret_cast<T*>(smem_raw);  // (BT, ldn) each, lane-major
  T* R = X + BT * ldn;                    // rhs, then the refinement residual
  T* XT = R + BT * ldn;
  T* Z = XT + BT * ldn;  // (BT, ldm) each
  T* Y = Z + BT * ldm;
  T* W = Y + BT * ldm;     // (BT, ldk): w of the current slab
  // `stages` stages of (KC, n), and 8 elements that the last group of 4
  // columns may read past the last row (float64 rows of n = 2 mod 4), into
  // outputs past n, which are dropped
  T* ring = W + BT * ldk;
  __shared__ bool frozen[BT];
  __shared__ uint64_t full[kMaxStages];  // a stage's slab has landed

  const int tid = threadIdx.x;
  const int lane32 = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * BT;

  // products with n outputs: thread -> (lane group lg, column group cg);
  // 64 column groups of 4 a lane group (n <= 256)
  const int lg = tid / 64, cg = tid % 64;
  const int c0 = 4 * cg;
  const bool nt_on = c0 < n4;
  // zt of a slab: thread -> (lane group dlg, row group drg, split sp); a warp
  // covers 2 lane groups x 2 row groups where it can (fewer distinct rows)
  const int sp = lane32 % SP;
  int dlg, drg;
  if (SP == 8 && G % 2 == 0) {
    const int tw = lane32 / SP;
    dlg = (warp / (RG / 2)) * 2 + (tw >> 1);
    drg = (warp % (RG / 2)) * 2 + (tw & 1);
  } else {
    const int tile = warp * (32 / SP) + lane32 / SP;
    dlg = tile / RG;
    drg = tile % RG;
  }
  const int own = own0<SP>(sp);

  K1_CLOCK_START
  // pads must read as zeros: zero everything, then load the tile
  const int words = BT * (3 * ldn + 2 * ldm + ldk) + stages * KC * n + 8;
  for (int e = tid; e < words; e += NT) X[e] = T(0);
  if (tid < BT) frozen[tid] = b0 + tid >= B || done[b0 + tid] != 0;
  if (tid < stages) mbar_init(&full[tid], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  fence_proxy_async();  // the zeros land before any bulk copy into the ring
  __syncthreads();
  for (int e = tid; e < BT * n; e += NT) {
    const int b = e / n, c = e - b * n;
    if (b0 + b < B) X[b * ldn + c] = x[(size_t)(b0 + b) * n + c];
  }
  for (int e = tid; e < BT * m; e += NT) {
    const int b = e / m, c = e - b * m;
    if (b0 + b < B) {
      Z[b * ldm + c] = z[(size_t)(b0 + b) * m + c];
      Y[b * ldm + c] = y[(size_t)(b0 + b) * m + c];
    }
  }
  __syncthreads();

  // the slab sequence: a leading A pass, then per iteration Minv (M, Minv)
  // and A, through a ring of `stages` stages, `stages` - 1 slabs in flight
  // ahead of the one in use.  A slab's rows are contiguous in the matrix and
  // in the ring (row stride n), so thread 0 requests it with one bulk copy,
  // counted on the stage's mbarrier; warp 0 first zeroes the rows of a
  // last, partial slab past the matrix.
  const int ppi = refine ? 4 : 2;
  const int nph = 1 + k_iters * ppi;
  auto kind_of = [&](int p) -> int {
    if (p == 0) return kLead;
    const int r = (p - 1) % ppi;
    if (!refine) return r == 0 ? kMinv1 : kApass;
    return r == 0 ? kMinv1 : r == 1 ? kM : r == 2 ? kMinv2 : kApass;
  };
  const int nsl_a = (m + KC - 1) / KC, nsl_n = (n + KC - 1) / KC;
  int pp = 0, ps = 0, pstage = 0;  // the next slab to fetch, and its stage
  auto fetch_next = [&]() {
    if (pp >= nph) return;
    const int kind = kind_of(pp);
    const bool on_a = kind == kLead || kind == kApass;
    if (warp == 0) {
      const T* mat = on_a ? A : kind == kM ? M : Minv;
      const int valid = min(KC, (on_a ? m : n) - ps * KC);
      T* dst = ring + pstage * KC * n;
      if (valid < KC) {
        for (int e = lane32; e < (KC - valid) * n; e += 32) dst[valid * n + e] = T(0);
        fence_proxy_async();
        __syncwarp();
      }
      if (lane32 == 0) {
        const int bytes = valid * n * (int)sizeof(T);
        mbar_expect_tx(&full[pstage], bytes);
        bulk_copy(dst, mat + (size_t)ps * KC * n, bytes, &full[pstage]);
      }
    }
    if (++ps == (on_a ? nsl_a : nsl_n)) {
      ps = 0;
      ++pp;
    }
    if (++pstage == stages) pstage = 0;
  };
  for (int k = 0; k + 1 < stages; ++k) fetch_next();
  K1_CLOCK(0);  // set-up: tile loaded

  int cstage = 0, cparity = 0;  // the stage in use, and its mbarrier's phase
  for (int p = 0; p < nph; ++p) {
    const int kind = kind_of(p);
    const bool on_a = kind == kLead || kind == kApass;
    const int nsl = on_a ? nsl_a : nsl_n;
    const bool want_w = kind == kLead || (kind == kApass && p != nph - 1);
    const T* V = kind == kM ? XT : R;
    // the phase's product (an n x n one, or w A of an A pass into the next
    // rhs), and q of the owned rhs entries, fetched during the last slab
    T acc[4][4], qv[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[b][c] = T(0);

    for (int s = 0; s < nsl; ++s) {
      mbar_wait(&full[cstage], cparity);
      K1_CLOCK(1);  // wait for the slab's copies
      __syncthreads();  // every thread is done with slab s - 1
      K1_CLOCK(2);  // the barrier after it
      fetch_next();  // into the stage slab s - 1 used
      const T* S = ring + cstage * KC * n;
      if (++cstage == stages) {
        cstage = 0;
        cparity ^= 1;
      }
      if (!on_a) {
        if (nt_on) {
          const int k0 = s * KC;
          nt_product<T>(V + 4 * lg * ldn + k0, ldn, S + c0, n, min(KC, n4 - k0), acc);
        }
        K1_CLOCK(3);  // next slab requested; n x n products (Minv rhs, M xt, Minv res)
        continue;
      }
      const int i0 = s * KC;
      if (want_w && s == nsl - 1 && nt_on) {
        // q of the thread's rhs entries, in flight during this slab
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int gb = b0 + 4 * lg + b, col = c0 + c;
            qv[b][c] = gb < B && col < n ? __ldg(q + (size_t)gb * n + col) : T(0);
          }
      }
      // rho, l and u of the thread's (lane, row) pairs, in flight during zt
      T rr[VPT], lo[VPT], hi[VPT];
#pragma unroll
      for (int e = 0; e < VPT; ++e) {
        const int idx = own + e;
        const int lane = 4 * dlg + idx / 4;
        const int i = i0 + 4 * drg + idx % 4;
        rr[e] = i < m ? __ldg(rho + i) : T(1);
        lo[e] = hi[e] = T(0);
        if (kind == kApass && i < m && !frozen[lane]) {
          const size_t g = (size_t)(b0 + lane) * m + i;
          lo[e] = __ldg(l + g);
          hi[e] = __ldg(u + g);
        }
      }
      T d[16];
      if (kind == kApass) {
        T dd[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int r = 0; r < 4; ++r) dd[b][r] = T(0);
        dot_product<T, SP>(XT + 4 * dlg * ldn, ldn, S + 4 * drg * n, n, n4 / 4, sp, dd);
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int r = 0; r < 4; ++r) d[4 * b + r] = dd[b][r];
        K1_CLOCK(4);  // l, u, rho (q) requested; zt of the slab's rows
        reduce_scatter<T, SP>(d, sp);
      }
#pragma unroll
      for (int e = 0; e < VPT; ++e) {
        const int idx = own + e;
        const int lane = 4 * dlg + idx / 4;
        const int ii = 4 * drg + idx % 4;
        const int i = i0 + ii;
        T zn = T(0), yn = T(0);
        if (i < m) {
          zn = Z[lane * ldm + i];
          yn = Y[lane * ldm + i];
          if (kind == kApass && !frozen[lane]) {
            const T zo = zn, yo = yn;
            const T zr = alpha * d[e] + one_minus_alpha * zo;
            // y / rho with the division of a zero skipped (the quotient is
            // that zero; a zero numerator takes the division's slow path)
            const T zu = zr + (yo == T(0) ? yo : yo / rr[e]);
            zn = clip_bounds(zu, lo[e], hi[e]);
            const bool clipped = (zu < lo[e]) || (zu > hi[e]);
            yn = clipped ? yo + rr[e] * (zr - zn) : T(0);
            Z[lane * ldm + i] = zn;
            Y[lane * ldm + i] = yn;
          }
        }
        if (want_w) W[lane * ldk + ii] = i < m ? rr[e] * zn - yn : T(0);
      }
      K1_CLOCK(5);  // reduce-scatter, relaxation, projection, dual update, w
      if (want_w) {
        __syncthreads();  // w of the slab complete
        K1_CLOCK(6);  // the barrier before w A
        if (nt_on)
          nt_product<T>(W + 4 * lg * ldk, ldk, S + c0, n, KC, acc);
        K1_CLOCK(7);  // w A into the next rhs
      }
    }

    // epilogues on the thread's 4 lanes x 4 columns
    if (nt_on && (!on_a || want_w)) {
      const bool x_update = kind == (refine ? kMinv2 : kMinv1);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int lane = 4 * lg + b;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + c;
          if (col >= n) continue;
          const int o = lane * ldn + col;
          if (kind == kMinv1) {
            XT[o] = acc[b][c];
          } else if (kind == kM) {
            R[o] = R[o] - acc[b][c];
          } else if (kind == kMinv2) {
            XT[o] = XT[o] + acc[b][c];
          } else {
            R[o] = sigma * X[o] - qv[b][c] + acc[b][c];
          }
          if (x_update && !frozen[lane]) X[o] = alpha * XT[o] + one_minus_alpha * X[o];
        }
      }
    }
    K1_CLOCK(8);  // epilogues: xt, residual, x update, rhs
  }
  K1_CLOCK_FLUSH();

  __syncthreads();
  for (int e = tid; e < BT * n; e += NT) {
    const int b = e / n, c = e - b * n;
    if (b0 + b < B) ox[(size_t)(b0 + b) * n + c] = X[b * ldn + c];
  }
  for (int e = tid; e < BT * m; e += NT) {
    const int b = e / m, c = e - b * m;
    if (b0 + b < B) {
      oz[(size_t)(b0 + b) * m + c] = Z[b * ldm + c];
      oy[(size_t)(b0 + b) * m + c] = Y[b * ldm + c];
    }
  }
}

// ---------------------------------------------------------------------------
// the stream tier: any shape that fits a lane's vectors.  One block owns BT
// lanes; thread j walks the contraction index k and reads Mat[k][j] through
// the read-only path (coalesced across the warp) and v[k][0..BT) from shared
// memory, keeping BT accumulators in registers; zt reads a transposed copy
// of A.  (3 n + 2 m + max(n, m)) words a lane, the refinement residual in
// w's buffer.

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
__global__ void __launch_bounds__(kStreamThreads)
admm_stream_kernel(const T* __restrict__ x, const T* __restrict__ z,
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
        const T zn = clip_bounds(zu, lo, hi);
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

__host__ __device__ constexpr long long stream_words(int bt, int n, int m) {
  return (long long)(3 * n + 2 * m + (n > m ? n : m)) * bt;
}

// ---------------------------------------------------------------------------
// the layout.  The caller chooses it (ops/admm_fused.py::layout, which
// compares the two tiers' costs); the launcher only checks that the tier,
// tile and ring depth it is given apply to the shape and fit the shared
// memory, and refuses them otherwise.

struct Layout {
  int tier, bt, stages, smem, grid;
};

// the launch's layout, or tier -1 where (tier, bt, stages) does not apply
Layout check_layout(int tier, int bt, int stages, int B, int n, int m, int elem,
                    bool aligned) {
  const Layout refused{-1, 0, 0, 0, 0};
  if (B < 0 || n < 1 || m < 1) return refused;
  long long bytes = -1;
  if (tier == 1) {
    if (!aligned || !staged_shape(n, m, elem) || (bt != 16 && bt != 8 && bt != 4) ||
        stages < 2 || stages > kMaxStages)
      return refused;
    bytes = staged_words(bt, n, m, stages) * 4;
  } else if (tier == 0) {
    if ((elem == 4 ? bt > 8 : bt > 4) || bt < 1 || (bt & (bt - 1)) != 0 || stages != 0)
      return refused;
    bytes = stream_words(bt, n, m) * elem;
  }
  if (bytes < 0 || bytes > kSmemLimit) return refused;
  return Layout{tier, bt, stages, (int)bytes, (B + bt - 1) / bt};
}

template <int BT>
cudaError_t launch_staged(const float* x, const float* z, const float* y,
                          const uint8_t* done, const float* q, const float* l,
                          const float* u, const float* A, const float* M, const float* Minv,
                          const float* rho, float* ox, float* oz, float* oy, int B, int n,
                          int m, int k_iters, double sigma, double alpha, int refine,
                          const Layout& lay, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(admm_staged_kernel<BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         lay.smem);
  if (err != cudaSuccess) return err;
  admm_staged_kernel<BT><<<lay.grid, 16 * BT, lay.smem, stream>>>(
      x, z, y, done, q, l, u, A, M, Minv, rho, ox, oz, oy, B, n, m, k_iters, float(sigma),
      float(alpha), float(1.0 - alpha), refine, lay.stages);
  return cudaGetLastError();
}

template <typename T, int BT>
cudaError_t launch_stream(const T* x, const T* z, const T* y, const uint8_t* done,
                          const T* q, const T* l, const T* u, const T* A, const T* At,
                          const T* M, const T* Minv, const T* rho, T* ox, T* oz, T* oy,
                          int B, int n, int m, int k_iters, double sigma, double alpha,
                          int refine, const Layout& lay, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(admm_stream_kernel<T, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         lay.smem);
  if (err != cudaSuccess) return err;
  admm_stream_kernel<T, BT><<<lay.grid, kStreamThreads, lay.smem, stream>>>(
      x, z, y, done, q, l, u, A, At, M, Minv, rho, ox, oz, oy, B, n, m, k_iters,
      T(sigma), T(alpha), T(1.0 - alpha), refine);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int dispatch(const T* x, const T* z, const T* y, const uint8_t* done, const T* q,
             const T* l, const T* u, const T* A, const T* At, const T* M, const T* Minv,
             const T* rho, T* ox, T* oz, T* oy, int B, int n, int m, int k_iters,
             double sigma, double alpha, int refine, int tier, int bt, int stages,
             cudaStream_t stream) {
  const bool aligned = aligned16(A) && aligned16(M) && aligned16(Minv);
  const Layout lay = check_layout(tier, bt, stages, B, n, m, sizeof(T), aligned);
  if (lay.tier < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if constexpr (sizeof(T) == 4) {
    if (lay.tier == 1) {
#define LIBMPC_STAGED_CASE(BT_)                                                       \
  case BT_:                                                                           \
    return (int)launch_staged<BT_>(x, z, y, done, q, l, u, A, M, Minv, rho, ox, oz, oy, \
                                   B, n, m, k_iters, sigma, alpha, refine, lay, stream);
      switch (lay.bt) {
        LIBMPC_STAGED_CASE(16)
        LIBMPC_STAGED_CASE(8)
        LIBMPC_STAGED_CASE(4)
        default:
          return (int)cudaErrorInvalidValue;
      }
#undef LIBMPC_STAGED_CASE
    }
  }
  if (lay.tier != 0 || At == nullptr) return (int)cudaErrorInvalidValue;
#define LIBMPC_STREAM_CASE(BT_)                                                       \
  case BT_:                                                                           \
    return (int)launch_stream<T, BT_>(x, z, y, done, q, l, u, A, At, M, Minv, rho, ox, \
                                      oz, oy, B, n, m, k_iters, sigma, alpha, refine,  \
                                      lay, stream);
  switch (lay.bt) {
    LIBMPC_STREAM_CASE(8)
    LIBMPC_STREAM_CASE(4)
    LIBMPC_STREAM_CASE(2)
    LIBMPC_STREAM_CASE(1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LIBMPC_STREAM_CASE
}

}  // namespace

// The layout: tier 1 (staged; float32, n <= 256 and a multiple of 4, A, M
// and Minv 16-byte aligned) with bt 16, 8 or 4 lanes a block and 2 to 4
// ring stages, or tier 0 (stream) with bt 8, 4, 2 or 1 lanes in float32 (4,
// 2 or 1 in float64) and stages 0.  A layout that does not apply or does
// not fit the shared memory returns cudaErrorInvalidValue.  At is read only
// by the stream tier (pass null where the layout is staged).
extern "C" int libmpc_admm_fused_f32(
    const float* x, const float* z, const float* y, const uint8_t* done,
    const float* q, const float* l, const float* u, const float* A,
    const float* At, const float* M, const float* Minv, const float* rho,
    float* ox, float* oz, float* oy, int B, int n, int m, int k_iters,
    double sigma, double alpha, int refine, int tier, int bt, int stages,
    void* stream) {
  return dispatch<float>(x, z, y, done, q, l, u, A, At, M, Minv, rho, ox, oz, oy, B, n,
                         m, k_iters, sigma, alpha, refine, tier, bt, stages,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int libmpc_admm_fused_f64(
    const double* x, const double* z, const double* y, const uint8_t* done,
    const double* q, const double* l, const double* u, const double* A,
    const double* At, const double* M, const double* Minv, const double* rho,
    double* ox, double* oz, double* oy, int B, int n, int m, int k_iters,
    double sigma, double alpha, int refine, int tier, int bt, int stages,
    void* stream) {
  return dispatch<double>(x, z, y, done, q, l, u, A, At, M, Minv, rho, ox, oz, oy, B, n,
                          m, k_iters, sigma, alpha, refine, tier, bt, stages,
                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* libmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
