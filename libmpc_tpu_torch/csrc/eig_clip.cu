// Eigenvalue clipping of a batch of small symmetric matrices for Hopper
// (sm_90a), float and double: for each lane's H (n x n), the convex model
//
//   V diag(max(w, tau)) V',   H = V diag(w) V',   tau = max(1e-8, 1e-6 max|w|),
//
// the SQP loop's exact-Hessian "eigh" curvature (ops/sqp.py::_eigh_convexify).
//
// It replaces no Pallas kernel: the JAX package calls jnp.linalg.eigh
// (libmpc_tpu/ops/sqp.py:458), which XLA runs in one fused program on the
// TPU.  On this card torch.linalg.eigh runs cuSOLVER's batched Jacobi
// through thousands of launches a call at the UGV's 256 x 61 x 61 and reads
// its status back: a call is bound by launches and a host round trip, not
// by its arithmetic.  This kernel does the whole clipping in one launch and
// reads nothing back.
//
// What bounds it: operations.  A sweep of two-sided Jacobi costs about
// 9 n^3 flops a lane (6 n^3 for the rotations of A's rows and columns, 3 n^3
// for V), the reconstruction 2 n^3; the input is read and the output written
// once (2 n^2 words).  At (256, 61, 61) the least time is about 10 us a
// sweep at 67 TFLOP/s, and the work is a chain of n_p - 1 rounds a sweep,
// each a few block barriers apart, so the kernel's time is those barriers
// and the shared memory's traffic between them.  The design keeps the whole
// lane in shared memory and the block busy inside each round:
//
//   * one block a lane.  The lane's matrix A (scaled by a power of two so
//     that max|a| lies in [1/2, 1): exact, and no square overflows) and its
//     rotations V live in shared memory, padded to an even size n_p with a
//     leading dimension of n_p + 1 (rows and columns are read without bank
//     conflicts); the padding row and column are zero and never rotated.
//     float at n = 61 takes 32 KB, so all 256 lanes of the UGV are resident
//     in one wave on 132 SMs; double 64 KB, as dynamic shared memory;
//   * parallel cyclic Jacobi in round-robin order: each round rotates n_p / 2
//     disjoint pairs (p, q), and n_p - 1 rounds meet every pair once (a
//     sweep).  A round computes the rotations (Rutishauser's stable
//     t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), a rotation skipped
//     where |a_pq| is below tol ||A||_F / n_p, so that all skipped entries
//     together stay within the stopping test), then rotates A's rows, a
//     barrier, then A's columns and V's columns, writing the 2 x 2 block of
//     each pair as its exact diagonal (a_pp - t a_pq, a_qq + t a_pq) and
//     zeros, a barrier;
//   * a lane stops when the Frobenius norm of A's off-diagonal part is at
//     most 4 unit roundoffs of ||A||_F, tested before the first sweep (a
//     diagonal matrix does none) and after each one, or at the cap of sweeps
//     (20 for float, 30 for double; the spectra tried need at most 11 and
//     17); the sweeps done are written out per lane;
//   * then, in the same block: w from the diagonal (scaled back), tau from
//     max|w|, U = V diag(sqrt(max(w, tau))) in place of V, and the output
//     U U' written row by row (coalesced; exactly symmetric, since each entry
//     is the same sum of the same products whichever triangle it lies in).
//
// A lane with a non-finite entry writes NaN over its whole output (0 sweeps)
// and touches no other lane.  No library call, no atomics, no read to the
// host; the sums run in a fixed order, so a lane's result depends on its
// input alone.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block can use
constexpr int kMaxThreads = 1024;

template <typename T>
struct EigConst;
template <>
struct EigConst<float> {
  static constexpr float tol = 4.0f * 5.9604644775390625e-8f;  // 4 u, u = 2^-24
  static constexpr int max_sweeps = 20;
  __device__ static float nan() { return CUDART_NAN_F; }
};
template <>
struct EigConst<double> {
  static constexpr double tol = 4.0 * 1.1102230246251565e-16;  // 4 u, u = 2^-53
  static constexpr int max_sweeps = 30;
  __device__ static double nan() { return CUDART_NAN; }
};

__host__ __device__ constexpr int padded(int n) { return n + (n & 1); }

// dynamic shared memory of a block: A and V (n_p rows of n_p + 1), four
// arrays of n_p / 2 rotation values, 32 reduction slots, two arrays of
// n_p / 2 pair indices (ops/batched_linalg.py::eig_clip_smem_bytes)
template <typename T>
size_t smem_bytes(int n) {
  const size_t np = padded(n), half = np / 2;
  return (2 * np * (np + 1) + 4 * half + 32) * sizeof(T) + 2 * half * sizeof(int);
}

// threads a block, 32 to 512: about 4 of a round's row (or column) updates a
// thread in float, 8 in double, whose registers would keep two blocks of 512
// from sharing an SM (at (256, 61, 61): 512 and 256 threads, 1.04 and 1.78 ms
// on random inputs, against 1.30 and 2.16 ms the other way round)
template <typename T>
int default_threads(int n) {
  const int np = padded(n), each = sizeof(T) == 4 ? 4 : 8;
  const int per = (np / 2 * np + each - 1) / each;
  const int t = (per + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 512 ? 512 : t);
}

// the sum (kMax false) or the maximum (kMax true) of v over the block; every
// thread gets it.  `red` holds 32 slots; the first barrier keeps a previous
// call's readers ahead of this call's writers.
template <bool kMax, typename T>
__device__ T block_reduce(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmax(v, w) : v + w;
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < warps ? red[lane] : T(0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmax(v, w) : v + w;
  }
  return v;
}

// sum of the squares of A's entries off the diagonal (n x n, leading
// dimension ld)
template <typename T>
__device__ T off_norm2(const T* A, int n, int ld, T* red) {
  T s = T(0);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    const T a = A[i * ld + j];
    if (i != j) s += a * a;
  }
  return block_reduce<false>(s, red);
}

template <typename T>
__global__ void eig_clip_kernel(const T* __restrict__ H, T* __restrict__ out,
                                int* __restrict__ sweeps_out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = padded(n), ld = np + 1, half = np / 2;
  T* A = reinterpret_cast<T*>(smem_raw);
  T* V = A + np * ld;
  T* rc = V + np * ld;  // the round's rotations: c, s
  T* rs = rc + half;
  T* rdp = rs + half;  // and the rotated pair's diagonal
  T* rdq = rdp + half;
  T* red = rdq + half;
  int* rp = reinterpret_cast<int*>(red + 32);
  int* rq = rp + half;

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = (size_t)blockIdx.x * n * n;
  const T* h = H + base;
  T* o = out + base;

  // load (coalesced), the padding and V = I; the lane's largest |entry| and
  // whether every entry is finite
  T amax = T(0);
  int bad = 0;
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e - i * n;
    const T a = h[e];
    A[i * ld + j] = a;
    bad |= !isfinite(a);
    amax = fmax(amax, fabs(a));
  }
  for (int e = tid; e < np * np; e += nt) {
    const int i = e / np, j = e - i * np;
    V[i * ld + j] = T(i == j);
    if (i >= n || j >= n) A[i * ld + j] = T(0);
  }
  if (__syncthreads_or(bad)) {
    for (int e = tid; e < n * n; e += nt) o[e] = EigConst<T>::nan();
    if (tid == 0) sweeps_out[blockIdx.x] = 0;
    return;
  }
  amax = block_reduce<true>(amax, red);
  int ex = 0;
  if (amax > T(0)) frexp(amax, &ex);
  const T scale = ldexp(T(1), -ex);
  T sq = T(0);
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e - i * n;
    const T a = A[i * ld + j] * scale;
    A[i * ld + j] = a;
    sq += a * a;
  }
  const T norm2 = block_reduce<false>(sq, red);  // ||A||_F^2, kept by rotations
  const T tol = EigConst<T>::tol;
  const T stop2 = tol * tol * norm2;
  const T skip = tol * sqrt(norm2) / T(np);

  // this thread's first (pair, index) of a round's updates and its stride
  const int k0 = tid / np, j0 = tid - k0 * np;
  const int dk = nt / np, dj = nt - dk * np;

  int sweeps = 0;
  T off2 = off_norm2(A, n, ld, red);
  while (off2 > stop2 && sweeps < EigConst<T>::max_sweeps) {
    for (int r = 0; r < np - 1; ++r) {
      // the round's pairs: 0 stays, 1 .. n_p - 1 turn one place a round
      for (int k = tid; k < half; k += nt) {
        const int a = k == 0 ? 0 : (k - 1 + r) % (np - 1) + 1;
        const int b = (np - 2 - k + r) % (np - 1) + 1;
        const int p = a < b ? a : b, q = a < b ? b : a;
        const T app = A[p * ld + p], aqq = A[q * ld + q], apq = A[p * ld + q];
        T c = T(1), s = T(0), dp = app, dq = aqq;
        if (fabs(apq) > skip) {
          const T theta = (aqq - app) / (T(2) * apq);
          T t = T(1) / (fabs(theta) + sqrt(theta * theta + T(1)));
          if (theta < T(0)) t = -t;
          c = T(1) / sqrt(t * t + T(1));
          s = t * c;
          dp = app - t * apq;
          dq = aqq + t * apq;
        }
        rp[k] = p;
        rq[k] = q;
        rc[k] = c;
        rs[k] = s;
        rdp[k] = dp;
        rdq[k] = dq;
      }
      __syncthreads();
      // rows p and q of A: A <- J' A
      for (int k = k0, j = j0; k < half;) {
        const T s = rs[k];
        if (s != T(0)) {
          const T c = rc[k];
          T* ap = A + rp[k] * ld + j;
          T* aq = A + rq[k] * ld + j;
          const T x = *ap, y = *aq;
          *ap = c * x - s * y;
          *aq = s * x + c * y;
        }
        k += dk;
        j += dj;
        if (j >= np) {
          j -= np;
          ++k;
        }
      }
      __syncthreads();
      // columns p and q of A and V: A <- A J, V <- V J; the pair's own 2 x 2
      // block of A gets its exact diagonal and zeros
      for (int k = k0, i = j0; k < half;) {
        const T s = rs[k];
        if (s != T(0)) {
          const T c = rc[k];
          const int p = rp[k], q = rq[k];
          T* ai = A + i * ld;
          const T x = ai[p], y = ai[q];
          T xp = c * x - s * y, xq = s * x + c * y;
          if (i == p) {
            xp = rdp[k];
            xq = T(0);
          } else if (i == q) {
            xp = T(0);
            xq = rdq[k];
          }
          ai[p] = xp;
          ai[q] = xq;
          T* vi = V + i * ld;
          const T vx = vi[p], vy = vi[q];
          vi[p] = c * vx - s * vy;
          vi[q] = s * vx + c * vy;
        }
        k += dk;
        i += dj;
        if (i >= np) {
          i -= np;
          ++k;
        }
      }
      __syncthreads();
    }
    ++sweeps;
    off2 = off_norm2(A, n, ld, red);
  }

  // w (scaled back, exactly), tau, and U = V diag(sqrt(max(w, tau)))
  T wmax = T(0);
  for (int k = tid; k < n; k += nt) wmax = fmax(wmax, fabs(ldexp(A[k * ld + k], ex)));
  wmax = block_reduce<true>(wmax, red);
  const T tau = fmax(T(1e-8), T(1e-6) * wmax);
  for (int k = tid; k < n; k += nt) A[k * ld + k] = sqrt(fmax(ldexp(A[k * ld + k], ex), tau));
  __syncthreads();
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, k = e - i * n;
    V[i * ld + k] *= A[k * ld + k];
  }
  __syncthreads();
  // out = U U', row i, column j (consecutive threads on consecutive j)
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e - i * n;
    const T* ui = V + i * ld;
    const T* uj = V + j * ld;
    T acc = T(0);
    for (int k = 0; k < n; ++k) acc += ui[k] * uj[k];
    o[e] = acc;
  }
  if (tid == 0) sweeps_out[blockIdx.x] = sweeps;
}

// a kernel's dynamic shared-memory attribute, set to the most a block can
// have once for each device (`ready` holds a bit a device)
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

template <typename T>
int launch(const T* H, T* out, int* sweeps, int B, int n, int threads, cudaStream_t stream) {
  if (threads == 0) threads = default_threads<T>(n);
  const size_t smem = n >= 1 ? smem_bytes<T>(n) : 0;
  if (B < 0 || n < 1 || smem > kSmemLimit || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  static std::atomic<uint64_t> ready{0};
  const cudaError_t err = allow_smem(eig_clip_kernel<T>, ready);
  if (err != cudaSuccess) return (int)err;
  eig_clip_kernel<T><<<B, threads, smem, stream>>>(H, out, sweeps, n);
  return (int)cudaGetLastError();
}

}  // namespace

// H, out: B matrices of n x n, contiguous; sweeps: B ints (the Jacobi sweeps
// each lane ran).  threads: a multiple of 32 up to 1024, or 0 for the
// kernel's own choice.  An n whose block does not fit in shared memory
// (ops/batched_linalg.py::eig_clip_supported) returns cudaErrorInvalidValue.
extern "C" int libmpc_eig_clip_f32(const float* H, float* out, int* sweeps, int B, int n,
                                   int threads, void* stream) {
  return launch<float>(H, out, sweeps, B, n, threads, static_cast<cudaStream_t>(stream));
}

extern "C" int libmpc_eig_clip_f64(const double* H, double* out, int* sweeps, int B, int n,
                                   int threads, void* stream) {
  return launch<double>(H, out, sweeps, B, n, threads, static_cast<cudaStream_t>(stream));
}
