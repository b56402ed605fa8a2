// Dense kernel-profile direct sum for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/_build.py).
//
//   y_j = sum_i K(||a_j - b_i||) x_i        a (n_out, d), b (n_in, d),
//                                           x (n_in, C), y (n_out, C)
//
// with K one of the paper's four profiles evaluated on r^2, T in {float,
// double}, 1 <= d <= kMaxD, and the optional zero diagonal masked by INDEX
// (row == col), even for two different point sets, as the TPU kernel does.
//
// Replaces src/repro/kernels/kernel_matvec.py:_matvec_kernel.  The TPU
// kernel walks (TJ, TI) tiles with i innermost and accumulates into a
// revisited output block.  Hopper runs blocks in parallel and in no order,
// so the i walk is a loop inside the block, over one of S contiguous
// splits of the sources (grid: row blocks x S).  A block owns kThreads * R
// target rows, R per thread, with their coordinates and channel sums in
// registers, and streams its split's sources through shared memory in
// tiles of kTile points and their x values.  Each (split, row) is written
// once: with S = 1 straight into y, else into a scratch array (S, n_out,
// C) whose S partial sums a second, small kernel adds in split order.
// Every sum has a fixed order (sources in order within a tile, tiles in
// order within a split, splits in order): no atomics, deterministic.
//
// What bounds it: operations.  It reads n_out*d + n_in*(d + C) values and
// writes n_out*C, but does ~(3d + profile + 2C) operations per pair, and an
// accurate FP64 exp alone is a couple of dozen FP64 instructions: the FP64
// pipe's issue rate is the ceiling.  The design is about keeping that pipe
// busy on every SM: the wrapper picks S (kernel_matvec.choose_splits) so
// that small n_out still gives every SM several blocks; R independent
// exp/sqrt chains per thread hide their latency; and every shared-memory
// read of a source serves R pairs (all threads of a block read the same
// word at once: a broadcast, no bank conflicts).  The profile and the
// dimension are template parameters (d = 2, 3 unrolled; other d up to
// kMaxD through one generic loop), and the channel chunk is 1, 4 or 8 wide
// (R = 4 at one channel and d = 2, 3; 2 for the generic d, 1 for four or
// eight channels, so the coordinates and sums stay in registers).
// exp/sqrt/rsqrt are the accurate math-library versions (no fast-math):
// the float32 tolerance depends on it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block (BLOCK_THREADS)
constexpr int kTile = 64;      // sources per shared-memory tile (SOURCE_TILE)
constexpr int kMaxD = 8;       // largest d the generic path takes
constexpr int kReduceThreads = 256;

// Target rows per thread (rows_per_thread in Python): four at one channel
// and d = 2, 3; fewer where the coordinates (generic d: 8 a row) or the
// channel sums take more registers (at R = 2, f64 four-channel instances
// spilled).
template <int D, int CH>
constexpr int rows_per_thread() {
  return CH == 1 ? (D > 0 ? 4 : 2) : 1;
}

// Profile ids, in the order of repro_torch.kernels.kernel_matvec.PROFILES.
enum Profile {
  kGaussian = 0,
  kLaplacianRbf = 1,
  kMultiquadric = 2,
  kInverseMultiquadric = 3,
};

// s is the profile's constant: -1/param^2 (Gaussian), -1/param (Laplacian
// RBF) or param^2 (the multiquadrics).
template <typename T, int P>
__device__ __forceinline__ T profile(T r2, T s) {
  if (P == kGaussian) return exp(r2 * s);
  if (P == kLaplacianRbf) return exp(sqrt(r2) * s);
  if (P == kMultiquadric) return sqrt(r2 + s);
  return rsqrt(r2 + s);
}

// First pass.  Block (bx, by) owns rows bx * kThreads * R + threadIdx.x +
// k * kThreads (k < R) and sources [by * split_len, (by + 1) * split_len),
// and writes its sums to out + by * n_out * c.  D: 2 or 3 unrolled, 0 =
// generic (runtime d up to kMaxD).  CH: channels accumulated per pass over
// the sources (C > CH loops over chunks).
template <typename T, int D, int P, int CH, int R>
__global__ void __launch_bounds__(kThreads)
kernel_matvec_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const T* __restrict__ x, T* __restrict__ out,
                     long long n_out, long long n_in, int d_rt, int c, T s,
                     int zero_diagonal, long long split_len) {
  constexpr int DM = D > 0 ? D : kMaxD;
  const int d = D > 0 ? D : d_rt;
  __shared__ T sb[kTile * DM];
  __shared__ T sx[kTile * CH];

  const long long row0 = (long long)blockIdx.x * (kThreads * R) + threadIdx.x;
  const long long i_begin = (long long)blockIdx.y * split_len;
  const long long i_end =
      i_begin + split_len < n_in ? i_begin + split_len : n_in;
  out += (long long)blockIdx.y * n_out * c;
  const bool any_live = row0 < n_out;
  T ai[R][DM];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long row = row0 + (long long)k * kThreads;
#pragma unroll
    for (int m = 0; m < DM; ++m)
      ai[k][m] = (row < n_out && m < d) ? a[row * d + m] : T(0);
  }

  for (int c0 = 0; c0 < c; c0 += CH) {
    const int cc = c - c0 < CH ? c - c0 : CH;
    T acc[R][CH];
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int q = 0; q < CH; ++q) acc[k][q] = T(0);

    for (long long i0 = i_begin; i0 < i_end; i0 += kTile) {
      const int tn = i_end - i0 < kTile ? (int)(i_end - i0) : kTile;
      __syncthreads();  // the previous tile is consumed
      for (int t = threadIdx.x; t < tn * d; t += kThreads) sb[t] = b[i0 * d + t];
      for (int t = threadIdx.x; t < tn * CH; t += kThreads) {
        const int j = t / CH, q = t - j * CH;
        sx[t] = q < cc ? x[(i0 + j) * c + c0 + q] : T(0);
      }
      __syncthreads();
      if (!any_live) continue;
      // the one column of this tile that is row k's diagonal, or -1
      int diag[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const long long rel = row0 + (long long)k * kThreads - i0;
        diag[k] = (zero_diagonal && rel >= 0 && rel < tn) ? (int)rel : -1;
      }
      T part[R][CH];
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int q = 0; q < CH; ++q) part[k][q] = T(0);
#pragma unroll 1
      for (int j = 0; j < tn; ++j) {
        T bj[DM], xj[CH];
#pragma unroll
        for (int m = 0; m < DM; ++m) bj[m] = m < d ? sb[j * d + m] : T(0);
#pragma unroll
        for (int q = 0; q < CH; ++q) xj[q] = sx[j * CH + q];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          T r2 = T(0);
#pragma unroll
          for (int m = 0; m < DM; ++m) {
            if (m < d) {
              const T diff = ai[k][m] - bj[m];
              r2 += diff * diff;
            }
          }
          T w = profile<T, P>(r2, s);
          if (j == diag[k]) w = T(0);
#pragma unroll
          for (int q = 0; q < CH; ++q) part[k][q] += w * xj[q];
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int q = 0; q < CH; ++q) acc[k][q] += part[k][q];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long row = row0 + (long long)k * kThreads;
#pragma unroll
      for (int q = 0; q < CH; ++q)
        if (row < n_out && q < cc) out[row * c + c0 + q] = acc[k][q];
    }
  }
}

// Second pass: y[e] = partial[0][e] + partial[1][e] + ... in split order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
add_splits_kernel(const T* __restrict__ partial, T* __restrict__ y,
                  long long elems, int splits) {
  const long long e = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= elems) return;
  T v = partial[e];
#pragma unroll 8
  for (int sp = 1; sp < splits; ++sp) v += partial[(long long)sp * elems + e];
  y[e] = v;
}

struct Args {
  const void* a;
  const void* b;
  const void* x;
  void* y;
  void* partial;
  long long n_out, n_in;
  int d, c;
  double param;
  int zero_diagonal;
  int splits;
  long long split_len;
  cudaStream_t stream;
};

template <typename T, int D, int P, int CH>
int launch_one(const Args& g) {
  constexpr int R = rows_per_thread<D, CH>();
  double s;
  if (P == kGaussian) s = -1.0 / (g.param * g.param);
  else if (P == kLaplacianRbf) s = -1.0 / g.param;
  else s = g.param * g.param;
  const long long row_blocks = (g.n_out + kThreads * R - 1) / (kThreads * R);
  T* first = static_cast<T*>(g.splits == 1 ? g.y : g.partial);
  kernel_matvec_kernel<T, D, P, CH, R>
      <<<dim3((unsigned)row_blocks, (unsigned)g.splits), kThreads, 0,
         g.stream>>>(static_cast<const T*>(g.a), static_cast<const T*>(g.b),
                     static_cast<const T*>(g.x), first, g.n_out, g.n_in, g.d,
                     g.c, (T)s, g.zero_diagonal, g.split_len);
  int rc = (int)cudaGetLastError();
  if (rc || g.splits == 1) return rc;
  const long long elems = g.n_out * g.c;
  add_splits_kernel<T>
      <<<(unsigned)((elems + kReduceThreads - 1) / kReduceThreads),
         kReduceThreads, 0, g.stream>>>(static_cast<const T*>(g.partial),
                                        static_cast<T*>(g.y), elems,
                                        g.splits);
  return (int)cudaGetLastError();
}

template <typename T, int D, int P>
int launch_chunk(const Args& g) {
  if (g.c == 1) return launch_one<T, D, P, 1>(g);
  if (g.c <= 4) return launch_one<T, D, P, 4>(g);
  return launch_one<T, D, P, 8>(g);
}

template <typename T, int D>
int launch_profile(int profile_id, const Args& g) {
  switch (profile_id) {
    case kGaussian: return launch_chunk<T, D, kGaussian>(g);
    case kLaplacianRbf: return launch_chunk<T, D, kLaplacianRbf>(g);
    case kMultiquadric: return launch_chunk<T, D, kMultiquadric>(g);
    case kInverseMultiquadric:
      return launch_chunk<T, D, kInverseMultiquadric>(g);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(int profile_id, const Args& g) {
  // every split but the last holds split_len sources, a whole number of
  // tiles, and none is empty
  if (g.d < 1 || g.d > kMaxD || g.c < 1 || g.n_out < 1 || g.n_in < 1 ||
      g.splits < 1 || g.splits > 65535 || g.split_len < 1 ||
      g.split_len % kTile != 0 ||
      (long long)(g.splits - 1) * g.split_len >= g.n_in ||
      (long long)g.splits * g.split_len < g.n_in ||
      (g.splits > 1 && g.partial == nullptr) ||
      (g.n_out + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (g.d) {
    case 2: return launch_profile<T, 2>(profile_id, g);
    case 3: return launch_profile<T, 3>(profile_id, g);
    default: return launch_profile<T, 0>(profile_id, g);
  }
}

}  // namespace

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).  `profile` indexes Profile; `param` is
// sigma (Gaussian, Laplacian RBF) or c (the multiquadrics).  The sources
// are cut into `splits` runs of `split_len` (the last may be shorter);
// with splits > 1, `partial` is scratch of splits * n_out * c values.
extern "C" {

int repro_kernel_matvec_f64(const void* a, const void* b, const void* x,
                            void* y, void* partial, long long n_out,
                            long long n_in, int d, int c, int profile,
                            double param, int zero_diagonal, int splits,
                            long long split_len, void* stream) {
  return launch<double>(profile, Args{a, b, x, y, partial, n_out, n_in, d, c,
                                      param, zero_diagonal, splits, split_len,
                                      static_cast<cudaStream_t>(stream)});
}

int repro_kernel_matvec_f32(const void* a, const void* b, const void* x,
                            void* y, void* partial, long long n_out,
                            long long n_in, int d, int c, int profile,
                            double param, int zero_diagonal, int splits,
                            long long split_len, void* stream) {
  return launch<float>(profile, Args{a, b, x, y, partial, n_out, n_in, d, c,
                                     param, zero_diagonal, splits, split_len,
                                     static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
