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
// so the i walk becomes a loop inside the block instead: each block owns
// kRows target rows, one row per thread, with the row's coordinates and its
// channel sums in registers, and streams the sources through shared memory
// in tiles of kTile points and their x values.  Every output is written
// once by the thread that owns it, after a fixed-order sum (per-tile
// partial sums added in tile order): no atomics, deterministic.
//
// What bounds it: operations.  It reads n_out*d + n_in*(d + C) values and
// writes n_out*C, but does ~(3d + profile + 2C) operations per pair, and an
// FP64 exp is a few dozen instructions.  The design keeps the per-pair work
// to the arithmetic itself: coordinates and sums stay in registers, every
// thread of a block reads the same shared-memory word at the same time
// (broadcast, no bank conflicts), the profile and the dimension are
// template parameters (d = 2, 3 unrolled; other d up to kMaxD through one
// generic loop), and the channel chunk is 1, 4 or 8 wide so C = 1 does not
// pay for eight accumulators.  exp/sqrt/rsqrt are the accurate math-library
// versions (no fast-math): the float32 tolerance depends on it.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;  // target rows per block, one per thread
constexpr int kTile = 64;  // source points staged per shared-memory tile
constexpr int kMaxD = 8;   // largest d the generic path takes

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

// D: 2 or 3 unrolled, 0 = generic (runtime d up to kMaxD).  CH: channels
// accumulated per pass over the sources (C > CH loops over chunks).
template <typename T, int D, int P, int CH>
__global__ void __launch_bounds__(kRows)
kernel_matvec_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const T* __restrict__ x, T* __restrict__ y,
                     long long n_out, long long n_in, int d_rt, int c, T s,
                     int zero_diagonal) {
  constexpr int DM = D > 0 ? D : kMaxD;
  const int d = D > 0 ? D : d_rt;
  __shared__ T sb[kTile * DM];
  __shared__ T sx[kTile * CH];

  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n_out;
  T ai[DM];
#pragma unroll
  for (int k = 0; k < DM; ++k)
    ai[k] = (live && k < d) ? a[row * d + k] : T(0);

  for (int c0 = 0; c0 < c; c0 += CH) {
    const int cc = c - c0 < CH ? c - c0 : CH;
    T acc[CH];
#pragma unroll
    for (int q = 0; q < CH; ++q) acc[q] = T(0);

    for (long long i0 = 0; i0 < n_in; i0 += kTile) {
      const int tn = n_in - i0 < kTile ? (int)(n_in - i0) : kTile;
      __syncthreads();  // the previous tile is consumed
      for (int t = threadIdx.x; t < tn * d; t += kRows) sb[t] = b[i0 * d + t];
      for (int t = threadIdx.x; t < tn * CH; t += kRows) {
        const int j = t / CH, q = t - j * CH;
        sx[t] = q < cc ? x[(i0 + j) * c + c0 + q] : T(0);
      }
      __syncthreads();
      if (!live) continue;
      // the one column of this tile that is this row's diagonal, if any
      const long long diag = zero_diagonal ? row - i0 : -1;
      T part[CH];
#pragma unroll
      for (int q = 0; q < CH; ++q) part[q] = T(0);
      for (int j = 0; j < tn; ++j) {
        T r2 = T(0);
#pragma unroll
        for (int k = 0; k < DM; ++k) {
          if (k < d) {
            const T diff = ai[k] - sb[j * d + k];
            r2 += diff * diff;
          }
        }
        T w = profile<T, P>(r2, s);
        if (j == diag) w = T(0);
#pragma unroll
        for (int q = 0; q < CH; ++q) part[q] += w * sx[j * CH + q];
      }
#pragma unroll
      for (int q = 0; q < CH; ++q) acc[q] += part[q];
    }
    if (live)
      for (int q = 0; q < cc; ++q) y[row * c + c0 + q] = acc[q];
  }
}

struct Args {
  const void* a;
  const void* b;
  const void* x;
  void* y;
  long long n_out, n_in;
  int d, c;
  double param;
  int zero_diagonal;
  cudaStream_t stream;
};

template <typename T, int D, int P, int CH>
int launch_one(const Args& g) {
  double s;
  if (P == kGaussian) s = -1.0 / (g.param * g.param);
  else if (P == kLaplacianRbf) s = -1.0 / g.param;
  else s = g.param * g.param;
  const unsigned blocks = (unsigned)((g.n_out + kRows - 1) / kRows);
  kernel_matvec_kernel<T, D, P, CH><<<blocks, kRows, 0, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b),
      static_cast<const T*>(g.x), static_cast<T*>(g.y), g.n_out, g.n_in, g.d,
      g.c, (T)s, g.zero_diagonal);
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
  if (g.d < 1 || g.d > kMaxD || g.c < 1 || g.n_out < 1 ||
      (g.n_out + kRows - 1) / kRows > 0x7fffffffLL)
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
// sigma (Gaussian, Laplacian RBF) or c (the multiquadrics).
extern "C" {

int repro_kernel_matvec_f64(const void* a, const void* b, const void* x,
                            void* y, long long n_out, long long n_in, int d,
                            int c, int profile, double param,
                            int zero_diagonal, void* stream) {
  return launch<double>(profile, Args{a, b, x, y, n_out, n_in, d, c, param,
                                      zero_diagonal,
                                      static_cast<cudaStream_t>(stream)});
}

int repro_kernel_matvec_f32(const void* a, const void* b, const void* x,
                            void* y, long long n_out, long long n_in, int d,
                            int c, int profile, double param,
                            int zero_diagonal, void* stream) {
  return launch<float>(profile, Args{a, b, x, y, n_out, n_in, d, c, param,
                                     zero_diagonal,
                                     static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
