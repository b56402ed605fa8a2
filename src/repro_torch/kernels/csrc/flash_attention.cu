// Flash attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (repro_torch/kernels/_build.py).
//
//   o[b, h, t] = softmax_k(scale * q[b, h, t] . k[b, h / G, k]) v[b, h / G, k]
//
// q (b, hq, sq, dh), k and v (b, hkv, sk, dh), o like q, all contiguous, of
// one type T in {float, bf16, fp16}; G = hq / hkv query heads share a KV head
// (GQA).  Causal masking uses decode alignment: query t sees keys
// k <= t + (sk - sq).  A row that sees no key at all (causal, sq > sk,
// t < sq - sk) is written as 0.  Accumulation is float32 whatever T is.
//
// Replaces src/repro/kernels/flash_attention.py:_flash_kernel.  The TPU
// kernel walks (q tile, KV tile) grid steps in order and carries the running
// max, normaliser and accumulator in VMEM scratch from one KV step to the
// next.  Hopper runs blocks in parallel and in no order, so the KV walk is a
// loop inside the block instead: each block owns kRows query rows of one
// (batch, q head), a query row per thread (two threads for dh = 128, each
// with half the dims, joined by one shuffle per key), with the row's q, its
// float32 accumulator and its running max and normaliser in registers.  K
// and V tiles of the block's KV head are staged through shared memory as
// float32, and every thread of a warp reads the same key at the same time
// (broadcast, 16 bytes per load).  Keys are scored kChunk at a time, so the
// accumulator is rescaled once per chunk and not once per key.  Causal
// blocks stop at the diagonal of their last row (the tiles past it are never
// read), and the heaviest causal tiles are launched first.
//
// What bounds it: operations.  It reads q, k and v once from device memory
// (per q head, K/V again from L2) and writes o once, but does 2 * dh
// multiply-adds per visible (query, key) pair.  Without tensor cores those
// run on the CUDA cores (67 TFLOP/s FP32 on the H100 SXM, against 989 for
// bf16 on the tensor cores), and each multiply-add needs a quarter of a
// shared-memory load.  A wgmma/TMA version is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;   // query rows per block
constexpr int kChunk = 16;  // keys scored per online-softmax update

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

template <int DH>
struct Shape {
  static constexpr int kDpt = DH < 64 ? DH : 64;    // dims per thread
  static constexpr int kTpr = DH / kDpt;            // threads per query row
  static constexpr int kThreads = kRows * kTpr;
  static constexpr int kKeys = DH <= 64 ? 64 : 32;  // keys per staged tile
  // floats per staged row part; the pad of 4 puts the parts of one key on
  // different banks, so the two threads of a row do not conflict
  static constexpr int kPart = kDpt + 4;
  static constexpr int kStride = kTpr * kPart;      // floats per staged key
  static_assert(kDpt % 4 == 0 && kTpr <= 2, "unsupported head dim");
};

template <typename T, int DH>
__global__ void __launch_bounds__(Shape<DH>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int sk, float scale_log2, int causal) {
  using S = Shape<DH>;
  __shared__ __align__(16) float ks[S::kKeys * S::kStride];
  __shared__ __align__(16) float vs[S::kKeys * S::kStride];

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh - b * hq;
  const long long kv_off =
      ((long long)b * hkv + h / (hq / hkv)) * (long long)sk * DH;
  const int r = threadIdx.x / S::kTpr, part = threadIdx.x - r * S::kTpr;
  const int row = tile * kRows + r;
  const bool live = row < sq;
  const int shift = sk - sq;
  // keys the block reads: all, or (causal) up to its last row's diagonal
  int k_end = sk;
  if (causal) {
    const int last = min(tile * kRows + kRows, sq) - 1;
    k_end = max(0, min(sk, last + shift + 1));
  }
  // keys this row sees: [0, row_end)
  const int row_end = causal ? min(sk, row + shift + 1) : sk;

  float qr[S::kDpt], acc[S::kDpt];
  const T* qrow = q + ((long long)bh * sq + row) * DH + part * S::kDpt;
#pragma unroll
  for (int d = 0; d < S::kDpt; ++d) {
    qr[d] = live ? to_float<T>(qrow[d]) : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < k_end; k0 += S::kKeys) {
    const int tn = min(S::kKeys, k_end - k0);
    __syncthreads();  // the previous tile is consumed
    const T* kt = k + kv_off + (long long)k0 * DH;
    const T* vt = v + kv_off + (long long)k0 * DH;
    for (int e = threadIdx.x; e < tn * DH; e += S::kThreads) {
      const int j = e / DH, c = e - j * DH;
      const int at = j * S::kStride + (c / S::kDpt) * S::kPart + c % S::kDpt;
      ks[at] = to_float<T>(kt[e]);
      vs[at] = to_float<T>(vt[e]);
    }
    __syncthreads();

    for (int j0 = 0; j0 < tn; j0 += kChunk) {
      // scores of kChunk keys, in log2 units; masked keys are -inf
      float s[kChunk];
      float m_chunk = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        float dot = 0.0f;
        if (j < tn) {  // uniform across the block
          const float4* kr = reinterpret_cast<const float4*>(
              ks + j * S::kStride + part * S::kPart);
#pragma unroll
          for (int d4 = 0; d4 < S::kDpt / 4; ++d4) {
            const float4 kk = kr[d4];
            dot = fmaf(qr[4 * d4], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
          }
        }
        if (S::kTpr == 2) dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        s[c] = (j < tn && k0 + j < row_end) ? dot * scale_log2 : -INFINITY;
        m_chunk = fmaxf(m_chunk, s[c]);
      }
      const float m_new = fmaxf(m, m_chunk);
      if (m_new == -INFINITY) continue;  // nothing visible to this row yet
      const float alpha = exp2f(m - m_new);  // 0 while m is still -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < S::kDpt; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        if (j >= tn) break;  // stale shared memory past the tile
        const float p = exp2f(s[c] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(
            vs + j * S::kStride + part * S::kPart);
#pragma unroll
        for (int d4 = 0; d4 < S::kDpt / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (live) {
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // no visible key -> 0
    T* orow = o + ((long long)bh * sq + row) * DH + part * S::kDpt;
#pragma unroll
    for (int d = 0; d < S::kDpt; ++d) orow[d] = from_float<T>(acc[d] * inv);
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, void* o, int b,
              int hq, int hkv, int sq, int sk, float scale_log2, int causal,
              cudaStream_t stream) {
  const dim3 grid((unsigned)((sq + kRows - 1) / kRows), (unsigned)(b * hq));
  flash_fwd_kernel<T, DH><<<grid, Shape<DH>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int dh, double scale, int causal,
           void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 0 ||
      (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(scale * 1.4426950408889634);  // log2(e)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_dh<T, 16>(q, k, v, o, b, hq, hkv, sq, sk,
                                     scale_log2, causal, s);
    case 32: return launch_dh<T, 32>(q, k, v, o, b, hq, hkv, sq, sk,
                                     scale_log2, causal, s);
    case 64: return launch_dh<T, 64>(q, k, v, o, b, hq, hkv, sq, sk,
                                     scale_log2, causal, s);
    case 128: return launch_dh<T, 128>(q, k, v, o, b, hq, hkv, sq, sk,
                                       scale_log2, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).  dh is 16, 32, 64 or 128.
extern "C" {

int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                              void* o, int b, int hq, int hkv, int sq, int sk,
                              int dh, double scale, int causal, void* stream) {
  return launch<float>(q, k, v, o, b, hq, hkv, sq, sk, dh, scale, causal,
                       stream);
}

int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                               void* o, int b, int hq, int hkv, int sq,
                               int sk, int dh, double scale, int causal,
                               void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, dh, scale,
                               causal, stream);
}

int repro_flash_attention_f16(const void* q, const void* k, const void* v,
                              void* o, int b, int hq, int hkv, int sq, int sk,
                              int dh, double scale, int causal, void* stream) {
  return launch<__half>(q, k, v, o, b, hq, hkv, sq, sk, dh, scale, causal,
                        stream);
}

}  // extern "C"
