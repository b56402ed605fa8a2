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
// Replaces src/repro/kernels/flash_attention.py:_flash_kernel (body :34,
// pallas_call :113).  The TPU kernel walks (q tile, KV tile) grid steps in
// order and carries the running max, normaliser and accumulator in VMEM
// scratch from one KV step to the next.  Hopper runs blocks in parallel and in no order, so the KV walk is a
// loop inside the block instead, over tiles of keys.  Causal blocks stop at
// the diagonal of their last row (the tiles past it are never read), only
// the diagonal (or ragged) tile is masked, and the heaviest causal tiles are
// launched first.  Both kernels run on the tensor cores, one by dtype:
//
// bf16 and fp16: flash_fwd_wgmma, on the tensor cores through wgmma.
//   A block is one consumer warpgroup, owning 64 query rows of one (batch,
//   q head), and one producer warp.  The producer keeps a two-stage ring of
//   K and V tiles (64 keys, in T) full with TMA copies, each tile swizzled
//   as wgmma reads it, against mbarriers: tile j + 1 loads while tile j is
//   multiplied.  A tile is column regions of 64 rows x 128 bytes in
//   128-byte swizzle (one for dh = 64, two for 128, four for 256), or one
//   region a whole row wide below dh = 64 (32- and 64-byte swizzle).  A
//   160-byte row (dh = 80) fits no single swizzle: its tile is one 64-column
//   region in 128-byte swizzle and a tail of the last 16 columns in 32-byte
//   swizzle, each with a tensor map of its own; QK's last 16-deep step reads
//   the tail, and PV is a 64-wide product on the region plus a 16-wide one
//   on the tail.  No column is padded, so no work is added.  On the H100
//   (700 W, time_flash.py at hubert's heads) this beat five 16-column
//   regions in 32-byte swizzle (five TMA boxes a tile) by ~15 % and three
//   32-column regions in 64-byte swizzle padded to 96 columns (PV at
//   n = 96) by ~7 %.  The warpgroup keeps its q rows in registers as wgmma
//   A fragments and computes S = Q K^T (K-major B from shared memory,
//   float32 accumulator).  At dh = 256 the accumulator of O alone takes 128
//   registers a thread and q's fragments would take 64 more, so that block
//   stages its 64 rows of q in shared memory once (a third TMA copy, laid
//   out like K) and QK reads A through a descriptor too: ~160 KB of shared
//   memory (K and V stages 128 KB, q 32 KB), one block an SM.  The online
//   softmax runs in float32 on the accumulator fragments: row max and sum
//   over the 4 threads of a quad, p = exp2((s - m) c) with
//   c = |scale| log2(e), the difference taken on the raw scores (exact for
//   the keys that carry the weight, so large logits lose no bits to the
//   scaling; a negative scale flips q's sign bits once, or the scores'
//   signs where q is staged, both exact).  P is then split into hi = T(p)
//   and lo = T(p - hi), straight from the S fragments in registers, and
//   O += P_hi V + P_lo V: two wgmma products with A from registers and V as
//   a transposed (MN-major) B.  One rounding of P to T (what the TPU kernel
//   and the usual tensor-core flash kernels do) leaves outputs near zero
//   up to ~30 bf16 ulps off; hi + lo keeps 16 bits of p, and the result
//   within two ulps of T of the float32 attention.  The split costs half as
//   much tensor work again as one rounding.
//   What bounds it: operations, 4 dh flops per visible (query, key) pair
//   (6 dh on the tensor cores with the split), against 989 TFLOP/s dense
//   bf16/fp16 on the H100 SXM; q, k, v are read once from device memory
//   (K/V again per q head, from L2) and o written once.  Beside the tensor
//   work, each score costs ~10 float32 operations and one exp2 on the
//   CUDA cores, and each key tile rescales the accumulator (dh / 2 float32
//   multiplies a thread); where several blocks share an SM, one block's
//   softmax overlaps another's products.  Registers set how many
//   (ptxas for sm_90a, bf16 / fp16, no spill): three at dh = 64 and at
//   dh = 80 (130 registers, 42,032 bytes of shared memory), two at 128,
//   and one at dh = 256 (207 / 205 registers, 164,920 bytes), whose
//   softmax and products take turns.  Every block also reads its head's
//   K and V whole (from L2), 64 rows of q at a time.
//
// float32: flash_fwd_tf32, on the TF32 tensor cores through mma.sync.
//   One TF32 product (10 fraction bits an operand) misses the float32 limit
//   of 2e-5: a logit's error of ~2^-11 sqrt(dh) |q| |k| scale puts outputs
//   ~60 times over it at granite-3-2b's heads (tests/test_torch_flash.py).
//   So every operand x of both products (q and K for S = Q K^T, P and V for
//   O += P V) is split into hi = TF32(x), rounded to nearest, and lo = x - hi
//   truncated to TF32, and a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi
//   (the product SDPA's float32 path takes, cutlass's OpMultiplyAddFastF32):
//   x = hi + lo to 2^-21 |x|, the left-out a_lo b_lo is ~2^-22 |a b|, and
//   the outputs stay within 0.04-0.56 of the limit of the float32 attention
//   at the paths' shapes.  The split is done on register fragments, as the
//   operands are read; nothing of it is stored.
//   A block is 4 warps, each owning 16 of the block's 64 query rows; every
//   warp reads the whole K/V tile.  K and V tiles (kKeys rows) are copied
//   by cp.async into a two-stage ring of padded rows: tile j + 1 loads while
//   tile j is multiplied.  mma.sync.m16n8k8's A is 16 x 8, its B 8 x 8.
//   The contraction over dh is taken in a permuted order, so that a lane
//   reads q's and K's two neighbouring floats of a row (8-byte loads); P's
//   A fragments are the S accumulator's own registers once the 8 keys of a
//   step are taken in the order the accumulator holds them, and V's B
//   fragments are read 4 bytes a lane at those keys.  The online softmax is
//   flash_fwd_wgmma's: float32 on the accumulator fragments, p = exp2((s -
//   m) c) taken on the raw scores.
//   Why mma.sync and not wgmma: tf32 wgmma takes K-major operands only, so
//   V would have to reach shared memory transposed, and B's low parts
//   would need tiles of their own (four tiles a stage: 256 KB at dh = 256);
//   mma.sync splits B where it is read.  On the H100 (700 W, time_flash.py
//   at granite-3-2b's heads, s = 2048, causal) it takes 0.30 ms where the
//   CUDA-core kernel it replaces took 1.38 ms (ROADMAP / PERF.md give the
//   other shapes).  A wgmma version is untried.
//   What bounds it: operations.  4 dh flops a visible (query, key) pair,
//   three times over on the TF32 tensor cores: the card's least time is
//   the work over 495 TFLOP/s (TF32, dense), and this design's own ceiling
//   three times that.  Beside the products, each split costs four integer
//   and float operations an operand element a warp reads (the split's
//   rounding is done with bit operations: cvt.rna.tf32.f32 compiles to a
//   NaN-handling sequence, a compare and a select an element, that made
//   the kernel slower), each score ~10 float32 operations and one exp2.
//   Registers (ptxas for sm_90a, no spill), dynamic shared memory and
//   blocks an SM: dh 16: 119, 22.5 KB, 4; dh 32: 142, 38.9 KB, 3; dh 64:
//   164, 71.7 KB, 3; dh 80: 183, 88.1 KB, 2; dh 128 (32 keys a tile): 219,
//   68.6 KB, 2; dh 256 (32 keys a tile, q staged in shared memory: its raw
//   fragments would take 128 registers beside the 128 of the accumulator):
//   224, 197 KB, 1.  Two 16-row m-tiles a warp (each split K and V
//   fragment feeding twice the products) ran barely faster at granite's
//   causal heads for 70 more registers, and is not taken.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// Shared by both kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// float32: the tensor-core kernel (mma.sync m16n8k8 TF32, three products)
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;      // query rows per block: 4 warps x 16
constexpr int kF32Threads = 128;
constexpr int kF32Stages = 2;     // K/V tiles in flight

// One block's shared memory: kF32Stages stages of a K tile and a V tile of
// kKeys rows, and (dh = 256) the block's 64 rows of q.  Rows are padded so
// that the fragment reads below hit 32 different banks: K (and q) rows are
// read 8 bytes a lane (lane (g, t4): row g, columns 2 t4, 2 t4 + 1), free of
// conflicts when the stride is 8 or 24 mod 32 floats; V rows 4 bytes a lane
// (rows 2 t4 and 2 t4 + 1, column g), when twice the stride is 8 mod 32.
template <int DH>
struct F32Tile {
  static_assert(DH == 16 || DH == 32 || DH == 64 || DH == 80 || DH == 128 ||
                    DH == 256,
                "unsupported head dim");
  // keys per tile: 64 while two stages leave room for three blocks an SM
  // (two at dh = 80), else 32 (at dh = 256 one block an SM either way; 32
  // keys ran 20 % faster than 16 there)
  static constexpr int kKeys = DH <= 80 ? 64 : 32;
  // blocks an SM the registers are capped for (65,536 / (128 x 170) = 3)
  static constexpr int kMinBlocks = DH <= 64 ? 3 : (DH <= 128 ? 2 : 1);
  // q as raw A fragments (DH / 2 registers) would not fit beside the
  // 128-register accumulator at dh = 256: that block stages q in shared
  // memory and reads its fragments from there
  static constexpr bool kQShared = DH == 256;
  static constexpr int kKStride = DH + 8;  // floats
  static constexpr int kVStride = DH + 4;
  static_assert(kKStride % 32 == 8 || kKStride % 32 == 24, "K stride");
  static_assert((2 * kVStride) % 32 == 8, "V stride");
  static constexpr int kSmem =
      4 * (kF32Stages * kKeys * (kKStride + kVStride) +
           (kQShared ? kF32Rows * kKStride : 0));
  static_assert(kSmem <= 232448, "over the 227 KB of shared memory a block");
};

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes zeros (rows past the end)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most one group (the newest) is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x = hi + lo to 2^-21 |x|, both TF32 (10 fraction bits, the low 13 bits
// of a float32 clear).  hi rounds x to nearest, ties away from zero: half
// a TF32 ulp added to the bits, the low bits cleared (what cvt.rna.tf32.f32
// gives for a finite x, in two integer operations where cvt's NaN handling
// compiles to five; the kernel was ~15 % slower with it).  x - hi is exact
// in float32 (|x - hi| <= 2^-11 |x|), and lo truncates it to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b, one warp: a 16 x 8 (rows g, g + 8; columns t4, t4 + 4), b 8 x 8
// (rows t4, t4 + 4; column g), d 16 x 8 (rows g, g + 8; columns 2 t4,
// 2 t4 + 1), float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// ... with both operands split: a_hi b_hi + a_hi b_lo + a_lo b_hi, the
// small products first (a_lo b_lo, ~2^-22 of a b, is left out)
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

template <int DH>
__global__ void __launch_bounds__(kF32Threads, F32Tile<DH>::kMinBlocks)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int hq,
               int hkv, int sq, int sk, float scale_log2, int causal) {
  using L = F32Tile<DH>;
  constexpr int kKeys = L::kKeys, kN = kKeys / 8, kD8 = DH / 8;
  constexpr int kRK = L::kKStride, kRV = L::kVStride;
  extern __shared__ float4 f32_smem[];
  float* const ks = reinterpret_cast<float*>(f32_smem);  // [stage][key][kRK]
  float* const vs = ks + kF32Stages * kKeys * kRK;       // [stage][key][kRV]
  float* const qs = vs + kF32Stages * kKeys * kRV;       // [row][kRK]

  const int bh = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / hq, h = bh - b * hq;
  const long long kv_off =
      ((long long)b * hkv + h / (hq / hkv)) * (long long)sk * DH;
  const float* const kh = k + kv_off;
  const float* const vh = v + kv_off;
  const int r0 = tile * kF32Rows;
  const int shift = sk - sq;
  // keys the block reads: all, or (causal) up to its last row's diagonal
  int k_end = sk;
  if (causal) {
    const int last = min(r0 + kF32Rows, sq) - 1;
    k_end = max(0, min(sk, last + shift + 1));
  }
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

  // K and V rows [j kKeys, (j + 1) kKeys) into stage st; rows past sk
  // arrive as zeros (a masked key's p is 0, and 0 v must not be NaN)
  auto load_tile = [&](int j, int st) {
    const int k0 = j * kKeys;
    float* const kd = ks + st * kKeys * kRK;
    float* const vd = vs + st * kKeys * kRV;
    for (int e = threadIdx.x; e < kKeys * DH / 4; e += kF32Threads) {
      const int r = e / (DH / 4), c = 4 * (e - r * (DH / 4));
      const bool in = k0 + r < sk;
      const long long at = in ? (long long)(k0 + r) * DH + c : 0;
      cp_async16(smem_u32(kd + r * kRK + c), kh + at, in ? 16 : 0);
      cp_async16(smem_u32(vd + r * kRV + c), vh + at, in ? 16 : 0);
    }
  };
  if constexpr (L::kQShared) {  // the block's 64 rows of q, once
    const float* const qh = q + (long long)bh * sq * DH;
    for (int e = threadIdx.x; e < kF32Rows * DH / 4; e += kF32Threads) {
      const int r = e / (DH / 4), c = 4 * (e - r * (DH / 4));
      const bool in = r0 + r < sq;
      const long long at = in ? (long long)(r0 + r) * DH + c : 0;
      cp_async16(smem_u32(qs + r * kRK + c), qh + at, in ? 16 : 0);
    }
  }
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // warp w holds rows 16 w + g and 16 w + g + 8
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = r0 + warp * 16 + g;
  // keys each row sees: [0, lim)
  const int lim0 = causal ? min(sk, wr + shift + 1) : sk;
  const int lim1 = causal ? min(sk, wr + 8 + shift + 1) : sk;
  const float cexp = fabsf(scale_log2);

  // The contraction over dh is taken in a permuted order: A column t4 of
  // an 8-deep step is dim 2 t4 and column t4 + 4 dim 2 t4 + 1, for q and
  // for K alike, so that a lane reads two neighbouring floats of a row.
  // A negative scale flips q (exact), for cexp = |scale_log2|; where q is
  // staged, the scores' signs flip instead (exact too).
  float qf[L::kQShared ? 1 : kD8][4];
  if constexpr (!L::kQShared) {
    const float sgn = scale_log2 < 0.0f ? -1.0f : 1.0f;
    const float* const q0 = q + ((long long)bh * sq + wr) * DH + 2 * t4;
    const bool live0 = wr < sq, live1 = wr + 8 < sq;
#pragma unroll
    for (int kk = 0; kk < kD8; ++kk) {
      const float2 x0 = live0 ? *reinterpret_cast<const float2*>(q0 + 8 * kk)
                              : make_float2(0.0f, 0.0f);
      const float2 x1 =
          live1 ? *reinterpret_cast<const float2*>(q0 + 8 * DH + 8 * kk)
                : make_float2(0.0f, 0.0f);
      qf[kk][0] = sgn * x0.x;  // row g, dim 8 kk + 2 t4
      qf[kk][1] = sgn * x1.x;  // row g + 8
      qf[kk][2] = sgn * x0.y;  // row g, dim 8 kk + 2 t4 + 1
      qf[kk][3] = sgn * x1.y;
    }
  }

  float acc[kD8][4];
#pragma unroll
  for (int n = 0; n < kD8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) load_tile(j + 1, st ^ 1);
    cp_async_commit();  // empty on the last tile
    cp_async_wait_one();  // tile j (and q) landed
    __syncthreads();
    const int k0 = j * kKeys;
    const float* const kt = ks + st * kKeys * kRK;
    const float* const vt = vs + st * kKeys * kRV;

    // S = Q K^T, 64 rows x kKeys keys, three TF32 products an 8-deep step
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kD8; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (L::kQShared) {
        const float* const qr = qs + (warp * 16 + g) * kRK + 8 * kk + 2 * t4;
        const float2 x0 = *reinterpret_cast<const float2*>(qr);
        const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * kRK);
        split_tf32(x0.x, ah[0], al[0]);
        split_tf32(x1.x, ah[1], al[1]);
        split_tf32(x0.y, ah[2], al[2]);
        split_tf32(x1.y, ah[3], al[3]);
      } else {
        // split anew every tile: hoisted out of the loop, q's hi and lo
        // would hold dh / 2 more registers a thread (a spill at dh = 128)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = qf[kk][e];
          asm volatile("" : "+f"(x));
          split_tf32(x, ah[e], al[e]);
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float2 kx = *reinterpret_cast<const float2*>(
            kt + (8 * n + g) * kRK + 8 * kk + 2 * t4);
        uint32_t bh2[2], bl2[2];
        split_tf32(kx.x, bh2[0], bl2[0]);
        split_tf32(kx.y, bh2[1], bl2[1]);
        mma_tf32x3(s[n], ah, al, bh2, bl2);
      }
    }
    if constexpr (L::kQShared) {
      if (scale_log2 < 0.0f) {
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = -s[n][e];
      }
    }

    // only a ragged or diagonal tile is masked
    const bool masked =
        k0 + kKeys > sk || (causal && k0 + kKeys - 1 > r0 + shift);
    if (masked) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + t4 * 2 + (e & 1);
          if (key >= (e < 2 ? lim0 : lim1)) s[n][e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with nothing visible yet keeps m = -inf: subtract 0 instead,
    // and its alpha is 0, never NaN
    const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float alpha0 = m0 == -INFINITY ? 0.0f : ex2((m0 - mu0) * cexp);
    const float alpha1 = m1 == -INFINITY ? 0.0f : ex2((m1 - mu1) * cexp);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < kD8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
    if (masked) {  // a masked key is 0 even at scale 0 (-inf * 0 is NaN)
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = s[n][e] == -INFINITY
                        ? 0.0f
                        : ex2((s[n][e] - (e < 2 ? mu0 : mu1)) * cexp);
    } else {
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = ex2((s[n][e] - (e < 2 ? mu0 : mu1)) * cexp);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // O += P V, three TF32 products an 8-key step.  The S fragment of
    // 8-key block kb holds keys 2 t4 and 2 t4 + 1 of rows g and g + 8: it
    // is the A fragment of that step when A column t4 stands for key 2 t4
    // and t4 + 4 for key 2 t4 + 1, so a lane's B is V at those two keys.
#pragma unroll
    for (int kb = 0; kb < kN; ++kb) {
      uint32_t ph[4], pl[4];
      split_tf32(s[kb][0], ph[0], pl[0]);  // row g, key 2 t4
      split_tf32(s[kb][2], ph[1], pl[1]);  // row g + 8, key 2 t4
      split_tf32(s[kb][1], ph[2], pl[2]);  // row g, key 2 t4 + 1
      split_tf32(s[kb][3], ph[3], pl[3]);  // row g + 8, key 2 t4 + 1
      const float* const v0 = vt + (8 * kb + 2 * t4) * kRV + g;
#pragma unroll
      for (int n = 0; n < kD8; ++n) {
        uint32_t bh2[2], bl2[2];
        split_tf32(v0[8 * n], bh2[0], bl2[0]);
        split_tf32(v0[kRV + 8 * n], bh2[1], bl2[1]);
        mma_tf32x3(acc[n], ph, pl, bh2, bl2);
      }
    }
    __syncthreads();  // stage st is consumed before tile j + 2 lands there
  }

  // the row sums over the quad; no visible key -> 0
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  float* const orow = o + ((long long)bh * sq + wr) * DH + t4 * 2;
  const bool live0 = wr < sq, live1 = wr + 8 < sq;
#pragma unroll
  for (int n = 0; n < kD8; ++n) {
    if (live0)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (live1)
      *reinterpret_cast<float2*>(orow + 8 * DH + n * 8) =
          make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int DH>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int sq, int sk, float scale_log2, int causal,
                cudaStream_t stream) {
  const int tiles = (sq + kF32Rows - 1) / kF32Rows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  if (sk == 0)  // no row sees a key
    return (int)cudaMemsetAsync(o, 0, (size_t)b * hq * sq * DH * sizeof(float),
                                stream);
  constexpr int smem = F32Tile<DH>::kSmem;
  // above the 48 KB default only after an explicit opt-in; at dh 16 and 32
  // none is asked, so a latency-bound launch makes no extra CUDA call
  if (smem > 48 * 1024) {
    const cudaError_t set = cudaFuncSetAttribute(
        flash_fwd_tf32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (set != cudaSuccess) return (int)set;
  }
  const dim3 grid((unsigned)(b * hq), (unsigned)tiles);
  flash_fwd_tf32<DH><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, sk,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;      // query rows per block: one warpgroup
constexpr int kTcKeys = 64;      // keys per K/V tile
constexpr int kTcStages = 2;     // K/V tiles in flight
constexpr int kTcThreads = 160;  // warps 0-3 consume, warp 4 loads

// One 64-row tile of dh elements in shared memory, as TMA writes it and as
// wgmma reads it: kRegions column regions of 64 rows x kSw bytes, swizzled
// kSw bytes wide (128, or a whole row below dh = 64), then, at dh = 80, a
// tail region of the last 16 columns, 64 rows x 32 bytes in 32-byte swizzle.
template <int DH>
struct TcTile {
  static_assert(DH == 16 || DH == 32 || DH == 64 || DH == 80 || DH == 128 ||
                    DH == 256,
                "unsupported head dim");
  static constexpr int kSw = DH >= 64 ? 128 : DH * 2;  // swizzle bytes
  static constexpr int kBoxCols = kSw / 2;              // elements
  static constexpr int kRegions = DH / kBoxCols;
  static constexpr int kMain = kRegions * kBoxCols;     // columns
  static constexpr int kTail = DH - kMain;              // columns
  static_assert(kTail == 0 || kTail == 16, "unsupported head dim");
  static constexpr int kRegionBytes = 64 * kSw;
  static constexpr int kTailAt = kRegions * kRegionBytes;  // byte offset
  static constexpr int kBytes = 64 * DH * 2;
  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kSw == 128 ? 1 : (kSw == 64 ? 2 : 3);
  static constexpr int kTailSw = 2 * kTail;  // bytes: a tail row, swizzled
  static constexpr uint64_t kTailLayout = 3;
  // q as A fragments (DH / 4 registers) would not fit beside a 128-register
  // accumulator at dh = 256: its block stages q in shared memory instead,
  // and the QK product reads A through a descriptor
  static constexpr bool kQShared = DH == 256;
  // dynamic shared memory: kTcStages stages of K and V, q's tile where it
  // is staged, 1024 bytes of alignment slack, 3 barriers a stage (+ q's)
  static constexpr int kSmem = 2 * kTcStages * kBytes +
                               (kQShared ? kBytes + 8 : 0) + 1024 +
                               24 * kTcStages;
  static_assert(kSmem <= 232448, "over the 227 KB of shared memory a block");
};

// a shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits for the phase of `parity` to complete.  A wait that never ends
// (a lost copy) traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 24)) __trap();
  }
}

// rows [row, row + 64) of one head, columns from col on, through `map`
// (whose box is one column region) into dst; rows past the head's end
// arrive as zeros
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int row,
                                        int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}
// ... a whole tile: every region through `map`, the tail through `tail`
template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         const CUtensorMap* tail,
                                         uint32_t bar, int row, int head) {
  using L = TcTile<DH>;
#pragma unroll
  for (int r = 0; r < L::kRegions; ++r)
    tma_box(dst + r * L::kRegionBytes, map, bar, r * L::kBoxCols, row, head);
  if constexpr (L::kTail > 0)
    tma_box(dst + L::kTailAt, tail, bar, L::kMain, row, head);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products
template <int R, int C>
__device__ __forceinline__ void wg_pin(float (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

// (x, y) -> hi = T(x), T(y) packed, and lo = T(x - hi.x), T(y - hi.y)
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo);
template <>
__device__ __forceinline__ void split2<__nv_bfloat16>(float x, float y,
                                                      uint32_t& hi,
                                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
template <>
__device__ __forceinline__ void split2<__half>(float x, float y, uint32_t& hi,
                                               uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d (+)= a b for the warpgroup's 64 rows, A from registers (the layout of
// mma.m16n8k16's A, one warp per 16 rows), B through a descriptor; d is
// laid out as mma.m16n8k16's accumulator, one [4] per 8 columns.
// S = Q K^T: m64n64k16, K-major B; `accumulate` = 0 overwrites d.
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);
// The same with A (q) from shared memory through a descriptor too.
template <typename T>
__device__ __forceinline__ void wgmma_qk_ss(float (&d)[8][4], uint64_t a,
                                            uint64_t b, int accumulate);
// O += P V: m64nNk16, V as a transposed (MN-major) B; N = dh, or at
// dh = 80 N = 64 on the region and N = 16 on the tail.
template <typename T, int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t b);

#define REPRO_ACC(i) \
  "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

template <>
__device__ __forceinline__ void wgmma_qk<__nv_bfloat16>(
    float (&d)[8][4], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_pv<__nv_bfloat16, 16>(
    float (&d)[2][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__nv_bfloat16, 32>(
    float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__nv_bfloat16, 64>(
    float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_qk_ss<__nv_bfloat16>(
    float (&d)[8][4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_pv<__nv_bfloat16, 128>(
    float (&d)[16][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7), REPRO_ACC(8), REPRO_ACC(9),
        REPRO_ACC(10), REPRO_ACC(11), REPRO_ACC(12), REPRO_ACC(13),
        REPRO_ACC(14), REPRO_ACC(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__nv_bfloat16, 256>(
    float (&d)[32][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7), REPRO_ACC(8), REPRO_ACC(9),
        REPRO_ACC(10), REPRO_ACC(11), REPRO_ACC(12), REPRO_ACC(13),
        REPRO_ACC(14), REPRO_ACC(15), REPRO_ACC(16), REPRO_ACC(17),
        REPRO_ACC(18), REPRO_ACC(19), REPRO_ACC(20), REPRO_ACC(21),
        REPRO_ACC(22), REPRO_ACC(23), REPRO_ACC(24), REPRO_ACC(25),
        REPRO_ACC(26), REPRO_ACC(27), REPRO_ACC(28), REPRO_ACC(29),
        REPRO_ACC(30), REPRO_ACC(31)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_qk<__half>(
    float (&d)[8][4], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 16>(
    float (&d)[2][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 32>(
    float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 64>(
    float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_qk_ss<__half>(
    float (&d)[8][4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 128>(
    float (&d)[16][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7), REPRO_ACC(8), REPRO_ACC(9),
        REPRO_ACC(10), REPRO_ACC(11), REPRO_ACC(12), REPRO_ACC(13),
        REPRO_ACC(14), REPRO_ACC(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 256>(
    float (&d)[32][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : REPRO_ACC(0), REPRO_ACC(1), REPRO_ACC(2), REPRO_ACC(3), REPRO_ACC(4),
        REPRO_ACC(5), REPRO_ACC(6), REPRO_ACC(7), REPRO_ACC(8), REPRO_ACC(9),
        REPRO_ACC(10), REPRO_ACC(11), REPRO_ACC(12), REPRO_ACC(13),
        REPRO_ACC(14), REPRO_ACC(15), REPRO_ACC(16), REPRO_ACC(17),
        REPRO_ACC(18), REPRO_ACC(19), REPRO_ACC(20), REPRO_ACC(21),
        REPRO_ACC(22), REPRO_ACC(23), REPRO_ACC(24), REPRO_ACC(25),
        REPRO_ACC(26), REPRO_ACC(27), REPRO_ACC(28), REPRO_ACC(29),
        REPRO_ACC(30), REPRO_ACC(31)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef REPRO_ACC

template <typename T, int DH>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_wgmma(const T* __restrict__ q,
                const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_k_tail,
                const __grid_constant__ CUtensorMap tm_v_tail,
                T* __restrict__ o, int hq, int hkv, int sq, int sk,
                float scale_log2, int causal) {
  using L = TcTile<DH>;
  constexpr int kD8 = DH / 8;  // 8-wide column blocks of O
  extern __shared__ unsigned char tc_smem[];
  // 1024-byte aligned stages of K, then of V, then q's tile where it is
  // staged; then the barriers
  const uint32_t base = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + kTcStages * L::kBytes;
  const uint32_t q_s = base + 2 * kTcStages * L::kBytes;
  const uint32_t bars = q_s + (L::kQShared ? L::kBytes : 0);
  const uint32_t k_full = bars, v_full = bars + 8 * kTcStages,
                 empty = bars + 16 * kTcStages,  // + stage * 8
                 q_full = bars + 24 * kTcStages;

  const int bh = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / hq, h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int r0 = tile * kTcRows;
  const int shift = sk - sq;
  // keys the block reads: all, or (causal) up to its last row's diagonal
  int k_end = sk;
  if (causal) {
    const int last = min(r0 + kTcRows, sq) - 1;
    k_end = max(0, min(sk, last + shift + 1));
  }
  const int n_tiles = (k_end + kTcKeys - 1) / kTcKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 128);  // every consumer thread arrives
    }
    if (L::kQShared) mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer: one thread issues every copy
    if (lane == 0) {
      if (L::kQShared && n_tiles > 0) {  // the block's 64 rows of q, once
        mbar_expect_tx(q_full, L::kBytes);
        tma_tile<DH>(q_s, &tm_q, nullptr, q_full, r0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kTcStages;
        if (j >= kTcStages)  // the stage's previous tile is consumed
          mbar_wait(empty + 8 * st, (j / kTcStages - 1) & 1);
        mbar_expect_tx(k_full + 8 * st, L::kBytes);
        tma_tile<DH>(k_s + st * L::kBytes, &tm_k, &tm_k_tail,
                     k_full + 8 * st, j * kTcKeys, kvh);
        mbar_expect_tx(v_full + 8 * st, L::kBytes);
        tma_tile<DH>(v_s + st * L::kBytes, &tm_v, &tm_v_tail,
                     v_full + 8 * st, j * kTcKeys, kvh);
      }
    }
    return;
  }

  // consumer warpgroup: warp w holds rows 16 w + g and 16 w + g + 8
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = r0 + warp * 16 + g;
  // keys each row sees: [0, lim)
  const int lim0 = causal ? min(sk, wr + shift + 1) : sk;
  const int lim1 = causal ? min(sk, wr + 8 + shift + 1) : sk;
  const float cexp = fabsf(scale_log2);

  // the rows' q as A fragments, straight from device memory; a negative
  // scale flips their sign bits (exact), for cexp = |scale_log2|.  Where q
  // is staged in shared memory, the scores' signs flip instead (exact too).
  uint32_t qf[L::kQShared ? 1 : DH / 16][4];
  if constexpr (L::kQShared) {
    if (n_tiles > 0) mbar_wait(q_full, 0);
  } else {
    const uint32_t flip = scale_log2 < 0.0f ? 0x80008000u : 0u;
    const T* q0 = q + ((long long)bh * sq + wr) * DH + t4 * 2;
    const bool live0 = wr < sq, live1 = wr + 8 < sq;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t* p0 = reinterpret_cast<const uint32_t*>(q0 + kk * 16);
      const uint32_t* p1 =
          reinterpret_cast<const uint32_t*>(q0 + kk * 16 + 8 * DH);
      qf[kk][0] = live0 ? p0[0] ^ flip : 0u;  // row g, columns 2 t4 + {0, 1}
      qf[kk][1] = live1 ? p1[0] ^ flip : 0u;  // row g + 8
      qf[kk][2] = live0 ? p0[4] ^ flip : 0u;  // row g, columns + 8
      qf[kk][3] = live1 ? p1[4] ^ flip : 0u;
    }
  }

  float acc[kD8][4];
#pragma unroll
  for (int n = 0; n < kD8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTcKeys;
    const int st = j % kTcStages;
    const uint32_t phase = (j / kTcStages) & 1;
    const uint32_t kt = k_s + st * L::kBytes, vt = v_s + st * L::kBytes;

    // S = Q K^T, 64 rows x 64 keys; a 16-deep k step moves 32 bytes along
    // a swizzled row, or to the next column region or the tail (of K, and
    // of a staged q laid out the same way)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    mbar_wait(k_full + 8 * st, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bool tail = kk * 16 >= L::kMain;
      const uint32_t off = tail ? L::kTailAt
                                : (kk * 16 / L::kBoxCols) * L::kRegionBytes +
                                      (kk * 16 % L::kBoxCols) * 2;
      const uint32_t sbo = 8 * (tail ? L::kTailSw : L::kSw);
      const uint64_t lay = tail ? L::kTailLayout : L::kLayout;
      const uint64_t kd = wg_desc(kt + off, 16, sbo, lay);
      if constexpr (L::kQShared)
        wgmma_qk_ss<T>(s, wg_desc(q_s + off, 16, sbo, lay), kd, kk > 0);
      else
        wgmma_qk<T>(s, qf[kk], kd, kk > 0);
    }
    wg_commit_wait();
    wg_pin(s);
    if constexpr (L::kQShared) {
      if (scale_log2 < 0.0f) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = -s[n][e];
      }
    }

    // only a ragged or diagonal tile is masked
    const bool masked =
        k0 + kTcKeys > sk || (causal && k0 + kTcKeys - 1 > r0 + shift);
    if (masked) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + t4 * 2 + (e & 1);
          if (key >= (e < 2 ? lim0 : lim1)) s[n][e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with nothing visible yet keeps m = -inf: subtract 0 instead,
    // and its alpha is 0, never NaN
    const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float alpha0 = m0 == -INFINITY ? 0.0f : ex2((m0 - mu0) * cexp);
    const float alpha1 = m1 == -INFINITY ? 0.0f : ex2((m1 - mu1) * cexp);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < kD8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
    if (masked) {  // a masked key is 0 even at scale 0 (-inf * 0 is NaN)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = s[n][e] == -INFINITY
                        ? 0.0f
                        : ex2((s[n][e] - (e < 2 ? mu0 : mu1)) * cexp);
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = ex2((s[n][e] - (e < 2 ? mu0 : mu1)) * cexp);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // O += P_hi V + P_lo V.  The S fragments of 8-key blocks 2 kk and
    // 2 kk + 1 are the A fragment of 16-key step kk; a step is two 8-row
    // swizzle groups further on in V.  At dh = 80 the regions give O's first
    // 64 columns and the tail, in a product of its own, the last 16.
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split2<T>(s[2 * kk][0], s[2 * kk][1], p_hi[kk][0], p_lo[kk][0]);
      split2<T>(s[2 * kk][2], s[2 * kk][3], p_hi[kk][1], p_lo[kk][1]);
      split2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], p_hi[kk][2],
                p_lo[kk][2]);
      split2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], p_hi[kk][3],
                p_lo[kk][3]);
    }
    mbar_wait(v_full + 8 * st, phase);
    wg_pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = wg_desc(vt + kk * 16 * L::kSw, L::kRegionBytes,
                                  8 * L::kSw, L::kLayout);
      auto& am = reinterpret_cast<float(&)[L::kMain / 8][4]>(acc[0]);
      wgmma_pv<T, L::kMain>(am, p_hi[kk], vd);
      wgmma_pv<T, L::kMain>(am, p_lo[kk], vd);
      if constexpr (L::kTail > 0) {
        const uint64_t td =
            wg_desc(vt + L::kTailAt + kk * 16 * L::kTailSw, 64 * L::kTailSw,
                    8 * L::kTailSw, L::kTailLayout);
        auto& at = reinterpret_cast<float(&)[L::kTail / 8][4]>(
            acc[L::kMain / 8]);
        wgmma_pv<T, L::kTail>(at, p_hi[kk], td);
        wgmma_pv<T, L::kTail>(at, p_lo[kk], td);
      }
    }
    wg_commit_wait();
    wg_pin(acc);
    mbar_arrive(empty + 8 * st);  // this stage may be refilled
  }

  // the row sums over the quad; no visible key -> 0
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  T* orow = o + ((long long)bh * sq + wr) * DH + t4 * 2;
  const bool live0 = wr < sq, live1 = wr + 8 < sq;
#pragma unroll
  for (int n = 0; n < kD8; ++n) {
    if (live0)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack2<T>(acc[n][0] * inv0, acc[n][1] * inv0);
    if (live1)
      *reinterpret_cast<uint32_t*>(orow + 8 * DH + n * 8) =
          pack2<T>(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// links no libcuda
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// q, K or V as (heads, rows, dh), in boxes of 64 rows x box_cols columns
// (one region, or the tail) in sw-byte swizzle
template <typename T, int DH>
bool make_tensor_map(CUtensorMap* map, const void* ptr, int rows, int heads,
                     int box_cols, int sw) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)DH * sizeof(T),
                                 (cuuint64_t)rows * DH * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map,
                std::is_same<T, __half>::value
                    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int hq, int hkv, int sq, int sk, float scale_log2, int causal,
              cudaStream_t stream) {
  const int tiles = (sq + kTcRows - 1) / kTcRows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  if (sk == 0)  // no row sees a key
    return (int)cudaMemsetAsync(o, 0, (size_t)b * hq * sq * DH * sizeof(T),
                                stream);
  using L = TcTile<DH>;
  // q's map is read only where q is staged, the tails' only at dh = 80
  CUtensorMap tq = {}, tk, tv, tk_tail = {}, tv_tail = {};
  const int bc = L::kBoxCols, sw = L::kSw, tc = L::kTail, tsw = L::kTailSw;
  if ((L::kQShared && !make_tensor_map<T, DH>(&tq, q, sq, b * hq, bc, sw)) ||
      !make_tensor_map<T, DH>(&tk, k, sk, b * hkv, bc, sw) ||
      !make_tensor_map<T, DH>(&tv, v, sk, b * hkv, bc, sw) ||
      (tc > 0 && (!make_tensor_map<T, DH>(&tk_tail, k, sk, b * hkv, tc, tsw) ||
                  !make_tensor_map<T, DH>(&tv_tail, v, sk, b * hkv, tc, tsw))))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = L::kSmem;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_fwd_wgmma<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)(b * hq), (unsigned)tiles);
  flash_fwd_wgmma<T, DH><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), tq, tk, tv, tk_tail, tv_tail,
      static_cast<T*>(o), hq, hkv, sq, sk, scale_log2, causal);
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
  // float32 on mma.sync (TF32, three products), bf16 / fp16 on wgmma
#define REPRO_FLASH_DH(DH)                                                  \
  case DH:                                                                  \
    if constexpr (std::is_same<T, float>::value)                            \
      return launch_tf32<DH>(q, k, v, o, b, hq, hkv, sq, sk, scale_log2,    \
                             causal, s);                                    \
    else                                                                    \
      return launch_tc<T, DH>(q, k, v, o, b, hq, hkv, sq, sk, scale_log2,   \
                              causal, s);
  switch (dh) {
    REPRO_FLASH_DH(16)
    REPRO_FLASH_DH(32)
    REPRO_FLASH_DH(64)
    REPRO_FLASH_DH(80)
    REPRO_FLASH_DH(128)
    REPRO_FLASH_DH(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_DH
}

}  // namespace

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).  dh is 16, 32, 64, 80, 128 or 256.
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
