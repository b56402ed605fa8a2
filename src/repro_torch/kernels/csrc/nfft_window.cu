// NFFT window spread and gather for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// Both kernels work on the fused engine's separable window geometry:
//   base    (n, d)        int32  leftmost tap corner in padded-grid coords
//   weights (n, d, taps)  T      per-dimension window values
//   grid    (P,)^d x C    T      channels-last, wrap-padded (P = M + taps - 1)
//   x / out (n, C)        T      node values, Morton-sorted rows
// with d in {1, 2, 3}, T in {float, double}, C >= 1 at run time, and a
// tile plan (repro_torch/kernels/nfft_window.py: build_tile_plan):
//   tiles   (n_tiles, 11) int32  first row, row count, box corner[3],
//                                box extent[3], first window tap[3]
//                                (unused axes: 0, 1 and 0)
// that cuts the rows into contiguous tiles of at most 64 rows, each with
// the bounding box of its windows; a box holds at most 6,144 cells (48 KB
// of float64).  Where one window exceeds that, each row's window is cut
// along its leading axes into pieces that fit, one single-row tile each,
// consecutive in the table: taps [first, first + extent) on each axis, the
// box corner at base + first.  One block walks one tile, except that one
// gather block walks all pieces of a row.  Every grid offset is 64-bit.
//
// window_spread replaces src/repro/kernels/nfft_window.py:_spread_kernel.
//   The TPU kernel keeps the whole padded grid resident in VMEM as one
//   revisited output block.  Hopper runs blocks in parallel and in no
//   order, and a SETUP_3 grid (142^3 x 8 B = 22.9 MB a channel) is far
//   beyond 227 KB of shared memory, so the grid stays in global memory.
//   What bounds a scatter there is the number of global atomics: the main
//   path's Morton-sorted spiral nodes collapse onto a few thousand window
//   corners, so one atomic per (node, cell, channel), 3.4e8 at n = 10^5,
//   SETUP_3, serialises on a few thousand contended L2 lines.  This kernel
//   is output-stationary.  A block stages its tile's weights, corners and
//   up to 4 channels of x in shared memory; a thread owns up to 8 cells of
//   one column of the box (its first axis) at one cell of the box's other
//   axes, and sums the tile's nodes into registers in row order: one
//   window test and plane weight per node, then w0 * (w1 * w2) * x per
//   column cell inside the window.  The sum within a tile has a fixed
//   order.  How the boxes reach the grid is the kernel's one mode switch:
//   * atomic (repro_window_spread_*): each cell goes to the grid with one
//     atomicAdd per channel, coalesced along the last axis (neighbouring
//     tiles' boxes overlap): ~n * box / 64 global atomics, ~50x fewer than
//     one per node, at the price of box / taps^d window tests (1.0-1.2 on
//     the main path).  By the data-sheet roofline it is operation-bound;
//     in practice instruction issue and latency bound it.  The order in
//     which tiles land, and so the result's last bits, vary from run to
//     run.
//   * deterministic (repro_window_spread_det_*): the tiles run in waves
//     of consecutive tiles whose boxes, times the call's C channels, fit a
//     scratch cap (nfft_window.py: DET_SCRATCH_BYTES).  Phase A of a wave
//     is the same kernel over all C channels in one launch, but each tile
//     stores its whole box, zeros included, with plain coalesced stores
//     into the scratch at the tile's own int32 offset (C order, one plane
//     of the wave's cells per channel).  Phase B (reduce_blocks_kernel)
//     cuts the padded grid into
//     aligned output blocks of side^d cells and runs one block per chunk
//     of an output block's ascending tile list (nfft_window.py:
//     spread_block_index, cached on the plan): its threads own the output
//     block's cells x channels in registers and add, tile by tile in
//     ascending order, the part of each tile's box inside the output
//     block, read from the scratch in runs along the box's last axis.  A
//     block whose list is one chunk stores its cells; otherwise each chunk
//     writes a partial, and the chunk that arrives last at its output
//     block (a counter a block, __threadfence before the atomicAdd, reset
//     to 0 by the block that sums) adds the partials in chunk order.  From
//     the second wave on, the cells are added onto the grid (each by one
//     thread: load, add, store).  A cell's sum runs over waves, then
//     chunks, then tiles, in an order fixed by the index alone, never by
//     SM count or timing: two runs give the same bits.  The Python wrapper
//     picks this mode when torch.are_deterministic_algorithms_enabled() is
//     true.
//
// window_gather replaces src/repro/kernels/nfft_window.py:_gather_kernel.
//   A block stages its tile's box in shared memory once, coalesced along
//   the last axis, as many channels wide (a power of two up to 8) as fit
//   48 KB, so the ~56 nodes of a tile that read each cell read it from
//   shared memory.  A warp contracts one node: its lanes own the window's
//   cells on the last two axes (up to 8 each, weight and offset in
//   registers), and for d = 3 it walks the first axis one box plane per
//   tap.  A shuffle butterfly sums the lanes in a fixed order.  It is
//   read-only on the grid and deterministic.  It is operation-bound by the
//   same roofline; shared-memory reads and their latency bound it in
//   practice.
//
// Pieces of a window over the budget.  The spread needs nothing more: a
//   thread only visits its box's cells, and a cell's window tap is its
//   offset from the node's base, so a piece adds exactly its own taps and
//   two pieces never add the same cell.  The gather block that owns a
//   row's first piece walks all of the row's pieces in table order,
//   staging each piece's box in turn and adding the pieces' sums in that
//   order (the blocks of the other pieces return at once): deterministic,
//   no scratch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;       // gather: channels in registers per pass
constexpr int kSpreadChunk = 4;  // spread: channels in registers per pass
constexpr int kCol = 8;         // spread: column cells a thread owns
constexpr int kPlane = 8;       // gather: window-plane cells a lane owns
constexpr int kTileCols = 11;
constexpr int kBoxBytes = 48 * 1024;  // a box's shared memory (BOX_BYTES)

struct Tile {
  int start, count;
  int corner[3], ext[3];
};

__device__ inline Tile load_tile(const int* __restrict__ tiles,
                                 long long index) {
  const int* t = tiles + index * kTileCols;
  Tile out;
  out.start = t[0];
  out.count = t[1];
  for (int a = 0; a < 3; ++a) {
    out.corner[a] = t[2 + a];
    out.ext[a] = t[5 + a];
  }
  return out;
}

// The first window tap a tile covers on axis a (0 for whole windows).
__device__ inline int tile_first(const int* __restrict__ tiles,
                                 long long index, int a) {
  return tiles[index * kTileCols + 8 + a];
}

// Stage a tile's weights and its corners relative to the box corner.
template <typename T, int D>
__device__ inline void stage_nodes(const Tile& tile, const int* __restrict__ base,
                                   const T* __restrict__ w, int taps, T* sw,
                                   int* sb) {
  const long long row0 = tile.start;
  for (int i = threadIdx.x; i < tile.count * D * taps; i += blockDim.x)
    sw[i] = w[row0 * D * taps + i];
  for (int i = threadIdx.x; i < tile.count * D; i += blockDim.x)
    sb[i] = base[row0 * D + i] - tile.corner[i % D];
}

// Spread.  A thread owns up to kCol cells of one column of the box (the
// first axis; for d = 1 one cell) at one cell of the box's "plane" (the
// other axes); consecutive threads take consecutive plane cells, so the
// flush is coalesced along the last axis.  For each node of the tile, in
// row order, a thread tests its plane cell against the node's window once,
// forms the plane weight, and then adds w0 * (w_plane * x) to each of its
// column cells inside the window.  CC channels ride along in registers.
// Channels [c_lo, c_hi) are spread, `chunk` at a time.  kDet: each pass's
// box is stored at scratch[(c0 + q) * pitch + box_off[tile] + cell] (cell
// in C order over the box, one plane of `pitch` cells per channel) instead
// of added to the grid.
template <typename T, int D, int CC, bool kDet>
__global__ void __launch_bounds__(kThreads)
spread_kernel(const T* __restrict__ x, const int* __restrict__ base,
              const T* __restrict__ w, T* __restrict__ grid,
              const int* __restrict__ tiles, int taps, int c, long long P,
              int chunk, int max_rows, int c_lo, int c_hi,
              T* __restrict__ scratch, const int* __restrict__ box_off,
              long long pitch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile tile = load_tile(tiles, blockIdx.x);
  T* sw = reinterpret_cast<T*>(smem);           // max_rows * D * taps
  T* sx = sw + (long long)max_rows * D * taps;  // max_rows * chunk
  int* sb = reinterpret_cast<int*>(sx + (long long)max_rows * chunk);
  stage_nodes<T, D>(tile, base, w, taps, sw, sb);

  // column: axis 0 for d >= 2; plane: the remaining axes (d = 1: axis 0)
  const int col_len = D > 1 ? tile.ext[0] : 1;
  int plane = 1;
  for (int a = (D > 1 ? 1 : 0); a < D; ++a) plane *= tile.ext[a];
  const int segs = (col_len + kCol - 1) / kCol;
  const int seg_len = (col_len + segs - 1) / segs;  // balanced, <= kCol
  const int items = plane * segs;
  const long long row0 = tile.start;

  for (int c0 = c_lo; c0 < c_hi; c0 += chunk) {
    const int cc = min(chunk, c_hi - c0);
    __syncthreads();  // the last chunk's readers are done
    for (int i = threadIdx.x; i < tile.count * cc; i += blockDim.x) {
      const int r = i / cc, q = i - r * cc;
      sx[r * chunk + q] = x[(row0 + r) * c + c0 + q];
    }
    __syncthreads();
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int seg = item / plane, pc = item - seg * plane;
      const int k0 = seg * seg_len;                 // first column cell
      const int nk = min(seg_len, col_len - k0);    // column cells owned
      // plane coordinates: (p1, p2) for d = 3, p1 for d = 2, p0 for d = 1
      const int p_last = D == 3 ? pc % tile.ext[2] : pc;
      const int p_mid = D == 3 ? pc / tile.ext[2] : 0;
      T acc[kCol][CC];
#pragma unroll
      for (int k = 0; k < kCol; ++k)
#pragma unroll
        for (int q = 0; q < CC; ++q) acc[k][q] = T(0);
      for (int r = 0; r < tile.count; ++r) {
        const int* b = sb + r * D;
        const T* wr = sw + r * D * taps;
        const T* xr = sx + r * chunk;
        T xq[CC];
#pragma unroll
        for (int q = 0; q < CC; ++q) xq[q] = q < cc ? xr[q] : T(0);
        if constexpr (D == 1) {
          const unsigned i0 = (unsigned)(p_last - b[0]);
          if (i0 < (unsigned)taps) {
            const T w0 = wr[i0];
#pragma unroll
            for (int q = 0; q < CC; ++q) acc[0][q] += w0 * xq[q];
          }
        } else {
          const unsigned il = (unsigned)(p_last - b[D - 1]);
          const unsigned im = D == 3 ? (unsigned)(p_mid - b[1]) : 0u;
          if (il < (unsigned)taps && im < (unsigned)taps) {
            T wp = wr[(D - 1) * taps + il];
            if (D == 3) wp = wr[taps + im] * wp;
            const int lo = b[0] - k0;  // column cell k sees tap k - lo
#pragma unroll
            for (int k = 0; k < kCol; ++k) {
              const unsigned i0 = (unsigned)(k - lo);
              if (k < nk && i0 < (unsigned)taps) {
                const T wt = wr[i0] * wp;
#pragma unroll
                for (int q = 0; q < CC; ++q) acc[k][q] += wt * xq[q];
              }
            }
          }
        }
      }
      if constexpr (kDet) {
        // the box's cell (k0 + k, pc) in C order: the column axis first
        T* sc = scratch + (long long)c0 * pitch + box_off[blockIdx.x] +
                (long long)k0 * plane + pc;
#pragma unroll
        for (int k = 0; k < kCol; ++k) {
          if (k >= nk) break;
#pragma unroll
          for (int q = 0; q < CC; ++q)
            if (q < cc) sc[q * pitch + (long long)k * plane] = acc[k][q];
        }
        continue;
      }
      // one add per owned cell and channel; neighbouring tiles overlap
      long long cell = 0;
      if constexpr (D == 1) {
        cell = tile.corner[0] + p_last;
      } else {
        cell = tile.corner[0] + k0;
        if (D == 3) cell = cell * P + (tile.corner[1] + p_mid);
        cell = cell * P + (tile.corner[D - 1] + p_last);
      }
      const long long col_stride = D == 3 ? P * P : P;
#pragma unroll
      for (int k = 0; k < kCol; ++k) {
        if (k >= nk) break;
        T* g = grid + (cell + k * col_stride) * c + c0;
#pragma unroll
        for (int q = 0; q < CC; ++q)
          if (q < cc && acc[k][q] != T(0)) atomicAdd(g + q, acc[k][q]);
      }
    }
  }
}

// Deterministic spread, phase B.  One block per chunk, a row of `chunks`:
// (output block, first entry of pair_tile, tiles, chunk k of the output
// block's nk, nk, partial slot).  The output block is the aligned cube of
// side = 1 << lb cells a side at its index's coordinates (nb blocks a
// side, C order).  Its cells x channels are items, cells innermost; a
// thread holds kItems of them in registers per round, blockDim.x apart
// (as few warps, up to kThreads, as hold the items in one round), and
// for each of the chunk's tiles, in ascending order, adds the tile's box
// cell over each item it holds (read at scratch[q * pitch + box_off[tile]
// + cell], cell in C order over the box: runs along the box's last axis),
// kUnroll tiles' loads in flight before their adds.  A chunk that is its block's whole list writes the
// grid (accumulate: adds to it, each cell by one thread); otherwise it
// writes its partial, and the block's last chunk to arrive sums the nk
// partials in chunk order and writes the grid.
constexpr int kItems = 4;     // phase B: items a thread holds per round
constexpr int kUnroll = 4;    // phase B: tiles whose loads are in flight
constexpr int kStage = 128;   // phase B: tiles staged in shared memory
constexpr int kSumUnroll = 8; // phase B: partials whose loads are in flight
constexpr int kChunkCols = 6;
constexpr int kWaveCols = 5;  // first tile, end tile, first chunk, end chunk, slots

template <typename T, int D>
__device__ inline void write_cell(T* __restrict__ grid, const int* origin,
                                  int item, int c, int lb, long long P,
                                  T v, int accumulate) {
  int cell = item & ((1 << (lb * D)) - 1);
  const int q = item >> (lb * D);
  long long g = 0, stride = 1;
  for (int a = D - 1; a >= 0; --a) {
    const long long ga = origin[a] + (cell & ((1 << lb) - 1));
    cell >>= lb;
    if (ga >= P) return;  // past the grid's edge
    g += ga * stride;
    stride *= P;
  }
  T* dst = grid + g * c + q;
  *dst = accumulate ? *dst + v : v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
reduce_blocks_kernel(const T* __restrict__ scratch,
                     const int* __restrict__ tiles,
                     const int* __restrict__ box_off,
                     const int* __restrict__ pair_tile,
                     const int* __restrict__ chunks, T* __restrict__ grid,
                     T* __restrict__ partial, int* __restrict__ arrivals,
                     int c, int pitch, long long P, int lb, int nb,
                     int accumulate) {
  __shared__ int s_lo[kStage][D];   // box corner minus the block's corner
  __shared__ int s_ext[kStage][D];
  __shared__ int s_off[kStage];
  __shared__ int s_last;
  const int* ch = chunks + (long long)blockIdx.x * kChunkCols;
  const int block = ch[0], first = ch[1], count = ch[2], k = ch[3],
            nk = ch[4], slot = ch[5];
  int origin[D];
  {
    int rem = block;
    for (int a = D - 1; a >= 0; --a) {
      origin[a] = (rem % nb) << lb;
      rem /= nb;
    }
  }
  const int items = (1 << (lb * D)) * c;
  const int nt = blockDim.x;
  const int per_round = nt * kItems;
  const bool once = count <= kStage;  // every tile staged up front

  auto stage = [&](int j0) {
    const int nj = min(kStage, count - j0);
    for (int j = threadIdx.x; j < nj; j += nt) {
      const int t = pair_tile[first + j0 + j];
      const int* row = tiles + (long long)t * kTileCols;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        s_lo[j][a] = row[2 + a] - origin[a];
        s_ext[j][a] = row[5 + a];
      }
      s_off[j] = box_off[t];
    }
  };
  if (once) {
    stage(0);
    __syncthreads();
  }

  for (int i0 = 0; i0 < items; i0 += per_round) {
    int xs[kItems][D], qs[kItems];
    bool live[kItems];
    T acc[kItems];
#pragma unroll
    for (int kk = 0; kk < kItems; ++kk) {
      const int item = i0 + kk * nt + threadIdx.x;
      live[kk] = item < items;
      int cell = item & ((1 << (lb * D)) - 1);
      qs[kk] = item >> (lb * D);
#pragma unroll
      for (int a = D - 1; a >= 0; --a) {
        xs[kk][a] = cell & ((1 << lb) - 1);
        cell >>= lb;
      }
      acc[kk] = T(0);
    }
    for (int j0 = 0; j0 < count; j0 += kStage) {
      if (!once) {
        __syncthreads();  // the last batch's readers are done
        stage(j0);
        __syncthreads();
      }
      const int nj = min(kStage, count - j0);
      for (int j = 0; j < nj; j += kUnroll) {
        T v[kUnroll][kItems];
        bool in[kUnroll][kItems];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool tile_ok = j + u < nj;
          const int js = tile_ok ? j + u : 0;
          const int off = s_off[js];
#pragma unroll
          for (int kk = 0; kk < kItems; ++kk) {
            bool ok = tile_ok && live[kk];
            int cell = 0;
#pragma unroll
            for (int a = 0; a < D; ++a) {
              const int ua = xs[kk][a] - s_lo[js][a];
              ok = ok && (unsigned)ua < (unsigned)s_ext[js][a];
              cell = cell * s_ext[js][a] + ua;
            }
            in[u][kk] = ok;
            v[u][kk] = ok ? scratch[qs[kk] * pitch + off + cell] : T(0);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int kk = 0; kk < kItems; ++kk)
            if (in[u][kk]) acc[kk] += v[u][kk];
      }
    }
#pragma unroll
    for (int kk = 0; kk < kItems; ++kk) {
      if (!live[kk]) continue;
      const int item = i0 + kk * nt + threadIdx.x;
      if (nk == 1)
        write_cell<T, D>(grid, origin, item, c, lb, P, acc[kk], accumulate);
      else
        partial[(long long)slot * items + item] = acc[kk];
    }
  }
  if (nk == 1) return;

  // the last chunk to arrive at the output block sums the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrivals + block, 1) == nk - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const T* base = partial + (long long)(slot - k) * items;
  for (int item = threadIdx.x; item < items; item += nt) {
    const T* p = base + item;
    T total = T(0);
    int j = 0;
    for (; j + kSumUnroll <= nk; j += kSumUnroll) {
      T v[kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
        v[u] = __ldcg(p + (long long)(j + u) * items);
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) total += v[u];
    }
    for (; j < nk; ++j) total += __ldcg(p + (long long)j * items);
    write_cell<T, D>(grid, origin, item, c, lb, P, total, accumulate);
  }
  if (threadIdx.x == 0) arrivals[block] = 0;  // ready for the next call
}

// Stage channels [c0, c0 + CC) of a tile's box in shared memory, one warp
// per line, coalesced along the last axis; channels past C are zero.
template <typename T, int D, int CC>
__device__ inline void stage_box(const Tile& tile, const T* __restrict__ grid,
                                 T* sbox, int c, int c0, long long P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int cc = min(CC, c - c0);
  const int row_elems = tile.ext[D - 1] * CC;
  int lines = 1;  // box lines along the last axis
  for (int a = 0; a < D - 1; ++a) lines *= tile.ext[a];
  for (int line = warp; line < lines; line += nwarps) {
    long long cell = 0;
    {
      int rem = line, cb[D > 1 ? D - 1 : 1];
      for (int a = D - 2; a >= 0; --a) {
        cb[a] = rem % tile.ext[a];
        rem /= tile.ext[a];
      }
      for (int a = 0; a < D - 1; ++a)
        cell = cell * P + (tile.corner[a] + cb[a]);
    }
    cell = cell * P + tile.corner[D - 1];
    const T* src = grid + cell * c + c0;
    T* dst = sbox + (long long)line * row_elems;
    if (cc == c && cc == CC) {  // the box line is contiguous in the grid
      for (int e = lane; e < row_elems; e += 32) dst[e] = src[e];
    } else {
      for (int e = lane; e < row_elems; e += 32) {
        const int cl = e / CC, q = e % CC;
        dst[e] = q < cc ? src[(long long)cl * c + q] : T(0);
      }
    }
  }
}

// Gather.  A block stages its tile's box, CC channels wide (channels past
// C are zero), and contracts one node per warp at a time.  The lanes own
// the cells of the window's plane (the last two axes for d >= 2, the only
// axis for d = 1), up to kPlane each, with the plane weight and box offset
// of each in registers; for d = 3 the warp then walks the first axis, one
// box plane per tap, weighting the plane's partial sum by w0.  A shuffle
// butterfly sums the lanes in a fixed order.
template <typename T, int D, int CC>
__device__ inline void gather_tile(const Tile& tile,
                                   const T* __restrict__ grid,
                                   T* __restrict__ out, T* sbox, const T* sw,
                                   const int* sb, int taps, int c,
                                   long long P) {
  const int elast = tile.ext[D - 1];
  const int wplane = D == 1 ? taps : taps * taps;  // window plane cells
  const int outer = D == 3 ? taps : 1;
  const int box_plane = D == 3 ? tile.ext[1] * elast : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long long row0 = tile.start;
  // the lane's cells of the window's first plane block, decomposed once
  int im0[kPlane], il0[kPlane];
#pragma unroll
  for (int k = 0; k < kPlane; ++k) {
    const int p = lane + 32 * k;
    im0[k] = D == 1 ? 0 : p / taps;
    il0[k] = D == 1 ? p : p - im0[k] * taps;
  }

  for (int c0 = 0; c0 < c; c0 += CC) {
    const int cc = min(CC, c - c0);
    __syncthreads();  // the last pass's readers are done
    stage_box<T, D, CC>(tile, grid, sbox, c, c0, P);
    __syncthreads();
    for (int r = warp; r < tile.count; r += nwarps) {
      const int* b = sb + r * D;
      const T* wr = sw + r * D * taps;
      T acc[CC];
#pragma unroll
      for (int q = 0; q < CC; ++q) acc[q] = T(0);
      for (int p0 = 0; p0 < wplane; p0 += 32 * kPlane) {
        const int kcount = min(kPlane, (wplane - p0 + 31) / 32);
        T wk[kPlane];
        int off[kPlane];
#pragma unroll
        for (int k = 0; k < kPlane; ++k) {
          const int p = p0 + lane + 32 * k;
          int im = im0[k], il = il0[k];
          if (p0 > 0) {
            im = D == 1 ? 0 : p / taps;
            il = D == 1 ? p : p - im * taps;
          }
          wk[k] = T(0);
          off[k] = 0;
          if (k < kcount && p < wplane) {
            if constexpr (D == 1) {
              wk[k] = wr[il];
              off[k] = b[0] + il;
            } else {
              // the plane's axes: (1, 2) for d = 3, (0, 1) for d = 2
              wk[k] = wr[(D - 2) * taps + im] * wr[(D - 1) * taps + il];
              off[k] = (b[D - 2] + im) * elast + b[D - 1] + il;
            }
          }
        }
        for (int i0 = 0; i0 < outer; ++i0) {
          const T* pl = sbox + (long long)(D == 3 ? (b[0] + i0) * box_plane
                                                  : 0) * CC;
          T part[CC];
#pragma unroll
          for (int q = 0; q < CC; ++q) part[q] = T(0);
#pragma unroll
          for (int k = 0; k < kPlane; ++k) {
            if (k < kcount) {
              const T* v = pl + off[k] * CC;
#pragma unroll
              for (int q = 0; q < CC; ++q) part[q] += wk[k] * v[q];
            }
          }
          const T w0 = D == 3 ? wr[i0] : T(1);
#pragma unroll
          for (int q = 0; q < CC; ++q) acc[q] += w0 * part[q];
        }
      }
#pragma unroll
      for (int q = 0; q < CC; ++q)
        for (int s = 16; s > 0; s >>= 1)
          acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], s);
      T v = T(0);
#pragma unroll
      for (int q = 0; q < CC; ++q)
        if (q == lane) v = acc[q];
      if (lane < cc) out[(row0 + r) * c + c0 + lane] = v;
    }
  }
}

// One block per tile.  The box takes the most channels per pass, a power
// of two up to `chunk`, that fit `box_bytes` of shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ grid, const int* __restrict__ base,
              const T* __restrict__ w, T* __restrict__ out,
              const int* __restrict__ tiles, int taps, int c, long long P,
              int chunk, int box_bytes, int max_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile tile = load_tile(tiles, blockIdx.x);
  T* sbox = reinterpret_cast<T*>(smem);  // box_bytes
  T* sw = sbox + box_bytes / sizeof(T);  // max_rows * D * taps
  int* sb = reinterpret_cast<int*>(sw + (long long)max_rows * D * taps);
  stage_nodes<T, D>(tile, base, w, taps, sw, sb);
  const long long cells =
      (long long)tile.ext[0] * tile.ext[1] * tile.ext[2];
  int cct = chunk;
  while (cct > 1 && cells * cct * (long long)sizeof(T) > box_bytes) cct >>= 1;
  switch (cct) {
    case 8: gather_tile<T, D, 8>(tile, grid, out, sbox, sw, sb, taps, c, P); break;
    case 4: gather_tile<T, D, 4>(tile, grid, out, sbox, sw, sb, taps, c, P); break;
    case 2: gather_tile<T, D, 2>(tile, grid, out, sbox, sw, sb, taps, c, P); break;
    default: gather_tile<T, D, 1>(tile, grid, out, sbox, sw, sb, taps, c, P);
  }
}

// Gather of a plan whose windows are cut into pieces: gather_tile's
// arithmetic, but a tile is one row and covers only the taps
// [first, first + n) of each axis, n = min(taps - first, extent), and a
// block walks the `parts` consecutive tiles of the row's pieces in turn,
// staging each piece's box and adding the pieces' sums in table order
// (warp 0 contracts the row).
template <typename T, int D, int CC>
__device__ inline void gather_tiles(const int* __restrict__ tiles,
                                    long long t0, int parts,
                                    const int* __restrict__ base,
                                    const T* __restrict__ w,
                                    const T* __restrict__ grid,
                                    T* __restrict__ out, T* sbox, T* sw,
                                    int* sb, int taps, int c, long long P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int c0 = 0; c0 < c; c0 += CC) {
    const int cc = min(CC, c - c0);
    T total[CC];  // the row's sum, in warp 0
#pragma unroll
    for (int q = 0; q < CC; ++q) total[q] = T(0);
    long long row0 = 0;
    for (int part = 0; part < parts; ++part) {
      const Tile tile = load_tile(tiles, t0 + part);
      row0 = tile.start;
      int tf[D], tn[D];  // the tile's first tap and tap count per axis
#pragma unroll
      for (int a = 0; a < D; ++a) {
        tf[a] = tile_first(tiles, t0 + part, a);
        tn[a] = min(taps - tf[a], tile.ext[a]);
      }
      const int al = D - 1, am = D >= 2 ? D - 2 : 0;  // the plane's axes
      const int nl = tn[al];
      const int wplane = D == 1 ? nl : tn[am] * nl;  // window plane cells
      const int elast = tile.ext[D - 1];
      const int box_plane = D == 3 ? tile.ext[1] * elast : 0;
      // the lane's cells of the window's first plane block, decomposed once
      int im0[kPlane], il0[kPlane];
#pragma unroll
      for (int k = 0; k < kPlane; ++k) {
        const int p = lane + 32 * k;
        im0[k] = D == 1 ? 0 : p / nl;
        il0[k] = D == 1 ? p : p - im0[k] * nl;
      }
      __syncthreads();  // the last piece's readers are done
      stage_nodes<T, D>(tile, base, w, taps, sw, sb);
      stage_box<T, D, CC>(tile, grid, sbox, c, c0, P);
      __syncthreads();
      for (int r = warp; r < tile.count; r += nwarps) {
        const int* b = sb + r * D;
        const T* wr = sw + r * D * taps;
        T acc[CC];
#pragma unroll
        for (int q = 0; q < CC; ++q) acc[q] = T(0);
        for (int p0 = 0; p0 < wplane; p0 += 32 * kPlane) {
          const int kcount = min(kPlane, (wplane - p0 + 31) / 32);
          T wk[kPlane];
          int off[kPlane];
#pragma unroll
          for (int k = 0; k < kPlane; ++k) {
            const int p = p0 + lane + 32 * k;
            int im = im0[k], il = il0[k];
            if (p0 > 0) {
              im = D == 1 ? 0 : p / nl;
              il = D == 1 ? p : p - im * nl;
            }
            im += D == 1 ? 0 : tf[am];
            il += tf[al];
            wk[k] = T(0);
            off[k] = 0;
            if (k < kcount && p < wplane) {
              if constexpr (D == 1) {
                wk[k] = wr[il];
                off[k] = b[0] + il;
              } else {
                // the plane's axes: (1, 2) for d = 3, (0, 1) for d = 2
                wk[k] = wr[(D - 2) * taps + im] * wr[(D - 1) * taps + il];
                off[k] = (b[D - 2] + im) * elast + b[D - 1] + il;
              }
            }
          }
          const int outer_lo = D == 3 ? tf[0] : 0;
          const int outer_hi = D == 3 ? tf[0] + tn[0] : 1;
          for (int i0 = outer_lo; i0 < outer_hi; ++i0) {
            const T* pl = sbox + (long long)(D == 3 ? (b[0] + i0) * box_plane
                                                    : 0) * CC;
            T part_sum[CC];
#pragma unroll
            for (int q = 0; q < CC; ++q) part_sum[q] = T(0);
#pragma unroll
            for (int k = 0; k < kPlane; ++k) {
              if (k < kcount) {
                const T* v = pl + off[k] * CC;
#pragma unroll
                for (int q = 0; q < CC; ++q) part_sum[q] += wk[k] * v[q];
              }
            }
            const T w0 = D == 3 ? wr[i0] : T(1);
#pragma unroll
            for (int q = 0; q < CC; ++q) acc[q] += w0 * part_sum[q];
          }
        }
#pragma unroll
        for (int q = 0; q < CC; ++q)
          for (int s = 16; s > 0; s >>= 1)
            acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], s);
#pragma unroll
        for (int q = 0; q < CC; ++q) total[q] += acc[q];
      }
    }
    if (warp == 0) {
      T v = T(0);
#pragma unroll
      for (int q = 0; q < CC; ++q)
        if (q == lane) v = total[q];
      if (lane < cc) out[row0 * c + c0 + lane] = v;
    }
  }
}

// One block per row of a pieced plan: its `pieces` tiles, the largest
// (the first) choosing the channels per pass.  A kernel of its own, so the
// whole-window gather above keeps its registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
gather_pieces_kernel(const T* __restrict__ grid, const int* __restrict__ base,
                     const T* __restrict__ w, T* __restrict__ out,
                     const int* __restrict__ tiles, int pieces, int taps,
                     int c, long long P, int chunk, int box_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long t0 = (long long)blockIdx.x * pieces;
  T* sbox = reinterpret_cast<T*>(smem);  // box_bytes
  T* sw = sbox + box_bytes / sizeof(T);  // D * taps
  int* sb = reinterpret_cast<int*>(sw + (long long)D * taps);
  const Tile tile = load_tile(tiles, t0);
  const long long cells =
      (long long)tile.ext[0] * tile.ext[1] * tile.ext[2];
  int cct = chunk;
  while (cct > 1 && cells * cct * (long long)sizeof(T) > box_bytes) cct >>= 1;
  switch (cct) {
    case 8: gather_tiles<T, D, 8>(tiles, t0, pieces, base, w, grid, out, sbox, sw, sb, taps, c, P); break;
    case 4: gather_tiles<T, D, 4>(tiles, t0, pieces, base, w, grid, out, sbox, sw, sb, taps, c, P); break;
    case 2: gather_tiles<T, D, 2>(tiles, t0, pieces, base, w, grid, out, sbox, sw, sb, taps, c, P); break;
    default: gather_tiles<T, D, 1>(tiles, t0, pieces, base, w, grid, out, sbox, sw, sb, taps, c, P);
  }
}

// Allow `bytes` of dynamic shared memory for `kernel` (above the 48 KB
// default only after an explicit opt-in).
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// What the deterministic mode adds to phase A: the scratch and each tile's
// offset in it (null for the atomic mode).
template <typename T>
struct DetArgs {
  T* scratch;
  const int* box_off;
  long long pitch;  // scratch cells of one channel
};

template <typename T, int D, int CC, bool kDet>
int spread_cc(const T* x, const int* base, const T* w, T* grid,
              const int* tiles, long long n_tiles, int taps, int c,
              long long P, int chunk, int max_rows, int c_lo, int c_hi,
              const DetArgs<T>& det, cudaStream_t s) {
  const size_t bytes = (size_t)max_rows * (D * taps + chunk) * sizeof(T) +
                       (size_t)max_rows * D * sizeof(int);
  auto kernel = spread_kernel<T, D, CC, kDet>;
  int rc = allow_smem(kernel, bytes);
  if (rc) return rc;
  kernel<<<(unsigned)n_tiles, kThreads, bytes, s>>>(
      x, base, w, grid, tiles, taps, c, P, chunk, max_rows, c_lo, c_hi,
      det.scratch, det.box_off, det.pitch);
  return (int)cudaGetLastError();
}

// registers for exactly the chunk's channels: 1, 2 or 4
template <typename T, int D, bool kDet>
int spread_d(const T* x, const int* base, const T* w, T* grid,
             const int* tiles, long long n_tiles, int taps, int c,
             long long P, int chunk, int max_rows, int c_lo, int c_hi,
             const DetArgs<T>& det, cudaStream_t s) {
  if (chunk == 1)
    return spread_cc<T, D, 1, kDet>(x, base, w, grid, tiles, n_tiles, taps,
                                    c, P, chunk, max_rows, c_lo, c_hi, det,
                                    s);
  if (chunk == 2)
    return spread_cc<T, D, 2, kDet>(x, base, w, grid, tiles, n_tiles, taps,
                                    c, P, chunk, max_rows, c_lo, c_hi, det,
                                    s);
  return spread_cc<T, D, kSpreadChunk, kDet>(x, base, w, grid, tiles,
                                             n_tiles, taps, c, P, chunk,
                                             max_rows, c_lo, c_hi, det, s);
}

template <typename T, bool kDet>
int spread_any_d(int d, const T* x, const int* base, const T* w, T* grid,
                 const int* tiles, long long n_tiles, int taps, int c,
                 long long P, int chunk, int max_rows, int c_lo, int c_hi,
                 const DetArgs<T>& det, cudaStream_t s) {
  switch (d) {
    case 1: return spread_d<T, 1, kDet>(x, base, w, grid, tiles, n_tiles, taps, c, P, chunk, max_rows, c_lo, c_hi, det, s);
    case 2: return spread_d<T, 2, kDet>(x, base, w, grid, tiles, n_tiles, taps, c, P, chunk, max_rows, c_lo, c_hi, det, s);
    default: return spread_d<T, 3, kDet>(x, base, w, grid, tiles, n_tiles, taps, c, P, chunk, max_rows, c_lo, c_hi, det, s);
  }
}

template <typename T>
int reduce_blocks(int d, const T* scratch, const int* tiles,
                  const int* box_off, const int* pair_tile, const int* chunks,
                  long long n_chunks, T* grid, T* partial, int* arrivals,
                  int c, int pitch, long long P, int lb, int nb,
                  int accumulate, cudaStream_t s) {
  // the warps that hold an output block's items in one round, at most 8
  const long long items = (1LL << (lb * d)) * c;
  long long warps = (items + 32 * kItems - 1) / (32 * kItems);
  if (warps > kThreads / 32) warps = kThreads / 32;
  const unsigned threads = (unsigned)(32 * warps);
  switch (d) {
    case 1:
      reduce_blocks_kernel<T, 1><<<(unsigned)n_chunks, threads, 0, s>>>(
          scratch, tiles, box_off, pair_tile, chunks, grid, partial,
          arrivals, c, pitch, P, lb, nb, accumulate);
      break;
    case 2:
      reduce_blocks_kernel<T, 2><<<(unsigned)n_chunks, threads, 0, s>>>(
          scratch, tiles, box_off, pair_tile, chunks, grid, partial,
          arrivals, c, pitch, P, lb, nb, accumulate);
      break;
    default:
      reduce_blocks_kernel<T, 3><<<(unsigned)n_chunks, threads, 0, s>>>(
          scratch, tiles, box_off, pair_tile, chunks, grid, partial,
          arrivals, c, pitch, P, lb, nb, accumulate);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int gather_d(const T* grid, const int* base, const T* w, T* out,
             const int* tiles, long long n_tiles, int taps, int c,
             long long P, int chunk, int max_cells, int max_rows, int pieces,
             cudaStream_t s) {
  // the largest box at `chunk` channels, within kBoxBytes
  const size_t box = (size_t)max_cells * chunk * sizeof(T);
  const int box_bytes = (int)(box < (size_t)kBoxBytes ? box : kBoxBytes);
  const size_t bytes = (size_t)box_bytes +
                       (size_t)max_rows * D * taps * sizeof(T) +
                       (size_t)max_rows * D * sizeof(int);
  if (pieces > 1) {  // one block per row, max_rows == 1
    auto kernel = gather_pieces_kernel<T, D>;
    int rc = allow_smem(kernel, bytes);
    if (rc) return rc;
    kernel<<<(unsigned)(n_tiles / pieces), kThreads, bytes, s>>>(
        grid, base, w, out, tiles, pieces, taps, c, P, chunk, box_bytes);
    return (int)cudaGetLastError();
  }
  auto kernel = gather_kernel<T, D>;
  int rc = allow_smem(kernel, bytes);
  if (rc) return rc;
  kernel<<<(unsigned)n_tiles, kThreads, bytes, s>>>(
      grid, base, w, out, tiles, taps, c, P, chunk, box_bytes, max_rows);
  return (int)cudaGetLastError();
}

// A plan with pieces holds `pieces` single-row tiles for every row.
bool bad_args(long long n_tiles, int d, int chunk, int max_chunk,
              int max_rows, int pieces) {
  return n_tiles < 1 || n_tiles > 0x7fffffffLL || d < 1 || d > 3 ||
         chunk < 1 || chunk > max_chunk || max_rows < 1 || pieces < 1 ||
         n_tiles % pieces != 0 || (pieces > 1 && max_rows != 1);
}

template <typename T>
int launch_spread(const void* x, const void* base, const void* w, void* grid,
                  const void* tiles, long long n_tiles, int d, int taps,
                  int c, long long P, int chunk, int max_rows, int pieces,
                  void* stream) {
  if (bad_args(n_tiles, d, chunk, kSpreadChunk, max_rows, pieces))
    return (int)cudaErrorInvalidValue;
  const DetArgs<T> none{nullptr, nullptr, 0};
  return spread_any_d<T, false>(
      d, static_cast<const T*>(x), static_cast<const int*>(base),
      static_cast<const T*>(w), static_cast<T*>(grid),
      static_cast<const int*>(tiles), n_tiles, taps, c, P, chunk, max_rows,
      0, c, none, static_cast<cudaStream_t>(stream));
}

// The deterministic spread, wave by wave, after zeroing the grid: phase A
// over the wave's tiles and all C channels, then phase B over the wave's
// chunks.  `waves` (host memory) holds kWaveCols numbers a wave; the waves
// must cover the tiles in order, and their chunks the chunk table, or
// nothing is launched.
template <typename T>
int launch_spread_det(const void* x, const void* base, const void* w,
                      void* grid, const void* tiles, long long n_tiles, int d,
                      int taps, int c, long long P, int chunk, int max_rows,
                      int pieces, void* stream, void* scratch,
                      const void* box_off, const void* pair_tile,
                      const void* chunks, void* partial, void* arrivals,
                      const void* waves, int n_waves, int side, int pitch) {
  if (bad_args(n_tiles, d, chunk, kSpreadChunk, max_rows, pieces) ||
      !scratch || !box_off || !pair_tile || !chunks || !arrivals || !waves ||
      n_waves < 1 || side < 1 || side > 1024 || (side & (side - 1)) ||
      pitch < 1 || (long long)pitch * c > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long* wv = static_cast<const long long*>(waves);
  long long t_end = 0, ch_end = 0;
  for (int i = 0; i < n_waves; ++i) {
    const long long* r = wv + (long long)i * kWaveCols;
    if (r[0] != t_end || r[1] <= r[0] || r[2] != ch_end || r[3] <= r[2] ||
        r[3] - r[2] > 0x7fffffffLL || r[4] < 0 || (r[4] > 0 && !partial))
      return (int)cudaErrorInvalidValue;
    t_end = r[1];
    ch_end = r[3];
  }
  if (t_end != n_tiles) return (int)cudaErrorInvalidValue;
  int lb = 0;
  while ((1 << lb) < side) ++lb;
  const int nb = (int)((P + side - 1) / side);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* gp = static_cast<T*>(grid);
  T* sp = static_cast<T*>(scratch);
  const int* tp = static_cast<const int*>(tiles);
  const int* bo = static_cast<const int*>(box_off);
  long long grid_cells = c;
  for (int a = 0; a < d; ++a) grid_cells *= P;
  int rc = (int)cudaMemsetAsync(gp, 0, (size_t)grid_cells * sizeof(T), s);
  if (rc) return rc;
  for (int i = 0; i < n_waves; ++i) {
    const long long* r = wv + (long long)i * kWaveCols;
    const DetArgs<T> det{sp, bo + r[0], pitch};
    rc = spread_any_d<T, true>(
        d, static_cast<const T*>(x), static_cast<const int*>(base),
        static_cast<const T*>(w), gp, tp + r[0] * kTileCols, r[1] - r[0],
        taps, c, P, chunk, max_rows, 0, c, det, s);
    if (rc) return rc;
    rc = reduce_blocks<T>(
        d, sp, tp, bo, static_cast<const int*>(pair_tile),
        static_cast<const int*>(chunks) + r[2] * kChunkCols, r[3] - r[2], gp,
        static_cast<T*>(partial), static_cast<int*>(arrivals), c, pitch, P,
        lb, nb, i > 0, s);
    if (rc) return rc;
  }
  return 0;
}

template <typename T>
int launch_gather(const void* grid, const void* base, const void* w,
                  void* out, const void* tiles, long long n_tiles, int d,
                  int taps, int c, long long P, int chunk, int max_cells,
                  int max_rows, int pieces, void* stream) {
  if (bad_args(n_tiles, d, chunk, kChunk, max_rows, pieces) || max_cells < 1 ||
      (chunk & (chunk - 1)) || (long long)max_cells * sizeof(T) > kBoxBytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* gp = static_cast<const T*>(grid);
  const int* bp = static_cast<const int*>(base);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  const int* tp = static_cast<const int*>(tiles);
  switch (d) {
    case 1: return gather_d<T, 1>(gp, bp, wp, op, tp, n_tiles, taps, c, P, chunk, max_cells, max_rows, pieces, s);
    case 2: return gather_d<T, 2>(gp, bp, wp, op, tp, n_tiles, taps, c, P, chunk, max_cells, max_rows, pieces, s);
    default: return gather_d<T, 3>(gp, bp, wp, op, tp, n_tiles, taps, c, P, chunk, max_cells, max_rows, pieces, s);
  }
}

}  // namespace

// Each entry point launches one block per tile (the gather of a pieced
// plan: per row) on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).  The caller zeroes `grid` for the
// atomic spread; the deterministic spread zeroes it itself.
// `chunk` is the channels of one pass (spread <= 4, gather <= 8);
// `max_cells` / `max_rows` are the plan's largest box and tile, which size
// the dynamic shared memory; `pieces` is the tiles of each row's window
// (1: whole windows).
extern "C" {

int repro_window_spread_f64(const void* x, const void* base, const void* w,
                            void* grid, const void* tiles, long long n_tiles,
                            int d, int taps, int c, long long P, int chunk,
                            int max_cells, int max_rows, int pieces,
                            void* stream) {
  (void)max_cells;
  return launch_spread<double>(x, base, w, grid, tiles, n_tiles, d, taps, c,
                               P, chunk, max_rows, pieces, stream);
}

int repro_window_spread_f32(const void* x, const void* base, const void* w,
                            void* grid, const void* tiles, long long n_tiles,
                            int d, int taps, int c, long long P, int chunk,
                            int max_cells, int max_rows, int pieces,
                            void* stream) {
  (void)max_cells;
  return launch_spread<float>(x, base, w, grid, tiles, n_tiles, d, taps, c,
                              P, chunk, max_rows, pieces, stream);
}

// The deterministic spread: as repro_window_spread_*, plus its schedule
// (nfft_window.py: SpreadBlockIndex): the scratch (C planes of `pitch`
// cells, the largest wave's box cells), box_off (n_tiles int32: a tile's
// first scratch cell in its wave), pair_tile (int32: the tiles of each
// (wave, output block) run,
// ascending), chunks (int32, kChunkCols a chunk), partial (slots of
// side^d x C elements; null where no wave has one), arrivals (an int32
// zero a output block, left zero), waves (host int64, kWaveCols a wave),
// the output blocks' side, a power of two, and the pitch.
int repro_window_spread_det_f64(const void* x, const void* base,
                                const void* w, void* grid, const void* tiles,
                                long long n_tiles, int d, int taps, int c,
                                long long P, int chunk, int max_cells,
                                int max_rows, int pieces, void* stream,
                                void* scratch, const void* box_off,
                                const void* pair_tile, const void* chunks,
                                void* partial, void* arrivals,
                                const void* waves, int n_waves, int side,
                                int pitch) {
  (void)max_cells;
  return launch_spread_det<double>(x, base, w, grid, tiles, n_tiles, d, taps,
                                   c, P, chunk, max_rows, pieces, stream,
                                   scratch, box_off, pair_tile, chunks,
                                   partial, arrivals, waves, n_waves, side,
                                   pitch);
}

int repro_window_spread_det_f32(const void* x, const void* base,
                                const void* w, void* grid, const void* tiles,
                                long long n_tiles, int d, int taps, int c,
                                long long P, int chunk, int max_cells,
                                int max_rows, int pieces, void* stream,
                                void* scratch, const void* box_off,
                                const void* pair_tile, const void* chunks,
                                void* partial, void* arrivals,
                                const void* waves, int n_waves, int side,
                                int pitch) {
  (void)max_cells;
  return launch_spread_det<float>(x, base, w, grid, tiles, n_tiles, d, taps,
                                  c, P, chunk, max_rows, pieces, stream,
                                  scratch, box_off, pair_tile, chunks,
                                  partial, arrivals, waves, n_waves, side,
                                  pitch);
}

int repro_window_gather_f64(const void* grid, const void* base, const void* w,
                            void* out, const void* tiles, long long n_tiles,
                            int d, int taps, int c, long long P, int chunk,
                            int max_cells, int max_rows, int pieces,
                            void* stream) {
  return launch_gather<double>(grid, base, w, out, tiles, n_tiles, d, taps,
                               c, P, chunk, max_cells, max_rows, pieces,
                               stream);
}

int repro_window_gather_f32(const void* grid, const void* base, const void* w,
                            void* out, const void* tiles, long long n_tiles,
                            int d, int taps, int c, long long P, int chunk,
                            int max_cells, int max_rows, int pieces,
                            void* stream) {
  return launch_gather<float>(grid, base, w, out, tiles, n_tiles, d, taps,
                              c, P, chunk, max_cells, max_rows, pieces,
                              stream);
}

}  // extern "C"
