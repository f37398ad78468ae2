// K6: radius-3 bilinear lookup in the zero-bordered P-major pyramid, for Hopper.
//
// Replaces the TPU kernel droid_slam_reserch_tpu/ops/pallas_corr.py
// (corr_lookup_pmajor_pallas, body _lookup_kernel).  Same function: level l
// is [E, Hp_l, Wp_l, P] with Hp_l = (H2 >> l) + 16 (ops/corr.py
// build_pyramid_pmajor: an 8-pixel zero border, pixels last).  For edge e,
// source pixel p and level l, with (x, y) = coords[e, p] / 2^l, the 8-tap
// span starts at padded row
//   sy = clip(floor(y) + 8 - 3, 0, Hp_l - 8)
// (sx likewise), and
//   out[e, p, 49 l + 7 a + b] = (1 - fx) * Y[b][a] + fx * Y[b][a + 1],
//   Y[b][j] = (1 - fy) * v[sy + b][sx + j] + fy * v[sy + b + 1][sx + j]
// with fx, fy the fractional parts: K3's function, read without bounds
// checks because a span off the level lands wholly in the border.
//
// What bounds it on the H100: bytes.  Each (e, p, l) needs 64 cells and
// writes 49 floats; at the main path's shapes (E = 48, P = 2560) that is
// 126 MB read and 96 MB written, about 0.07 ms at 3.35 TB/s.  The layout
// does not make those reads coalesce by itself: a pixel's cells lie P floats
// apart, and neighbouring source pixels look up neighbouring target columns,
// so at level 0 lane k of a warp that reads "the same tap" of 32 pixels
// lands (P + 1) k floats from lane 0, one 32-byte sector each.  But a sector
// holds one cell of 8 neighbouring pixels, whose spans overlap: under smooth
// motion pixel p + k needs cell (r, c) where pixel p needs (r, c - k).  Nor
// do the outputs coalesce by themselves: a pixel's 196 floats are
// contiguous, and a thread per pixel writes 196 floats from its neighbour.
//
// Design: one block per (edge, tile of 32 consecutive pixels), a thread per
// (pixel, x tap a).  A thread reads its span's columns a and a + 1 at all
// four levels (64 loads, all in flight together) and blends its 28 outputs,
// along y then along x as K3, into the tile's [32][196] outputs staged in
// shared memory; the block then writes them as one contiguous run with
// 16-byte stores.  The loads go through L1, where the 7 threads of a pixel
// and the 8 pixels of a sector share what they fetch.  Copying each 8-pixel
// group's union box of spans into shared memory first (every sector read
// whole, one pass a level, with gathers for boxes that overflow the buffer)
// was slower at every buffer size tried, with smooth and with random
// coords: the shared memory it takes shrinks L1, which already gave that
// reuse.
//
// bf16 (the JAX package's bfloat16 levels, where the TPU kernel writes
// padded[0].dtype) has a kernel of its own, pmajor_lookup_bf16_kernel, with
// the same arithmetic: bf16 cells widened, the fractional parts rounded to
// bf16 as the TPU kernel casts them, each blend operation rounded alone in
// fp32 and each output rounded once, so it equals the plain version
// (ops/corr.py) exactly.  The fp32 design issued as many gathers for half
// the bytes.  Here a block takes a group of 32 consecutive pixels, whose
// cells are 64 contiguous bytes each (pixels last), and first copies into
// shared memory, for each level, the box that the group's spans cover: rows
// [min sy, max sy + 8) x columns [min sx, max sx + 8) x the 32 pixels, by
// 16-byte cp.async copies (2-byte loads where P is not a multiple of 8 or a
// level is not 16-byte aligned).  Under smooth motion the box is about the
// sectors that the spans touch (8 x 39 cells at level 0 under a pan).  The
// block's 256 threads are (pixel q, x tap a), tid = 32 a + q (a = 7 only
// copies and stores): the box extents are min/max shuffles across a warp.
// Each thread then blends its columns a and a + 1 of each level's span from
// the box, level by level, holds its 28 outputs in registers until the box
// is read, and stages them in the same buffer for the group's contiguous
// run, written 16 bytes a store (8 where e * P + p0 is odd;
// lookup_bf16::store_run).  A group whose four boxes exceed the buffer (768
// cells of 32 pixels, 48 KB: pixels far apart, as under the random coords
// of tools/lookup_sources.py, or a group across two image rows), or the last
// group of an edge where P is not a multiple of 32, gathers its cells
// through L1 a level at a time, in the same kernel.
//
// What that bought (PERF.md §6, tools/lookup_sources.py): a few per cent at
// E = 48.  Copying the boxes alone takes about as long as the whole kernel
// under the pan (64-byte runs 5 KB apart move at about two thirds of the HBM
// rate), so the layout, not the instructions, bounds K6 bf16.  Under random
// coords most boxes exceed the buffer and those groups gather.  Groups of 16 pixels (one sector a cell, a
// 1,024-cell buffer, the design first built, variant tile16) were slower
// than the fp32 design's kernel with random coords.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"
#include "lookup_bf16.cuh"

namespace {

constexpr int kLevels = 4, kPad = 8, kR = 3;
constexpr int kD = 2 * kR + 1;          // 7 taps per axis
constexpr int kOut = kLevels * kD * kD; // 196 outputs per pixel
constexpr int kTile = 32;               // pixels per block
constexpr int kThreads = kTile * kD;    // a thread per (pixel, x tap)

template <typename T> struct Padded {
  const T* lv[kLevels];
  int Hp[kLevels], Wp[kLevels];
};

__device__ __forceinline__ int floor_clamped(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

// Cells (row, column) g00 = (b, a), g01 = (b, a + 1), g10 = (b + 1, a),
// g11 = (b + 1, a + 1) of the span, f = (fx, fy): along y, then along x,
// each product and sum rounded on its own as the plain version rounds them
// (no contraction into FMAs), so K6, K3 and the plain versions agree exactly.
__device__ __forceinline__ float blend(float g00, float g01, float g10, float g11, float2 f) {
  const float wy = 1.f - f.y, wx = 1.f - f.x;
  const float y0 = __fadd_rn(__fmul_rn(wy, g00), __fmul_rn(f.y, g10));   // Y[b][a]
  const float y1 = __fadd_rn(__fmul_rn(wy, g01), __fmul_rn(f.y, g11));   // Y[b][a + 1]
  return __fadd_rn(__fmul_rn(wx, y0), __fmul_rn(f.x, y1));
}

__global__ void __launch_bounds__(kThreads)
pmajor_lookup_kernel(Padded<float> pad, const float2* __restrict__ coords,
                     float* __restrict__ out, int P) {
  __shared__ __align__(16) float stage[kTile * kOut];   // the tile's outputs
  const int tid = threadIdx.x, q = tid / kD, a = tid - q * kD;
  const int e = blockIdx.y, p0 = blockIdx.x * kTile;
  const int np = min(kTile, P - p0);

  if (q < np) {
    const float2 c = coords[(size_t)e * P + p0 + q];
    const size_t col = (size_t)P;
    float g[kLevels][2][kD + 1];         // columns a and a + 1 of each level's span
    float2 f[kLevels];
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      const int Hp = pad.Hp[l], Wp = pad.Wp[l];
      const float scale = 1.f / (float)(1 << l);
      const float x = c.x * scale, y = c.y * scale;
      const int sy = min(max(floor_clamped(y) + kPad - kR, 0), Hp - 8);
      const int sx = min(max(floor_clamped(x) + kPad - kR, 0), Wp - 8);
      f[l] = make_float2(x - floorf(x), y - floorf(y));
      // cell (row, column) of edge e lives at ((e * Hp + row) * Wp + column) * P + p
      const float* v = pad.lv[l] + (((size_t)e * Hp + sy) * Wp + sx + a) * col + p0 + q;
      const size_t row = (size_t)Wp * col;
#pragma unroll
      for (int i = 0; i <= kD; i++) {
        g[l][0][i] = Io<float>::load(v + i * row);
        g[l][1][i] = Io<float>::load(v + i * row + col);
      }
    }
    float* o = stage + q * kOut + a * kD;
#pragma unroll
    for (int l = 0; l < kLevels; l++)
#pragma unroll
      for (int b = 0; b < kD; b++)
        o[l * kD * kD + b] = blend(g[l][0][b], g[l][1][b], g[l][0][b + 1], g[l][1][b + 1], f[l]);
  }
  __syncthreads();

  // ---- the tile's np x 196 outputs are one contiguous run: 16-byte stores,
  // chunk i holding outputs 4 i .. 4 i + 3
  const size_t first = ((size_t)e * P + p0) * kOut;
  float4* dst = reinterpret_cast<float4*>(out + first);
  const float4* src = reinterpret_cast<const float4*>(stage);
  for (int i = tid; i < np * (kOut / 4); i += kThreads) dst[i] = src[i];
}

constexpr int kTileB = 32;               // bf16: pixels a block, 64 bytes of a cell
constexpr int kThreadsB = 8 * kTileB;    // thread 32 a + q: pixel q, x tap a (a = 7 copies)
constexpr int kBoxCells = 768;           // cells of kTileB pixels the box buffer holds
constexpr int kCellChunks = kTileB / 8;  // 16-byte chunks of a cell's kTileB pixels

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ float widen(unsigned short c) {
  return __uint_as_float((uint32_t)c << 16);
}

// kVec: the boxes come by 16-byte cp.async copies (P a multiple of 8, the
// levels 16-byte aligned), else 2 bytes a cell.
template <bool kVec>
__global__ void __launch_bounds__(kThreadsB)
pmajor_lookup_bf16_kernel(Padded<bf16> pad, const float2* __restrict__ coords,
                          bf16* __restrict__ out, int P) {
  // the group's four boxes, cell (level l, row ry_l + r, column cx_l + c) at
  // 16 (at_l + r * nc_l + c) + pixel; then the group's staged outputs
  __shared__ __align__(16) uint4 buf[kCellChunks * kBoxCells];
  unsigned short* box = reinterpret_cast<unsigned short*>(buf);
  const int tid = threadIdx.x, q = tid % kTileB, a = tid / kTileB;
  const int e = blockIdx.y, p0 = blockIdx.x * kTileB;
  const int np = min(kTileB, P - p0);
  // pixel q's coords; lanes past the run take the last pixel's, which keeps
  // the group's box as it is
  const float2 c = coords[(size_t)e * P + p0 + min(q, np - 1)];
  int sy[kLevels], sx[kLevels], ry[kLevels], cx[kLevels], nc[kLevels], at[kLevels];
  float2 f[kLevels];
  int cells = 0;
#pragma unroll
  for (int l = 0; l < kLevels; l++) {
    const float scale = 1.f / (float)(1 << l);
    const float x = c.x * scale, y = c.y * scale;
    sy[l] = min(max(floor_clamped(y) + kPad - kR, 0), pad.Hp[l] - 8);
    sx[l] = min(max(floor_clamped(x) + kPad - kR, 0), pad.Wp[l] - 8);
    f[l] = make_float2(Io<bf16>::round(x - floorf(x)), Io<bf16>::round(y - floorf(y)));
    int y0 = sy[l], y1 = sy[l], x0 = sx[l], x1 = sx[l];
#pragma unroll
    for (int o = 1; o < kTileB; o <<= 1) {       // over the group's pixels (lanes)
      y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, o));
      y1 = max(y1, __shfl_xor_sync(0xffffffffu, y1, o));
      x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, o));
      x1 = max(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    }
    ry[l] = y0;
    cx[l] = x0;
    nc[l] = x1 - x0 + 8;
    at[l] = cells;
    cells += (y1 - y0 + 8) * nc[l];
  }
  const bool staged = np == kTileB && cells <= kBoxCells;

  if (staged) {
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      const int Hp = pad.Hp[l], Wp = pad.Wp[l];
      const bf16* lv = pad.lv[l] + p0;
      const int n = (l + 1 < kLevels ? at[l + 1] : cells) - at[l];
      if constexpr (kVec) {
        for (int i = tid; i < kCellChunks * n; i += kThreadsB) {   // a cell's chunks
          const int k = i / kCellChunks, r = k / nc[l], cc = k - r * nc[l];
          cp_async16(smem_addr(buf + kCellChunks * at[l] + i),
                     lv + (((size_t)e * Hp + ry[l] + r) * Wp + cx[l] + cc) * P
                         + 8 * (i % kCellChunks));
        }
      } else {
        for (int i = tid; i < kTileB * n; i += kThreadsB) {
          const int k = i / kTileB, r = k / nc[l], cc = k - r * nc[l];
          box[kTileB * at[l] + i] = __ldg(reinterpret_cast<const unsigned short*>(
              lv + (((size_t)e * Hp + ry[l] + r) * Wp + cx[l] + cc) * P + i % kTileB));
        }
      }
    }
    if constexpr (kVec) asm volatile("cp.async.wait_all;" ::: "memory");
  }
  __syncthreads();

  // ---- columns a and a + 1 of each level's span, from the box or gathered
  // (cell (row, column) of edge e at ((e * Hp + row) * Wp + column) * P + p)
  const bool live = q < np && a < kD;
  unsigned short o[kLevels][kD];
  if (live) {
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      float g[2][kD + 1];
      if (staged) {
        const unsigned short* v =
            box + kTileB * (at[l] + (sy[l] - ry[l]) * nc[l] + sx[l] + a - cx[l]) + q;
        const int row = kTileB * nc[l];
#pragma unroll
        for (int i = 0; i <= kD; i++) {
          g[0][i] = widen(v[i * row]);
          g[1][i] = widen(v[i * row + kTileB]);
        }
      } else {
        const int Wp = pad.Wp[l];
        const bf16* v =
            pad.lv[l] + (((size_t)e * pad.Hp[l] + sy[l]) * Wp + sx[l] + a) * P + p0 + q;
        const size_t row = (size_t)Wp * P;
#pragma unroll
        for (int i = 0; i <= kD; i++) {
          g[0][i] = Io<bf16>::load(v + i * row);
          g[1][i] = Io<bf16>::load(v + i * row + P);
        }
      }
#pragma unroll
      for (int b = 0; b < kD; b++)
        o[l][b] = __bfloat16_as_ushort(
            Io<bf16>::cvt(blend(g[0][b], g[1][b], g[0][b + 1], g[1][b + 1], f[l])));
    }
  }
  __syncthreads();                             // the boxes are read: stage the outputs
  unsigned short* stage = box;
  if (live) {
#pragma unroll
    for (int l = 0; l < kLevels; l++)
#pragma unroll
      for (int b = 0; b < kD; b++) stage[q * kOut + l * kD * kD + a * kD + b] = o[l][b];
  }
  __syncthreads();
  lookup_bf16::store_run(reinterpret_cast<const bf16*>(stage),
                         out + ((size_t)e * P + p0) * kOut, np * kOut, tid, kThreadsB);
}

template <typename T>
Padded<T> padded(const void* const* lv, int H2, int W2) {
  Padded<T> pad;
  for (int l = 0; l < kLevels; l++) {
    pad.lv[l] = (const T*)lv[l];
    pad.Hp[l] = (H2 >> l) + 2 * kPad;
    pad.Wp[l] = (W2 >> l) + 2 * kPad;
  }
  return pad;
}

}  // namespace

// Launches K6 on `stream`: level0..level3 the padded P-major levels
// [E, (H2 >> l) + 16, (W2 >> l) + 16, P] float32, coords [E, P, 2] float32
// level-0 pixels -> out [E, P, 196] (16-byte aligned, as torch.empty gives
// it).  Returns cudaGetLastError().
extern "C" int corr_pmajor_lookup_launch(const void* level0, const void* level1,
                                         const void* level2, const void* level3,
                                         const void* coords, int E, int P, int H2, int W2,
                                         void* out, void* stream) {
  const void* lv[kLevels] = {level0, level1, level2, level3};
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E > 0 && P > 0) {
    dim3 grid((P + kTile - 1) / kTile, E);
    pmajor_lookup_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        padded<float>(lv, H2, W2), (const float2*)coords, (float*)out, P);
  }
  return (int)cudaGetLastError();
}

// The same on bf16 padded levels -> out [E, P, 196] bf16 (8-byte aligned).
// The boxes come 16 bytes a copy where P is a multiple of 8 and every level
// is 16-byte aligned, else 2 bytes a cell.
extern "C" int corr_pmajor_lookup_bf16_launch(const void* level0, const void* level1,
                                              const void* level2, const void* level3,
                                              const void* coords, int E, int P, int H2,
                                              int W2, void* out, void* stream) {
  const void* lv[kLevels] = {level0, level1, level2, level3};
  bool vec = P % 8 == 0;
  for (int l = 0; l < kLevels; l++) vec &= (reinterpret_cast<uintptr_t>(lv[l]) & 15) == 0;
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E > 0 && P > 0) {
    dim3 grid((P + kTileB - 1) / kTileB, E);
    auto* kernel = vec ? pmajor_lookup_bf16_kernel<true> : pmajor_lookup_bf16_kernel<false>;
    kernel<<<grid, kThreadsB, 0, (cudaStream_t)stream>>>(
        padded<bf16>(lv, H2, W2), (const float2*)coords, (bf16*)out, P);
  }
  return (int)cudaGetLastError();
}
