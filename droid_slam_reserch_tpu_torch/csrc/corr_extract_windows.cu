// K7: cut the per-pixel window cache out of an existing pyramid, for Hopper.
//
// Replaces the TPU kernel droid_slam_reserch_tpu/ops/pallas_corr.py
// (corr_extract_windows_pallas, body _extract_kernel).  Same function as
// K4's window phase (csrc/corr_windows_build.cu), reading the levels that
// K2 wrote instead of building them: level l is [E, P, H2 >> l, W2 >> l]
// with no border, and thinking of it with an 8-pixel zero border, the
// window of pixel p is the WH x WW block of the bordered level that starts
// at the base
//   by_l = clip(floor(y0 / 2^l) + 8 - 3 - (WH - 8) / 2, 0, Hp_l - WH)
// (bx_l likewise) around coords (x0, y0).  WH = WW = 24 unless the bordered
// level is smaller, when the window is all of it.  Output: windows
// [E, P, sum_l WH_l, max_l WW_l] (level l at rows off_l; cells in the
// border and columns past WW_l hold 0) and bases [E, 2L, P] int32.
//
// What bounds it on the H100: bytes.  At the main path's shapes (E = 48,
// P = 2560, 40x64) it writes 1.10 GB of windows and reads at most as much
// of the levels (each pixel's levels are its own, so nothing is shared),
// about 0.5 ms at 3.35 TB/s; it does no arithmetic to speak of.
//
// Design: K4's window phase, reading the levels from device memory instead
// of shared memory.  One block per (pixel, edge): for each level (unrolled,
// so the parameters are read at constant offsets) the block computes the
// pixel's base once and its threads write the level's window rows of the
// pixel's contiguous packed tile, so the stores coalesce and each window
// row reads consecutive cells of a level row.  A first version with one
// thread per cell recomputed the bases in every thread and selected the
// level at run time, which put the parameter struct in local memory: 9.1 ms
// at the main path's shapes, against 0.48 ms of bound.
//
// fp32: a thread writes a run of 16 bytes of a window row (4 cells) with one
// store wherever the packed rows are whole 16-byte runs (max WW a multiple
// of 4; 24 at any map 8 cells wide or more), cell by cell otherwise.
//
// bf16 (the JAX package's bfloat16 path, where the TPU kernel writes
// levels[0].dtype; bf16 windows, a copy of cells with no rounding) has a
// kernel of its own, extract_windows_bf16_kernel.  There the fp32 design's
// instructions, not its bytes, set the time: a block per (pixel, edge) writes
// 4,464 bytes, only 72 of its 128 threads have work at a level, and each
// issues 8 scalar 2-byte loads behind 4 bounds tests for one 16-byte store.
// Instead a block takes 32 consecutive pixels of an edge (their packed
// windows are one contiguous run) and computes their bases once, into
// shared memory and to bases[] coalesced.  A thread per (pixel, window row,
// 16-byte output chunk k), 768 threads a block, so that 32 pixels x 24 rows
// x 3 chunks is 3 passes of the block with no thread idle, and consecutive
// threads store consecutive 16 bytes of the run: a thread per window row,
// its three stores 48 bytes apart across lanes, was slower than the parent's
// kernel (tools/lookup_sources.py, variant rowthread).  Output chunk k holds cells
// x0 .. x0 + 7, x0 = bx - 8 + 8 k, of level row y = by - 8 + r: on a level
// whose rows are whole 16-byte chunks (W_l a positive multiple of 8, the
// level 16-byte aligned) it reads chunks x0 >> 3 (floor division: x0 >= -8)
// and, only where x0 & 7 != 0, the next one, each wholly inside the row or
// taken as zeros (as are rows off the level), so no cell needs a test: the
// window's border is the chunks' zero fill.  lookup_bf16::span8 aligns the
// two chunks by word selects and a funnel shift, as the bf16 lookups do.
// Neighbouring threads read overlapping chunks of one row, so a warp's loads
// touch about 11 rows' 64 bytes and L1 serves the overlap.  Other levels
// (widths 45, 17, 3, ...; levels 2 bytes off alignment) take the same body
// with 2-byte cells and the fp32 kernel's tests, and window rows that are not
// whole 16-byte chunks (max WW not a multiple of 8) are stored cell by cell.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"
#include "lookup_bf16.cuh"

namespace {

constexpr int kLevels = 4, kPad = 8, kWin = 24, kR = 3;
constexpr int kThreads = 128;

template <typename T> struct Meta {
  const T* lv[kLevels];
  int H[kLevels], W[kLevels];    // level sizes
  int WH[kLevels], WW[kLevels];  // window extents
  int off[kLevels];              // packed row offset of each level's window
  int sum_wh, ww_max;
};

__device__ __forceinline__ int floor_clamped(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

__device__ __forceinline__ int window_base(float c, float scale, int n, int win) {
  const int b = floor_clamped(c * scale) + kPad - kR - (win - 8) / 2;
  return min(max(b, 0), n + 2 * kPad - win);
}

__global__ void __launch_bounds__(kThreads)
extract_windows_kernel(Meta<float> m, const float2* __restrict__ coords,
                       float* __restrict__ wins, int* __restrict__ bases, int P) {
  constexpr int kVec = Io<float>::kVec;      // cells of a 16-byte store
  const int p = blockIdx.x, e = blockIdx.y, tid = threadIdx.x;
  const size_t ep = (size_t)e * P + p;
  const float2 c = coords[ep];
  const int wwm = m.ww_max, runs = (wwm + kVec - 1) / kVec;   // runs a window row
  float* out = wins + ep * m.sum_wh * wwm;
#pragma unroll
  for (int l = 0; l < kLevels; l++) {
    const float scale = 1.f / (float)(1 << l);
    const int Hl = m.H[l], Wl = m.W[l], WWl = m.WW[l];
    const int by = window_base(c.y, scale, Hl, m.WH[l]);
    const int bx = window_base(c.x, scale, Wl, WWl);
    if (tid == 0) {                          // bases [E, 2L, P]: (by_l, bx_l)
      int* b = bases + ((size_t)e * 2 * kLevels + 2 * l) * P + p;
      b[0] = by;
      b[P] = bx;
    }
    const float* src = m.lv[l] + ep * Hl * Wl;
    float* dst = out + m.off[l] * wwm;
    const int n = m.WH[l] * runs;
    for (int i = tid; i < n; i += kThreads) {
      const int r = i / runs, c0 = kVec * (i - r * runs);
      const int y = by + r - kPad;
      const bool in_y = y >= 0 && y < Hl;
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; j++) {
        const int cc = c0 + j, x = bx + cc - kPad;
        v[j] = (in_y && cc < WWl && x >= 0 && x < Wl) ? Io<float>::load(src + y * Wl + x) : 0.f;
      }
      float* d = dst + r * wwm + c0;
      if (wwm % kVec == 0) {
        Io<float>::store_run(d, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; j++)
          if (c0 + j < wwm) d[j] = Io<float>::cvt(v[j]);
      }
    }
  }
}

constexpr int kTileB = 32;               // bf16: pixels a block
constexpr int kThreadsB = kTileB * kWin; // 768: a 24-row level's 3 chunks a row in 3 passes
constexpr int kVecStores = 1 << kLevels; // bit of `vec`: window rows are whole 16-byte chunks

// One block per (edge, 32 consecutive pixels).  vec: bit l set where level
// l's rows are whole 16-byte chunks (W_l a positive multiple of 8, the level
// 16-byte aligned), bit kLevels where the window rows are (ww_max a multiple
// of 8, the windows 16-byte aligned).
__global__ void __launch_bounds__(kThreadsB)
extract_windows_bf16_kernel(Meta<bf16> m, int vec, const float2* __restrict__ coords,
                            bf16* __restrict__ wins, int* __restrict__ bases, int P) {
  __shared__ int2 base[kLevels][kTileB];     // (by_l, bx_l) of the tile's pixels
  const int tid = threadIdx.x, e = blockIdx.y, p0 = blockIdx.x * kTileB;
  const int np = min(kTileB, P - p0);
  const size_t ep0 = (size_t)e * P + p0;
  if (tid < np) {
    const float2 c = coords[ep0 + tid];
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      const float scale = 1.f / (float)(1 << l);
      const int by = window_base(c.y, scale, m.H[l], m.WH[l]);
      const int bx = window_base(c.x, scale, m.W[l], m.WW[l]);
      base[l][tid] = make_int2(by, bx);
      int* b = bases + ((size_t)e * 2 * kLevels + 2 * l) * P + p0 + tid;   // [E, 2L, P]
      b[0] = by;
      b[P] = bx;
    }
  }
  __syncthreads();
  const int wwm = m.ww_max, runs = (wwm + 7) >> 3;   // 16-byte chunks of a window row
  const size_t pix = (size_t)m.sum_wh * wwm;         // cells of a pixel's packed windows
  bf16* out = wins + ep0 * pix;
#pragma unroll
  for (int l = 0; l < kLevels; l++) {
    const int Hl = m.H[l], Wl = m.W[l], WWl = m.WW[l];
    const bf16* lv = m.lv[l] + ep0 * Hl * Wl;
    const int per = m.WH[l] * runs, n = np * per;   // (row, chunk) items a pixel, a tile
    for (int i = tid; i < n; i += kThreadsB) {
      const int q = i / per, rk = i - q * per, r = rk / runs, k = rk - r * runs;
      const int2 b = base[l][q];
      const int y = b.x + r - kPad, x0 = b.y - kPad + 8 * k;   // the chunk's first cell
      const bool in_y = y >= 0 && y < Hl;
      const bf16* row = lv + ((size_t)q * Hl + (in_y ? y : 0)) * Wl;
      uint4 v;
      if (vec >> l & 1) {
        // chunks x0 >> 3 and, where x0 & 7, the next; a chunk off the row is 0
        const int ch = x0 >> 3, s = x0 & 7, wc = Wl >> 3;
        const uint4* rc = reinterpret_cast<const uint4*>(row);
        const uint4 zero = make_uint4(0, 0, 0, 0);
        const uint4 lo = in_y && ch >= 0 && ch < wc ? __ldg(rc + ch) : zero;
        const uint4 hi = in_y && s && ch + 1 >= 0 && ch + 1 < wc ? __ldg(rc + ch + 1) : zero;
        v = lookup_bf16::span8(lo, hi, s);
      } else {
        const unsigned short* rs = reinterpret_cast<const unsigned short*>(row);
        unsigned short cell[8];
#pragma unroll
        for (int j = 0; j < 8; j++) {
          const int x = x0 + j;
          cell[j] = in_y && 8 * k + j < WWl && x >= 0 && x < Wl ? __ldg(rs + x) : 0;
        }
        v = lookup_bf16::pack8(cell);
      }
      bf16* d = out + q * pix + (size_t)(m.off[l] + r) * wwm + 8 * k;
      if (vec & kVecStores) {
        *reinterpret_cast<uint4*>(d) = v;
      } else {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        unsigned short* ds = reinterpret_cast<unsigned short*>(d);
#pragma unroll
        for (int j = 0; j < 8; j++)
          if (8 * k + j < wwm) ds[j] = (unsigned short)(w[j >> 1] >> (16 * (j & 1)));
      }
    }
  }
}

template <typename T>
Meta<T> meta(const void* const* lv, int H2, int W2) {
  Meta<T> m;
  m.sum_wh = 0;
  m.ww_max = 0;
  for (int l = 0; l < kLevels; l++) {
    m.lv[l] = (const T*)lv[l];
    m.H[l] = H2 >> l;
    m.W[l] = W2 >> l;
    m.WH[l] = m.H[l] + 2 * kPad < kWin ? m.H[l] + 2 * kPad : kWin;
    m.WW[l] = m.W[l] + 2 * kPad < kWin ? m.W[l] + 2 * kPad : kWin;
    m.off[l] = m.sum_wh;
    m.sum_wh += m.WH[l];
    m.ww_max = m.WW[l] > m.ww_max ? m.WW[l] : m.ww_max;
  }
  return m;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Launches K7 on `stream`: level0..level3 from K2 ([E, P, H2 >> l, W2 >> l]
// float32), coords [E, P, 2] float32 level-0 pixels -> wins
// [E, P, sum WH, max WW] float32 (16-byte aligned, as torch.empty gives it)
// and bases [E, 8, P] int32.  Returns cudaGetLastError() after the launch.
extern "C" int corr_extract_windows_launch(const void* level0, const void* level1,
                                           const void* level2, const void* level3,
                                           const void* coords, int E, int P, int H2, int W2,
                                           void* wins, void* bases, void* stream) {
  const void* lv[kLevels] = {level0, level1, level2, level3};
  const Meta<float> m = meta<float>(lv, H2, W2);
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E > 0 && P > 0) {
    dim3 grid(P, E);
    extract_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        m, (const float2*)coords, (float*)wins, (int*)bases, P);
  }
  return (int)cudaGetLastError();
}

// The same on bf16 levels -> bf16 windows, the same bases.  Each level is
// read 16 bytes at a time where its rows are whole 16-byte chunks and it is
// 16-byte aligned, else 2 bytes at a time.
extern "C" int corr_extract_windows_bf16_launch(const void* level0, const void* level1,
                                                const void* level2, const void* level3,
                                                const void* coords, int E, int P, int H2,
                                                int W2, void* wins, void* bases, void* stream) {
  const void* lv[kLevels] = {level0, level1, level2, level3};
  const Meta<bf16> m = meta<bf16>(lv, H2, W2);
  int vec = m.ww_max % 8 == 0 && aligned16(wins) ? kVecStores : 0;
  for (int l = 0; l < kLevels; l++)
    if (m.W[l] > 0 && m.W[l] % 8 == 0 && aligned16(lv[l])) vec |= 1 << l;
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E > 0 && P > 0) {
    dim3 grid((P + kTileB - 1) / kTileB, E);
    extract_windows_bf16_kernel<<<grid, kThreadsB, 0, (cudaStream_t)stream>>>(
        m, vec, (const float2*)coords, (bf16*)wins, (int*)bases, P);
  }
  return (int)cudaGetLastError();
}
