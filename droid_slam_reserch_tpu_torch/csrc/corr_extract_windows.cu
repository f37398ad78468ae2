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
// Element types: fp32, and bf16 levels (the JAX package's bfloat16 path,
// where the TPU kernel writes levels[0].dtype) -> bf16 windows, a copy of
// cells with no rounding.  A thread writes a run of 16 bytes of a window row
// (4 fp32 or 8 bf16 cells) with one store wherever the packed rows are whole
// 16-byte runs (max WW a multiple of 4 or 8; 24 at any map 8 cells wide or
// more), cell by cell otherwise.  The bases are computed as in fp32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
extract_windows_kernel(Meta<T> m, const float2* __restrict__ coords, T* __restrict__ wins,
                       int* __restrict__ bases, int P) {
  constexpr int kVec = Io<T>::kVec;          // cells of a 16-byte store
  const int p = blockIdx.x, e = blockIdx.y, tid = threadIdx.x;
  const size_t ep = (size_t)e * P + p;
  const float2 c = coords[ep];
  const int wwm = m.ww_max, runs = (wwm + kVec - 1) / kVec;   // runs a window row
  T* out = wins + ep * m.sum_wh * wwm;
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
    const T* src = m.lv[l] + ep * Hl * Wl;
    T* dst = out + m.off[l] * wwm;
    const int n = m.WH[l] * runs;
    for (int i = tid; i < n; i += kThreads) {
      const int r = i / runs, c0 = kVec * (i - r * runs);
      const int y = by + r - kPad;
      const bool in_y = y >= 0 && y < Hl;
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; j++) {
        const int cc = c0 + j, x = bx + cc - kPad;
        v[j] = (in_y && cc < WWl && x >= 0 && x < Wl) ? Io<T>::load(src + y * Wl + x) : 0.f;
      }
      T* d = dst + r * wwm + c0;
      if (wwm % kVec == 0) {
        Io<T>::store_run(d, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; j++)
          if (c0 + j < wwm) d[j] = Io<T>::cvt(v[j]);
      }
    }
  }
}

template <typename T>
int launch(const void* const* lv, const void* coords, int E, int P, int H2, int W2, void* wins,
           void* bases, void* stream) {
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
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E > 0 && P > 0) {
    dim3 grid(P, E);
    extract_windows_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        m, (const float2*)coords, (T*)wins, (int*)bases, P);
  }
  return (int)cudaGetLastError();
}

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
  return launch<float>(lv, coords, E, P, H2, W2, wins, bases, stream);
}

// The same on bf16 levels -> bf16 windows, the same bases.
extern "C" int corr_extract_windows_bf16_launch(const void* level0, const void* level1,
                                                const void* level2, const void* level3,
                                                const void* coords, int E, int P, int H2,
                                                int W2, void* wins, void* bases, void* stream) {
  const void* lv[kLevels] = {level0, level1, level2, level3};
  return launch<bf16>(lv, coords, E, P, H2, W2, wins, bases, stream);
}
