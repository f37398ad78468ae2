// K5: radius-3 bilinear lookup inside the per-pixel window cache, for Hopper.
//
// Replaces the TPU kernel droid_slam_reserch_tpu/ops/pallas_corr.py
// (corr_lookup_windows_pallas, body _lookup_windows_kernel).  Same function:
// for edge e, source pixel p and level l, with (x, y) = coords[e, p] / 2^l,
// the 8-tap span starts at window row
//   sy = clip(floor(y) + 8 - 3 - by_l, 0, WH_l - 8)
// (sx likewise) of the window K4 cut around the first round's coords, and
//   out[e, p, 49 l + 7 a + b] = (1 - fx) * Y[b][a] + fx * Y[b][a + 1],
//   Y[b][j] = (1 - fy) * w[sy + b][sx + j] + fy * w[sy + b + 1][sx + j]
// with fx, fy the fractional parts: the K3 formula read from the window.
// It equals K3 wherever the engine's drift rule (ops/corr.py
// window_drift_ok) holds, taps off the image included, because the window
// carries the zero border.
//
// What bounds it on the H100: bytes.  Each (e, p, l) reads the 8x8 block of
// its window that it samples and writes 49 floats; at the main path's shapes
// (E = 48, P = 2560) that is 126 MB read and 96 MB written, 0.068 ms at
// 3.35 TB/s.
//
// Design: one thread per output value out[e, p, c], c = 49 l + 7 a + b, so
// that consecutive threads write consecutive floats and every store
// coalesces (the edge is the grid's y, so no 64-bit division finds it).  A
// thread reads only its four cells, rows sy + b and sy + b + 1 and columns
// sx + a and sx + a + 1, and blends them first along y, then along x, as the
// plain version does.  The 196 threads of a pixel share its four 8x8 spans,
// so those loads hit in L1; its coords and bases are warp broadcasts.
//
// bf16 (the JAX package's bfloat16 path, where K4 stores bf16 windows): the
// same kernel reads bf16 cells and writes bf16 outputs.  It blends in fp32
// with the fractional parts rounded to bf16, as the TPU kernel casts them,
// each product and sum rounded on its own (no FMAs) as the plain version
// rounds them, and rounds the output once, so it equals the plain version
// exactly.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

constexpr int kLevels = 4, kPad = 8, kWin = 24, kR = 3;
constexpr int kD = 2 * kR + 1;          // 7 taps per axis
constexpr int kOut = kLevels * kD * kD; // 196 outputs per pixel
constexpr int kThreads = 256;

struct WinMeta {
  int WH[kLevels], WW[kLevels], off[kLevels];
  int sum_wh, ww_max;
};

__device__ __forceinline__ int floor_clamped(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
windows_lookup_kernel(const T* __restrict__ wins, const int* __restrict__ bases,
                      const float2* __restrict__ coords, T* __restrict__ out, int P,
                      WinMeta m) {
  const int e = blockIdx.y;                  // grid: (output blocks, edges)
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= P * kOut) return;
  const int p = idx / kOut, ch = idx - p * kOut;
  const int l = ch / (kD * kD), ab = ch - l * (kD * kD);
  const int a = ab / kD, b = ab - a * kD;
  int WH = m.WH[0], WW = m.WW[0], off = m.off[0];
#pragma unroll
  for (int k = 1; k < kLevels; k++)          // select without indexing the parameter
    if (l == k) {
      WH = m.WH[k];
      WW = m.WW[k];
      off = m.off[k];
    }

  const size_t ep = (size_t)e * P + p;
  const float2 c = coords[ep];
  const float scale = 1.f / (float)(1 << l);
  const float x = c.x * scale, y = c.y * scale;
  const float dx = x - floorf(x), dy = y - floorf(y);
  const int* bp = bases + ((size_t)e * 2 * kLevels + 2 * l) * P + p;
  const int sy = min(max(floor_clamped(y) + kPad - kR - bp[0], 0), WH - 8);
  const int sx = min(max(floor_clamped(x) + kPad - kR - bp[P], 0), WW - 8);
  const T* w = wins + (ep * m.sum_wh + off + sy + b) * m.ww_max + sx + a;

  const float g00 = Io<T>::load(w), g01 = Io<T>::load(w + 1);
  const float g10 = Io<T>::load(w + m.ww_max), g11 = Io<T>::load(w + m.ww_max + 1);
  if constexpr (sizeof(T) == 4) {
    const float y0 = (1.f - dy) * g00 + dy * g10;   // Y[b][a]
    const float y1 = (1.f - dy) * g01 + dy * g11;   // Y[b][a + 1]
    out[(size_t)e * P * kOut + idx] = (1.f - dx) * y0 + dx * y1;
  } else {
    const float fy = Io<T>::round(dy), fx = Io<T>::round(dx);
    const float wy = 1.f - fy, wx = 1.f - fx;
    const float y0 = __fadd_rn(__fmul_rn(wy, g00), __fmul_rn(fy, g10));
    const float y1 = __fadd_rn(__fmul_rn(wy, g01), __fmul_rn(fy, g11));
    out[(size_t)e * P * kOut + idx] = Io<T>::cvt(__fadd_rn(__fmul_rn(wx, y0), __fmul_rn(fx, y1)));
  }
}

template <typename T>
int launch(const void* wins, const void* bases, const void* coords, int E, int P, int H2,
           int W2, void* out, void* stream) {
  WinMeta m;
  m.sum_wh = 0;
  m.ww_max = 0;
  for (int l = 0; l < kLevels; l++) {
    const int hp = (H2 >> l) + 2 * kPad, wp = (W2 >> l) + 2 * kPad;
    m.WH[l] = hp < kWin ? hp : kWin;
    m.WW[l] = wp < kWin ? wp : kWin;
    m.off[l] = m.sum_wh;
    m.sum_wh += m.WH[l];
    m.ww_max = m.WW[l] > m.ww_max ? m.WW[l] : m.ww_max;
  }
  if (E > 65535 || (long long)P * kOut > 0x7fffffffLL)   // edges ride the grid's y
    return (int)cudaErrorInvalidValue;
  if (E > 0 && P > 0) {
    dim3 grid((P * kOut + kThreads - 1) / kThreads, E);
    windows_lookup_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)wins, (const int*)bases, (const float2*)coords, (T*)out, P, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K5 on `stream`: wins [E, P, sum WH, max WW] float32 and bases
// [E, 8, P] int32 from K4, coords [E, P, 2] float32 level-0 pixels, for an
// H2 x W2 target grid -> out [E, P, 196].  Returns cudaGetLastError().
extern "C" int corr_windows_lookup_launch(const void* wins, const void* bases,
                                          const void* coords, int E, int P, int H2, int W2,
                                          void* out, void* stream) {
  return launch<float>(wins, bases, coords, E, P, H2, W2, out, stream);
}

// The same over K4's bf16 windows -> out [E, P, 196] bf16.
extern "C" int corr_windows_lookup_bf16_launch(const void* wins, const void* bases,
                                               const void* coords, int E, int P, int H2,
                                               int W2, void* out, void* stream) {
  return launch<bf16>(wins, bases, coords, E, P, H2, W2, out, stream);
}
