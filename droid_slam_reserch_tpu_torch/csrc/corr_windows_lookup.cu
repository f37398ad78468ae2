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
// What bounds it on the H100: bytes.  Each (e, p, l) reads an 8x8 block of
// its window and writes 49 floats; at the main path's shapes (E = 48,
// P = 2560) that is 126 MB read and 96 MB written, tens of microseconds.
//
// Design: one thread per (edge, pixel, level), as K3 (the edge is the
// grid's y, so no 64-bit division finds it): it loads the 8x8 block into
// registers, blends along y then along x, and writes its 49 outputs in the
// JAX channel order.  Neighbouring threads write 196 floats
// apart, so the stores do not coalesce (as in K3).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4, kPad = 8, kWin = 24, kR = 3;
constexpr int kD = 2 * kR + 1;  // 7 taps per axis

struct WinMeta {
  int WH[kLevels], WW[kLevels], off[kLevels];
  int sum_wh, ww_max;
};

__device__ __forceinline__ int floor_clamped(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

__global__ void windows_lookup_kernel(const float* __restrict__ wins,
                                      const int* __restrict__ bases,
                                      const float2* __restrict__ coords,
                                      float* __restrict__ out, int P, WinMeta m) {
  const int e = blockIdx.y;                  // grid: (pixel-level blocks, edges)
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * kLevels) return;
  const int p = idx / kLevels, l = idx % kLevels;
  const size_t ep = (size_t)e * P + p;
  int WH = m.WH[0], WW = m.WW[0], off = m.off[0];
#pragma unroll
  for (int k = 1; k < kLevels; k++)          // select without indexing the parameter
    if (l == k) {
      WH = m.WH[k];
      WW = m.WW[k];
      off = m.off[k];
    }

  const float2 c = coords[ep];
  const float scale = 1.f / (float)(1 << l);
  const float x = c.x * scale, y = c.y * scale;
  const float xf = floorf(x), yf = floorf(y);
  const float dx = x - xf, dy = y - yf;
  const int* b = bases + ((size_t)e * 2 * kLevels + 2 * l) * P + p;
  const int sy = min(max(floor_clamped(y) + kPad - kR - b[0], 0), WH - 8);
  const int sx = min(max(floor_clamped(x) + kPad - kR - b[P], 0), WW - 8);
  const float* w = wins + (ep * m.sum_wh + off + sy) * m.ww_max + sx;

  float g[kD + 1][kD + 1];
#pragma unroll
  for (int i = 0; i <= kD; i++)
#pragma unroll
    for (int j = 0; j <= kD; j++) g[i][j] = __ldg(w + i * m.ww_max + j);

  float* o = out + ep * (kLevels * kD * kD) + l * kD * kD;
#pragma unroll
  for (int b = 0; b < kD; b++) {
    float yb[kD + 1];
#pragma unroll
    for (int j = 0; j <= kD; j++) yb[j] = (1.f - dy) * g[b][j] + dy * g[b + 1][j];
#pragma unroll
    for (int a = 0; a < kD; a++) o[a * kD + b] = (1.f - dx) * yb[a] + dx * yb[a + 1];
  }
}

}  // namespace

// Launches K5 on `stream`: wins [E, P, sum WH, max WW] float32 and bases
// [E, 8, P] int32 from K4, coords [E, P, 2] float32 level-0 pixels, for an
// H2 x W2 target grid -> out [E, P, 196].  Returns cudaGetLastError().
extern "C" int corr_windows_lookup_launch(const void* wins, const void* bases,
                                          const void* coords, int E, int P, int H2, int W2,
                                          void* out, void* stream) {
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
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E > 0 && P > 0) {
    const int threads = 128;
    dim3 grid((P * kLevels + threads - 1) / threads, E);
    windows_lookup_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)wins, (const int*)bases, (const float2*)coords, (float*)out, P, m);
  }
  return (int)cudaGetLastError();
}
