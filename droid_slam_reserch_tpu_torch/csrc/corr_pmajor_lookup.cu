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
// What bounds it on the H100: bytes.  Each (e, p, l) reads 64 cells and
// writes 49 floats; at the main path's shapes (E = 48, P = 2560) that is
// 126 MB read and 96 MB written, tens of microseconds.
//
// Design: one thread per (edge, pixel, level), the pixel fastest across a
// warp, so each of the 64 loads reads 32 neighbouring floats of one padded
// row (the pixels-last layout makes the reads coalesce).  The blend is K3's
// (along y, then along x); the 49 outputs of a thread are contiguous, so
// neighbouring threads write 196 floats apart, as in K3.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4, kPad = 8, kR = 3;
constexpr int kD = 2 * kR + 1;  // 7 taps per axis
constexpr int kThreads = 128;

struct Padded {
  const float* lv[kLevels];
  int Hp[kLevels], Wp[kLevels];
};

__device__ __forceinline__ int floor_clamped(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

__global__ void __launch_bounds__(kThreads)
pmajor_lookup_kernel(Padded pad, const float2* __restrict__ coords, float* __restrict__ out,
                     int P) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int l = blockIdx.y;                  // grid: (pixel blocks, levels, edges)
  const int e = blockIdx.z;
  if (p >= P) return;
  const float* v = pad.lv[0];
  int Hp = pad.Hp[0], Wp = pad.Wp[0];
#pragma unroll
  for (int k = 1; k < kLevels; k++)          // select without indexing the parameter
    if (l == k) {
      v = pad.lv[k];
      Hp = pad.Hp[k];
      Wp = pad.Wp[k];
    }

  const size_t ep = (size_t)e * P + p;
  const float2 c = coords[ep];
  const float scale = 1.f / (float)(1 << l);
  const float x = c.x * scale, y = c.y * scale;
  const float xf = floorf(x), yf = floorf(y);
  const float dx = x - xf, dy = y - yf;
  const int sy = min(max(floor_clamped(y) + kPad - kR, 0), Hp - 8);
  const int sx = min(max(floor_clamped(x) + kPad - kR, 0), Wp - 8);
  // cell (row, col) of edge e lives at ((e * Hp + row) * Wp + col) * P + p
  const float* base = v + (((size_t)e * Hp + sy) * Wp + sx) * P + p;

  float g[kD + 1][kD + 1];
#pragma unroll
  for (int i = 0; i <= kD; i++)
#pragma unroll
    for (int j = 0; j <= kD; j++) g[i][j] = __ldg(base + ((size_t)i * Wp + j) * P);

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

// Launches K6 on `stream`: level0..level3 the padded P-major levels
// [E, (H2 >> l) + 16, (W2 >> l) + 16, P] float32, coords [E, P, 2] float32
// level-0 pixels -> out [E, P, 196].  Returns cudaGetLastError().
extern "C" int corr_pmajor_lookup_launch(const void* level0, const void* level1,
                                         const void* level2, const void* level3,
                                         const void* coords, int E, int P, int H2, int W2,
                                         void* out, void* stream) {
  Padded pad;
  const void* lv[kLevels] = {level0, level1, level2, level3};
  for (int l = 0; l < kLevels; l++) {
    pad.lv[l] = (const float*)lv[l];
    pad.Hp[l] = (H2 >> l) + 2 * kPad;
    pad.Wp[l] = (W2 >> l) + 2 * kPad;
  }
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's z
  if (E > 0 && P > 0) {
    dim3 grid((P + kThreads - 1) / kThreads, kLevels, E);
    pmajor_lookup_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        pad, (const float2*)coords, (float*)out, P);
  }
  return (int)cudaGetLastError();
}
