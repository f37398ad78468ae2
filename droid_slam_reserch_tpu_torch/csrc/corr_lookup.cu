// K3: radius-3 bilinear lookup in a 4-level correlation pyramid, for Hopper.
//
// Replaces the TPU kernel droid_slam_reserch_tpu/ops/pallas_corr.py
// (corr_lookup_blocked_pallas, body _lookup_blocked_kernel).  Same function:
// for edge e, source pixel p and level l, with (x, y) = coords[e, p] / 2^l,
//   out[e, p, 49 l + 7 a + b] = bilinear sample of level l at
//                               (floor(x) - 3 + a + fx, floor(y) - 3 + b + fy)
// where fx, fy are the fractional parts, a is the x tap and b the y tap.
// Corners outside the level read 0 (the TPU kernel reads its 8-pixel zero
// border instead, which gives the same values).  Levels are the port's
// layout [E, P, H2 >> l, W2 >> l] written by K2.
//
// What bounds it on the H100: bytes.  Each (e, p, l) needs at most an 8x8
// window of its level (8 rows of 32 bytes) and writes 49 floats; at the
// main path's shapes (E = 48, P = 2560) that is about 126 MB read and 96 MB
// written, tens of microseconds, with a few flops per byte.
//
// Design: one thread per (edge, pixel, level).  It loads the 8x8 window
// into registers with bounds checks, blends along y then along x (the plain
// version's order), and writes its 49 outputs in the JAX channel order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 3;
constexpr int kD = 2 * kR + 1;     // 7 taps per axis
constexpr int kLevels = 4;

struct Pyramid {
  const float* lv[kLevels];
  int H[kLevels];
  int W[kLevels];
};

__global__ void corr_lookup_kernel(Pyramid pyr, const float2* __restrict__ coords,
                                   float* __restrict__ out, size_t EP) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= EP * kLevels) return;
  const size_t ep = idx / kLevels;
  const int l = (int)(idx % kLevels);
  const int Hl = pyr.H[l], Wl = pyr.W[l];
  const float* v = pyr.lv[l] + ep * Hl * Wl;

  const float2 c = coords[ep];
  const float scale = 1.f / (float)(1 << l);
  const float x = c.x * scale, y = c.y * scale;
  const float xf = floorf(x), yf = floorf(y);
  const float dx = x - xf, dy = y - yf;
  const int x0 = (int)fminf(fmaxf(xf, -1e6f), 1e6f) - kR;
  const int y0 = (int)fminf(fmaxf(yf, -1e6f), 1e6f) - kR;

  float g[kD + 1][kD + 1];
#pragma unroll
  for (int i = 0; i <= kD; i++) {
    const int yy = y0 + i;
    const bool oky = yy >= 0 && yy < Hl;
#pragma unroll
    for (int j = 0; j <= kD; j++) {
      const int xx = x0 + j;
      g[i][j] = (oky && xx >= 0 && xx < Wl) ? __ldg(v + (size_t)yy * Wl + xx) : 0.f;
    }
  }

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

// Launches K3 on `stream`: level0..level3 from K2 (H2 x W2 target grid at
// level 0), coords [E, P, 2] float32 level-0 pixels -> out [E, P, 196].
// Returns cudaGetLastError() after the launch.
extern "C" int corr_lookup_launch(const void* level0, const void* level1,
                                  const void* level2, const void* level3,
                                  const void* coords, int E, int P, int H2, int W2,
                                  void* out, void* stream) {
  Pyramid pyr;
  const void* lv[kLevels] = {level0, level1, level2, level3};
  for (int l = 0; l < kLevels; l++) {
    pyr.lv[l] = (const float*)lv[l];
    pyr.H[l] = H2 >> l;
    pyr.W[l] = W2 >> l;
  }
  const size_t EP = (size_t)E * P;
  if (EP > 0) {
    const int threads = 128;
    const size_t blocks = (EP * kLevels + threads - 1) / threads;
    corr_lookup_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        pyr, (const float2*)coords, (float*)out, EP);
  }
  return (int)cudaGetLastError();
}
