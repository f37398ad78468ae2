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
// padded[0].dtype): the same kernel reads bf16 cells and widens them, rounds
// the fractional parts to bf16 as the TPU kernel casts them, blends in fp32
// with each operation rounded alone, and rounds each output once, so it
// equals the plain version (ops/corr.py) exactly.  The outputs are staged as
// bf16 and stored 8 to a 16-byte store; a tile's run starts 8-byte aligned
// (196 outputs a pixel), so its first and last 8 bytes may take an 8-byte
// store.  It moves about half the bytes of the fp32 kernel, with as many
// loads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
pmajor_lookup_kernel(Padded<T> pad, const float2* __restrict__ coords, T* __restrict__ out,
                     int P) {
  // the outputs in T; a bf16 run may start 8 bytes into a 16-byte chunk, and
  // the stage starts as many bytes in, so that it lines up with the chunks
  __shared__ __align__(16) T stage[kTile * kOut + (sizeof(T) == 2 ? 8 : 0)];
  const int tid = threadIdx.x, q = tid / kD, a = tid - q * kD;
  const int e = blockIdx.y, p0 = blockIdx.x * kTile;
  const int np = min(kTile, P - p0);
  // where the tile's first output lies in its 16-byte chunk: 0 or 4 (kOut % 4 == 0)
  const int sh = sizeof(T) == 2 ? (int)((((size_t)e * P + p0) * kOut) & 7) : 0;

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
      f[l] = make_float2(Io<T>::round(x - floorf(x)), Io<T>::round(y - floorf(y)));
      // cell (row, column) of edge e lives at ((e * Hp + row) * Wp + column) * P + p
      const T* v = pad.lv[l] + (((size_t)e * Hp + sy) * Wp + sx + a) * col + p0 + q;
      const size_t row = (size_t)Wp * col;
#pragma unroll
      for (int i = 0; i <= kD; i++) {
        g[l][0][i] = Io<T>::load(v + i * row);
        g[l][1][i] = Io<T>::load(v + i * row + col);
      }
    }
    T* o = stage + sh + q * kOut + a * kD;
#pragma unroll
    for (int l = 0; l < kLevels; l++)
#pragma unroll
      for (int b = 0; b < kD; b++)
        o[l * kD * kD + b] =
            Io<T>::cvt(blend(g[l][0][b], g[l][1][b], g[l][0][b + 1], g[l][1][b + 1], f[l]));
  }
  __syncthreads();

  // ---- the tile's np x 196 outputs are one contiguous run: 16-byte stores,
  // chunk i holding outputs 8 i - sh .. 8 i - sh + 7 (bf16) or 4 i .. 4 i + 3
  const size_t first = ((size_t)e * P + p0) * kOut;
  if constexpr (sizeof(T) == 4) {
    float4* dst = reinterpret_cast<float4*>(out + first);
    const float4* src = reinterpret_cast<const float4*>(stage);
    for (int i = tid; i < np * (kOut / 4); i += kThreads) dst[i] = src[i];
  } else {
    const int n = np * kOut;
    uint4* dst = reinterpret_cast<uint4*>(out + first - sh);
    const uint4* src = reinterpret_cast<const uint4*>(stage);
    for (int i = tid; i < (sh + n + 7) / 8; i += kThreads) {
      const uint4 v = src[i];
      const int lo = 8 * i - sh;                 // the chunk's first output
      if (lo >= 0 && lo + 8 <= n) {
        dst[i] = v;
      } else {                                    // half in the run: 8 bytes
        uint2* d = reinterpret_cast<uint2*>(dst + i);
        if (lo >= 0) d[0] = make_uint2(v.x, v.y);
        else d[1] = make_uint2(v.z, v.w);
      }
    }
  }
}

template <typename T>
int launch(const void* const* lv, const void* coords, int E, int P, int H2, int W2, void* out,
           void* stream) {
  Padded<T> pad;
  for (int l = 0; l < kLevels; l++) {
    pad.lv[l] = (const T*)lv[l];
    pad.Hp[l] = (H2 >> l) + 2 * kPad;
    pad.Wp[l] = (W2 >> l) + 2 * kPad;
  }
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E > 0 && P > 0) {
    dim3 grid((P + kTile - 1) / kTile, E);
    pmajor_lookup_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        pad, (const float2*)coords, (T*)out, P);
  }
  return (int)cudaGetLastError();
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
  return launch<float>(lv, coords, E, P, H2, W2, out, stream);
}

// The same on bf16 padded levels -> out [E, P, 196] bf16.
extern "C" int corr_pmajor_lookup_bf16_launch(const void* level0, const void* level1,
                                              const void* level2, const void* level3,
                                              const void* coords, int E, int P, int H2,
                                              int W2, void* out, void* stream) {
  const void* lv[kLevels] = {level0, level1, level2, level3};
  return launch<bf16>(lv, coords, E, P, H2, W2, out, stream);
}
