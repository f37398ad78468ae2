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
// span of its level (8 rows of 32 bytes, each row straddling up to two
// 32-byte sectors) and writes 49 floats; at the main path's shapes (E = 48,
// P = 2560) that is about 126 MB needed (up to 250 MB of sectors) and 96 MB
// written, with a few flops per byte.  A thread per (e, p, l), as the first
// version had it, makes each of its 64 loads touch 32 sectors for a warp and
// writes its 49 floats 196 floats from its neighbour's.
//
// Design, K6's: one block per (edge, tile of 16 consecutive pixels), a
// thread per (pixel, x tap a).  A thread reads its span's columns a and
// a + 1 at all four levels (64 bounds-checked loads, all in flight
// together; cells off the level read 0) and blends its 28 outputs, along y
// then along x (the plain version's order), into the tile's [16][196]
// outputs staged in shared memory; the block then writes them as one
// contiguous run with 16-byte stores.  The loads go through L1, where the 7
// threads of a (pixel, level) share the sectors of its span's rows.
// Copying each (pixel, level)'s span into shared memory first, 8 lanes to a
// row, and blending four outputs a thread from there was slower, at E = 48
// and at E = 1.  16-pixel tiles give the motion filter's single edge 160
// blocks, more than the 132 SMs.
//
// bf16 (the JAX package's bfloat16 path, where K2 stores bf16 levels): the
// same kernel reads bf16 spans and writes bf16 outputs.  It blends in fp32
// with the fractional parts rounded to bf16, as the TPU kernel casts them
// to the volume's dtype, and rounds each output once, so it equals the
// plain version (ops/corr.py) exactly.  It moves about half the bytes of
// the fp32 kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

constexpr int kR = 3;
constexpr int kD = 2 * kR + 1;          // 7 taps per axis
constexpr int kLevels = 4;
constexpr int kOut = kLevels * kD * kD; // 196 outputs per pixel
constexpr int kTile = 16;               // pixels per block
constexpr int kThreads = kTile * kD;    // a thread per (pixel, x tap)

template <typename T> struct Pyramid {
  const T* lv[kLevels];
  int H[kLevels];
  int W[kLevels];
};

__device__ __forceinline__ int floor_clamped(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

// Cells (row, column) g00 = (b, a), g01 = (b, a + 1), g10 = (b + 1, a),
// g11 = (b + 1, a + 1) of the span, f = (fx, fy): along y, then along x,
// each product and sum rounded on its own as the plain version rounds them
// (no contraction into FMAs), so K3, K6 and the plain versions agree exactly.
__device__ __forceinline__ float blend(float g00, float g01, float g10, float g11, float2 f) {
  const float wy = 1.f - f.y, wx = 1.f - f.x;
  const float y0 = __fadd_rn(__fmul_rn(wy, g00), __fmul_rn(f.y, g10));   // Y[b][a]
  const float y1 = __fadd_rn(__fmul_rn(wy, g01), __fmul_rn(f.y, g11));   // Y[b][a + 1]
  return __fadd_rn(__fmul_rn(wx, y0), __fmul_rn(f.x, y1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Pyramid<T> pyr, const float2* __restrict__ coords, T* __restrict__ out,
                   int P) {
  __shared__ __align__(16) float stage[kTile * kOut];
  const int tid = threadIdx.x, q = tid / kD, a = tid - q * kD;
  const int e = blockIdx.y, p0 = blockIdx.x * kTile;
  const int np = min(kTile, P - p0);

  if (q < np) {
    const float2 c = coords[(size_t)e * P + p0 + q];
    float g[kLevels][2][kD + 1];         // columns a and a + 1 of each level's span
    float2 f[kLevels];
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      const int H = pyr.H[l], W = pyr.W[l];
      const float scale = 1.f / (float)(1 << l);
      const float x = c.x * scale, y = c.y * scale;
      const int y0 = floor_clamped(y) - kR, x0 = floor_clamped(x) - kR + a;
      f[l] = make_float2(Io<T>::round(x - floorf(x)), Io<T>::round(y - floorf(y)));
      const T* v = pyr.lv[l] + ((size_t)e * P + p0 + q) * H * W;
      const bool ok0 = x0 >= 0 && x0 < W, ok1 = x0 + 1 >= 0 && x0 + 1 < W;
#pragma unroll
      for (int i = 0; i <= kD; i++) {
        const int yy = y0 + i;
        const bool oky = yy >= 0 && yy < H;
        g[l][0][i] = oky && ok0 ? Io<T>::load(v + (size_t)yy * W + x0) : 0.f;
        g[l][1][i] = oky && ok1 ? Io<T>::load(v + (size_t)yy * W + x0 + 1) : 0.f;
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

  // ---- the tile's np x 196 outputs are one contiguous run: 16-byte stores
  // (8-byte stores of 4 values in bf16)
  const float4* src = reinterpret_cast<const float4*>(stage);
  T* dst = out + ((size_t)e * P + p0) * kOut;
  for (int i = tid; i < np * (kOut / 4); i += kThreads) {
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(dst)[i] = src[i];
    } else {
      const float4 v = src[i];
      reinterpret_cast<uint2*>(dst)[i] =
          make_uint2(Io<T>::pack(v.x, v.y), Io<T>::pack(v.z, v.w));
    }
  }
}

template <typename T>
int launch(const void* const* lv, const void* coords, int E, int P, int H2, int W2, void* out,
           void* stream) {
  Pyramid<T> pyr;
  for (int l = 0; l < kLevels; l++) {
    pyr.lv[l] = (const T*)lv[l];
    pyr.H[l] = H2 >> l;
    pyr.W[l] = W2 >> l;
  }
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E > 0 && P > 0) {
    dim3 grid((P + kTile - 1) / kTile, E);
    corr_lookup_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        pyr, (const float2*)coords, (T*)out, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream`: level0..level3 from K2 (H2 x W2 target grid at
// level 0), coords [E, P, 2] float32 level-0 pixels -> out [E, P, 196]
// (16-byte aligned, as torch.empty gives it).  Returns cudaGetLastError()
// after the launch.
extern "C" int corr_lookup_launch(const void* level0, const void* level1,
                                  const void* level2, const void* level3,
                                  const void* coords, int E, int P, int H2, int W2,
                                  void* out, void* stream) {
  const void* lv[kLevels] = {level0, level1, level2, level3};
  return launch<float>(lv, coords, E, P, H2, W2, out, stream);
}

// The same on bf16 levels (K2's bf16 instantiation) -> out [E, P, 196] bf16.
extern "C" int corr_lookup_bf16_launch(const void* level0, const void* level1,
                                       const void* level2, const void* level3,
                                       const void* coords, int E, int P, int H2, int W2,
                                       void* out, void* stream) {
  const void* lv[kLevels] = {level0, level1, level2, level3};
  return launch<bf16>(lv, coords, E, P, H2, W2, out, stream);
}
