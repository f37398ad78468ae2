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
// bf16 (the JAX package's bfloat16 path, where K2 stores bf16 levels) has a
// kernel of its own, corr_lookup_bf16_kernel: the fp32 design's 64 scalar
// loads a thread set its time, not its bytes.  One thread per (pixel,
// level) reads its span's 8 rows as aligned 16-byte chunks wherever the
// level's width is a multiple of 8 cells and the level 16-byte aligned
// (every level at the main path's 40x64).  Row yy of the span needs chunk
// floor(x0 / 8) and, where x0 % 8 != 0, the next one (x0 = floor(x) - 3 may
// be negative: floor division); each chunk lies wholly inside the level's
// row or wholly outside it, so cells off the level read 0 by skipping whole
// chunks and rows.  It loads all 8 rows (up to 16 chunks) before it
// blends; lookup_bf16.cuh aligns them with funnel shifts, blends row pair
// by row pair (along y, then x, each product and sum rounded on its own,
// the fractional parts rounded to bf16 as the TPU kernel casts them to the
// volume's dtype, the output rounded once, so it equals the plain version,
// ops/corr.py, exactly) into the tile's outputs staged in shared memory,
// and the block writes the tile's contiguous run with 16-byte stores
// (8-byte ones where the run starts at an odd pixel, e * P + p0).  A level whose
// width is not a multiple of 8, or that is not 16-byte aligned, is read
// 2 bytes a cell by the same body, with bounds checks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"
#include "lookup_bf16.cuh"

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

__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Pyramid<float> pyr, const float2* __restrict__ coords,
                   float* __restrict__ out, int P) {
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
      f[l] = make_float2(Io<float>::round(x - floorf(x)), Io<float>::round(y - floorf(y)));
      const float* v = pyr.lv[l] + ((size_t)e * P + p0 + q) * H * W;
      const bool ok0 = x0 >= 0 && x0 < W, ok1 = x0 + 1 >= 0 && x0 + 1 < W;
#pragma unroll
      for (int i = 0; i <= kD; i++) {
        const int yy = y0 + i;
        const bool oky = yy >= 0 && yy < H;
        g[l][0][i] = oky && ok0 ? Io<float>::load(v + (size_t)yy * W + x0) : 0.f;
        g[l][1][i] = oky && ok1 ? Io<float>::load(v + (size_t)yy * W + x0 + 1) : 0.f;
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
  const float4* src = reinterpret_cast<const float4*>(stage);
  float* dst = out + ((size_t)e * P + p0) * kOut;
  for (int i = tid; i < np * (kOut / 4); i += kThreads) reinterpret_cast<float4*>(dst)[i] = src[i];
}

constexpr int kTileB = 16;                  // bf16: pixels a block
constexpr int kThreadsB = kTileB * kLevels; // a thread per (pixel, level)

// The 8 rows of the span at (x0, y0) of an H x W level (v points at the
// pixel's level), cells x0 .. x0 + 7 of rows y0 .. y0 + 7, 0 off the level:
// whole 16-byte chunks (kVec: W % 8 == 0, v 16-byte aligned) or 2-byte cells.
template <bool kVec>
__device__ __forceinline__ void load_span(const bf16* v, int H, int W, int x0, int y0,
                                          uint4 (&rows)[8]) {
  if constexpr (kVec) {
    const int cx = x0 >> 3, s = x0 & 7;     // floor division: x0 may be negative
    const bool ok0 = cx >= 0 && cx < W / 8, ok1 = s && cx + 1 >= 0 && cx + 1 < W / 8;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4 lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
      const int yy = y0 + i;
      const bool oky = yy >= 0 && yy < H;
      const uint4* r = reinterpret_cast<const uint4*>(v + (size_t)(oky ? yy : 0) * W) + cx;
      lo[i] = oky && ok0 ? __ldg(r) : zero;
      hi[i] = oky && ok1 ? __ldg(r + 1) : zero;
    }
#pragma unroll
    for (int i = 0; i < 8; i++) rows[i] = lookup_bf16::span8(lo[i], hi[i], s);
  } else {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(v);
    unsigned short c[8][8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
      const int yy = y0 + i;
      const bool oky = yy >= 0 && yy < H;
#pragma unroll
      for (int j = 0; j < 8; j++) {
        const int xx = x0 + j;
        c[i][j] = oky && xx >= 0 && xx < W ? __ldg(r + (size_t)yy * W + xx) : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; i++) rows[i] = lookup_bf16::pack8(c[i]);
  }
}

// A block takes kTileB consecutive pixels of edge blockIdx.y; thread
// l * kTileB + q is (pixel p0 + q, level l), so a warp's coords loads
// coalesce.  Bit l of `vec` says that level l's rows are read in 16-byte
// chunks.
__global__ void __launch_bounds__(kThreadsB)
corr_lookup_bf16_kernel(Pyramid<bf16> pyr, int vec, const float2* __restrict__ coords,
                        bf16* __restrict__ out, int P) {
  __shared__ __align__(16) bf16 stage[kTileB * kOut];
  const int tid = threadIdx.x, l = tid / kTileB, q = tid - l * kTileB;
  const int e = blockIdx.y, p0 = blockIdx.x * kTileB;
  const int np = min(kTileB, P - p0);
  if (q < np) {
    const bf16* lv = pyr.lv[0];
    int H = pyr.H[0], W = pyr.W[0];
#pragma unroll
    for (int k = 1; k < kLevels; k++)        // select without indexing the parameter
      if (l == k) {
        lv = pyr.lv[k];
        H = pyr.H[k];
        W = pyr.W[k];
      }
    const float2 c = coords[(size_t)e * P + p0 + q];
    const float scale = 1.f / (float)(1 << l);
    const float x = c.x * scale, y = c.y * scale;
    const int y0 = floor_clamped(y) - kR, x0 = floor_clamped(x) - kR;
    const float fx = Io<bf16>::round(x - floorf(x)), fy = Io<bf16>::round(y - floorf(y));
    const bf16* v = lv + ((size_t)e * P + p0 + q) * H * W;
    uint4 rows[8];
    if ((vec >> l) & 1)
      load_span<true>(v, H, W, x0, y0, rows);
    else
      load_span<false>(v, H, W, x0, y0, rows);
    lookup_bf16::blend_span(rows, fx, fy, stage + q * kOut + l * kD * kD);
  }
  __syncthreads();
  lookup_bf16::store_run(stage, out + ((size_t)e * P + p0) * kOut, np * kOut, tid, kThreadsB);
}

template <typename T>
Pyramid<T> pyramid(const void* const* lv, int H2, int W2) {
  Pyramid<T> pyr;
  for (int l = 0; l < kLevels; l++) {
    pyr.lv[l] = (const T*)lv[l];
    pyr.H[l] = H2 >> l;
    pyr.W[l] = W2 >> l;
  }
  return pyr;
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
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E > 0 && P > 0) {
    dim3 grid((P + kTile - 1) / kTile, E);
    corr_lookup_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        pyramid<float>(lv, H2, W2), (const float2*)coords, (float*)out, P);
  }
  return (int)cudaGetLastError();
}

// The same on bf16 levels (K2's bf16 instantiation) -> out [E, P, 196] bf16
// (8-byte aligned).  A level is read 16 bytes at a time where its width is a
// multiple of 8 and it starts 16-byte aligned, else 2 bytes at a time.
extern "C" int corr_lookup_bf16_launch(const void* level0, const void* level1,
                                       const void* level2, const void* level3,
                                       const void* coords, int E, int P, int H2, int W2,
                                       void* out, void* stream) {
  const void* lv[kLevels] = {level0, level1, level2, level3};
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  int vec = 0;
  for (int l = 0; l < kLevels; l++)
    if ((W2 >> l) % 8 == 0 && (reinterpret_cast<uintptr_t>(lv[l]) & 15) == 0) vec |= 1 << l;
  if (E > 0 && P > 0) {
    dim3 grid((P + kTileB - 1) / kTileB, E);
    corr_lookup_bf16_kernel<<<grid, kThreadsB, 0, (cudaStream_t)stream>>>(
        pyramid<bf16>(lv, H2, W2), vec, (const float2*)coords, (bf16*)out, P);
  }
  return (int)cudaGetLastError();
}
