// K4: per-pixel window cache of the correlation pyramid, for Hopper, and
// K8: the same kernel storing the pyramid's levels as well.
//
// K4 replaces the TPU kernel droid_slam_reserch_tpu/ops/pallas_corr.py
// (corr_build_windows_light_pallas, body _build_windows_light_kernel), K8
// replaces corr_build_windows_pallas (body _build_windows_kernel).
// Same function: for edge e and source pixel p,
//   level0[y, x] = sum_c f1[e, p, c] * f2[e, y, x, c] / 16          (fp32)
//   level l+1    = 2x2 average of level l, floor semantics
// and, thinking of each level with an 8-pixel zero border, it writes the
// WH x WW block of the bordered level that starts at the base
//   by_l = clip(floor(y0 / 2^l) + 8 - 3 - (WH - 8) / 2, 0, Hp_l - WH)
// (bx_l likewise) around the first round's coords (x0, y0).  WH = WW = 24
// unless the bordered level is smaller, when the window is all of it.
// Output: windows [E, P, sum_l WH_l, max_l WW_l] (level l at rows off_l;
// columns past WW_l hold 0) and bases [E, 2L, P] int32 (by_l, bx_l).
// K4's pyramid never reaches device memory; K8 also writes each level in
// K2's layout [E, P, H2 >> l, W2 >> l] (csrc/corr_build.cu), no border.
//
// What bounds it on the H100: the product.  At the main path's shapes
// (E = 48, P = H2*W2 = 2560, C = 128) it is 2*E*P*P*C = 80.5 GFLOP of fp32,
// about 1.2 ms at the 67 TFLOP/s fp32 peak, against 1.1 GB of windows
// written (0.33 ms at 3.35 TB/s).
//
// Design: one block of 256 threads per (edge, group of PG = 8 pixels).  The
// block keeps its pixels' whole pyramid in shared memory (8 x 3400 floats,
// 109 KB at 40x64, so dynamic shared memory above 48 KB): a tiled fp32
// product streams f2[e] past the block's f1 rows in 1024-cell x 8-channel
// tiles, staged through registers so the next tile's loads overlap the
// current tile's arithmetic (each thread owns 8 pixels x 4 cells), and
// writes level 0; the block pools levels 1-3 in place (the four cells added
// in the plain version's order) and then cuts every window from shared
// memory with coalesced stores.  Where 8 pixels do not fit in shared memory
// it takes groups of 4.  Simple first: no tensor cores (the function is
// fp32), and every block re-reads f2[e] (from L2), 20 GB at the main path.
// K8 is the instantiation with kStoreLevels: after pooling, the block copies
// its pixels' levels from shared memory to device memory (a pixel group's
// level is one contiguous run there), 1.67 GB more stores at the main path;
// K4's instantiation compiles without that copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4, kPad = 8, kWin = 24, kR = 3;
constexpr int kThreads = 256;
constexpr int BN = 1024, BK = 8, TN = 4;   // 256 threads across cells, 4 cells each
constexpr int kBsStride = BN + 8;
constexpr int kLoads = BN * BK / kThreads;  // f2 values each thread stages per tile
constexpr int kMaxShared = 232448;          // bytes a block may use on Hopper

struct Meta {
  int H[kLevels], W[kLevels];    // level sizes
  int WH[kLevels], WW[kLevels];  // window extents
  int off[kLevels];              // packed row offset of each level's window
  int q0[kLevels + 1];           // prefix sums of H*W: a pixel's pyramid layout
  int sum_wh, ww_max;
};

struct LevelsOut {
  float* lv[kLevels];            // K8's levels [E, P, H_l, W_l]; unused by K4
};

__device__ __forceinline__ int floor_clamped(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

__device__ __forceinline__ int window_base(float c, float scale, int n, int win) {
  const int b = floor_clamped(c * scale) + kPad - kR - (win - 8) / 2;
  return min(max(b, 0), n + 2 * kPad - win);
}

template <int PG, bool kStoreLevels>
__global__ void __launch_bounds__(kThreads)
windows_build_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                     const float2* __restrict__ coords0, float* __restrict__ wins,
                     int* __restrict__ bases, int P, int C, Meta m, LevelsOut out_lv) {
  extern __shared__ float smem[];
  const int e = blockIdx.y;
  const int p0 = blockIdx.x * PG;
  const int Q = m.H[0] * m.W[0];
  float* lv[kLevels];
#pragma unroll
  for (int l = 0; l < kLevels; l++) lv[l] = smem + PG * m.q0[l];  // [PG][H_l * W_l]
  float* As = smem + PG * m.q0[kLevels];          // [BK][PG]
  float* Bs = As + BK * PG;                       // [BK][kBsStride]

  const int tid = threadIdx.x;
  const float* A = f1 + (size_t)e * P * C;
  const float* B = f2 + (size_t)e * Q * C;

  // level 0: the PG rows of the volume.  Tiles of BN cells x BK channels
  // are staged through registers, so the next tile's loads are in flight
  // while the block computes on the current one.
  const int nK = (C + BK - 1) / BK;
  const int nT = ((Q + BN - 1) / BN) * nK;
  float rb[kLoads], ra = 0.f;
  auto stage = [&](int t) {
    const int n0 = (t / nK) * BN, k0 = (t % nK) * BK;
#pragma unroll
    for (int u = 0; u < kLoads; u++) {
      const int i = tid + u * kThreads, r = i / BK, gq = n0 + r, gk = k0 + i % BK;
      rb[u] = (gq < Q && gk < C) ? __ldg(B + (size_t)gq * C + gk) : 0.f;
    }
    if (tid < PG * BK) {
      const int gp = p0 + tid / BK, gk = k0 + tid % BK;
      ra = (gp < P && gk < C) ? __ldg(A + (size_t)gp * C + gk) : 0.f;
    }
  };
  float acc[PG][TN];
#pragma unroll
  for (int i = 0; i < PG; i++)
#pragma unroll
    for (int j = 0; j < TN; j++) acc[i][j] = 0.f;
  stage(0);
  for (int t = 0; t < nT; t++) {
#pragma unroll
    for (int u = 0; u < kLoads; u++) {
      const int i = tid + u * kThreads;
      Bs[(i % BK) * kBsStride + i / BK] = rb[u];
    }
    if (tid < PG * BK) As[(tid % BK) * PG + tid / BK] = ra;
    __syncthreads();
    if (t + 1 < nT) stage(t + 1);
#pragma unroll
    for (int k = 0; k < BK; k++) {
      float a[PG], b[TN];
#pragma unroll
      for (int i = 0; i < PG; i++) a[i] = As[k * PG + i];
#pragma unroll
      for (int j = 0; j < TN; j++) b[j] = Bs[k * kBsStride + tid + kThreads * j];
#pragma unroll
      for (int i = 0; i < PG; i++)
#pragma unroll
        for (int j = 0; j < TN; j++) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
    if (t % nK == nK - 1) {                       // this tile's cells are complete
      const int n0 = (t / nK) * BN;
#pragma unroll
      for (int i = 0; i < PG; i++)
#pragma unroll
        for (int j = 0; j < TN; j++) {
          const int q = n0 + tid + kThreads * j;
          if (q < Q) lv[0][i * Q + q] = acc[i][j] * (1.f / 16.f);
          acc[i][j] = 0.f;
        }
    }
  }
  __syncthreads();

  // levels 1..3, pooled in shared memory
  for (int l = 1; l < kLevels; l++) {
    const int wi = m.W[l - 1], qi = m.H[l - 1] * wi;
    const int wo = m.W[l], qo = m.H[l] * wo;
    for (int i = tid; i < PG * qo; i += kThreads) {
      const int p = i / qo, rem = i - p * qo, y = rem / wo, x = rem - y * wo;
      const float* s = lv[l - 1] + p * qi + 2 * y * wi + 2 * x;
      lv[l][i] = (((s[0] + s[1]) + s[wi]) + s[wi + 1]) * 0.25f;
    }
    __syncthreads();
  }

  if constexpr (kStoreLevels) {          // K8: the levels, coalesced copies
    const int np = min(PG, P - p0);
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      const int q = m.H[l] * m.W[l];
      float* dst = out_lv.lv[l] + ((size_t)e * P + p0) * q;
      for (int i = tid; i < np * q; i += kThreads) dst[i] = lv[l][i];
    }
  }

  // bases, one thread per pixel
  if (tid < PG && p0 + tid < P) {
    const int gp = p0 + tid;
    const float2 c = coords0[(size_t)e * P + gp];
    for (int l = 0; l < kLevels; l++) {
      const float scale = 1.f / (float)(1 << l);
      int* b = bases + ((size_t)e * 2 * kLevels + 2 * l) * P + gp;
      b[0] = window_base(c.y, scale, m.H[l], m.WH[l]);
      b[P] = window_base(c.x, scale, m.W[l], m.WW[l]);
    }
  }

  // windows: each pixel's packed tile is contiguous, so the stores coalesce
  const int tile = m.sum_wh * m.ww_max;
  for (int p = 0; p < PG && p0 + p < P; p++) {
    const int gp = p0 + p;
    const float2 c = coords0[(size_t)e * P + gp];
    float* out = wins + ((size_t)e * P + gp) * tile;
    for (int l = 0; l < kLevels; l++) {
      const float scale = 1.f / (float)(1 << l);
      const int by = window_base(c.y, scale, m.H[l], m.WH[l]);
      const int bx = window_base(c.x, scale, m.W[l], m.WW[l]);
      const int Hl = m.H[l], Wl = m.W[l], WWl = m.WW[l];
      const float* src = lv[l] + p * Hl * Wl;
      float* dst = out + m.off[l] * m.ww_max;
      const int n = m.WH[l] * m.ww_max;
      for (int i = tid; i < n; i += kThreads) {
        const int r = i / m.ww_max, cc = i - r * m.ww_max;
        const int y = by + r - kPad, x = bx + cc - kPad;
        dst[i] = (cc < WWl && y >= 0 && y < Hl && x >= 0 && x < Wl) ? src[y * Wl + x] : 0.f;
      }
    }
  }
}

size_t shared_bytes(const Meta& m, int pg) {
  return sizeof(float) * ((size_t)pg * m.q0[kLevels] + (size_t)BK * pg + (size_t)BK * kBsStride);
}

template <int PG, bool kStoreLevels>
int launch(const Meta& m, size_t bytes, const float* f1, const float* f2, const float2* c0,
           float* wins, int* bases, const LevelsOut& lo, int E, int P, int C, cudaStream_t s) {
  int err = (int)cudaFuncSetAttribute(windows_build_kernel<PG, kStoreLevels>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  dim3 grid((P + PG - 1) / PG, E);
  windows_build_kernel<PG, kStoreLevels><<<grid, kThreads, bytes, s>>>(f1, f2, c0, wins, bases,
                                                                       P, C, m, lo);
  return (int)cudaGetLastError();
}

template <bool kStoreLevels>
int build_windows(const void* f1, const void* f2, const void* coords0, int E, int P, int H2,
                  int W2, int C, void* wins, void* bases, const LevelsOut& lo, void* stream) {
  Meta m;
  m.q0[0] = 0;
  m.sum_wh = 0;
  m.ww_max = 0;
  for (int l = 0; l < kLevels; l++) {
    m.H[l] = H2 >> l;
    m.W[l] = W2 >> l;
    m.WH[l] = m.H[l] + 2 * kPad < kWin ? m.H[l] + 2 * kPad : kWin;
    m.WW[l] = m.W[l] + 2 * kPad < kWin ? m.W[l] + 2 * kPad : kWin;
    m.off[l] = m.sum_wh;
    m.sum_wh += m.WH[l];
    m.ww_max = m.WW[l] > m.ww_max ? m.WW[l] : m.ww_max;
    m.q0[l + 1] = m.q0[l] + m.H[l] * m.W[l];
  }
  if (E > 65535) return (int)cudaErrorInvalidValue;   // edges ride the grid's y
  if (E <= 0 || P <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)f1;
  const float* b = (const float*)f2;
  const float2* c0 = (const float2*)coords0;
  float* w = (float*)wins;
  int* bs = (int*)bases;
  if (shared_bytes(m, 8) <= (size_t)kMaxShared)
    return launch<8, kStoreLevels>(m, shared_bytes(m, 8), a, b, c0, w, bs, lo, E, P, C, s);
  if (shared_bytes(m, 4) <= (size_t)kMaxShared)
    return launch<4, kStoreLevels>(m, shared_bytes(m, 4), a, b, c0, w, bs, lo, E, P, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches K4 on `stream`: f1 [E, P, C], f2 [E, H2*W2, C], coords0 [E, P, 2]
// (float32, contiguous) -> wins [E, P, sum WH, max WW] float32 and bases
// [E, 8, P] int32.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when even 4 pixels' pyramid exceeds shared memory.
extern "C" int corr_windows_build_launch(const void* f1, const void* f2, const void* coords0,
                                         int E, int P, int H2, int W2, int C, void* wins,
                                         void* bases, void* stream) {
  return build_windows<false>(f1, f2, coords0, E, P, H2, W2, C, wins, bases, LevelsOut{},
                              stream);
}

// Launches K8 on `stream`: K4's outputs, plus level0..level3
// [E, P, H2 >> l, W2 >> l] float32 (K2's layout).  Same return codes.
extern "C" int corr_windows_build_levels_launch(const void* f1, const void* f2,
                                                const void* coords0, int E, int P, int H2,
                                                int W2, int C, void* wins, void* bases,
                                                void* level0, void* level1, void* level2,
                                                void* level3, void* stream) {
  const LevelsOut lo{{(float*)level0, (float*)level1, (float*)level2, (float*)level3}};
  return build_windows<true>(f1, f2, coords0, E, P, H2, W2, C, wins, bases, lo, stream);
}
