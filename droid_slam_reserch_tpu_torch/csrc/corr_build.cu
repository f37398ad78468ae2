// K2: all-pairs correlation volume and its 4-level pyramid, for Hopper.
//
// Replaces the TPU kernel droid_slam_reserch_tpu/ops/pallas_corr.py
// (corr_build_pmajor_pallas, body _build_kernel).  Same function:
//   level0[e, p, y, x] = sum_c f1[e, p, c] * f2[e, y, x, c] / 16   (fp32)
//   level l+1 = 2x2 average of level l over (y, x), floor semantics
// for E edges, P = H1*W1 source pixels and an H2 x W2 target grid.  The
// layout is the port's: level l is [E, P, H2 >> l, W2 >> l], and the lookup
// (K3) checks bounds instead of reading an 8-pixel zero border.
//
// What bounds it on the H100: at the main path's shapes (E = 48,
// P = H2*W2 = 2560, C = 128) the product is 2*E*P*P*C = 80.5 GFLOP of fp32,
// about 1.2 ms at the 67 TFLOP/s fp32 peak, against 1.67 GB of levels
// written, about 0.5 ms at 3.35 TB/s: operations bound it.
//
// Design: a shared-memory tiled fp32 dot product (64x64 output tile per
// block, 16-deep k slices, 4x4 outputs per thread in registers) writes
// level 0; a second kernel pools one level from the previous one, adding
// the four cells in the same order as the plain version.  Simple first:
// no tensor cores (the function is fp32) and the pooling re-reads level 0
// from device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(kThreads)
corr_volume_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int P, int Q, int C) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* A = f1 + (size_t)e * P * C;
  const float* B = f2 + (size_t)e * Q * C;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; i++)
#pragma unroll
    for (int j = 0; j < TN; j++) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gn = n0 + r, gk = k0 + c;
      As[c][r] = (gm < P && gk < C) ? A[(size_t)gm * C + gk] : 0.f;
      Bs[c][r] = (gn < Q && gk < C) ? B[(size_t)gn * C + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; k++) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i++) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; j++) b[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; i++)
#pragma unroll
        for (int j = 0; j < TN; j++) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; i++) {
    const int gm = m0 + ty * TM + i;
    if (gm >= P) continue;
    float* row = out + ((size_t)e * P + gm) * Q;
#pragma unroll
    for (int j = 0; j < TN; j++) {
      const int gn = n0 + tx * TN + j;
      if (gn < Q) row[gn] = acc[i][j] * (1.f / 16.f);
    }
  }
}

__global__ void pool2x_kernel(const float* __restrict__ in, float* __restrict__ out,
                              size_t rows, int Hin, int Win, int Hout, int Wout) {
  const size_t cells = (size_t)Hout * Wout;
  const size_t total = rows * cells;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t r = idx / cells;
    const int rem = (int)(idx - r * cells);
    const int i = rem / Wout, j = rem % Wout;
    const float* s = in + r * Hin * Win + (2 * i) * Win + 2 * j;
    out[idx] = (((s[0] + s[1]) + s[Win]) + s[Win + 1]) * 0.25f;
  }
}

}  // namespace

// Launches K2 on `stream`: f1 [E, P, C], f2 [E, H2*W2, C] (float32,
// contiguous) -> level0..level3, level l = [E, P, H2 >> l, W2 >> l].
// Returns cudaGetLastError() after the launches.
extern "C" int corr_build_launch(const void* f1, const void* f2, int E, int P, int H2,
                                 int W2, int C, void* level0, void* level1,
                                 void* level2, void* level3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int Q = H2 * W2;
  if (E > 0 && P > 0 && Q > 0) {
    dim3 grid((Q + BN - 1) / BN, (P + BM - 1) / BM, E);
    corr_volume_kernel<<<grid, kThreads, 0, s>>>((const float*)f1, (const float*)f2,
                                                 (float*)level0, P, Q, C);
    int err = (int)cudaGetLastError();
    if (err) return err;
    void* lv[4] = {level0, level1, level2, level3};
    int h = H2, w = W2;
    for (int l = 1; l < 4; l++) {
      const int ho = h / 2, wo = w / 2;
      const size_t total = (size_t)E * P * ho * wo;
      if (total > 0) {
        const int threads = 256;
        const size_t want = (total + threads - 1) / threads;
        const int blocks = (int)(want < 65535u * 16u ? want : 65535u * 16u);
        pool2x_kernel<<<blocks, threads, 0, s>>>((const float*)lv[l - 1], (float*)lv[l],
                                                 (size_t)E * P, h, w, ho, wo);
        err = (int)cudaGetLastError();
        if (err) return err;
      }
      h = ho;
      w = wo;
    }
  }
  return (int)cudaGetLastError();
}
