// K1: per-edge Gauss-Newton blocks for dense bundle adjustment, for Hopper.
//
// Replaces the TPU kernel droid_slam_reserch_tpu/ops/pallas_ba.py
// (build_system_blocks_pallas, body _kernel).  Same function: for edge n
// with relative pose Gij = (R, t), every pixel of frame ii[n] is
// back-projected with its disparity, moved by Gij and projected; the
// weighted residual and the analytic Jacobians (Ji, Jj: 2x6 each, Jz: 2x1)
// are reduced into
//   H  [N, 12, 12]  pose Hessian  sum_p J^T W J         (pose-masked weight)
//   v  [N, 12]      pose rhs      sum_p J^T W r         (pose-masked weight)
//   E  [N, 12, HW]  pose-depth couplings  J^T W Jz      (pose-masked weight)
//   C  [N, HW]      depth diagonal        Jz^T W Jz     (full weight)
//   w  [N, HW]      depth rhs             Jz^T W r      (full weight)
// with weights scaled by w_scale and zeroed behind min_depth; the pose mask
// is 0 on stereo self-edges (ii == jj) and on the zero-weight padding edges.
//
// What bounds it on the H100: bytes.  Per edge it reads target and weight
// (16 B/pixel) and one disparity row (4 B/pixel) and writes E, C and w
// (56 B/pixel); the ~600 flops/pixel are far below the fp32 rate.  At the
// main path's shapes (N = 48-112 edges, HW = 2560) that is a few MB, so the
// kernel is short and launch- and occupancy-bound.
//
// Design: one block per edge, threads stride over the pixels.  Each thread
// computes its pixels' Jacobians in registers exactly as the TPU kernel's
// body does, writes E, C and w directly (coalesced over pixels), and keeps
// the 78 unique Hessian entries and 12 rhs entries in fp32 registers.  The
// block reduces them with warp shuffles and then shared memory, so no
// atomics across blocks are needed.  The reductions stay in full fp32: a
// damped Gauss-Newton step amplifies Hessian error.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNH = 78;             // unique entries of the symmetric 12x12 H
constexpr int kNR = kNH + 12;       // plus the 12 rhs entries

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The Jacobian rows of one residual coordinate (x: is_x = true, y: false),
// as in the TPU kernel's row_terms.
__device__ __forceinline__ void row_terms(
    bool is_x, float f, float h, float x1, float y1, float dz, float d2,
    float tx, float ty, float tz, const float* R, float J[12], float* Jz) {
  float Jj[6];
  if (is_x) {
    Jj[0] = f * h * dz;
    Jj[1] = 0.f;
    Jj[2] = -f * x1 * h * d2;
    Jj[3] = -f * x1 * y1 * d2;
    Jj[4] = f * (1.f + x1 * x1 * d2);
    Jj[5] = -f * y1 * dz;
    *Jz = f * (tx * dz - tz * x1 * d2);
  } else {
    Jj[0] = 0.f;
    Jj[1] = f * h * dz;
    Jj[2] = -f * y1 * h * d2;
    Jj[3] = -f * (1.f + y1 * y1 * d2);
    Jj[4] = f * x1 * y1 * d2;
    Jj[5] = f * x1 * dz;
    *Jz = f * (ty * dz - tz * y1 * d2);
  }
  // Ji = -AdjT(Gij) Jj
  const float al0 = Jj[0], al1 = Jj[1], al2 = Jj[2];
  const float aa0 = Jj[3] + (al1 * tz - al2 * ty);
  const float aa1 = Jj[4] + (al2 * tx - al0 * tz);
  const float aa2 = Jj[5] + (al0 * ty - al1 * tx);
  J[0] = -(R[0] * al0 + R[3] * al1 + R[6] * al2);
  J[1] = -(R[1] * al0 + R[4] * al1 + R[7] * al2);
  J[2] = -(R[2] * al0 + R[5] * al1 + R[8] * al2);
  J[3] = -(R[0] * aa0 + R[3] * aa1 + R[6] * aa2);
  J[4] = -(R[1] * aa0 + R[4] * aa1 + R[7] * aa2);
  J[5] = -(R[2] * aa0 + R[5] * aa1 + R[8] * aa2);
#pragma unroll
  for (int k = 0; k < 6; k++) J[6 + k] = Jj[k];
}

__global__ void __launch_bounds__(kThreads)
ba_blocks_kernel(const float2* __restrict__ target, const float2* __restrict__ weight,
                 const float* __restrict__ gij, const float* __restrict__ disps,
                 const int32_t* __restrict__ ii, const int32_t* __restrict__ jj,
                 const float* __restrict__ intr, float min_depth, float w_scale,
                 int H, int W, float* __restrict__ Hout, float* __restrict__ vout,
                 float* __restrict__ Eout, float* __restrict__ Cout,
                 float* __restrict__ wout) {
  const int n = blockIdx.x;
  const int HW = H * W;
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  float R[9];
#pragma unroll
  for (int k = 0; k < 9; k++) R[k] = gij[n * 12 + k];
  const float tx = gij[n * 12 + 9], ty = gij[n * 12 + 10], tz = gij[n * 12 + 11];
  const float pose_mask = (ii[n] != jj[n]) ? 1.f : 0.f;
  const float* d_i = disps + (size_t)ii[n] * HW;
  const size_t e0 = (size_t)n * HW;

  float acc[kNR];
#pragma unroll
  for (int k = 0; k < kNR; k++) acc[k] = 0.f;

  for (int p = threadIdx.x; p < HW; p += kThreads) {
    const float u = (float)(p % W), v = (float)(p / W);
    const float X = (u - cx) / fx;
    const float Y = (v - cy) / fy;
    const float h = d_i[p];
    const float x1 = R[0] * X + R[1] * Y + R[2] + h * tx;
    const float y1 = R[3] * X + R[4] * Y + R[5] + h * ty;
    const float z1 = R[6] * X + R[7] * Y + R[8] + h * tz;
    const bool valid = z1 > min_depth;
    const float dz = valid ? 1.f / z1 : 0.f;
    const float d2 = dz * dz;

    const float2 wt = weight[e0 + p];
    const float2 tg = target[e0 + p];
    const float wu = valid ? w_scale * wt.x : 0.f;
    const float wv = valid ? w_scale * wt.y : 0.f;
    const float ru = tg.x - (fx * x1 * dz + cx);
    const float rv = tg.y - (fy * y1 * dz + cy);

    float Jx[12], Jy[12], Jzx, Jzy;
    row_terms(true, fx, h, x1, y1, dz, d2, tx, ty, tz, R, Jx, &Jzx);
    row_terms(false, fy, h, x1, y1, dz, d2, tx, ty, tz, R, Jy, &Jzy);

    Cout[e0 + p] = wu * Jzx * Jzx + wv * Jzy * Jzy;
    wout[e0 + p] = wu * ru * Jzx + wv * rv * Jzy;

    const float wpu = wu * pose_mask, wpv = wv * pose_mask;
    const float ex = wpu * Jzx, ey = wpv * Jzy;
#pragma unroll
    for (int k = 0; k < 12; k++)
      Eout[((size_t)n * 12 + k) * HW + p] = Jx[k] * ex + Jy[k] * ey;

    int idx = 0;
#pragma unroll
    for (int a = 0; a < 12; a++) {
      const float xa = Jx[a] * wpu, ya = Jy[a] * wpv;
#pragma unroll
      for (int b = a; b < 12; b++) acc[idx++] += xa * Jx[b] + ya * Jy[b];
    }
    const float ur = wpu * ru, vr = wpv * rv;
#pragma unroll
    for (int a = 0; a < 12; a++) acc[kNH + a] += ur * Jx[a] + vr * Jy[a];
  }

  __shared__ float red[kWarps][kNR];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kNR; k++) {
    const float s = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < kNR) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; w++) s += red[w][k];
    if (k >= kNH) {
      vout[n * 12 + (k - kNH)] = s;
    } else {
      int a = 0, rem = k;
      while (rem >= 12 - a) { rem -= 12 - a; a++; }
      const int b = a + rem;
      Hout[(size_t)n * 144 + a * 12 + b] = s;
      Hout[(size_t)n * 144 + b * 12 + a] = s;
    }
  }
}

}  // namespace

// Launches K1 on `stream`.  gij: [N, 12] = row-major R (9) then t (3);
// target/weight: [N, H, W, 2]; disps: [MW, H, W]; ii/jj: [N] int32 local
// frame indices; intr: [4] (fx, fy, cx, cy).  Outputs H [N,12,12],
// v [N,12], E [N,12,H*W], C/w [N,H*W].
// Returns cudaGetLastError() after the launch.
extern "C" int ba_blocks_launch(const void* target, const void* weight, const void* gij,
                                const void* disps, const void* ii, const void* jj,
                                const void* intr, float min_depth, float w_scale, int N, int H, int W,
                                void* Hout, void* vout, void* Eout, void* Cout,
                                void* wout, void* stream) {
  if (N > 0) {
    ba_blocks_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
        (const float2*)target, (const float2*)weight, (const float*)gij,
        (const float*)disps, (const int32_t*)ii, (const int32_t*)jj, (const float*)intr,
        min_depth, w_scale, H, W, (float*)Hout, (float*)vout, (float*)Eout,
        (float*)Cout, (float*)wout);
  }
  return (int)cudaGetLastError();
}
