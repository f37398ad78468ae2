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
// (56 B/pixel); the few hundred flops a pixel are far below the fp32 rate.
// At the main path's shapes (N = 48-112 edges, HW = 2560) that is a few MB,
// so the kernel is short, and launches, latency and occupancy bound it.
//
// Design:
// (a) The relative pose is formed in the kernel.  Each block reads the
//     poses [MW, 7] (t, then quaternion xyzw), ii/jj as int64 and the
//     intrinsics from device memory, and one thread forms
//     Gij = poses[jj] * poses[ii]^-1 and its rotation matrix into shared
//     memory in fp32, with the operations of the plain version
//     (lie/se3.py se3_mul, se3_inv; lie/so3.py quat_to_matrix), each
//     rounded alone; a stereo self-edge (ii == jj) takes the fixed baseline
//     geom/projective.py STEREO_SE3.  The wrapper launches this kernel and
//     allocates its outputs, and does nothing else on the device.
// (b) Ji = L Jj for every pixel of an edge, with L = -AdjT(Gij) a fixed 6x6
//     map (row_terms below), so Hii = L Hjj L^T, Hij = L Hjj = Hji^T and
//     vi = L vj.  A thread therefore accumulates only the 21 unique entries
//     of Hjj and the 6 of vj, in fp32 registers, and computes Ei = L Ej per
//     pixel; block 0 of the cluster applies L once to the edge's sums.
//     The reductions stay in full fp32: a damped Gauss-Newton step
//     amplifies Hessian error.
// (c) One thread block cluster of kCluster = 2 blocks per edge
//     (__cluster_dims__): block r takes the r-th contiguous half of the
//     edge's pixels, so 48-112 edges give 96-224 blocks of 8 warps, 2 blocks
//     an SM (about 110 registers a thread), and up to 132 edges run in one
//     wave on the 132 SMs.  Each thread loads its next pixel's inputs one
//     pixel ahead and writes E, C and w directly (coalesced over pixels);
//     the block sums its 27 values by warp shuffles (xor butterfly) and then
//     over its warps in order.  Block 0 adds the blocks' partial sums in rank
//     order, reading them through distributed shared memory: a fixed order,
//     no atomics, the same result on every run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 2;         // blocks of one edge
constexpr int kNH = 21;             // unique entries of the symmetric 6x6 Hjj
constexpr int kNR = kNH + 6;        // plus the 6 of vj

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The plain version's SE3 arithmetic, each operation rounded alone (no
// contraction into fma), in its order of operations.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ void cross(const float a[3], const float b[3], float c[3]) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// quat_act: X + qw * uv + qv x uv with uv = 2 (qv x X)
__device__ void quat_act(const float q[4], const float X[3], float out[3]) {
  float uv[3], c[3];
  cross(q, X, uv);
#pragma unroll
  for (int k = 0; k < 3; k++) uv[k] = mul(2.f, uv[k]);
  cross(q, uv, c);
#pragma unroll
  for (int k = 0; k < 3; k++) out[k] = add(add(X[k], mul(q[3], uv[k])), c[k]);
}

// gij[0..8] = row-major R, gij[9..11] = t of poses[j] * poses[i]^-1
__device__ void relative_pose(const float* __restrict__ poses, int64_t i, int64_t j,
                              float* gij) {
  float t[3], q[4];
  if (i == j) {                      // STEREO_SE3: a fixed baseline, no rotation
    t[0] = -0.1f; t[1] = 0.f; t[2] = 0.f;
    q[0] = 0.f; q[1] = 0.f; q[2] = 0.f; q[3] = 1.f;
  } else {
    const float* Pi = poses + 7 * i;
    const float* Pj = poses + 7 * j;
    const float qi[4] = {-Pi[3], -Pi[4], -Pi[5], Pi[6]};       // se3_inv
    float ti[3];
    quat_act(qi, Pi, ti);
#pragma unroll
    for (int k = 0; k < 3; k++) ti[k] = -ti[k];
    const float qj[4] = {Pj[3], Pj[4], Pj[5], Pj[6]};          // se3_mul
    float a[3];
    quat_act(qj, ti, a);
#pragma unroll
    for (int k = 0; k < 3; k++) t[k] = add(Pj[k], a[k]);
    const float qx = qj[0], qy = qj[1], qz = qj[2], qw = qj[3];
    const float px = qi[0], py = qi[1], pz = qi[2], pw = qi[3];
    q[0] = sub(add(add(mul(qw, px), mul(qx, pw)), mul(qy, pz)), mul(qz, py));
    q[1] = sub(add(add(mul(qw, py), mul(qy, pw)), mul(qz, px)), mul(qx, pz));
    q[2] = sub(add(add(mul(qw, pz), mul(qz, pw)), mul(qx, py)), mul(qy, px));
    q[3] = sub(sub(sub(mul(qw, pw), mul(qx, px)), mul(qy, py)), mul(qz, pz));
  }
  const float x = q[0], y = q[1], z = q[2], w = q[3];           // quat_to_matrix
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  gij[0] = sub(1.f, mul(2.f, add(yy, zz)));
  gij[1] = mul(2.f, sub(xy, wz));
  gij[2] = mul(2.f, add(xz, wy));
  gij[3] = mul(2.f, add(xy, wz));
  gij[4] = sub(1.f, mul(2.f, add(xx, zz)));
  gij[5] = mul(2.f, sub(yz, wx));
  gij[6] = mul(2.f, sub(xz, wy));
  gij[7] = mul(2.f, add(yz, wx));
  gij[8] = sub(1.f, mul(2.f, add(xx, yy)));
  gij[9] = t[0];
  gij[10] = t[1];
  gij[11] = t[2];
}

// The Jj row of one residual coordinate (x: is_x = true, y: false) and
// its Jz, as in the TPU kernel's row_terms.
__device__ __forceinline__ void jj_terms(bool is_x, float f, float h, float x1, float y1,
                                         float dz, float d2, float tx, float ty, float tz,
                                         float Jj[6], float* Jz) {
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
}

// out = L a = -AdjT(Gij) a, as the TPU kernel's row_terms forms Ji from Jj:
// [-R^T a_l; -R^T (a_a + a_l x t)] for a = [a_l; a_a].
__device__ __forceinline__ void adj_t(const float* R, float tx, float ty, float tz,
                                      const float a[6], float out[6]) {
  const float al0 = a[0], al1 = a[1], al2 = a[2];
  const float aa0 = a[3] + (al1 * tz - al2 * ty);
  const float aa1 = a[4] + (al2 * tx - al0 * tz);
  const float aa2 = a[5] + (al0 * ty - al1 * tx);
  out[0] = -(R[0] * al0 + R[3] * al1 + R[6] * al2);
  out[1] = -(R[1] * al0 + R[4] * al1 + R[7] * al2);
  out[2] = -(R[2] * al0 + R[5] * al1 + R[8] * al2);
  out[3] = -(R[0] * aa0 + R[3] * aa1 + R[6] * aa2);
  out[4] = -(R[1] * aa0 + R[4] * aa1 + R[7] * aa2);
  out[5] = -(R[2] * aa0 + R[5] * aa1 + R[8] * aa2);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
ba_blocks_kernel(const float2* __restrict__ target, const float2* __restrict__ weight,
                 const float* __restrict__ poses, const float* __restrict__ disps,
                 const int64_t* __restrict__ ii, const int64_t* __restrict__ jj,
                 const float* __restrict__ intr, float min_depth, float w_scale,
                 int H, int W, float* __restrict__ Hout, float* __restrict__ vout,
                 float* __restrict__ Eout, float* __restrict__ Cout,
                 float* __restrict__ wout) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.x / kCluster;
  const int HW = H * W;
  __shared__ float gij[12];
  __shared__ float red[kWarps][kNR];
  __shared__ float part[kNR];                     // this block's sums, read by block 0

  const int64_t i_n = ii[n], j_n = jj[n];
  const float* d_i = disps + (size_t)i_n * HW;
  const size_t e0 = (size_t)n * HW;
  // block `rank` takes pixels [p_lo, p_hi), a multiple of 32 wide; each
  // thread loads its next pixel's inputs one pixel ahead, the first while
  // thread 0 forms Gij
  const int span = ((HW + kCluster - 1) / kCluster + 31) / 32 * 32;
  const int p_lo = min(rank * span, HW), p_hi = min(p_lo + span, HW);
  float h_next = 0.f;
  float2 wt_next = make_float2(0.f, 0.f), tg_next = wt_next;
  if (p_lo + (int)threadIdx.x < p_hi) {
    const int p = p_lo + threadIdx.x;
    h_next = d_i[p];
    wt_next = weight[e0 + p];
    tg_next = target[e0 + p];
  }
  if (threadIdx.x == 0) relative_pose(poses, i_n, j_n, gij);
  __syncthreads();
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  float R[9];
#pragma unroll
  for (int k = 0; k < 9; k++) R[k] = gij[k];
  const float tx = gij[9], ty = gij[10], tz = gij[11];
  const float pose_mask = (i_n != j_n) ? 1.f : 0.f;

  float acc[kNR];
#pragma unroll
  for (int k = 0; k < kNR; k++) acc[k] = 0.f;

  for (int p = p_lo + threadIdx.x; p < p_hi; p += kThreads) {
    const float h = h_next;
    const float2 wt = wt_next, tg = tg_next;
    if (p + kThreads < p_hi) {
      h_next = d_i[p + kThreads];
      wt_next = weight[e0 + p + kThreads];
      tg_next = target[e0 + p + kThreads];
    }
    const float u = (float)(p % W), v = (float)(p / W);
    const float X = (u - cx) / fx;
    const float Y = (v - cy) / fy;
    const float x1 = R[0] * X + R[1] * Y + R[2] + h * tx;
    const float y1 = R[3] * X + R[4] * Y + R[5] + h * ty;
    const float z1 = R[6] * X + R[7] * Y + R[8] + h * tz;
    const bool valid = z1 > min_depth;
    const float dz = valid ? 1.f / z1 : 0.f;
    const float d2 = dz * dz;

    const float wu = valid ? w_scale * wt.x : 0.f;
    const float wv = valid ? w_scale * wt.y : 0.f;
    const float ru = tg.x - (fx * x1 * dz + cx);
    const float rv = tg.y - (fy * y1 * dz + cy);

    float Jx[6], Jy[6], Jzx, Jzy;
    jj_terms(true, fx, h, x1, y1, dz, d2, tx, ty, tz, Jx, &Jzx);
    jj_terms(false, fy, h, x1, y1, dz, d2, tx, ty, tz, Jy, &Jzy);

    Cout[e0 + p] = wu * Jzx * Jzx + wv * Jzy * Jzy;
    wout[e0 + p] = wu * ru * Jzx + wv * rv * Jzy;

    const float wpu = wu * pose_mask, wpv = wv * pose_mask;
    const float ex = wpu * Jzx, ey = wpv * Jzy;
    float Ej[6], Ei[6];
#pragma unroll
    for (int k = 0; k < 6; k++) Ej[k] = Jx[k] * ex + Jy[k] * ey;
    adj_t(R, tx, ty, tz, Ej, Ei);
#pragma unroll
    for (int k = 0; k < 6; k++) {
      Eout[((size_t)n * 12 + k) * HW + p] = Ei[k];
      Eout[((size_t)n * 12 + 6 + k) * HW + p] = Ej[k];
    }

    int idx = 0;
#pragma unroll
    for (int a = 0; a < 6; a++) {
      const float xa = Jx[a] * wpu, ya = Jy[a] * wpv;
#pragma unroll
      for (int b = a; b < 6; b++) acc[idx++] += xa * Jx[b] + ya * Jy[b];
    }
    const float ur = wpu * ru, vr = wpv * rv;
#pragma unroll
    for (int a = 0; a < 6; a++) acc[kNH + a] += ur * Jx[a] + vr * Jy[a];
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kNR; k++) {
    const float s = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < kNR) {
    float s = red[0][k];
#pragma unroll
    for (int w = 1; w < kWarps; w++) s += red[w][k];
    part[k] = s;
  }
  cluster.sync();                                 // every block's part is written

  if (rank == 0) {                                // the edge's Hjj, vj, then L applied
    __shared__ float Hjj[6][6], vj[6], L[6][6], LH[6][6];
    if (k < kNR) {
      float s = part[k];
#pragma unroll
      for (int r = 1; r < kCluster; r++) s += cluster.map_shared_rank(part, r)[k];
      if (k < kNH) {
        int a = 0, rem = k;
        while (rem >= 6 - a) { rem -= 6 - a; a++; }
        Hjj[a][a + rem] = s;
        Hjj[a + rem][a] = s;
      } else {
        vj[k - kNH] = s;
      }
    } else if (k < kNR + 6) {                     // column c of L: L e_c
      const int c = k - kNR;
      float ec[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, col[6];
      ec[c] = 1.f;
      adj_t(R, tx, ty, tz, ec, col);
#pragma unroll
      for (int a = 0; a < 6; a++) L[a][c] = col[a];
    }
    __syncthreads();
    const int a = k / 6, b = k % 6;
    float* Hn = Hout + (size_t)n * 144;
    if (k < 36) {                                 // Hij = L Hjj; Hji = Hij^T
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 6; c++) s += L[a][c] * Hjj[c][b];
      LH[a][b] = s;
      Hn[a * 12 + 6 + b] = s;
      Hn[(6 + b) * 12 + a] = s;
      Hn[(6 + a) * 12 + 6 + b] = Hjj[a][b];
    } else if (k < 42) {                          // vi = L vj
      const int i = k - 36;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 6; c++) s += L[i][c] * vj[c];
      vout[n * 12 + i] = s;
      vout[n * 12 + 6 + i] = vj[i];
    }
    __syncthreads();
    if (k < 36) {                                 // Hii = L Hjj L^T
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 6; c++) s += LH[a][c] * L[b][c];
      Hn[a * 12 + b] = s;
    }
  }
  cluster.sync();                                 // block 0 has read the others' parts
}

}  // namespace

// Launches K1 on `stream`.  target/weight: [N, H, W, 2]; poses: [MW, 7]
// (t, then quaternion xyzw); disps: [MW, H, W]; ii/jj: [N] int64 local frame
// indices; intr: [4] (fx, fy, cx, cy); all float32 but ii/jj, contiguous, on
// the device.  Outputs H [N,12,12], v [N,12], E [N,12,H*W], C/w [N,H*W].
// Returns cudaGetLastError() after the launch.
extern "C" int ba_blocks_launch(const void* target, const void* weight, const void* poses,
                                const void* disps, const void* ii, const void* jj,
                                const void* intr, float min_depth, float w_scale, int N,
                                int H, int W, void* Hout, void* vout, void* Eout, void* Cout,
                                void* wout, void* stream) {
  if (N > 0) {
    ba_blocks_kernel<<<N * kCluster, kThreads, 0, (cudaStream_t)stream>>>(
        (const float2*)target, (const float2*)weight, (const float*)poses,
        (const float*)disps, (const int64_t*)ii, (const int64_t*)jj, (const float*)intr,
        min_depth, w_scale, H, W, (float*)Hout, (float*)vout, (float*)Eout,
        (float*)Cout, (float*)wout);
  }
  return (int)cudaGetLastError();
}
