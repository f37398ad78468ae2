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
// What bounds it on the H100.  At the main path's shapes (E = 48,
// P = H2*W2 = 2560, C = 128) the product is 2*E*P*P*C = 80.5 GFLOP.  Taken
// to fp32 accuracy as three TF32 tensor-core products (3xTF32) that is
// 241.6 GFLOP at the 495 TFLOP/s TF32 peak, 0.488 ms, against 1.797 GB moved
// (f1 and f2 read, 1.31 GB of level 0 and 0.44 GB of levels 1-3 written),
// 0.536 ms at 3.35 TB/s: bytes bound it, the levels' stores above all.
//
// Design: one launch.  A block computes one output tile of kM = 128 source
// pixels x kN = 256 target cells and writes every level of it once.
// (a) The tile's cells are an aligned block of 8 level-0 rows x 32 columns.
//     Such a block holds whole 2x2, 4x4 and 8x8 blocks, so it pools to its
//     4 x 16, 2 x 8 and 1 x 4 cells of levels 1-3 with no cell of another
//     tile (level-l row r comes from level-0 rows r*2^l .. (r+1)*2^l - 1).
//     No block needs a whole band row, so any W2 works; cells past H2 or W2
//     are zeros and are not stored (floor semantics).
// (b) The product runs on the tensor cores as wgmma m64n256k8 TF32 with
//     fp32 accumulators, two consumer warpgroups of 64 pixels each.  Both
//     operands are K-major, as TF32 wgmma requires: f1 [E, P, C] and
//     f2 [E, H2, W2, C].  TMA (cp.async.bulk.tensor, 128-byte swizzle,
//     zero fill past the edges) brings 32 channels of the f1 tile and of the
//     f2 block into one of two shared-memory stages and completes an
//     mbarrier.  The block splits each value in place, x = big + small with
//     big = x cut to TF32 (its low 13 bits cleared) and small = x - big
//     (exact) in a second buffer of the same layout, and takes the product
//     as small*big + big*small + big*big (3xTF32).  The split of one stage
//     runs while the tensor cores work on the other.
// (c) Epilogue, straight from the accumulators: level 0, scaled by 1/16,
//     leaves with 16-byte streaming stores once thread pairs have traded
//     halves (32 contiguous bytes a pixel and row for each pair).  A thread
//     holds both columns and both rows of its level-1 cells, so it pools
//     them in registers; each warp stages its 16 pixels' level 1 in shared
//     memory, and a lane then takes 4 level-1 columns of a pixel, which
//     pool to 2 columns of level 2 and 1 cell of level 3 in registers, and
//     stores all three (16, 8 and 4 bytes a row).  The four cells are
//     always added as the plain version adds them, ((s0 + s1) + s2) + s3.
//     Where a level's width does not allow the wide stores, 4-byte stores.
// Shared memory: two stages of 96 KB (f1 and f2, each whole and split);
// the epilogue's 36 KB of level 1 reuse them.  One block of 256 threads an
// SM.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 128;                  // source pixels a block
constexpr int kRows = 8, kCols = 32;     // the tile's level-0 rows and columns
constexpr int kN = kRows * kCols;        // 256 target cells a block
constexpr int kBK = 32;                  // channels a stage: 128 bytes, the swizzle span
constexpr int kStages = 2;
constexpr int kThreads = 256;            // two warpgroups
constexpr int kABytes = kM * kBK * 4;    // 16 KB
constexpr int kBBytes = kN * kBK * 4;    // 32 KB
constexpr int kStageBytes = 2 * (kABytes + kBBytes);     // whole and split parts
constexpr int kS = 72;                   // floats a staged pixel: its 64 level-1 cells, 8 mod 32
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n256k8(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma boundaries.
__device__ __forceinline__ void pin(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; i++) asm volatile("" : "+f"(d[i])::"memory");
}

// x = big + small in place: big keeps the 10 mantissa bits TF32 holds, small
// (exact in fp32) goes to the same offset of the split buffer.
__device__ __forceinline__ void split_tf32(float4* whole, float4* small) {
  const float4 x = *whole;
  float4 b;
  b.x = __uint_as_float(__float_as_uint(x.x) & 0xffffe000u);
  b.y = __uint_as_float(__float_as_uint(x.y) & 0xffffe000u);
  b.z = __uint_as_float(__float_as_uint(x.z) & 0xffffe000u);
  b.w = __uint_as_float(__float_as_uint(x.w) & 0xffffe000u);
  *whole = b;
  *small = make_float4(x.x - b.x, x.y - b.y, x.z - b.z, x.w - b.w);
}

struct Levels {
  float* lv[4];
  int H[4], W[4];
};

__global__ void __launch_bounds__(kThreads, 1)
corr_build_kernel(const __grid_constant__ CUtensorMap map_f1,
                  const __grid_constant__ CUtensorMap map_f2, int P, int C, int ncols,
                  Levels out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(smem + kStages * kStageBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;                       // consumer warpgroup: pixels 64 wg ..
  const int e = blockIdx.z, m0 = blockIdx.y * kM;
  const int y0 = (blockIdx.x / ncols) * kRows, x0 = (blockIdx.x % ncols) * kCols;
  const int nk = (C + kBK - 1) / kBK;

  // stage s: f1 whole [0, 16K), f1 small [16K, 32K), f2 whole [32K, 64K), f2 small [64K, 96K)
  auto a_whole = [&](int s) { return smem + s * kStageBytes; };
  auto a_small = [&](int s) { return smem + s * kStageBytes + kABytes; };
  auto b_whole = [&](int s) { return smem + s * kStageBytes + 2 * kABytes; };
  auto b_small = [&](int s) { return smem + s * kStageBytes + 2 * kABytes + kBBytes; };
  auto load = [&](int kc) {                       // one thread: chunk kc into stage kc % 2
    const int s = kc % kStages;
    const uint32_t bar = smem_addr(&full[s]);
    mbar_expect_tx(bar, kABytes + kBBytes);
    tma_load_3d(smem_addr(a_whole(s)), &map_f1, bar, kc * kBK, m0, e);
    tma_load_4d(smem_addr(b_whole(s)), &map_f2, bar, kc * kBK, x0, y0, e);
  };
  auto split = [&](int s) {                       // every thread, then a proxy fence
    float4* aw = (float4*)a_whole(s);
    float4* as = (float4*)a_small(s);
    float4* bw = (float4*)b_whole(s);
    float4* bs = (float4*)b_small(s);
#pragma unroll
    for (int u = 0; u < kABytes / 16 / kThreads; u++)
      split_tf32(aw + tid + u * kThreads, as + tid + u * kThreads);
#pragma unroll
    for (int u = 0; u < kBBytes / 16 / kThreads; u++)
      split_tf32(bw + tid + u * kThreads, bs + tid + u * kThreads);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by wgmma
  };

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_f1) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_f2) : "memory");
    for (int s = 0; s < kStages; s++) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int kc = 0; kc < kStages && kc < nk; kc++) load(kc);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; i++) acc[i] = 0.f;
  pin(acc);

  mbar_wait(smem_addr(&full[0]), 0);
  split(0);
  __syncthreads();
  for (int kc = 0; kc < nk; kc++) {
    const int s = kc % kStages;
    const uint64_t da_w = sw128_desc(smem_addr(a_whole(s) + wg * 64 * 128));
    const uint64_t da_s = sw128_desc(smem_addr(a_small(s) + wg * 64 * 128));
    const uint64_t db_w = sw128_desc(smem_addr(b_whole(s)));
    const uint64_t db_s = sw128_desc(smem_addr(b_small(s)));
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 8; kk++) {        // 8 channels (32 bytes) a step
      wgmma_m64n256k8(acc, da_s + 2 * kk, db_w + 2 * kk);
      wgmma_m64n256k8(acc, da_w + 2 * kk, db_s + 2 * kk);
      wgmma_m64n256k8(acc, da_w + 2 * kk, db_w + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kc + 1 < nk) {                            // split the next stage meanwhile
      mbar_wait(smem_addr(&full[(kc + 1) % kStages]), ((kc + 1) / kStages) & 1);
      split((kc + 1) % kStages);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(acc);
    __syncthreads();                              // stage s is free, the next one split
    if (tid == 0 && kc + kStages < nk) load(kc + kStages);
  }

  // ---- (c) epilogue.  Thread (g, q) of warp w holds, for pixels
  // 16 (w % 4) + g and + 8 of its warpgroup (half hf), cells
  // n = 8 j + 2 q + {0, 1}, j = 0 .. 31: tile row j / 4, column 8 (j % 4) + 2 q.
  const int g = lane >> 2, q = lane & 3, odd = q & 1;
  const int pw = m0 + 64 * wg + 16 * (warp & 3);  // the warp's first pixel
  const size_t ep0 = (size_t)e * P;

  // level 0 from the accumulators: thread pairs (q, q ^ 1) trade halves, so
  // an even q holds 4 columns of pixel g, an odd q the same of pixel g + 8
  {
    const int H0 = out.H[0], W0 = out.W[0];
    const int p = pw + g + 8 * odd, xc = x0 + 4 * (q >> 1);
    const bool vec = (W0 & 3) == 0;               // then x < W0 holds x + 3 < W0 too
#pragma unroll
    for (int r = 0; r < kRows; r++) {
      const int y = y0 + r;
      float* row = out.lv[0] + ((ep0 + p) * H0 + y) * W0;
#pragma unroll
      for (int cj = 0; cj < 4; cj++) {
        const int i = 4 * (4 * r + cj);
        const float t0 = __shfl_xor_sync(0xffffffffu, odd ? acc[i] : acc[i + 2], 1);
        const float t1 = __shfl_xor_sync(0xffffffffu, odd ? acc[i + 1] : acc[i + 3], 1);
        const float4 v = odd ? make_float4(t0 * 0.0625f, t1 * 0.0625f, acc[i + 2] * 0.0625f,
                                           acc[i + 3] * 0.0625f)
                             : make_float4(acc[i] * 0.0625f, acc[i + 1] * 0.0625f,
                                           t0 * 0.0625f, t1 * 0.0625f);
        const int x = xc + 8 * cj;
        if (p >= P || y >= H0 || x >= W0) continue;
        if (vec) {
          __stcs((float4*)(row + x), v);
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 4; k++)
            if (x + k < W0) __stcs(row + x + k, vs[k]);
        }
      }
    }
  }

  // level 1 pooled from the accumulators (a thread holds both columns and
  // both rows of its cells) and staged: 4 rows x 16 cells a pixel
  float* stg = (float*)smem + warp * 16 * kS;     // this warp's 16 pixels, kS floats each
#pragma unroll
  for (int hf = 0; hf < 2; hf++)
#pragma unroll
    for (int r1 = 0; r1 < 4; r1++)
#pragma unroll
      for (int cj = 0; cj < 4; cj++) {
        const int i0 = 4 * (8 * r1 + cj) + 2 * hf, i1 = i0 + 16;   // rows 2 r1, 2 r1 + 1
        const float s0 = acc[i0] * 0.0625f, s1 = acc[i0 + 1] * 0.0625f;
        const float s2 = acc[i1] * 0.0625f, s3 = acc[i1 + 1] * 0.0625f;
        stg[(g + 8 * hf) * kS + r1 * 16 + 4 * cj + q] = (((s0 + s1) + s2) + s3) * 0.25f;
      }
  __syncwarp();

  // each lane takes 4 level-1 columns of a pixel (all 4 rows), pools them to
  // 2 columns of level 2 and 1 cell of level 3, and stores all three
  const int H1 = out.H[1], W1 = out.W[1], H2 = out.H[2], W2 = out.W[2];
  const int H3 = out.H[3], W3 = out.W[3];
#pragma unroll
  for (int u = 0; u < 2; u++) {
    const int it = lane + 32 * u, lp = it >> 2, qq = it & 3, p = pw + lp;
    if (p >= P) continue;
    float4 l1[4];
#pragma unroll
    for (int r1 = 0; r1 < 4; r1++) l1[r1] = *(const float4*)(stg + lp * kS + r1 * 16 + 4 * qq);
    float l2[2][2];
#pragma unroll
    for (int r2 = 0; r2 < 2; r2++) {
      const float4 a = l1[2 * r2], b = l1[2 * r2 + 1];
      l2[r2][0] = (((a.x + a.y) + b.x) + b.y) * 0.25f;
      l2[r2][1] = (((a.z + a.w) + b.z) + b.w) * 0.25f;
    }
    const float l3 = (((l2[0][0] + l2[0][1]) + l2[1][0]) + l2[1][1]) * 0.25f;

    const int x1 = (x0 >> 1) + 4 * qq, x2 = (x0 >> 2) + 2 * qq, x3 = (x0 >> 3) + qq;
#pragma unroll
    for (int r1 = 0; r1 < 4; r1++) {
      const int y = (y0 >> 1) + r1;
      if (y >= H1 || x1 >= W1) continue;
      float* d = out.lv[1] + ((ep0 + p) * H1 + y) * W1 + x1;
      if ((W1 & 3) == 0) {
        __stcs((float4*)d, l1[r1]);
      } else {
        const float vs[4] = {l1[r1].x, l1[r1].y, l1[r1].z, l1[r1].w};
#pragma unroll
        for (int k = 0; k < 4; k++)
          if (x1 + k < W1) __stcs(d + k, vs[k]);
      }
    }
#pragma unroll
    for (int r2 = 0; r2 < 2; r2++) {
      const int y = (y0 >> 2) + r2;
      if (y >= H2 || x2 >= W2) continue;
      float* d = out.lv[2] + ((ep0 + p) * H2 + y) * W2 + x2;
      if ((W2 & 1) == 0) {
        __stcs((float2*)d, make_float2(l2[r2][0], l2[r2][1]));
      } else {
        __stcs(d, l2[r2][0]);
        if (x2 + 1 < W2) __stcs(d + 1, l2[r2][1]);
      }
    }
    if ((y0 >> 3) < H3 && x3 < W3) __stcs(out.lv[3] + ((ep0 + p) * H3 + (y0 >> 3)) * W3 + x3, l3);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime, so the
// library links against nothing but the CUDA runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A float32 tensor map of `rank` dims (innermost first), 128-byte swizzle,
// zeros past the edges.
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t strides[4];
  cuuint64_t s = 4;
  for (int i = 0; i + 1 < rank; i++) {
    s *= dims[i];
    strides[i] = s;
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Launches K2 on `stream`: f1 [E, P, C], f2 [E, H2*W2, C] (float32,
// contiguous, 16-byte aligned, C a multiple of 4) -> level0..level3,
// level l = [E, P, H2 >> l, W2 >> l].  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for inputs the kernel does not take.
extern "C" int corr_build_launch(const void* f1, const void* f2, int E, int P, int H2,
                                 int W2, int C, void* level0, void* level1,
                                 void* level2, void* level3, void* stream) {
  if (E <= 0 || P <= 0 || H2 <= 0 || W2 <= 0) return (int)cudaGetLastError();
  if (C <= 0 || C % 4 || (uintptr_t)f1 % 16 || (uintptr_t)f2 % 16 || E > 65535 ||
      (P + kM - 1) / kM > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_f1, map_f2;
  const cuuint64_t d1[3] = {(cuuint64_t)C, (cuuint64_t)P, (cuuint64_t)E};
  const cuuint32_t b1[3] = {kBK, kM, 1};
  const cuuint64_t d2[4] = {(cuuint64_t)C, (cuuint64_t)W2, (cuuint64_t)H2, (cuuint64_t)E};
  const cuuint32_t b2[4] = {kBK, kCols, kRows, 1};
  if (!make_map(&map_f1, f1, 3, d1, b1) || !make_map(&map_f2, f2, 4, d2, b2))
    return (int)cudaErrorInvalidValue;
  Levels out;
  void* lv[4] = {level0, level1, level2, level3};
  for (int l = 0; l < 4; l++) {
    out.lv[l] = (float*)lv[l];
    out.H[l] = H2 >> l;
    out.W[l] = W2 >> l;
  }
  int err = (int)cudaFuncSetAttribute(corr_build_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err) return err;
  const int ncols = (W2 + kCols - 1) / kCols, nbands = (H2 + kRows - 1) / kRows;
  dim3 grid(nbands * ncols, (P + kM - 1) / kM, E);
  corr_build_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(map_f1, map_f2, P, C,
                                                                          ncols, out);
  return (int)cudaGetLastError();
}

// What a launch uses: out[0] the dynamic shared memory bytes of a block,
// out[1] resident blocks per SM (-1 when the query fails).  Returns 0.
extern "C" int corr_build_info(void* out) {
  int* o = (int*)out;
  o[0] = kSmemBytes;
  int n = -1;
  if (cudaFuncSetAttribute(corr_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, corr_build_kernel, kThreads, kSmemBytes))
    n = -1;
  o[1] = n;
  return 0;
}
