// Conv3x3: the update operator's 3x3, stride-1, zero-padded convolutions
// in fp32, for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (models/update.py, models/gru.py), and the port handed them to cuDNN, which
// runs an fp32 convolution with TF32 off as FFTs (channel contraction in the
// frequency domain) or an fp32 implicit GEMM on the CUDA cores.  Function:
//   out[p, n] = bias[n] + sum_{t, c} w[n, t, c] * x[p + off(t), c]
// over the pixels p = (b, y, x) of a channels-last map [B, H, W, C_in], tap
// t = 3 dy + dx reading the neighbour (y + dy - 1, x + dx - 1), zero outside
// the map.  A GEMM of M = B*H*W pixels, N = C_out, K = 9 * C_in.
//
// What bounds it on the H100.  The GRU's convzr at the frontend's shape
// (E = 48 edges of 40 x 64 pixels, 448 -> 256) is 2 M N K = 253.7 GFLOP.
// Taken to fp32 accuracy as three TF32 tensor-core products (3xTF32) that is
// 761 GFLOP at the 495 TFLOP/s TF32 peak, 1.54 ms, against 0.35 GB moved
// (the input read once, 4.1 MB of weights, the output written once), 0.10 ms
// at 3.35 TB/s: operations bound it, at every shape the update operator has.
//
// Design: one launch, implicit GEMM, nothing staged in device memory.
// (a) M tiles are 128 consecutive pixels of the flattened map (B*H*W), so
//     every width tiles alike (43 x 70 wastes nothing but the last tile's
//     tail), and the grid is ceil(M / 128) x C_out / BN blocks of two
//     warpgroups; the wrapper picks BN (128 or 64 output channels) as the
//     widest that still gives every SM a block where it can.
// (b) The input is read in place: a 2-D TMA tensor map over (C_in, pixels)
//     with the map's own pixel stride (a channel slice of a wider
//     channels-last tensor needs no copy).  Tap t of a tile is the same box
//     of 128 pixel rows shifted by off(t) = (dy - 1) W + (dx - 1); TMA fills
//     the rows that fall before the first or after the last pixel with
//     zeros, and a thread zeroes the values of its rows whose neighbour
//     wraps across a row, an image or the map's edge (each of its two rows
//     carries a 9-bit mask of the taps that stay inside).  No im2col buffer,
//     no NCHW <-> NHWC transpose.
// (c) The weights are K-major [C_out, 9 C_in] (k = t C_in + c), packed once
//     per weight version by the wrapper as their TF32 big part (rounded to
//     the nearest TF32) and the exact remainder; TMA brings both.
// (d) The product is wgmma m64nBNk8 TF32 with fp32 accumulators, 32 channels
//     (128 bytes, the swizzle span) a stage, in a ring of 4 or 6 stages.
//     The input tile goes from shared memory to registers as each thread's
//     wgmma fragment and is split there, x = big + small with big rounded to
//     TF32 and small exact; the weights' parts stay in shared memory (B).
//     Each k8 step takes small*big + big*small + big*big (3xTF32): about
//     2^-21 relative error a product against fp32's 2^-24.  A thread loads
//     and splits the next stage's fragment while the tensor cores work on
//     this one's.  Splitting in shared memory instead (as K2,
//     csrc/corr_build.cu, does) wrote 32 KB a stage and ran at 99 TFLOP/s
//     against 107-118 at E = 48 on an H100 (700 W).
// (e) Sums in two levels.  The tensor cores round each wgmma's sum toward
//     zero, so a K of 9 * 448 = 4032 summed in the accumulators (1512
//     roundings of the same sign) lost 2.7e-5 relative on an H100 against
//     cuDNN's 7.9e-7.  Each stage's 12 products go instead to a fresh
//     partial sum, which one fp32 add (round to nearest) takes into the
//     total: 3.1e-7 at that shape.  Both sets of accumulators and two
//     fragments take 235 registers at BN = 128, so BN is 128 or 64.
// (f) Epilogue straight from the accumulators: bias added, fp32 stores of
//     the channels-last output [B, H, W, C_out] (32 contiguous bytes a
//     pixel for each quad of threads); rows past M are not stored.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 128;                  // output pixels a block: two warpgroups of 64
constexpr int kBK = 32;                  // input channels a stage: 128 bytes, the swizzle span
constexpr int kThreads = 256;
constexpr int kABytes = kM * kBK * 4;    // 16 KB
constexpr int kRing = 200 * 1024;        // shared memory for the ring of stages

template <int BN> struct Cfg {
  static constexpr int kBBytes = BN * kBK * 4;                 // 16 or 8 KB
  static constexpr int kStage = kABytes + 2 * kBBytes;         // A, B big, B small: 48 or 32 KB
  static constexpr int kStages = kRing / kStage;               // 4 or 6
  static constexpr int kSmem = kStages * kStage + 1024 + 64;   // alignment slack, mbarriers
  static_assert(kStages >= 2, "the ring needs two stages");
};

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

// Waits for phase `parity` of the barrier; traps after about 2^34 cycles (a
// copy that never lands ends the kernel with an error instead of a hang).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 34))
      __trap();
  }
}

// A box at (c0, c1) of a 2-D map; coordinates may be negative or past the
// end, where TMA writes zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}


// d = a * b + (scale_d ? d : 0), one wgmma m64nNk8 TF32 with fp32
// accumulators, a from registers (this thread's fragment), b K-major in
// shared memory, for N = 64 and 128.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  if constexpr (BN == 128)
    wgmma_rs_n128(d, a, db, scale_d);
  else
    wgmma_rs_n64(d, a, db, scale_d);
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; i++) asm volatile("" : "+f"(d[i])::"memory");
}

// x rounded to the nearest TF32 value: its low 13 bits cleared.
__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// The tap offsets of the flattened map: tap t = 3 dy + dx reads pixel
// p + (dy - 1) W + (dx - 1).
__device__ __forceinline__ int tap_offset(int t, int W) { return (t / 3 - 1) * W + (t % 3 - 1); }

// One stage's A operand in registers, split: for k8 step kk, big[kk] and
// small[kk] hold {A[r0][8 kk + q], A[r0 + 8][8 kk + q], A[r0][8 kk + q + 4],
// A[r0 + 8][8 kk + q + 4]}, the wgmma TF32 fragment of rows r0, r0 + 8.
struct Frag {
  uint32_t big[4][4], small[4][4];
};

// Keeps a fragment live, and in its registers, until the wgmmas reading it
// have completed.
__device__ __forceinline__ void pin(Frag& f) {
#pragma unroll
  for (int kk = 0; kk < 4; kk++)
#pragma unroll
    for (int j = 0; j < 4; j++)
      asm volatile("" : "+r"(f.big[kk][j]), "+r"(f.small[kk][j])::"memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_wbig,
               const __grid_constant__ CUtensorMap map_wsmall, const float* __restrict__ bias,
               float* __restrict__ out, int npix, int H, int W, int cin, int cout) {
  using C = Cfg<BN>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(smem + S * C::kStage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + g;  // this thread's rows: r0, r0 + 8
  const int m0 = blockIdx.x * kM, n0 = blockIdx.y * BN;
  const int chunks = cin / kBK;                   // stages a tap
  const int nk = 9 * chunks;                      // stage n: tap n / chunks

  // slot s: the input tile [0, 16K), the weights' big part, their remainder
  auto a_tile = [&](int s) { return smem + s * C::kStage; };
  auto b_big = [&](int s) { return smem + s * C::kStage + kABytes; };
  auto b_small = [&](int s) { return smem + s * C::kStage + kABytes + C::kBBytes; };
  auto load = [&](int n) {                        // one thread: stage n into slot n % S
    const int s = n % S, t = n / chunks, c0 = (n % chunks) * kBK;
    const uint32_t bar = smem_addr(&full[s]);
    mbar_expect_tx(bar, kABytes + 2 * C::kBBytes);
    tma_load_2d(smem_addr(a_tile(s)), &map_x, bar, c0, m0 + tap_offset(t, W));
    tma_load_2d(smem_addr(b_big(s)), &map_wbig, bar, t * cin + c0, n0);
    tma_load_2d(smem_addr(b_small(s)), &map_wsmall, bar, t * cin + c0, n0);
  };

  // bit t of taps[u] is set where the tap-t neighbour of row r0 + 8 u lies
  // inside the map
  uint32_t taps[2];
  const int HW = H * W;
#pragma unroll
  for (int u = 0; u < 2; u++) {
    const int p = m0 + r0 + 8 * u, qq = p % HW, y = qq / W, x = qq - y * W;
    uint32_t bits = 0;
#pragma unroll
    for (int t = 0; t < 9; t++) {
      const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) bits |= 1u << t;
    }
    taps[u] = bits;
  }
  // The fragment of stage n, split and masked.  Rows r0 and r0 + 8 are both
  // g mod 8, so in the 128-byte swizzle 16-byte unit u of either sits at u ^ g.
  auto load_frag = [&](int n, Frag& f) {
    const int t = n / chunks;
    const uint8_t* a = a_tile(n % S) + r0 * 128 + 4 * q;
    const bool ok0 = (taps[0] >> t) & 1u, ok1 = (taps[1] >> t) & 1u;
#pragma unroll
    for (int kk = 0; kk < 4; kk++)
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const int unit = 2 * kk + (j >> 1);
        const float v = *(const float*)(a + (j & 1) * 1024 + ((unit ^ g) << 4));
        const float x = ((j & 1) ? ok1 : ok0) ? v : 0.f;
        const float b = tf32_big(x);
        f.big[kk][j] = __float_as_uint(b);
        f.small[kk][j] = __float_as_uint(x - b);
      }
  };

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_x) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_wbig) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_wsmall) : "memory");
    for (int s = 0; s < S; s++) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int n = 0; n < S && n < nk; n++) load(n);

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; i++) acc[i] = 0.f;
  pin(acc);
  Frag fa, fb;
  mbar_wait(smem_addr(&full[0]), 0);
  load_frag(0, fa);

  // Stage n from fragment cur, fragment n + 1 loaded into nxt meanwhile; once
  // every warp is done with slot n % S, it is refilled with stage n + S.
  auto stage = [&](int n, Frag& cur, Frag& nxt) {
    const int s = n % S;
    const uint64_t db_b = sw128_desc(smem_addr(b_big(s)));
    const uint64_t db_s = sw128_desc(smem_addr(b_small(s)));
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 8; kk++) {
      wgmma_rs<BN>(part, cur.small[kk], db_b + 2 * kk, kk > 0);   // a fresh partial sum
      wgmma_rs<BN>(part, cur.big[kk], db_s + 2 * kk);
      wgmma_rs<BN>(part, cur.big[kk], db_b + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (n + 1 < nk) {
      mbar_wait(smem_addr(&full[(n + 1) % S]), ((n + 1) / S) & 1);
      load_frag(n + 1, nxt);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(part);
    pin(cur);
#pragma unroll
    for (int i = 0; i < BN / 2; i++) acc[i] += part[i];
    __syncthreads();
    if (tid == 0 && n + S < nk) load(n + S);
  };
  for (int n = 0; n < nk; n += 2) {              // two a pass: the fragments swap roles
    stage(n, fa, fb);
    if (n + 1 < nk) stage(n + 1, fb, fa);
  }

  // Epilogue.  Thread (g, q) holds, for pixels r0 and r0 + 8 of the tile,
  // channels n0 + 8 j + 2 q + {0, 1}: acc[4 j], acc[4 j + 1] and acc[4 j + 2],
  // acc[4 j + 3].
  const int p0 = m0 + r0, p1 = p0 + 8;
  float* row0 = out + (size_t)p0 * cout + n0 + 2 * q;
  float* row1 = out + (size_t)p1 * cout + n0 + 2 * q;
#pragma unroll
  for (int j = 0; j < BN / 8; j++) {
    const float2 b = bias ? *(const float2*)(bias + n0 + 8 * j + 2 * q) : make_float2(0.f, 0.f);
    if (p0 < npix) *(float2*)(row0 + 8 * j) = make_float2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
    if (p1 < npix)
      *(float2*)(row1 + 8 * j) = make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
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

// A 2-D fp32 tensor map: `cols` values a row, `rows` rows `stride` values
// apart, boxes of 32 x box_rows, 128-byte swizzle, zeros past the edges.
bool make_map(CUtensorMap* map, const void* base, long long cols, long long rows,
              long long stride, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const void* x, int npix, int H, int W, int cin, long long xstride, const void* wbig,
           const void* wsmall, const void* bias, int cout, void* out, void* stream) {
  using C = Cfg<BN>;
  if (npix <= 0) return (int)cudaGetLastError();
  // channels in whole stages; 16-byte rows and bases, as TMA requires; whole
  // images in the map; float2 bias loads and output stores
  if (H <= 0 || W <= 0 || npix % (H * W) || cin <= 0 || cin % kBK || cout <= 0 || cout % BN ||
      xstride < cin || xstride % 4 || (uintptr_t)x % 16 || (uintptr_t)wbig % 16 ||
      (uintptr_t)wsmall % 16 || (uintptr_t)bias % 8 || (uintptr_t)out % 8 ||
      (long long)npix + W + 1 > 0x7fffffffLL || cout / BN > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_wbig, map_wsmall;
  if (!make_map(&map_x, x, cin, npix, xstride, kM) ||
      !make_map(&map_wbig, wbig, 9LL * cin, cout, 9LL * cin, BN) ||
      !make_map(&map_wsmall, wsmall, 9LL * cin, cout, 9LL * cin, BN))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(conv3x3_kernel<BN>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err) return err;
  dim3 grid((npix + kM - 1) / kM, cout / BN);
  conv3x3_kernel<BN><<<grid, kThreads, C::kSmem, (cudaStream_t)stream>>>(
      map_x, map_wbig, map_wsmall, (const float*)bias, (float*)out, npix, H, W, cin, cout);
  return (int)cudaGetLastError();
}

template <int BN> void info(int* o) {
  using C = Cfg<BN>;
  o[0] = C::kSmem;
  o[1] = C::kStages;
  int n = -1;
  if (cudaFuncSetAttribute(conv3x3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv3x3_kernel<BN>, kThreads, C::kSmem))
    n = -1;
  o[2] = n;
}

}  // namespace

// Launches the 3x3 convolution on `stream`: x holds npix = B*H*W pixels of
// cin fp32 channels (channel stride 1, pixel p at x + p * xstride; 16-byte
// aligned, xstride a multiple of 4, cin of 32); wbig and wsmall [cout, 9 cin]
// (k = (3 dy + dx) cin + c), the TF32 big part of the weights and the
// remainder; bias [cout] or null; out [npix, cout] fp32.  bn, the output
// channels a block (128 or 64), must divide cout.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for inputs
// the kernel does not take.
extern "C" int conv3x3_launch(const void* x, int npix, int H, int W, int cin, long long xstride,
                              const void* wbig, const void* wsmall, const void* bias, int cout,
                              int bn, void* out, void* stream) {
  if (bn == 128)
    return launch<128>(x, npix, H, W, cin, xstride, wbig, wsmall, bias, cout, out, stream);
  if (bn == 64)
    return launch<64>(x, npix, H, W, cin, xstride, wbig, wsmall, bias, cout, out, stream);
  return (int)cudaErrorInvalidValue;
}

// What a launch with bn output channels a block uses: out[0] dynamic shared
// memory bytes, out[1] stages in the ring, out[2] resident blocks per SM (-1
// when the query fails).  Returns 0, or cudaErrorInvalidValue for another bn.
extern "C" int conv3x3_info(int bn, void* out) {
  int* o = (int*)out;
  if (bn == 128)
    info<128>(o);
  else if (bn == 64)
    info<64>(o);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}
