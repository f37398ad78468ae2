// K5: radius-3 bilinear lookup inside the per-pixel window cache, for Hopper.
//
// Replaces the TPU kernel droid_slam_reserch_tpu/ops/pallas_corr.py
// (corr_lookup_windows_pallas, body _lookup_windows_kernel).  Same function:
// for edge e, source pixel p and level l, with (x, y) = coords[e, p] / 2^l,
// the 8-tap span starts at window row
//   sy = clip(floor(y) + 8 - 3 - by_l, 0, WH_l - 8)
// (sx likewise) of the window K4 cut around the first round's coords, and
//   out[e, p, 49 l + 7 a + b] = (1 - fx) * Y[b][a] + fx * Y[b][a + 1],
//   Y[b][j] = (1 - fy) * w[sy + b][sx + j] + fy * w[sy + b + 1][sx + j]
// with fx, fy the fractional parts: the K3 formula read from the window.
// It equals K3 wherever the engine's drift rule (ops/corr.py
// window_drift_ok) holds, taps off the image included, because the window
// carries the zero border.
//
// What bounds it on the H100: bytes.  Each (e, p, l) reads the 8x8 block of
// its window that it samples and writes 49 floats; at the main path's shapes
// (E = 48, P = 2560) that is 126 MB read and 96 MB written, 0.068 ms at
// 3.35 TB/s.
//
// fp32 design: one thread per output value out[e, p, c], c = 49 l + 7 a + b,
// so that consecutive threads write consecutive floats and every store
// coalesces (the edge is the grid's y, so no 64-bit division finds it).  A
// thread reads only its four cells, rows sy + b and sy + b + 1 and columns
// sx + a and sx + a + 1, and blends them first along y, then along x, as the
// plain version does.  The 196 threads of a pixel share its four 8x8 spans,
// so those loads hit in L1; its coords and bases are warp broadcasts.
//
// bf16 (the JAX package's bfloat16 path, where K4 stores bf16 windows) has a
// kernel of its own, windows_lookup_bf16_kernel: there the fp32 design's
// instructions, not its bytes, set the time (four 2-byte loads and one
// 2-byte store an output).  One thread per (pixel, level) reads its coords
// and bases once.  A window row is ww_max = 24 cells (48 bytes) and every
// window starts on a 16-byte boundary, so the span's 8 rows are one
// contiguous 384-byte stretch that starts 16-byte aligned: one
// cp.async.bulk a thread copies it into shared memory, all of a block's on
// one mbarrier.  Row i then needs chunk sx / 8 and, only where sx % 8 != 0,
// chunk sx / 8 + 1 of its copy; lookup_bf16.cuh aligns them with funnel
// shifts, blends row pair by row pair (along y, then x, each product and sum
// rounded on its own, the fractional parts rounded to bf16 as the TPU
// kernel casts them, the output rounded once, so it equals the plain
// version exactly) into the tile's outputs staged in shared memory, and the
// block writes the tile's contiguous 16 x 392-byte run with 16-byte stores
// (8-byte ones where the run starts at an odd pixel, e * P + p0).  The bulk
// copy moves the whole stretch, about 1.5 times the sectors the span rows
// touch, yet took about 28 % less time at E = 48 on the H100 than the same
// thread reading its up to 16 chunks into registers (tools/lookup_sources.py,
// variant ldg): the scattered 16-byte loads, not the bytes, bounded that
// design.  Where ww_max % 8 != 0 (target maps narrower than 8 cells) or the
// windows are not 16-byte aligned, the same body reads its cells 2 bytes at
// a time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"
#include "lookup_bf16.cuh"

namespace {

constexpr int kLevels = 4, kPad = 8, kWin = 24, kR = 3;
constexpr int kD = 2 * kR + 1;          // 7 taps per axis
constexpr int kOut = kLevels * kD * kD; // 196 outputs per pixel
constexpr int kThreads = 256;

struct WinMeta {
  int WH[kLevels], WW[kLevels], off[kLevels];
  int sum_wh, ww_max;
};

__device__ __forceinline__ int floor_clamped(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

__global__ void __launch_bounds__(kThreads)
windows_lookup_kernel(const float* __restrict__ wins, const int* __restrict__ bases,
                      const float2* __restrict__ coords, float* __restrict__ out, int P,
                      WinMeta m) {
  const int e = blockIdx.y;                  // grid: (output blocks, edges)
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= P * kOut) return;
  const int p = idx / kOut, ch = idx - p * kOut;
  const int l = ch / (kD * kD), ab = ch - l * (kD * kD);
  const int a = ab / kD, b = ab - a * kD;
  int WH = m.WH[0], WW = m.WW[0], off = m.off[0];
#pragma unroll
  for (int k = 1; k < kLevels; k++)          // select without indexing the parameter
    if (l == k) {
      WH = m.WH[k];
      WW = m.WW[k];
      off = m.off[k];
    }

  const size_t ep = (size_t)e * P + p;
  const float2 c = coords[ep];
  const float scale = 1.f / (float)(1 << l);
  const float x = c.x * scale, y = c.y * scale;
  const float dx = x - floorf(x), dy = y - floorf(y);
  const int* bp = bases + ((size_t)e * 2 * kLevels + 2 * l) * P + p;
  const int sy = min(max(floor_clamped(y) + kPad - kR - bp[0], 0), WH - 8);
  const int sx = min(max(floor_clamped(x) + kPad - kR - bp[P], 0), WW - 8);
  const float* w = wins + (ep * m.sum_wh + off + sy + b) * m.ww_max + sx + a;

  const float g00 = Io<float>::load(w), g01 = Io<float>::load(w + 1);
  const float g10 = Io<float>::load(w + m.ww_max), g11 = Io<float>::load(w + m.ww_max + 1);
  const float y0 = (1.f - dy) * g00 + dy * g10;   // Y[b][a]
  const float y1 = (1.f - dy) * g01 + dy * g11;   // Y[b][a + 1]
  out[(size_t)e * P * kOut + idx] = (1.f - dx) * y0 + dx * y1;
}

constexpr int kTileB = 16;                  // bf16: pixels a block
constexpr int kThreadsB = kTileB * kLevels; // a thread per (pixel, level)
// 16-byte chunks of a thread's span copy: 8 window rows of ww_max <= 24
// cells (384 bytes), and one more so that the threads' copies start on
// different banks
constexpr int kSpanChunks = 25;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One bulk copy of `bytes` (a multiple of 16; src and dst 16-byte aligned)
// from global to shared memory, completing on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];" :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wait_phase0(uint32_t bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar) : "memory");
}

// The 8 rows of a span read 2 bytes a cell: cells sx .. sx + 7 of window
// rows sy .. sy + 7 (w points at row sy, column 0).
__device__ __forceinline__ void load_cells(const bf16* w, int ww, int sx, uint4 (&rows)[8]) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(w) + sx;
  unsigned short c[8][8];
#pragma unroll
  for (int i = 0; i < 8; i++)
#pragma unroll
    for (int j = 0; j < 8; j++) c[i][j] = __ldg(r + i * ww + j);
#pragma unroll
  for (int i = 0; i < 8; i++) rows[i] = lookup_bf16::pack8(c[i]);
}

// A block takes kTileB consecutive pixels of edge blockIdx.y; thread
// l * kTileB + q is (pixel p0 + q, level l), so a warp's coords and bases
// loads coalesce.  kBulk: the span's 8 window rows, one contiguous 16-byte
// aligned stretch of 16 ww_max bytes, come by one bulk copy a thread into
// shared memory, all of the block's on one mbarrier; else 2 bytes a cell.
template <bool kBulk>
__global__ void __launch_bounds__(kThreadsB)
windows_lookup_bf16_kernel(const bf16* __restrict__ wins, const int* __restrict__ bases,
                           const float2* __restrict__ coords, bf16* __restrict__ out, int P,
                           WinMeta m) {
  __shared__ __align__(16) bf16 stage[kTileB * kOut];
  __shared__ __align__(16) uint4 spans[kBulk ? kThreadsB : 1][kSpanChunks];
  __shared__ __align__(8) unsigned long long bar;
  const int tid = threadIdx.x, l = tid / kTileB, q = tid - l * kTileB;
  const int e = blockIdx.y, p0 = blockIdx.x * kTileB;
  const int np = min(kTileB, P - p0);
  if constexpr (kBulk) {
    if (tid == 0) {         // one arrival for each (pixel, level) of the tile
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(&bar)),
                   "r"(np * kLevels) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  if (q < np) {
    int WH = m.WH[0], WW = m.WW[0], off = m.off[0];
#pragma unroll
    for (int k = 1; k < kLevels; k++)        // select without indexing the parameter
      if (l == k) {
        WH = m.WH[k];
        WW = m.WW[k];
        off = m.off[k];
      }
    const size_t ep = (size_t)e * P + p0 + q;
    const float2 c = coords[ep];
    const float scale = 1.f / (float)(1 << l);
    const float x = c.x * scale, y = c.y * scale;
    const float fx = Io<bf16>::round(x - floorf(x)), fy = Io<bf16>::round(y - floorf(y));
    const int* bp = bases + ((size_t)e * 2 * kLevels + 2 * l) * P + p0 + q;
    const int sy = min(max(floor_clamped(y) + kPad - kR - bp[0], 0), WH - 8);
    const int sx = min(max(floor_clamped(x) + kPad - kR - bp[P], 0), WW - 8);
    const bf16* w = wins + (ep * m.sum_wh + off + sy) * m.ww_max;   // span row 0, column 0
    uint4 rows[8];
    if constexpr (kBulk) {
      bulk_copy(smem_addr(spans[tid]), w, 16 * m.ww_max, smem_addr(&bar));
      wait_phase0(smem_addr(&bar));
      // row i needs chunk sx / 8 and, only where sx % 8 != 0, the next one
      // (sx <= WW_l - 8 <= 16 keeps both inside the row)
      const int s = sx & 7, c0 = sx >> 3, rc = m.ww_max >> 3;
#pragma unroll
      for (int i = 0; i < 8; i++)
        rows[i] = lookup_bf16::span8(spans[tid][i * rc + c0],
                                     s ? spans[tid][i * rc + c0 + 1] : make_uint4(0, 0, 0, 0), s);
    } else {
      load_cells(w, m.ww_max, sx, rows);
    }
    lookup_bf16::blend_span(rows, fx, fy, stage + q * kOut + l * kD * kD);
  }
  __syncthreads();
  lookup_bf16::store_run(stage, out + ((size_t)e * P + p0) * kOut, np * kOut, tid, kThreadsB);
}

// The packed windows' layout for an H2 x W2 target grid (ops/corr.py
// win_shape and pack_offsets).
WinMeta win_meta(int H2, int W2) {
  WinMeta m;
  m.sum_wh = 0;
  m.ww_max = 0;
  for (int l = 0; l < kLevels; l++) {
    const int hp = (H2 >> l) + 2 * kPad, wp = (W2 >> l) + 2 * kPad;
    m.WH[l] = hp < kWin ? hp : kWin;
    m.WW[l] = wp < kWin ? wp : kWin;
    m.off[l] = m.sum_wh;
    m.sum_wh += m.WH[l];
    m.ww_max = m.WW[l] > m.ww_max ? m.WW[l] : m.ww_max;
  }
  return m;
}

}  // namespace

// Launches K5 on `stream`: wins [E, P, sum WH, max WW] float32 and bases
// [E, 8, P] int32 from K4, coords [E, P, 2] float32 level-0 pixels, for an
// H2 x W2 target grid -> out [E, P, 196].  Returns cudaGetLastError().
extern "C" int corr_windows_lookup_launch(const void* wins, const void* bases,
                                          const void* coords, int E, int P, int H2, int W2,
                                          void* out, void* stream) {
  const WinMeta m = win_meta(H2, W2);
  if (E > 65535 || (long long)P * kOut > 0x7fffffffLL)   // edges ride the grid's y
    return (int)cudaErrorInvalidValue;
  if (E > 0 && P > 0) {
    dim3 grid((P * kOut + kThreads - 1) / kThreads, E);
    windows_lookup_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)wins, (const int*)bases, (const float2*)coords, (float*)out, P, m);
  }
  return (int)cudaGetLastError();
}

// The same over K4's bf16 windows -> out [E, P, 196] bf16 (8-byte aligned).
// The span rows are read 16 bytes at a time where a window row is a whole
// number of 16-byte chunks and the windows start 16-byte aligned (always
// for torch.empty's windows with W2 >= 8), else 2 bytes at a time.
extern "C" int corr_windows_lookup_bf16_launch(const void* wins, const void* bases,
                                               const void* coords, int E, int P, int H2,
                                               int W2, void* out, void* stream) {
  const WinMeta m = win_meta(H2, W2);
  if (E > 65535) return (int)cudaErrorInvalidValue;      // edges ride the grid's y
  if (E > 0 && P > 0) {
    dim3 grid((P + kTileB - 1) / kTileB, E);
    auto* kernel = m.ww_max % 8 == 0 && (reinterpret_cast<uintptr_t>(wins) & 15) == 0
                       ? windows_lookup_bf16_kernel<true>
                       : windows_lookup_bf16_kernel<false>;
    kernel<<<grid, kThreadsB, 0, (cudaStream_t)stream>>>(
        (const bf16*)wins, (const int*)bases, (const float2*)coords, (bf16*)out, P, m);
  }
  return (int)cudaGetLastError();
}
