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
// What bounds it on the H100.  K4: the product, 2*E*P*P*C = 80.5 GFLOP at
// the main path's shapes (E = 48, P = H2*W2 = 2560, C = 128), done to fp32
// accuracy as three TF32 tensor-core products (3xTF32): 241.6 GFLOP at the
// 495 TFLOP/s TF32 peak, 0.488 ms, against 1.23 GB moved (f1, f2, coords
// in; 1.10 GB of windows and the bases out), 0.367 ms at 3.35 TB/s.  K8:
// bytes, 2.90 GB with its 1.67 GB of levels, 0.865 ms.
//
// Design: the cell dimension is cut into bands of 8 level-0 rows.  A band
// holds whole 2x2, 4x4 and 8x8 blocks, so it pools to its 4, 2 and 1 rows
// of levels 1-3 with no cell of another band (level-l row r comes from
// level-0 rows r*2^l .. (r+1)*2^l - 1, all in band floor(r*2^l / 8)), and a
// block needs only its band of the pyramid, not a pixel's whole pyramid.
// One block is (band, tile of kM source pixels, edge): kM = 64 and 16 warps
// where a band row fits one chunk of 64 cells (W2 <= 64), else kM = 32 and
// 8 warps, the band rows in column chunks.  A warp takes 32 pixels, two band
// rows and 32 columns.
// (a) The kM x (8 rows x W2) product tile over C runs on the tensor cores,
//     mma.sync m16n8k8 TF32 with fp32 accumulation, each operand split as
//     a = big + small, both rounded to TF32 (to nearest, ties away from
//     zero), and the product taken as small*big + big*small + big*big.
//     f1's tile and f2's band stream through shared-memory stages of 16
//     channels by cp.async, 3 (kM = 64) or 2 in flight while the tensor
//     cores work.
// (b) The tile, scaled by 1/16, goes to shared memory.  A thread holds both
//     rows of its columns, so it pools level 1 in registers; levels 2 and 3
//     are pooled in shared memory.  The four cells are added in the plain
//     version's order, ((s0 + s1) + s2) + s3.
// (c) The window rows that fall in the band are written with 16-byte stores,
//     so every window cell is written once and no memset is needed: rows
//     above the level (the zero border) by band 0, rows below it by the last
//     band, zeros for columns outside the level and past WW_l.  The window
//     bases come from a table made at the block's start; band 0 writes them
//     out.  K8 (kStoreLevels) also copies the band's rows of each level, one
//     contiguous run per pixel and level in K2's layout.
// At 40x64 the 64-pixel tile (182 KB, the stages in the same memory) leaves
// room for one block of 512 threads on an SM, at 128 registers a thread;
// each block reads f2's band (256 KB) once, 2.5 GB from L2 at the main path.
// Maps wider than about 80 cells need more shared memory than a block has.
//
// bf16 features (the JAX package's bfloat16 path) have a kernel of their own,
// windows_build_bf16_kernel, for K4 and K8, with the fp32 kernel's pixel
// tiles, warps and stage order: the product is one mma.sync m16n8k16 bf16
// with fp32 accumulation where fp32 takes three TF32 products, a stage holds
// 32 channels (the same 64 bytes a pixel), and the windows are bf16, written
// 8 cells to a 16-byte store.  Each level-0 cell is rounded to bf16 once after
// the scale, each pooled cell is the fp32 mean of the rounded cells below it,
// rounded once, as the plain version does, so the tile holds bf16 cells, and
// windows and levels are copied out of it as bits.  At the main path's shapes
// the product is 0.081 ms at the 989 TFLOP/s bf16 peak against 0.61 GB moved
// (0.55 GB of bf16 windows), 0.18 ms at 3.35 TB/s: bytes bound it.  K8 stores
// each level from the same cells (0.84 GB more, 0.43 ms in all), so its
// windows equal K7's cut from its own levels, bit for bit; its levels are
// within one rounding step of K2's (the two sum the products in other orders).
// What holds bf16 back is neither bound: one block an SM (at 40x64 the
// 64-pixel block takes 149,504 bytes and the whole register file) runs its
// phases in turn.  On the H100 at E = 48, 40x64 (tools/windows_build_phases.py)
// the kernel with an fp32 tile took 1.26 ms: the cp.async loads alone 0.22,
// with the products 0.48, with the tile and the pools 0.79; the window stores
// took the rest.  Two blocks of 32 pixels an SM (a 45 KB bf16 tile) were
// measured slower: their phases did not overlap, and f2's band, read by twice
// as many blocks, made the loads alone 0.32 ms.  What this kernel does
// instead, each step measured:
// - the tile holds bf16 cells (at 40x64 99 KB, in the 4 stages' 147 KB);
//   K4 pads each level's rows to 3 or 5 mod 8 words, so the window stores'
//   reads of up to 8 rows find distinct banks, and a pixel's tile is
//   4 (2 j + 1) words, so the tile stores of a warp's threads do too;
// - the stages swap a pixel's two 32-byte halves in rows r with r & 2, so the
//   fragment loads of rows g and g + 2 find distinct banks: the same
//   fragments in the same order, so the windows are bit for bit those of the
//   kernel with an fp32 tile;
// - f2's band stays in L2 (evict_last) while the windows and levels stream
//   past it (st.global.cs);
// - K8 keeps its rows W_l cells (rounded up to even), so a band of a level is
//   one run in the tile as in the level, and copies it 16 bytes at a time
//   where W_l and the run's offset in the tile are multiples of 8 (every level
//   at 40x64), else a cell at a time.  Its window stores' reads conflict in
//   banks, which costs K8 less than padded rows copied row by row did.
// Maps wider than 64 cells take 32 pixels a block, the tile and the stages
// side by side, up to 181 cells.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

constexpr int kLevels = 4, kPad = 8, kWin = 24, kR = 3;
constexpr int kBand = 8;                 // level-0 rows per band
constexpr int kColMax = 64;              // cells of a band row per column chunk
constexpr int kNT = 8;                   // n8 tiles of a warp: 2 rows x 32 columns
constexpr int kBK = 16;                  // fp32 channels per stage (bf16: 32), 64 bytes
constexpr int kMaxShared = 232448;       // bytes a block may use on Hopper

// kM source pixels per block, 32 per group of 8 warps: 64 where a band row
// fits one chunk (W2 <= 64), whose tile holds the stages too; 32 for wider
// maps, whose tile and stages must fit side by side.
template <int kM> struct Tile {
  static constexpr int kThreads = 8 * kM;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStages = kM == 64 ? 4 : 3;
  static constexpr int kStageF = (kM + kBand * kColMax) * kBK;              // floats a stage
  static constexpr int kBLoads = kBand * kColMax * (kBK / 4) / kThreads;    // f2 copies a thread
};

// Offsets into shared memory count cells of the tile's type, fp32 or bf16.
struct Meta {
  int H[kLevels], W[kLevels];    // level sizes
  int WH[kLevels], WW[kLevels];  // window extents
  int off[kLevels];              // packed row offset of each level's window
  int lo[kLevels];               // offset of each level's band rows in a pixel's tile
  int S;                         // cells of one pixel's tile
  int sum_wh, ww_max;
  int nbands;
  int nchunks, cw, nt;           // column chunks of a band row, cw = 8 nt cells each
  int stage_off;                 // cells from the tile to the stages
  int base_off;                  // cells from the tile to the block's window bases
  int rs[kLevels];               // bf16: cells from a level's row to the next
};

template <typename Elem> struct LevelsOut {
  Elem* lv[kLevels];             // K8's levels [E, P, H_l, W_l]; unused by K4
};

__device__ __forceinline__ int floor_clamped(float v) {
  return (int)fminf(fmaxf(floorf(v), -1e6f), 1e6f);
}

__device__ __forceinline__ int window_base(float c, float scale, int n, int win) {
  const int b = floor_clamped(c * scale) + kPad - kR - (win - 8) / 2;
  return min(max(b, 0), n + 2 * kPad - win);
}

// 16-byte copy to shared memory; with ok false the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// The same with an L2 eviction policy for the source (createpolicy).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok, uint64_t policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small, both TF32 rounded to nearest, ties away from zero: the
// values of cvt.rna.tf32.f32 for finite x, by integer operations, which
// the SM dispatches faster than the conversion.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a * b on a 16x8x8 tile: a row-major (m16 x k8), b column-major (k8 x
// n8).  Not volatile, so the compiler may interleave independent tiles.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b on a 16x8x16 tile of bf16 pairs, the fragments of mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// fp32 features and windows (bf16 has a kernel of its own below).
template <int kM, bool kStoreLevels>
__global__ void __launch_bounds__(Tile<kM>::kThreads, 64 / kM)
windows_build_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                     const float2* __restrict__ coords0, float* __restrict__ wins,
                     int* __restrict__ bases, int P, int C, Meta m, LevelsOut<float> out_lv) {
  using T = Tile<kM>;
  using io = Io<float>;
  constexpr int kChan = kBK;                       // channels a stage: 64 bytes a pixel
  constexpr int kV = 4;                            // channels a 16-byte copy
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);   // [kM][S]: each pixel's band of levels
  float* stages = tile + m.stage_off;              // kStages x ([kM][16] f1, [8][64][16] f2)
  const int band = blockIdx.x, p0 = blockIdx.y * kM, e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // warp: 32 pixels from ph, band rows 2k and 2k + 1, columns 32h .. 32h + 31 of a chunk
  const int ph = 32 * (warp >> 3), k = warp & 3, h = (warp >> 2) & 1;
  const int g = lane >> 2, t = lane & 3;           // mma fragment coordinates
  const int H0 = m.H[0], W0 = m.W[0];
  const int y0 = band * kBand;
  const bool live = y0 + 2 * k < H0;               // the warp's first row exists
  const float* A = f1 + (size_t)e * P * C;
  const float* B = f2 + (size_t)e * H0 * W0 * C;
  const int q4 = kV * (tid & 3);                   // first channel of this thread's copies
  const int nk = (C + kChan - 1) / kChan;
  const int a_gp = p0 + (tid >> 2);
  const int a_goff = (tid < kM * 4 && a_gp < P) ? a_gp * C + q4 : -1;

  // each pixel's window bases, [2L][kM] in shared memory beside the tile;
  // band 0 writes them out
  int* wb = reinterpret_cast<int*>(tile + m.base_off);
  if (tid < kM && p0 + tid < P) {
    const float2 c = coords0[(size_t)e * P + p0 + tid];
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      const float scale = 1.f / (float)(1 << l);
      const int by = window_base(c.y, scale, m.H[l], m.WH[l]);
      const int bx = window_base(c.x, scale, m.W[l], m.WW[l]);
      wb[2 * l * kM + tid] = by;
      wb[(2 * l + 1) * kM + tid] = bx;
      if (band == 0) {
        int* bo = bases + ((size_t)e * 2 * kLevels + 2 * l) * P + p0 + tid;
        bo[0] = by;
        bo[P] = bx;
      }
    }
  }

  // ---- (a) levels 0 and 1 of the band, chunk by chunk of columns
  for (int ch = 0; ch < m.nchunks; ch++) {
    const int x0 = ch * m.cw;
    const int bj = (tid >> 2) % kColMax;           // column of the cells this thread copies
    auto load = [&](int kc) {
      float* As = stages + (kc % T::kStages) * T::kStageF;
      float* Bs = As + kM * kChan;
      const int k0 = kc * kChan;
      const bool kin = k0 + q4 < C;
      if (tid < kM * 4)
        cp_async16(As + (tid >> 2) * kChan + q4, a_goff >= 0 ? A + a_goff + k0 : A,
                   a_goff >= 0 && kin);
#pragma unroll
      for (int u = 0; u < T::kBLoads; u++) {       // slot c: band row c / 64, column c % 64
        const int c = (tid >> 2) + u * (T::kThreads / 4), w = c / kColMax;
        const bool in = bj < m.cw && y0 + w < H0 && x0 + bj < W0;
        cp_async16(Bs + c * kChan + q4, in ? B + ((y0 + w) * W0 + x0 + bj) * C + q4 + k0 : B,
                   in && kin);
      }
    };

    float acc[2][kNT][4];          // [m16 tile][n8 tile: row 2k + ni / 4, column 8 (ni % 4)]
#pragma unroll
    for (int mi = 0; mi < 2; mi++)
#pragma unroll
      for (int ni = 0; ni < kNT; ni++)
#pragma unroll
        for (int r = 0; r < 4; r++) acc[mi][ni][r] = 0.f;

#pragma unroll
    for (int st = 0; st < T::kStages - 1; st++) {  // kStages - 1 stages in flight
      if (st < nk) load(st);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; kc++) {
      cp_async_wait<T::kStages - 2>();             // stage kc has landed ...
      __syncthreads();                             // ... for every thread, and kc - 1 is done
      if (kc + T::kStages - 1 < nk) load(kc + T::kStages - 1);
      cp_async_commit();
      if (live) {
        // The 16 channels of a stage are two k8 steps.  Both operands take
        // step s's k-slots t and t + 4 from channels 4t + 2s and 4t + 2s + 1,
        // so one 8-byte load gives a thread both of a row's slots.
        const float* As = stages + (kc % T::kStages) * T::kStageF + (ph + g) * kBK + 4 * t;
        const float* Bs = stages + (kc % T::kStages) * T::kStageF + kM * kBK
                          + (2 * k * kColMax + 32 * h + g) * kBK + 4 * t;
#pragma unroll
        for (int st = 0; st < 2; st++) {
          uint32_t ab[2][4], as[2][4];             // [m16 tile][fragment]: big, small
#pragma unroll
          for (int mi = 0; mi < 2; mi++) {
            const float2 lo = *reinterpret_cast<const float2*>(As + 16 * mi * kBK + 2 * st);
            const float2 hi =
                *reinterpret_cast<const float2*>(As + (16 * mi + 8) * kBK + 2 * st);
            split_tf32(lo.x, ab[mi][0], as[mi][0]);
            split_tf32(hi.x, ab[mi][1], as[mi][1]);
            split_tf32(lo.y, ab[mi][2], as[mi][2]);
            split_tf32(hi.y, ab[mi][3], as[mi][3]);
          }
#pragma unroll
          for (int ni = 0; ni < kNT; ni++) {
            const float2 v = *reinterpret_cast<const float2*>(
                Bs + ((ni >> 2) * kColMax + 8 * (ni & 3)) * kBK + 2 * st);
            uint32_t bb[2], bs[2];
            split_tf32(v.x, bb[0], bs[0]);
            split_tf32(v.y, bb[1], bs[1]);
            mma_tf32(acc[0][ni], as[0], bb);       // small * big, big * small, big * big
            mma_tf32(acc[1][ni], as[1], bb);
            mma_tf32(acc[0][ni], ab[0], bs);
            mma_tf32(acc[1][ni], ab[1], bs);
            mma_tf32(acc[0][ni], ab[0], bb);
            mma_tf32(acc[1][ni], ab[1], bb);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();               // every warp is done with the stages (the tile may hold them)

    // The tile, scaled: thread (g, t) holds, for pixels g and g + 8 of each
    // m16 tile, columns 2t and 2t + 1 of both rows, the four cells of its
    // level-1 outputs, which it pools in the plain version's order.
    if (live) {
      const bool row1 = y0 + 2 * k + 1 < H0, lv1 = (y0 >> 1) + k < m.H[1];
#pragma unroll
      for (int mi = 0; mi < 2; mi++)
#pragma unroll
        for (int half = 0; half < 2; half++) {     // pixel g, then g + 8
          float* px = tile + (ph + 16 * mi + 8 * half + g) * m.S;
#pragma unroll
          for (int j = 0; j < 4; j++) {
            const int xc = 32 * h + 8 * j + 2 * t, x = x0 + xc;   // xc + 1 < cw when xc < cw
            if (xc >= m.cw) continue;
            const float s0 = io::round(acc[mi][j][2 * half] * 0.0625f);
            const float s1 = io::round(acc[mi][j][2 * half + 1] * 0.0625f);
            const float s2 = io::round(acc[mi][4 + j][2 * half] * 0.0625f);
            const float s3 = io::round(acc[mi][4 + j][2 * half + 1] * 0.0625f);
            float* r0 = px + 2 * k * W0 + x;
            if (x < W0) r0[0] = s0;
            if (x + 1 < W0) r0[1] = s1;
            if (row1 && x < W0) r0[W0] = s2;
            if (row1 && x + 1 < W0) r0[W0 + 1] = s3;
            if (lv1 && x + 1 < W0)
              px[m.lo[1] + k * m.W[1] + (x >> 1)] = io::round((((s0 + s1) + s2) + s3) * 0.25f);
          }
        }
    }
  }
  __syncthreads();

  // ---- (b), (c) each warp takes kM / kWarps pixels: it pools their band
  // rows of levels 2 and 3, then writes their window rows in this band
  // (16-byte stores, several rows a store) and K8's level rows
  constexpr int kPx = kM / T::kWarps;
#pragma unroll
  for (int l = 2; l < kLevels; l++) {
    const int wi = m.W[l - 1], wo = m.W[l];
    const int rows = min(kBand >> l, m.H[l] - (y0 >> l));
#pragma unroll
    for (int u = 0; u < kPx; u++) {              // pixels past P pool zeros, unused
      const float* s = tile + (warp + u * T::kWarps) * m.S + m.lo[l - 1];
      float* d = tile + (warp + u * T::kWarps) * m.S + m.lo[l];
#pragma unroll
      for (int r = 0; r < (kBand >> l); r++)
        if (r < rows)
          for (int x = lane; x < wo; x += 32) {
            const float* q = s + 2 * r * wi + 2 * x;
            d[r * wo + x] = io::round((((q[0] + q[1]) + q[wi]) + q[wi + 1]) * 0.25f);
          }
    }
    __syncwarp();
  }

  const bool first = band == 0, last = band == m.nbands - 1;
  const int wwm = m.ww_max;
  constexpr int kVec = io::kVec;                   // cells of a 16-byte store
  const int cpr = (wwm + kVec - 1) / kVec, rpi = 32 / cpr;  // chunks a row, rows a store
  const int lr = lane / cpr, q = kVec * (lane - lr * cpr);
  for (int u = 0; u < kPx; u++) {
    const int pl = warp + u * T::kWarps, gp = p0 + pl;
    if (gp >= P) break;
    const float* src = tile + pl * m.S;
    const size_t ep = (size_t)e * P + gp;
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      const int Hl = m.H[l], Wl = m.W[l], WWl = m.WW[l];
      const int by = wb[2 * l * kM + pl], bx = wb[(2 * l + 1) * kM + pl];
      // window row r holds level row by - 8 + r; this band owns level rows
      // [ylo, ymax), stretched to the zero rows above (band 0) and below (last)
      const int ylo = y0 >> l;
      const int ymin = first ? INT_MIN / 2 : ylo;
      const int ymax = last ? INT_MAX / 2 : (y0 + kBand) >> l;
      const int r0 = max(0, ymin - by + kPad), r1 = min(m.WH[l], ymax - by + kPad);
      const float* lv = src + m.lo[l];
      float* dst = wins + (ep * m.sum_wh + m.off[l]) * wwm + q;
      if (lr < rpi)
        for (int r = r0 + lr; r < r1; r += rpi) {
          const int y = by - kPad + r;
          const bool in_y = y >= 0 && y < Hl;
          float v[kVec];
#pragma unroll
          for (int j = 0; j < kVec; j++) {
            const int x = bx - kPad + q + j;
            v[j] = (in_y && q + j < WWl && x >= 0 && x < Wl) ? lv[(y - ylo) * Wl + x] : 0.f;
          }
          float* d = dst + r * wwm;
          if (wwm % kVec == 0) {
            io::store_run(d, v);
          } else {
#pragma unroll
            for (int j = 0; j < kVec; j++)
              if (q + j < wwm) d[j] = io::cvt(v[j]);
          }
        }
      if constexpr (kStoreLevels) {    // K8: the band's rows of the level, one run
        const int nl = min(kBand >> l, Hl - ylo) * Wl;
        float* d = out_lv.lv[l] + (ep * Hl + ylo) * Wl;
        for (int i = lane; i < nl; i += 32) d[i] = io::cvt(lv[i]);   // already rounded
      }
    }
  }
}

// bf16 features and windows: the fp32 kernel's pixel tiles, warps, stage
// order and fragments, with one m16n8k16 product where fp32 takes three TF32
// ones.  The tile holds bf16 cells in rows of whole words (make_meta), and
// windows and levels are copied out of it as bits.
template <int kM, bool kStoreLevels>
__global__ void __launch_bounds__(Tile<kM>::kThreads, 64 / kM)
windows_build_bf16_kernel(const bf16* __restrict__ f1, const bf16* __restrict__ f2,
                          const float2* __restrict__ coords0, bf16* __restrict__ wins,
                          int* __restrict__ bases, int P, int C, Meta m, LevelsOut<bf16> out_lv) {
  using T = Tile<kM>;
  constexpr int kChan = 32;                        // channels a stage: 64 bytes a pixel
  constexpr int kV = 8;                            // channels a 16-byte copy, cells a 16-byte store
  extern __shared__ float4 smem4[];
  bf16* tile = reinterpret_cast<bf16*>(smem4);     // [kM][S]: each pixel's band of levels
  // kStages x ([kM][32] f1, [8][64][32] f2), the fp32 kernel's bytes
  float* stages = reinterpret_cast<float*>(tile + m.stage_off);
  const int band = blockIdx.x, p0 = blockIdx.y * kM, e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // warp: 32 pixels from ph, band rows 2k and 2k + 1, columns 32h .. 32h + 31 of a chunk
  const int ph = 32 * (warp >> 3), k = warp & 3, h = (warp >> 2) & 1;
  const int g = lane >> 2, t = lane & 3;           // mma fragment coordinates
  const int H0 = m.H[0], W0 = m.W[0];
  const int y0 = band * kBand;
  const bool live = y0 + 2 * k < H0;               // the warp's first row exists
  const bf16* A = f1 + (size_t)e * P * C;
  const bf16* B = f2 + (size_t)e * H0 * W0 * C;
  const int q4 = kV * (tid & 3);                   // first channel of this thread's copies
  // the stages swap a pixel's two 32-byte halves in rows r with r & 2, so that
  // the fragment loads of rows g and g + 2 fall in different banks; this
  // thread's copies (rows tid / 4 + u kThreads / 4, all with tid / 4's bit 1)
  // land at q4s
  const int q4s = kV * ((tid & 3) ^ ((tid >> 2) & 2));
  const int nk = (C + kChan - 1) / kChan;
  const int a_gp = p0 + (tid >> 2);
  const int a_goff = (tid < kM * 4 && a_gp < P) ? a_gp * C + q4 : -1;
  // f2's band, read by every pixel tile's block, is kept in L2 before the
  // windows and levels written around it (streaming stores below)
  uint64_t keep;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep));

  // each pixel's window bases, [2L][kM] in shared memory beside the tile;
  // band 0 writes them out
  int* wb = reinterpret_cast<int*>(tile + m.base_off);
  if (tid < kM && p0 + tid < P) {
    const float2 c = coords0[(size_t)e * P + p0 + tid];
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      const float scale = 1.f / (float)(1 << l);
      const int by = window_base(c.y, scale, m.H[l], m.WH[l]);
      const int bx = window_base(c.x, scale, m.W[l], m.WW[l]);
      wb[2 * l * kM + tid] = by;
      wb[(2 * l + 1) * kM + tid] = bx;
      if (band == 0) {
        int* bo = bases + ((size_t)e * 2 * kLevels + 2 * l) * P + p0 + tid;
        bo[0] = by;
        bo[P] = bx;
      }
    }
  }

  // ---- (a) levels 0 and 1 of the band, chunk by chunk of columns
  for (int ch = 0; ch < m.nchunks; ch++) {
    const int x0 = ch * m.cw;
    const int bj = (tid >> 2) % kColMax;           // column of the cells this thread copies
    auto load = [&](int kc) {
      bf16* As = reinterpret_cast<bf16*>(stages + (kc % T::kStages) * T::kStageF);
      bf16* Bs = As + kM * kChan;
      const int k0 = kc * kChan;
      const bool kin = k0 + q4 < C;
      if (tid < kM * 4)
        cp_async16(As + (tid >> 2) * kChan + q4s, a_goff >= 0 ? A + a_goff + k0 : A,
                   a_goff >= 0 && kin);
#pragma unroll
      for (int u = 0; u < T::kBLoads; u++) {       // slot c: band row c / 64, column c % 64
        const int c = (tid >> 2) + u * (T::kThreads / 4), w = c / kColMax;
        const bool in = bj < m.cw && y0 + w < H0 && x0 + bj < W0;
        cp_async16(Bs + c * kChan + q4s,
                   in ? B + ((y0 + w) * W0 + x0 + bj) * C + q4 + k0 : B, in && kin, keep);
      }
    };

    float acc[2][kNT][4];          // [m16 tile][n8 tile: row 2k + ni / 4, column 8 (ni % 4)]
#pragma unroll
    for (int mi = 0; mi < 2; mi++)
#pragma unroll
      for (int ni = 0; ni < kNT; ni++)
#pragma unroll
        for (int r = 0; r < 4; r++) acc[mi][ni][r] = 0.f;

#pragma unroll
    for (int st = 0; st < T::kStages - 1; st++) {  // kStages - 1 stages in flight
      if (st < nk) load(st);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; kc++) {
      cp_async_wait<T::kStages - 2>();             // stage kc has landed ...
      __syncthreads();                             // ... for every thread, and kc - 1 is done
      if (kc + T::kStages - 1 < nk) load(kc + T::kStages - 1);
      cp_async_commit();
      if (live) {
        // The 32 channels of a stage are two k16 steps.  Both operands take
        // step s's k-slots 2t, 2t + 1 (fragment registers 0 of A and B) from
        // channels 4t, 4t + 1 and k-slots 2t + 8, 2t + 9 (registers 2 of A, 1
        // of B) from channels 4t + 2, 4t + 3: one 8-byte load a row.  Step s
        // of rows g with g & 2 lies in the other half (the swizzle above).
        const int hs = (g >> 1) & 1;
        const bf16* As = reinterpret_cast<const bf16*>(stages + (kc % T::kStages) * T::kStageF)
                         + (ph + g) * kChan + 4 * t;
        const bf16* Bs = reinterpret_cast<const bf16*>(stages + (kc % T::kStages) * T::kStageF)
                         + kM * kChan + (2 * k * kColMax + 32 * h + g) * kChan + 4 * t;
#pragma unroll
        for (int st = 0; st < 2; st++) {
          uint32_t af[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; mi++) {
            const uint2 lo =
                *reinterpret_cast<const uint2*>(As + 16 * mi * kChan + 16 * (st ^ hs));
            const uint2 hi =
                *reinterpret_cast<const uint2*>(As + (16 * mi + 8) * kChan + 16 * (st ^ hs));
            af[mi][0] = lo.x;
            af[mi][1] = hi.x;
            af[mi][2] = lo.y;
            af[mi][3] = hi.y;
          }
#pragma unroll
          for (int ni = 0; ni < kNT; ni++) {
            const uint2 v = *reinterpret_cast<const uint2*>(
                Bs + ((ni >> 2) * kColMax + 8 * (ni & 3)) * kChan + 16 * (st ^ hs));
            const uint32_t bf[2] = {v.x, v.y};
            mma_bf16(acc[0][ni], af[0], bf);
            mma_bf16(acc[1][ni], af[1], bf);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();               // every warp is done with the stages (the tile may hold them)

    // The tile, scaled and rounded: thread (g, t) holds, for pixels g and
    // g + 8 of each m16 tile, columns 2t and 2t + 1 of both rows, the four
    // cells of its level-1 outputs, which it pools in the plain version's
    // order.  Cells x, x + 1 of a row are rounded as a pair and stored in one
    // 4-byte store: S, every row stride and x are even.
    if (live) {
      const bool row1 = y0 + 2 * k + 1 < H0, lv1 = (y0 >> 1) + k < m.H[1];
      const int rs0 = m.rs[0];
#pragma unroll
      for (int mi = 0; mi < 2; mi++)
#pragma unroll
        for (int half = 0; half < 2; half++) {     // pixel g, then g + 8
          bf16* px = tile + (ph + 16 * mi + 8 * half + g) * m.S;
#pragma unroll
          for (int j = 0; j < 4; j++) {
            const int xc = 32 * h + 8 * j + 2 * t, x = x0 + xc;   // xc + 1 < cw when xc < cw
            if (xc >= m.cw) continue;
            const __nv_bfloat162 c01 = __floats2bfloat162_rn(acc[mi][j][2 * half] * 0.0625f,
                                                             acc[mi][j][2 * half + 1] * 0.0625f);
            const __nv_bfloat162 c23 = __floats2bfloat162_rn(
                acc[mi][4 + j][2 * half] * 0.0625f, acc[mi][4 + j][2 * half + 1] * 0.0625f);
            bf16* r0 = px + 2 * k * rs0 + x;
            if (x + 1 < W0) {
              *reinterpret_cast<__nv_bfloat162*>(r0) = c01;
              if (row1) *reinterpret_cast<__nv_bfloat162*>(r0 + rs0) = c23;
            } else if (x < W0) {
              r0[0] = c01.x;
              if (row1) r0[rs0] = c23.x;
            }
            if (lv1 && x + 1 < W0)
              px[m.lo[1] + k * m.rs[1] + (x >> 1)] =
                  __float2bfloat16_rn((((__low2float(c01) + __high2float(c01)) + __low2float(c23))
                                       + __high2float(c23)) * 0.25f);
          }
        }
    }
  }
  __syncthreads();

  // ---- (b), (c) each warp takes kM / kWarps pixels: it pools their band
  // rows of levels 2 and 3, then writes their window rows in this band
  // (16-byte stores, several rows a store) and K8's level rows
  constexpr int kPx = kM / T::kWarps;
#pragma unroll
  for (int l = 2; l < kLevels; l++) {
    const int wi = m.rs[l - 1], wo = m.W[l], rso = m.rs[l];
    const int rows = min(kBand >> l, m.H[l] - (y0 >> l));
#pragma unroll
    for (int u = 0; u < kPx; u++) {              // pixels past P pool zeros, unused
      const bf16* s = tile + (warp + u * T::kWarps) * m.S + m.lo[l - 1];
      bf16* d = tile + (warp + u * T::kWarps) * m.S + m.lo[l];
#pragma unroll
      for (int r = 0; r < (kBand >> l); r++)
        if (r < rows)
          for (int x = lane; x < wo; x += 32) {
            const bf16* q = s + 2 * r * wi + 2 * x;
            d[r * rso + x] = __float2bfloat16_rn(
                (((__bfloat162float(q[0]) + __bfloat162float(q[1])) + __bfloat162float(q[wi]))
                 + __bfloat162float(q[wi + 1])) * 0.25f);
          }
    }
    __syncwarp();
  }

  const bool first = band == 0, last = band == m.nbands - 1;
  const int wwm = m.ww_max;
  const int cpr = (wwm + kV - 1) / kV, rpi = 32 / cpr;    // chunks a row, rows a store
  const int lr = lane / cpr, q = kV * (lane - lr * cpr);
  for (int u = 0; u < kPx; u++) {
    const int pl = warp + u * T::kWarps, gp = p0 + pl;
    if (gp >= P) break;
    const bf16* src = tile + pl * m.S;
    const size_t ep = (size_t)e * P + gp;
#pragma unroll
    for (int l = 0; l < kLevels; l++) {
      const int Hl = m.H[l], Wl = m.W[l], WWl = m.WW[l], rs = m.rs[l];
      const int by = wb[2 * l * kM + pl], bx = wb[(2 * l + 1) * kM + pl];
      // window row r holds level row by - 8 + r; this band owns level rows
      // [ylo, ymax), stretched to the zero rows above (band 0) and below (last)
      const int ylo = y0 >> l;
      const int ymin = first ? INT_MIN / 2 : ylo;
      const int ymax = last ? INT_MAX / 2 : (y0 + kBand) >> l;
      const int r0 = max(0, ymin - by + kPad), r1 = min(m.WH[l], ymax - by + kPad);
      const bf16* lv = src + m.lo[l];
      bf16* dst = wins + (ep * m.sum_wh + m.off[l]) * wwm + q;
      if (lr < rpi)
        for (int r = r0 + lr; r < r1; r += rpi) {
          const int y = by - kPad + r;
          const bool in_y = y >= 0 && y < Hl;
          // the tile's bf16 bits as they are
          const unsigned short* row = reinterpret_cast<const unsigned short*>(lv) + (y - ylo) * rs;
          uint32_t c[kV];
#pragma unroll
          for (int j = 0; j < kV; j++) {
            const int x = bx - kPad + q + j;
            c[j] = (in_y && q + j < WWl && x >= 0 && x < Wl) ? row[x] : 0u;
          }
          bf16* d = dst + r * wwm;
          if (wwm % kV == 0) {
            __stcs(reinterpret_cast<uint4*>(d), make_uint4(c[0] | c[1] << 16, c[2] | c[3] << 16,
                                                           c[4] | c[5] << 16, c[6] | c[7] << 16));
          } else {
#pragma unroll
            for (int j = 0; j < kV; j++)
              if (q + j < wwm) d[j] = __ushort_as_bfloat16((unsigned short)c[j]);
          }
        }
      if constexpr (kStoreLevels) {    // K8: the band's rows of the level, one run
        const int rows = min(kBand >> l, Hl - ylo);
        bf16* d = out_lv.lv[l] + (ep * Hl + ylo) * Wl;
        if (Wl % 8 == 0 && m.lo[l] % 8 == 0) {
          // the rows are not padded here (S is a multiple of 8): the band's
          // rows are one run in the tile as in the level, copied 16 bytes at a time
          for (int i = lane; i < rows * Wl / 8; i += 32)
            __stcs(reinterpret_cast<uint4*>(d) + i, reinterpret_cast<const uint4*>(lv)[i]);
        } else {
          for (int i = lane; i < rows * Wl; i += 32) {
            const int r = i / Wl;
            d[i] = lv[r * rs + i - r * Wl];
          }
        }
      }
    }
  }
}

// Geometry of a launch at H2 x W2 on Elem features: fills m, sets *bytes to
// the dynamic shared memory a block needs, and returns the pixels a block
// takes.  pad_rows: bf16 rows padded for the window stores (K4); K8 keeps
// them W_l cells, rounded up to even, for its 16-byte level copies.
template <typename Elem>
int make_meta(Meta& m, int H2, int W2, size_t* bytes, bool pad_rows) {
  m.sum_wh = 0;
  m.ww_max = 0;
  int lo = 0;
  for (int l = 0; l < kLevels; l++) {
    m.H[l] = H2 >> l;
    m.W[l] = W2 >> l;
    // bf16 rows: whole words, padded to 3 or 5 mod 8 words so that a window
    // store's reads (up to 8 rows, 3 runs of 8 cells) find 24 banks
    int words = (m.W[l] + 1) / 2;
    while (pad_rows && words % 8 != 3 && words % 8 != 5) words++;
    m.rs[l] = sizeof(Elem) == 2 ? 2 * words : m.W[l];
    m.WH[l] = m.H[l] + 2 * kPad < kWin ? m.H[l] + 2 * kPad : kWin;
    m.WW[l] = m.W[l] + 2 * kPad < kWin ? m.W[l] + 2 * kPad : kWin;
    m.off[l] = m.sum_wh;
    m.sum_wh += m.WH[l];
    m.ww_max = m.WW[l] > m.ww_max ? m.WW[l] : m.ww_max;
    m.lo[l] = lo;
    lo += (kBand >> l) * m.rs[l];
  }
  m.nbands = (H2 + kBand - 1) / kBand;
  m.nchunks = (W2 + kColMax - 1) / kColMax;
  const int per = m.nchunks > 0 ? (W2 + m.nchunks - 1) / m.nchunks : 0;
  m.nt = (per + 7) / 8;
  m.cw = 8 * m.nt;
  // pixels 8 floats apart in banks in fp32; in bf16 S = 2 (8 j + 4) cells,
  // 4 (2 j + 1) words, so the cells x, x + 1 that thread (g, t) stores for
  // pixel g lie in bank 4 g (2 j + 1) + t mod 32, apart for a warp's threads
  m.S = sizeof(Elem) == 2 ? ((lo + 1) / 2 + 7) / 8 * 16 + 8 : (lo + 31) / 32 * 32 + 8;
  constexpr int kF = sizeof(float) / sizeof(Elem);   // cells of the tile's type in a float
  if (m.nchunks == 1) {            // 64 pixels; the stages are free before the tile is written
    const size_t tile = 64 * (size_t)m.S;
    const size_t stages = Tile<64>::kStages * (size_t)Tile<64>::kStageF * kF;
    m.stage_off = 0;
    m.base_off = (int)(tile > stages ? tile : stages);
    *bytes = sizeof(Elem) * m.base_off + sizeof(int) * 2 * kLevels * 64;
    return 64;
  }
  m.stage_off = 32 * m.S;
  m.base_off = m.stage_off + Tile<32>::kStages * Tile<32>::kStageF * kF;
  *bytes = sizeof(Elem) * m.base_off + sizeof(int) * 2 * kLevels * 32;
  return 32;
}

// The kernel of a launch on Elem features.
template <int kM, bool kStoreLevels, typename Elem>
constexpr auto kernel() {
  if constexpr (sizeof(Elem) == 2)
    return windows_build_bf16_kernel<kM, kStoreLevels>;
  else
    return windows_build_kernel<kM, kStoreLevels>;
}

template <int kM, bool kStoreLevels, typename Elem>
int launch(const Meta& m, size_t bytes, const void* f1, const void* f2, const void* coords0,
           int E, int P, int C, void* wins, void* bases, const LevelsOut<Elem>& lo,
           cudaStream_t s) {
  const auto k = kernel<kM, kStoreLevels, Elem>();
  int err = (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  dim3 grid(m.nbands, (P + kM - 1) / kM, E);
  k<<<grid, Tile<kM>::kThreads, bytes, s>>>((const Elem*)f1, (const Elem*)f2,
                                            (const float2*)coords0, (Elem*)wins, (int*)bases, P,
                                            C, m, lo);
  return (int)cudaGetLastError();
}

template <bool kStoreLevels, typename Elem = float>
int build_windows(const void* f1, const void* f2, const void* coords0, int E, int P, int H2,
                  int W2, int C, void* wins, void* bases, const LevelsOut<Elem>& lo,
                  void* stream) {
  Meta m;
  size_t bytes = 0;
  const int M = make_meta<Elem>(m, H2, W2, &bytes, !kStoreLevels);
  // edges ride the grid's z and pixel tiles its y; offsets into f1 and f2 are 32-bit
  // and a pixel's channels are whole 16-byte copies
  if (E > 65535 || (P + 31) / 32 > 65535 || H2 <= 0 || W2 <= 0 || C <= 0 ||
      C % (16 / sizeof(Elem)) != 0 ||
      (long long)P * C > INT_MAX || (long long)H2 * W2 * C > INT_MAX ||
      bytes > (size_t)kMaxShared)
    return (int)cudaErrorInvalidValue;
  if (E <= 0 || P <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 64)
    return launch<64, kStoreLevels, Elem>(m, bytes, f1, f2, coords0, E, P, C, wins, bases, lo, s);
  return launch<32, kStoreLevels, Elem>(m, bytes, f1, f2, coords0, E, P, C, wins, bases, lo, s);
}

template <bool kStoreLevels, typename Elem>
int blocks_per_sm(int M, size_t bytes) {
  const auto k = M == 64 ? kernel<64, kStoreLevels, Elem>() : kernel<32, kStoreLevels, Elem>();
  const int threads = M == 64 ? Tile<64>::kThreads : Tile<32>::kThreads;
  int n = 0;
  if (bytes > (size_t)kMaxShared ||
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads, bytes))
    return -1;
  return n;
}

}  // namespace

// Launches K4 on `stream`: f1 [E, P, C], f2 [E, H2*W2, C], coords0 [E, P, 2]
// (float32, contiguous, f1 and f2 16-byte aligned, C a multiple of 4) ->
// wins [E, P, sum WH, max WW] float32 and bases [E, 8, P] int32.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes
// the kernel does not take (W2 above about 80 needs more shared memory than
// a block has).
extern "C" int corr_windows_build_launch(const void* f1, const void* f2, const void* coords0,
                                         int E, int P, int H2, int W2, int C, void* wins,
                                         void* bases, void* stream) {
  return build_windows<false>(f1, f2, coords0, E, P, H2, W2, C, wins, bases,
                              LevelsOut<float>{}, stream);
}

// K4 on bf16 features (C a multiple of 8) -> bf16 windows, the same bases
// (W2 up to 181).
extern "C" int corr_windows_build_bf16_launch(const void* f1, const void* f2,
                                              const void* coords0, int E, int P, int H2,
                                              int W2, int C, void* wins, void* bases,
                                              void* stream) {
  return build_windows<false, bf16>(f1, f2, coords0, E, P, H2, W2, C, wins, bases,
                                    LevelsOut<bf16>{}, stream);
}

// Launches K8 on `stream`: K4's outputs, plus level0..level3
// [E, P, H2 >> l, W2 >> l] float32 (K2's layout).  Same return codes.
extern "C" int corr_windows_build_levels_launch(const void* f1, const void* f2,
                                                const void* coords0, int E, int P, int H2,
                                                int W2, int C, void* wins, void* bases,
                                                void* level0, void* level1, void* level2,
                                                void* level3, void* stream) {
  const LevelsOut<float> lo{{(float*)level0, (float*)level1, (float*)level2, (float*)level3}};
  return build_windows<true>(f1, f2, coords0, E, P, H2, W2, C, wins, bases, lo, stream);
}

// K8 on bf16 features (C a multiple of 8) -> bf16 windows and levels, the
// same bases.
extern "C" int corr_windows_build_levels_bf16_launch(const void* f1, const void* f2,
                                                     const void* coords0, int E, int P, int H2,
                                                     int W2, int C, void* wins, void* bases,
                                                     void* level0, void* level1, void* level2,
                                                     void* level3, void* stream) {
  const LevelsOut<bf16> lo{{(bf16*)level0, (bf16*)level1, (bf16*)level2, (bf16*)level3}};
  return build_windows<true, bf16>(f1, f2, coords0, E, P, H2, W2, C, wins, bases, lo, stream);
}

// What a launch at H2 x W2 uses, fp32 in out[0..3] and bf16 in out[4..7]:
// source pixels a block takes, its dynamic shared memory bytes, and the
// resident blocks per SM of K4 and of K8 (-1 when the query fails or no
// tile fits).  Returns 0.
extern "C" int corr_windows_build_info(int H2, int W2, void* out) {
  Meta m;
  size_t bytes = 0;
  int* o = (int*)out;
  o[0] = make_meta<float>(m, H2, W2, &bytes, false);
  o[1] = (int)bytes;
  o[2] = blocks_per_sm<false, float>(o[0], bytes);
  o[3] = blocks_per_sm<true, float>(o[0], bytes);
  o[4] = make_meta<bf16>(m, H2, W2, &bytes, true);        // K4's padded rows
  o[5] = (int)bytes;
  o[6] = blocks_per_sm<false, bf16>(o[4], bytes);
  make_meta<bf16>(m, H2, W2, &bytes, false);              // K8's
  o[7] = blocks_per_sm<true, bf16>(o[4], bytes);
  return 0;
}
