// The bf16 radius-3 lookups' shared steps (K3 bf16 in corr_lookup.cu, K5 bf16
// in corr_windows_lookup.cu): a thread per (pixel, level) holds its 8x8 span
// as eight rows of 8 packed bf16 cells, blends its 49 outputs into the
// block's staged run in shared memory, and the block writes the run out.
// K7 bf16 (corr_extract_windows.cu) aligns its window rows' chunks with
// span8 and packs 2-byte cells with pack8; K6 bf16 (corr_pmajor_lookup.cu)
// writes its staged run with store_run.
#pragma once
#include <stdint.h>

#include "dtype_io.cuh"

namespace lookup_bf16 {

constexpr int kD = 7;                   // taps per axis
constexpr int kOut = 4 * kD * kD;       // 196 outputs per pixel

// Cells s .. s + 7 (0 <= s < 8) of the 16 cells in two consecutive 16-byte
// chunks lo, hi, as four words (the lower address in the lower half):
// shifted by 4 cells, then 2, then 1, as s's bits say.
__device__ __forceinline__ uint4 span8(uint4 lo, uint4 hi, int s) {
  const bool s4 = s & 4, s2 = s & 2;
  const uint32_t v0 = s4 ? lo.z : lo.x, v1 = s4 ? lo.w : lo.y, v2 = s4 ? hi.x : lo.z,
                 v3 = s4 ? hi.y : lo.w, v4 = s4 ? hi.z : hi.x, v5 = s4 ? hi.w : hi.y;
  const uint32_t u0 = s2 ? v1 : v0, u1 = s2 ? v2 : v1, u2 = s2 ? v3 : v2, u3 = s2 ? v4 : v3,
                 u4 = s2 ? v5 : v4;
  const unsigned sh = (s & 1) * 16;
  return make_uint4(__funnelshift_r(u0, u1, sh), __funnelshift_r(u1, u2, sh),
                    __funnelshift_r(u2, u3, sh), __funnelshift_r(u3, u4, sh));
}

// 8 bf16 cells as four words (the lower address in the lower half).
__device__ __forceinline__ uint4 pack8(const unsigned short (&c)[8]) {
  return make_uint4(c[0] | ((uint32_t)c[1] << 16), c[2] | ((uint32_t)c[3] << 16),
                    c[4] | ((uint32_t)c[5] << 16), c[6] | ((uint32_t)c[7] << 16));
}

__device__ __forceinline__ void widen8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; k++) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// The 49 outputs of one (pixel, level) from its span (row i: cells
// sx .. sx + 7 of span row i) and the fractional parts f rounded to bf16:
// Y[b][j] = (1 - fy) w[b][j] + fy w[b + 1][j] for the 8 columns j of row
// pair b, then o[7 a + b] = (1 - fx) Y[b][a] + fx Y[b][a + 1], each product
// and sum rounded on its own as the plain version rounds them (no FMAs),
// the output rounded to bf16 once.
__device__ __forceinline__ void blend_span(const uint4 (&rows)[8], float fx, float fy, bf16* o) {
  const float wy = 1.f - fy, wx = 1.f - fx;
  float g0[8], g1[8], y[8];
  widen8(rows[0], g0);
#pragma unroll
  for (int b = 0; b < kD; b++) {
    widen8(rows[b + 1], g1);
#pragma unroll
    for (int j = 0; j < 8; j++) {
      y[j] = __fadd_rn(__fmul_rn(wy, g0[j]), __fmul_rn(fy, g1[j]));
      g0[j] = g1[j];
    }
#pragma unroll
    for (int a = 0; a < kD; a++)
      o[kD * a + b] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(wx, y[a]), __fmul_rn(fx, y[a + 1])));
  }
}

// A tile's n staged outputs (n a multiple of 4) to dst, which is 8-byte
// aligned: 16-byte stores where dst is 16-byte aligned (and one 8-byte store
// for a last half chunk), else 8-byte stores.
__device__ __forceinline__ void store_run(const bf16* stage, bf16* dst, int n, int tid,
                                          int threads) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = tid; i < n / 8; i += threads)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(stage)[i];
    if (n % 8 && tid == 0)
      reinterpret_cast<uint2*>(dst)[n / 4 - 1] = reinterpret_cast<const uint2*>(stage)[n / 4 - 1];
  } else {
    for (int i = tid; i < n / 4; i += threads)
      reinterpret_cast<uint2*>(dst)[i] = reinterpret_cast<const uint2*>(stage)[i];
  }
}

}  // namespace lookup_bf16
