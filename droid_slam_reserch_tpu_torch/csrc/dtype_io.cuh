// Loads and stores of the correlation kernels' two element types, fp32 and
// bf16.  Every kernel computes in fp32; a bf16 value is widened when it is
// loaded and rounded (to nearest even) once, where it is stored, as the TPU
// kernels round with astype.  Included by every correlation kernel's source.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

template <typename T> struct Io;

template <> struct Io<float> {
  static constexpr int kVec = 4;                       // elements in 16 bytes
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  // the value a store of x keeps, as a float
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float cvt(float x) { return x; }
  static __device__ __forceinline__ void store1(float* d, float a) { __stcs(d, a); }
  static __device__ __forceinline__ void store2(float* d, float a, float b) {
    __stcs(reinterpret_cast<float2*>(d), make_float2(a, b));
  }
  static __device__ __forceinline__ void store4(float* d, float4 v) {
    __stcs(reinterpret_cast<float4*>(d), v);
  }
  // kVec consecutive cells, one 16-byte store (d 16-byte aligned)
  static __device__ __forceinline__ void store_run(float* d, const float (&v)[kVec]) {
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Io<bf16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(__ldg(p)); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ bf16 cvt(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {   // a at the lower address
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void store1(bf16* d, float a) {
    __stcs(reinterpret_cast<unsigned short*>(d), __bfloat16_as_ushort(__float2bfloat16_rn(a)));
  }
  static __device__ __forceinline__ void store2(bf16* d, float a, float b) {
    __stcs(reinterpret_cast<unsigned int*>(d), pack(a, b));
  }
  static __device__ __forceinline__ void store4(bf16* d, float4 v) {   // 8 bytes
    __stcs(reinterpret_cast<uint2*>(d), make_uint2(pack(v.x, v.y), pack(v.z, v.w)));
  }
  static __device__ __forceinline__ void store_run(bf16* d, const float (&v)[kVec]) {
    *reinterpret_cast<uint4*>(d) = make_uint4(pack(v[0], v[1]), pack(v[2], v[3]),
                                              pack(v[4], v[5]), pack(v[6], v[7]));
  }
};
