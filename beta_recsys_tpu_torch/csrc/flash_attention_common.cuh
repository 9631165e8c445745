// What the flash-attention forward and backward kernels share: tile sizes and
// 4-element row moves between device memory (float32 or bfloat16) and float32
// registers or shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kRows = 64;  // query rows of a query tile
constexpr int kKeys = 64;  // key rows of a key tile; == kRows
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kKeys == kRows, "only the diagonal tile may need the causal mask");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = raw.x;
  *reinterpret_cast<uint32_t*>(&hi) = raw.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// n elements of a row into float32 registers (zeros when !valid).
template <int W, typename T>
__device__ __forceinline__ void load_row(float (&dst)[W], const T* src, bool valid) {
#pragma unroll
  for (int d = 0; d < W; d += 4) {
    const float4 x = valid ? load4(src + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[d] = x.x;
    dst[d + 1] = x.y;
    dst[d + 2] = x.z;
    dst[d + 3] = x.w;
  }
}

template <int W, typename T>
__device__ __forceinline__ void store_row(T* dst, const float (&src)[W], float mul) {
#pragma unroll
  for (int d = 0; d < W; d += 4) {
    store4(dst + d, make_float4(src[d] * mul, src[d + 1] * mul, src[d + 2] * mul, src[d + 3] * mul));
  }
}

// sum_d a[d] * b[d], b a float32 row in shared memory.
template <int W>
__device__ __forceinline__ float dot_shared(const float (&a)[W], const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < W; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    acc = fmaf(a[d], x.x, acc);
    acc = fmaf(a[d + 1], x.y, acc);
    acc = fmaf(a[d + 2], x.z, acc);
    acc = fmaf(a[d + 3], x.w, acc);
  }
  return acc;
}

// acc[d] += w * b[d], b a float32 row in shared memory.
template <int W>
__device__ __forceinline__ void axpy_shared(float (&acc)[W], float w, const float* b) {
#pragma unroll
  for (int d = 0; d < W; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    acc[d] = fmaf(w, x.x, acc[d]);
    acc[d + 1] = fmaf(w, x.y, acc[d + 1]);
    acc[d + 2] = fmaf(w, x.z, acc[d + 2]);
    acc[d + 3] = fmaf(w, x.w, acc[d + 3]);
  }
}

// Two 64-row tiles of DH elements, rows r0 .. r0 + 63 of the (n, seq, DH)
// rows at src_a and src_b, into float32 tiles in shared memory, zeros past
// seq. All kThreads threads of the block take part; the stride is a
// compile-time constant, so the loop unrolls and keeps its loads in flight.
template <int DH, int kThreads, typename T>
__device__ __forceinline__ void stage_tiles(float* a, const T* src_a, float* b, const T* src_b, int r0,
                                            int seq) {
  static_assert((kRows * DH) % (kThreads * 4) == 0, "every thread moves the same number of vectors");
#pragma unroll
  for (int i = threadIdx.x * 4; i < kRows * DH; i += kThreads * 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (r0 + i / DH < seq) {
      const size_t at = static_cast<size_t>(r0) * DH + i;
      x = load4(src_a + at);
      y = load4(src_b + at);
    }
    store4(a + i, x);
    store4(b + i, y);
  }
}

}  // namespace flash
