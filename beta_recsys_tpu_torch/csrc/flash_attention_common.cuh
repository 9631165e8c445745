// What the flash-attention forward and backward kernels share: the tile
// geometry, 4-element moves between device memory (float32 or bfloat16) and
// float32 shared memory or registers, the staging of row tiles and of the
// dropout mask, the register-tiled 64 x 64 score product and the lane
// layout of the score pass.
//
// Both kernels form S = q k^T with score_tile: the same sum over d from 0
// upward in float4 steps by fmaf, so the backward recomputes the forward's
// score bits exactly. The backward's P = exp(round(s * scale) - lse) is
// exactly 1 at a saturated row's top key only then (flash_attention_bwd.cu,
// prob).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace flash {

// Query and key tiles are both 64 rows, so only the diagonal tile needs the
// causal mask.
constexpr int kTile = 64;            // query rows or keys of a tile
constexpr int kThreads = 256;        // threads of a CTA
constexpr int kWld = kTile + 4;      // row stride of the 64 x 64 tiles
constexpr int kGroups = kTile / 4;   // mask bytes a row: 4 keys each
constexpr float kLog2e = 1.4426950408889634f;

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

// Rows r0 .. r0 + 63 of two (seq, DH) arrays into two row tiles of stride
// DH + 4, float32, zeros past seq, their loads issued together. Every thread
// moves DH / 16 float4 of each.
template <int DH, typename T>
__device__ __forceinline__ void stage2(float* da, const T* sa, float* db, const T* sb, int r0, int seq) {
  constexpr int kLd = DH + 4;
  constexpr int kVecs = kTile * DH / 4;
  static_assert(kVecs % kThreads == 0, "every thread moves the same number of vectors");
#pragma unroll
  for (int it = 0; it < kVecs / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (DH / 4);
    const int d = (i % (DH / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (r0 + r < seq) {
      const size_t at = static_cast<size_t>(r0 + r) * DH + d;
      x = load4(sa + at);
      y = load4(sb + at);
    }
    *reinterpret_cast<float4*>(da + r * kLd + d) = x;
    *reinterpret_cast<float4*>(db + r * kLd + d) = y;
  }
}

// The keep bits of entries (q0 + r, k0 + c): byte r * 16 + c / 4, bit c % 4.
// One Philox call gives the four keys of a byte (counter (col / 4, row, n));
// bytes that no visible entry reads stay 0.
__device__ __forceinline__ void stage_mask(uint8_t* mask, philox::Key key, int n, int q0, int k0, int seq,
                                           uint32_t threshold) {
#pragma unroll
  for (int it = 0; it < kTile * kGroups / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int row = q0 + i / kGroups;
    const int col = k0 + 4 * (i % kGroups);
    uint32_t byte = 0;
    if (row < seq && col <= row) {
      const uint4 b = philox::bits4(key, n, row, col / 4);
      byte = static_cast<uint32_t>(b.x >= threshold) | static_cast<uint32_t>(b.y >= threshold) << 1 |
             static_cast<uint32_t>(b.z >= threshold) << 2 | static_cast<uint32_t>(b.w >= threshold) << 3;
    }
    mask[i] = static_cast<uint8_t>(byte);
  }
}

// Whether entry (r, c) of the tile was kept.
__device__ __forceinline__ bool kept(const uint8_t* mask, int r, int c) {
  return (mask[r * kGroups + c / 4] >> (c % 4)) & 1;
}

// s[i][j] = sum_d a[r0 + i][d] * b[tx + 16 j][d] for the key groups j < NB:
// a thread's 4 x 4 micro-tile of a 64 x 64 product of two row tiles of
// stride DH + 4, summed over d from 0 upward.
template <int DH, int NB>
__device__ __forceinline__ void score_tile(const float* a, const float* b, int r0, int tx, float (&s)[4][4]) {
  constexpr int kLd = DH + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    float4 x[4];
    float4 y[NB];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (r0 + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < NB; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
    }
  }
}

// score_tile over the first nb key groups (a warp-uniform count, 1-4), each
// count its own unrolled code.
template <int DH>
__device__ __forceinline__ void score_groups(const float* a, const float* b, int r0, int tx, int nb,
                                             float (&s)[4][4]) {
  switch (nb) {
    case 1: score_tile<DH, 1>(a, b, r0, tx, s); break;
    case 2: score_tile<DH, 2>(a, b, r0, tx, s); break;
    case 3: score_tile<DH, 3>(a, b, r0, tx, s); break;
    default: score_tile<DH, 4>(a, b, r0, tx, s);
  }
}

__device__ __forceinline__ void axpy4(float (&acc)[4], float w, float4 m) {
  acc[0] = fmaf(w, m.x, acc[0]);
  acc[1] = fmaf(w, m.y, acc[1]);
  acc[2] = fmaf(w, m.z, acc[2]);
  acc[3] = fmaf(w, m.w, acc[3]);
}

template <typename T>
__device__ __forceinline__ void store_scaled(T* dst, const float (&x)[4], float mul) {
  store4(dst, make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul));
}

// Score-pass geometry of a thread: rows r0 .. r0 + 3 of the tile, keys
// tx + 16 j; warp w holds rows 8w .. 8w + 7, and the 16 lanes of a row are
// the 16 lanes of a half-warp. It computes the key groups of 16 that hold a
// key before T and, on a diagonal tile, at or before its last row: the
// others are all masked.
struct ScoreLane {
  int tx, r0, warp;
  __device__ ScoreLane() : tx(threadIdx.x & 15), r0(4 * (threadIdx.x >> 4)), warp(threadIdx.x >> 5) {}
  __device__ int groups(bool diag, int keys) const {
    return min(diag ? (8 * warp + 7) / 16 + 1 : 4, (keys + 15) / 16);
  }
};

}  // namespace flash
