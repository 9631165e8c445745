// Causal flash attention, forward, written by hand for Hopper (sm_90a).
//
// Replaces beta_recsys_tpu/ops/pallas/flash_attention.py:_fwd_kernel at
// dropout rate 0 (reached through _flash_call). For q, k, v of shape
// (N = batch * heads, T, dh), contiguous, float32 or bfloat16:
//   out = softmax(q k^T / sqrt(dh) + causal mask) v    (N, T, dh), q's type
//   lse = m + log(sum_j exp(s_j - m))                 (N, T, 1), float32
// All arithmetic is float32, whatever the input type.
//
// Design. The TPU kernel gives one program a whole (T, T) score matrix in
// VMEM. Here one thread block of 64 threads owns one (n, 64-row query tile);
// each thread owns one query row and keeps q and its output accumulator in
// registers. The block walks the key tiles up to the causal limit of its last
// row (tiles past the diagonal are never loaded), staging each 64-row K and V
// tile in shared memory, and runs an online softmax over chunks of 8 keys: one
// rescale of the accumulator per chunk. Because query and key tiles are both
// 64 rows, only the diagonal tile masks by index. Rows and keys past T (the
// ragged edge) are masked; T = 1 works. Nothing of the (T, T) matrix reaches
// device memory. Shared memory is static, 2 * 64 * dh * 4 bytes (16 KB at
// dh = 32, the only head dim a served config uses): under the 48 KB that needs
// no opt-in through cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores, 989 TFLOP/s bf16 in them). The function moves N*T*(4*dh*b + 4) bytes
// (b = 4 for float32, 2 for bf16) and needs 4*dh FLOPs per visible (query, key)
// pair, N*T*(T+1)/2 pairs. At the checkpoint's serving shape (N = 1,886,
// T = 100, dh = 32, float32) that is 97 MB against 1.2 GFLOP: bytes bound it
// (29 us). At T = 200 in float32 the operations do (31 GFLOP for N = 12,080:
// 0.46 ms against 0.37 ms for the bytes), because float32 products run on the
// CUDA cores. The design reads each q, k, v element from device memory once per
// query tile that needs it and writes out and lse once; each thread reads K and
// V rows from shared memory as 16-byte broadcasts, one load per four FMAs. It
// does not use the tensor cores (wgmma, TMA): a later version can, for bf16.
//
// Interface: a plain C function (no PyTorch headers), built by nvcc into a
// shared library and called through ctypes. It launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kRows = 64;   // query rows per block, one per thread
constexpr int kKeys = 64;   // key rows per shared-memory tile; == kRows
constexpr int kChunk = 8;   // keys per online-softmax update
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kKeys == kRows, "only the diagonal tile may need the causal mask");
static_assert(kKeys % kChunk == 0, "a chunk never crosses a tile");

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

template <typename T, int DH>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int seq, float scale) {
  static_assert(DH % 4 == 0, "rows move as 4-element vectors");
  __shared__ __align__(16) float ks[kKeys * DH];
  __shared__ __align__(16) float vs[kKeys * DH];

  const int n = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int row = q0 + threadIdx.x;
  const bool active = row < seq;
  const size_t head = static_cast<size_t>(n) * seq * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x = active ? load4(q + head + static_cast<size_t>(row) * DH + d)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = x.x;
    qr[d + 1] = x.y;
    qr[d + 2] = x.z;
    qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }

  // m is the running max of the raw q.k over the keys seen so far; exponents
  // are taken in base 2 as (q.k - m) * scale * log2(e).
  const float c = scale * kLog2e;
  float m = -CUDART_INF_F;
  float l = 0.f;
  const int key_end = min(q0 + kRows, seq);  // keys the block's last row sees

  for (int k0 = 0; k0 < key_end; k0 += kKeys) {
    for (int i = threadIdx.x * 4; i < kKeys * DH; i += kRows * 4) {
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + i / DH < seq) {
        const size_t at = head + static_cast<size_t>(k0) * DH + i;
        kx = load4(k + at);
        vx = load4(v + at);
      }
      store4(ks + i, kx);
      store4(vs + i, vx);
    }
    __syncthreads();

    if (active) {
      // Keys k0 .. k0 + visible - 1 are at or before this row; fewer than
      // kKeys only on the diagonal tile (k0 == q0).
      const int visible = min(kKeys, row - k0 + 1);
      for (int j0 = 0; j0 < visible; j0 += kChunk) {
        float s[kChunk];
        float cmax = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const float* kr = ks + (j0 + t) * DH;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(kr + d);
            dot = fmaf(qr[d], kk.x, dot);
            dot = fmaf(qr[d + 1], kk.y, dot);
            dot = fmaf(qr[d + 2], kk.z, dot);
            dot = fmaf(qr[d + 3], kk.w, dot);
          }
          s[t] = (j0 + t < visible) ? dot : -CUDART_INF_F;
          cmax = fmaxf(cmax, s[t]);
        }
        const float m_new = fmaxf(m, cmax);
        const float alpha = exp2f((m - m_new) * c);  // 0 on the first chunk
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const float p = exp2f((s[t] - m_new) * c);  // 0 for a masked key
          l += p;
          const float* vr = vs + (j0 + t) * DH;
#pragma unroll
          for (int d = 0; d < DH; d += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(vr + d);
            acc[d] = fmaf(p, vv.x, acc[d]);
            acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
            acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
            acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
          }
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / l;
    T* dst = out + head + static_cast<size_t>(row) * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      store4(dst + d, make_float4(acc[d] * inv, acc[d + 1] * inv,
                                  acc[d + 2] * inv, acc[d + 3] * inv));
    }
    lse[static_cast<size_t>(n) * seq + row] = m * scale + logf(l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int n, int seq, cudaStream_t stream) {
  // 1/sqrt(dh) rounded once to float32, as the reference computes it.
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  const dim3 grid(n, (seq + kRows - 1) / kRows);
  flash_fwd_kernel<T, DH><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), seq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (n, seq, dh) contiguous, 16-byte aligned; bf16 != 0 selects
// bfloat16, else float32. lse: (n, seq) float32. dh must be 32.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int n, int seq, int dh,
                                   int bf16, void* stream) {
  if (n <= 0 || seq <= 0 || seq > 65535 * kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh != 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch<__nv_bfloat16, 32>(q, k, v, out, lse, n, seq, s)
              : launch<float, 32>(q, k, v, out, lse, n, seq, s);
}
