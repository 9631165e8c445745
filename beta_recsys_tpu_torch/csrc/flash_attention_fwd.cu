// Causal flash attention, forward, written by hand for Hopper (sm_90a).
//
// Replaces beta_recsys_tpu/ops/pallas/flash_attention.py:_fwd_kernel (reached
// through _flash_call), attention dropout included. For q, k, v of shape
// (N = batch * heads, T, dh), contiguous, float32 or bfloat16, dh 16, 32 or 64:
//   P   = softmax(q k^T / sqrt(dh) + causal mask)
//   out = (P * keep / (1 - rate)) v                 (N, T, dh), q's type
//   lse = m + log(sum_j exp(s_j - m))              (N, T, 1), float32
// keep is the Philox mask of philox.cuh (all ones at rate 0). All arithmetic
// is float32, whatever the input type.
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
// device memory. Dropout acts after the normalisation, as in the TPU kernel:
// the row sum l (and so lse) sums every visible key, kept or dropped, and only
// the output accumulator takes the mask and the 1/(1 - rate) factor. A chunk
// of 8 keys takes two Philox calls. Shared memory is static,
// 2 * 64 * dh * 4 bytes (32 KB at dh = 64): under the 48 KB that needs no
// opt-in through cudaFuncAttributeMaxDynamicSharedMemorySize.
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

#include <math_constants.h>

#include <cmath>

#include "flash_attention_common.cuh"
#include "philox.cuh"

namespace {

using flash::kKeys;
using flash::kLog2e;
using flash::kRows;

constexpr int kChunk = 8;  // keys per online-softmax update: two Philox calls

static_assert(kKeys % kChunk == 0, "a chunk never crosses a tile");

template <typename T, int DH>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int64_t* __restrict__ seed,
                 int seq, float scale, int dropout, uint32_t threshold,
                 float keep_scale) {
  static_assert(DH % 4 == 0, "rows move as 4-element vectors");
  __shared__ __align__(16) float ks[kKeys * DH];
  __shared__ __align__(16) float vs[kKeys * DH];

  const int n = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int row = q0 + threadIdx.x;
  const bool active = row < seq;
  const size_t head = static_cast<size_t>(n) * seq * DH;
  const philox::Key key = dropout ? philox::key_of(seed) : philox::Key{0u, 0u};

  float qr[DH];
  float acc[DH];
  flash::load_row<DH>(qr, q + head + static_cast<size_t>(row) * DH, active);
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  // m is the running max of the raw q.k over the keys seen so far; exponents
  // are taken in base 2 as (q.k - m) * scale * log2(e).
  const float c = scale * kLog2e;
  float m = -CUDART_INF_F;
  float l = 0.f;
  const int key_end = min(q0 + kRows, seq);  // keys the block's last row sees

  for (int k0 = 0; k0 < key_end; k0 += kKeys) {
    flash::stage_tiles<DH, kRows>(ks, k + head, vs, v + head, k0, seq);
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
          const float dot = flash::dot_shared<DH>(qr, ks + (j0 + t) * DH);
          s[t] = (j0 + t < visible) ? dot : -CUDART_INF_F;
          cmax = fmaxf(cmax, s[t]);
        }
        uint32_t bits[kChunk];
        if (dropout) {
          const int g = (k0 + j0) / 4;
          const uint4 a = philox::bits4(key, n, row, g);
          const uint4 b = philox::bits4(key, n, row, g + 1);
          bits[0] = a.x; bits[1] = a.y; bits[2] = a.z; bits[3] = a.w;
          bits[4] = b.x; bits[5] = b.y; bits[6] = b.z; bits[7] = b.w;
        }
        const float m_new = fmaxf(m, cmax);
        const float alpha = exp2f((m - m_new) * c);  // 0 on the first chunk
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const float p = exp2f((s[t] - m_new) * c);  // 0 for a masked key
          l += p;  // every visible key, kept or dropped
          const float pv = !dropout ? p : (bits[t] >= threshold ? p * keep_scale : 0.f);
          flash::axpy_shared<DH>(acc, pv, vs + (j0 + t) * DH);
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    flash::store_row<DH>(out + head + static_cast<size_t>(row) * DH, acc, 1.f / l);
    lse[static_cast<size_t>(n) * seq + row] = m * scale + logf(l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const void* seed, int n, int seq, int dropout, uint32_t threshold,
           float keep_scale, cudaStream_t stream) {
  // 1/sqrt(dh) rounded once to float32, as the reference computes it.
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  const dim3 grid(n, (seq + kRows - 1) / kRows);
  flash_fwd_kernel<T, DH><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<const int64_t*>(seed),
      seq, scale, dropout, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, void* lse,
              const void* seed, int n, int seq, int dh, int dropout,
              uint32_t threshold, float keep_scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, out, lse, seed, n, seq, dropout, threshold, keep_scale, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, seed, n, seq, dropout, threshold, keep_scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, seed, n, seq, dropout, threshold, keep_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: (n, seq, dh) contiguous, 16-byte aligned; bf16 != 0 selects
// bfloat16, else float32. lse: (n, seq) float32. dh is 16, 32 or 64.
// dropout != 0 drops attention probabilities by the Philox mask of the int64
// *seed (a device pointer, read by the kernel) with the given threshold and
// scales kept ones by keep_scale = 1/(1 - rate); seed may be null otherwise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, const void* seed,
                                   int n, int seq, int dh, int bf16, int dropout,
                                   unsigned int threshold, float keep_scale,
                                   void* stream) {
  if (n <= 0 || seq <= 0 || seq > 65535 * kRows || (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dh<__nv_bfloat16>(q, k, v, out, lse, seed, n, seq, dh, dropout, threshold, keep_scale, s)
              : launch_dh<float>(q, k, v, out, lse, seed, n, seq, dh, dropout, threshold, keep_scale, s);
}
