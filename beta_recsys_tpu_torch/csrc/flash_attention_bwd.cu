// Causal flash attention, backward, written by hand for Hopper (sm_90a).
//
// Replaces beta_recsys_tpu/ops/pallas/flash_attention.py:_bwd_kernel (reached
// through _flash_bwd). For q, k, v, dout of shape (N = batch * heads, T, dh),
// contiguous, float32 or bfloat16, dh 16, 32 or 64, and the forward's float32
// lse (N, T, 1), it gives dq, dk, dv (q's type) of
//   out = (P * keep / (1 - rate)) v,  P = softmax(q k^T / sqrt(dh) + causal mask)
// with keep the forward's Philox dropout mask (philox.cuh), regenerated from
// the same seed. Its inputs are the TPU kernel's residuals (q, k, v, seed,
// lse) and dout; the forward's out is not read. All arithmetic is float32.
//
// Per visible pair (i, j), with P recomputed from the saved lse:
//   P_ij  = exp(q_i . k_j / sqrt(dh) - lse_i)
//   dP_ij = keep_ij / (1 - rate) * (dout_i . v_j)
//   dv_j += keep_ij / (1 - rate) * P_ij * dout_i
//   dS_ij = P_ij * (dP_ij - D_i),   D_i = sum_j P_ij dP_ij
//   dq_i += dS_ij k_j / sqrt(dh),   dk_j += dS_ij q_i / sqrt(dh)
// D_i is the TPU kernel's rowsum(dP * P) (:116), in float32. (It equals
// dout_i . out_i, but out is stored in q's type: in bfloat16 that form reads a
// rounded out, and the error reaches dq through every key; at T = 1, where
// dq is exactly 0, it gave |dq| up to 0.022.)
//
// Design. The TPU kernel gives one program a whole head and its (T, T)
// matrices in VMEM. Here the work is tiled by 64 rows and split in two
// kernels, so that every output element has one owner and nothing is summed
// with atomics: two runs on the same inputs give the same bits.
//   1. flash_bwd_dq_kernel: a block owns a 64-row query tile of one head and
//      walks the key tiles up to the diagonal, K and V staged in shared
//      memory. In one pass each row sums D_i, A_i = sum_j P_ij dP_ij k_j and
//      B_i = sum_j P_ij k_j in registers; then dq_i = (A_i - D_i B_i) /
//      sqrt(dh), and D_i goes to a float32 scratch (N, T).
//   2. flash_bwd_dkdv_kernel (launched after 1 on the same stream, so D is
//      there): a block owns a 64-key tile and walks the query tiles from the
//      diagonal down, q, dout, lse and D staged in shared memory, accumulating
//      dk_j and dv_j in registers. The Philox mask is regenerated per pair.
// A row (or key) of dh elements is held by dh / 32 threads at dh = 64 (two
// lanes, their partial dot products summed by one shuffle) and by one thread
// at dh 16 and 32, so no thread holds more than 4 * 32 float32 accumulators
// and operands. Shared memory is static, at most 2 * 64 * 64 * 4 bytes
// (32 KB) plus two 64-float columns.
//
// What bounds it on the H100 (3.35 TB/s; 67 TFLOP/s float32 outside the
// tensor cores). The function reads q, k, v, dout and lse and writes dq, dk,
// dv: N*T*(7*dh*b + 4) bytes (b = 4 for float32, 2 for bf16); it needs about
// 10*dh FLOPs per visible pair (recomputing q.k, dout.v, and the products
// into dq, dk and dv), N*T*(T+1)/2 pairs. At the training shape (N = 256,
// T = 100, dh = 32, float32) that is 23 MB against 0.41 GFLOP: bytes 6.9 us,
// operations 6.2 us. At T = 200: 46 MB against 1.65 GFLOP, so the operations
// bound it (25 us against 14 us). This version does ~16*dh FLOPs per pair on
// the CUDA cores (q.k and dout.v are recomputed in both kernels, and dq
// takes two products), one Philox call per pair in kernel 2, and no
// tensor-core work: wgmma, TMA and register tiling come later.
//
// Interface: a plain C function (no PyTorch headers), built by nvcc into a
// shared library and called through ctypes. It launches both kernels on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cmath>

#include "flash_attention_common.cuh"
#include "philox.cuh"

namespace {

using flash::kKeys;
using flash::kLog2e;
using flash::kRows;

// Threads per row: a thread holds W = DH / kSplit elements of a row.
template <int DH>
struct Split {
  static constexpr int kSplit = DH > 32 ? DH / 32 : 1;
  static constexpr int W = DH / kSplit;
  static_assert(kSplit == 1 || kSplit == 2, "dh 16, 32 or 64");
};

// Sum of a partial dot product over the kSplit lanes of a row (neighbouring
// lanes); every lane of the warp must take part.
template <int kSplit>
__device__ __forceinline__ float row_sum(float x) {
  if constexpr (kSplit == 2) x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kRows* Split<DH>::kSplit)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const int64_t* __restrict__ seed,
                    T* __restrict__ dq, float* __restrict__ delta, int seq,
                    float scale, int dropout, uint32_t threshold, float keep_scale) {
  constexpr int S = Split<DH>::kSplit;
  constexpr int W = Split<DH>::W;
  __shared__ __align__(16) float ks[kKeys * DH];
  __shared__ __align__(16) float vs[kKeys * DH];

  const int n = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int row = q0 + threadIdx.x / S;
  const int part = (threadIdx.x % S) * W;  // this lane's first element of the row
  const bool active = row < seq;
  const size_t head = static_cast<size_t>(n) * seq * DH;
  const size_t at = head + static_cast<size_t>(active ? row : 0) * DH + part;
  const philox::Key key = dropout ? philox::key_of(seed) : philox::Key{0u, 0u};

  float qr[W], dor[W], acc_a[W], acc_b[W];
  flash::load_row<W>(qr, q + at, active);
  flash::load_row<W>(dor, dout + at, active);
#pragma unroll
  for (int d = 0; d < W; ++d) acc_a[d] = acc_b[d] = 0.f;
  float di = 0.f;  // D_i = sum_j P_ij dP_ij
  const float c = scale * kLog2e;
  const float lse2 = active ? lse[static_cast<size_t>(n) * seq + row] * kLog2e : 0.f;

  const int key_end = min(q0 + kRows, seq);
  for (int k0 = 0; k0 < key_end; k0 += kKeys) {
    flash::stage_tiles<DH, kRows * S>(ks, k + head, vs, v + head, k0, seq);
    __syncthreads();
    // Every lane walks the same keys (the shuffles need the whole warp);
    // keys after a row's own position are masked.
    const int keys = min(kKeys, key_end - k0);
    for (int j0 = 0; j0 < keys; j0 += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (dropout && active) bits = philox::bits4(key, n, row, (k0 + j0) / 4);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t;
        const float* kr = ks + j * DH + part;
        const float s = row_sum<S>(flash::dot_shared<W>(qr, kr));
        float dp = row_sum<S>(flash::dot_shared<W>(dor, vs + j * DH + part));
        const bool visible = active && j < keys && k0 + j <= row;
        const float p = visible ? exp2f(s * c - lse2) : 0.f;
        if (dropout) dp = philox::word(bits, t) >= threshold ? dp * keep_scale : 0.f;
        const float pd = p * dp;
        di += pd;
        flash::axpy_shared<W>(acc_a, pd, kr);
        flash::axpy_shared<W>(acc_b, p, kr);
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int d = 0; d < W; ++d) acc_a[d] = fmaf(-di, acc_b[d], acc_a[d]);
    flash::store_row<W>(dq + at, acc_a, scale);
    if (part == 0) delta[static_cast<size_t>(n) * seq + row] = di;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kKeys* Split<DH>::kSplit)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int64_t* __restrict__ seed, T* __restrict__ dk,
                      T* __restrict__ dv, int seq, float scale, int dropout,
                      uint32_t threshold, float keep_scale) {
  constexpr int S = Split<DH>::kSplit;
  constexpr int W = Split<DH>::W;
  __shared__ __align__(16) float qs[kRows * DH];
  __shared__ __align__(16) float dos[kRows * DH];
  __shared__ float lse_s[kRows];
  __shared__ float delta_s[kRows];

  const int n = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;
  const int col = k0 + threadIdx.x / S;  // this thread's key
  const int part = (threadIdx.x % S) * W;
  const bool active = col < seq;
  const size_t head = static_cast<size_t>(n) * seq * DH;
  const size_t at = head + static_cast<size_t>(active ? col : 0) * DH + part;
  const philox::Key key = dropout ? philox::key_of(seed) : philox::Key{0u, 0u};

  float kr[W], vr[W], dka[W], dva[W];
  flash::load_row<W>(kr, k + at, active);
  flash::load_row<W>(vr, v + at, active);
#pragma unroll
  for (int d = 0; d < W; ++d) dka[d] = dva[d] = 0.f;
  const float c = scale * kLog2e;

  for (int q0 = k0; q0 < seq; q0 += kRows) {
    flash::stage_tiles<DH, kKeys * S>(qs, q + head, dos, dout + head, q0, seq);
    for (int i = threadIdx.x; i < kRows; i += kKeys * S) {
      const bool in = q0 + i < seq;
      lse_s[i] = in ? lse[static_cast<size_t>(n) * seq + q0 + i] * kLog2e : 0.f;
      delta_s[i] = in ? delta[static_cast<size_t>(n) * seq + q0 + i] : 0.f;
    }
    __syncthreads();
    const int rows = min(kRows, seq - q0);
    for (int i = 0; i < rows; ++i) {
      const int row = q0 + i;
      const float* qi = qs + i * DH + part;
      const float* doi = dos + i * DH + part;
      const float s = row_sum<S>(flash::dot_shared<W>(kr, qi));
      float dp = row_sum<S>(flash::dot_shared<W>(vr, doi));
      const bool visible = active && col <= row;
      const float p = visible ? exp2f(s * c - lse_s[i]) : 0.f;
      float pk = p;
      if (dropout) {
        const bool keep = visible && philox::word(philox::bits4(key, n, row, col / 4), col % 4) >= threshold;
        pk = keep ? p * keep_scale : 0.f;
        dp = keep ? dp * keep_scale : 0.f;
      }
      flash::axpy_shared<W>(dva, pk, doi);
      flash::axpy_shared<W>(dka, p * (dp - delta_s[i]), qi);
    }
    __syncthreads();
  }
  if (active) {
    flash::store_row<W>(dk + at, dka, scale);
    flash::store_row<W>(dv + at, dva, 1.f);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* seed, void* dq,
           void* dk, void* dv, void* delta, int n, int seq, int dropout,
           uint32_t threshold, float keep_scale, cudaStream_t stream) {
  // 1/sqrt(dh) rounded once to float32, as the forward takes it.
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  const dim3 grid(n, (seq + kRows - 1) / kRows);
  const int threads = kRows * Split<DH>::kSplit;
  flash_bwd_dq_kernel<T, DH><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const int64_t*>(seed), static_cast<T*>(dq), static_cast<float*>(delta),
      seq, scale, dropout, threshold, keep_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, DH><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int64_t*>(seed), static_cast<T*>(dk), static_cast<T*>(dv),
      seq, scale, dropout, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* seed, void* dq, void* dk, void* dv,
              void* delta, int n, int seq, int dh,
              int dropout, uint32_t threshold, float keep_scale, cudaStream_t s) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, seed, dq, dk, dv, delta, n, seq, dropout, threshold, keep_scale, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, seed, dq, dk, dv, delta, n, seq, dropout, threshold, keep_scale, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, seed, dq, dk, dv, delta, n, seq, dropout, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (n, seq, dh) contiguous, 16-byte aligned;
// bf16 != 0 selects bfloat16, else float32. lse: (n, seq) float32 from the
// forward; delta: (n, seq) float32 scratch. dh is 16, 32 or 64. dropout,
// threshold, keep_scale and the device pointer seed as the forward took them.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* seed,
                                   void* dq, void* dk, void* dv, void* delta, int n,
                                   int seq, int dh, int bf16, int dropout,
                                   unsigned int threshold, float keep_scale, void* stream) {
  if (n <= 0 || seq <= 0 || seq > 65535 * kRows || (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dh<__nv_bfloat16>(q, k, v, dout, lse, seed, dq, dk, dv, delta, n, seq, dh,
                                         dropout, threshold, keep_scale, s)
              : launch_dh<float>(q, k, v, dout, lse, seed, dq, dk, dv, delta, n, seq, dh,
                                 dropout, threshold, keep_scale, s);
}
