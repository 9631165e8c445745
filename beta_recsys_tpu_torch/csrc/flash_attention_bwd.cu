// Causal flash attention, backward, written by hand for Hopper (sm_90a).
//
// Replaces beta_recsys_tpu/ops/pallas/flash_attention.py:_bwd_kernel (reached
// through _flash_bwd). For q, k, v, dout of shape (N = batch * heads, T, dh),
// contiguous, float32 or bfloat16, dh 16, 32 or 64, and the forward's float32
// lse (N, T, 1), it gives dq, dk, dv (q's type) of
//   out = (P * keep / (1 - rate)) v,  P = softmax(q k^T / sqrt(dh) + causal mask)
// with keep the forward's Philox dropout mask (philox.cuh), regenerated from
// the same seed. Its inputs are the TPU kernel's residuals (q, k, v, seed,
// lse) and dout; the forward's out is not read. All arithmetic is float32 on
// the CUDA cores (no TF32, no tensor cores).
//
// Per visible pair (i, j), with P recomputed from the saved lse:
//   P_ij  = exp(q_i . k_j / sqrt(dh) - lse_i)
//   dP_ij = keep_ij / (1 - rate) * (dout_i . v_j)
//   dv_j += keep_ij / (1 - rate) * P_ij * dout_i
//   dS_ij = P_ij * (dP_ij - D_i),   D_i = sum_j P_ij dP_ij
//   dq_i += dS_ij k_j / sqrt(dh),   dk_j += dS_ij q_i / sqrt(dh)
// The exponent is q_i . k_j / sqrt(dh) rounded, minus lse_i (prob below):
// SASRec at the shipped lr 0.5 drives lse past 1e7 within a few steps, where
// a float32 step of lse is 1 or more, and only a P that reproduces the
// forward's rounding keeps a saturated row's gradient at 0. Two earlier
// forms, s * (scale * log2 e) - lse * log2 e and fmaf(s, scale, -lse), left
// a rounding of that size in the exponent: training at that config climbed
// (the first also reached inf and NaN).
// D_i is the TPU kernel's rowsum(dP * P) (:116), summed in float32. (It equals
// dout_i . out_i, but out is stored in q's type: in bfloat16 that form reads a
// rounded out, and the error reaches dq through every key.)
//
// What bounds it on the H100 (3.35 TB/s; 67 TFLOP/s float32 outside the
// tensor cores). The function reads q, k, v, dout and lse and writes dq, dk,
// dv: N*T*(7*dh*b + 4) bytes (b = 4 for float32, 2 for bf16); it needs about
// 10*dh FLOPs per visible pair, N*T*(T+1)/2 pairs. At the training shape
// (N 256, T 100, dh 32, float32): 23 MB against 0.41 GFLOP, bytes 6.9 us,
// operations 6.2 us. At T 200 the operations bound it (24.6 us).
//
// The first port (one thread per query or key row, 64- or 128-thread CTAs)
// took 94.1 us at 256 x 100 x 32 rate 0.1 and 223.5 us at T 200 (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py): about 1,000 resident warps of the card's
// 8,448, every FMA reading its operand from shared memory, one Philox call
// per pair. This design:
//   - 256-thread CTAs, 64 x 64 (query x key) tiles, register-tiled. For S =
//     q k^T and dP = dout v^T a thread owns a 4 x 4 micro-tile (rows
//     4 ty .. 4 ty + 3, keys tx + 16 b) and walks dh in float4 steps: per
//     step 8 float4 loads feed 64 FMAs. Tiles sit in shared memory row-major
//     with a row stride of dh + 4 floats, so the 16 different key rows of a
//     warp's loads fall in different banks.
//   - Three tiled products. The elementwise pass writes two 64 x 64 tiles to
//     shared memory; then dv += P~^T dout, dk += dS^T q, dq += dS k run as
//     products over the tile with a (dh / 16) x 4 output micro-tile a thread,
//     accumulators in registers. A thread's dh / 16 outputs are consecutive,
//     so each step reads them from the tile as one vector: the dk/dv kernel
//     keeps its tiles query-major, the dq kernel writes its tiles key-major
//     (a thread's four rows of a key as one float4).
//   - The mask once per pair: each tile pair's 64 x 64 keep bits are made by
//     1,024 Philox calls (4 keys each, the forward's counters) into a byte
//     array in shared memory, and read from there.
//   - Work skipped, a warp at a time: warps whose 8 rows lie past T skip
//     both score products; a warp computes only the key groups of 16 that
//     hold a key before T and, on a diagonal tile, at or before its last row
//     (each count its own unrolled code); warps whose outputs lie past T skip
//     the products, whose loops run over valid rows or keys only and, on a
//     diagonal tile, only over the visible ones.
//   - Partition: two kernels, so that every output element has one owner and
//     nothing is summed with atomics (two runs give the same bits):
//       1. flash_bwd_dq_kernel: a CTA owns a 64-row query tile of one head
//          and walks the key tiles up to the diagonal. It keeps
//          A_i = sum_j P_ij dP_ij k_j and B_i = sum_j P_ij k_j in registers
//          (two products over the same k tile) and per-thread partial sums
//          of D_i, summed over the 16 lanes of a row by shuffles at the end;
//          then dq_i = (A_i - D_i B_i) / sqrt(dh), and D_i goes to a float32
//          scratch (N, T).
//       2. flash_bwd_dkdv_kernel (after 1 on the same stream, so D is
//          there): a CTA owns a 64-key tile and walks the query tiles from
//          the diagonal down, accumulating dk_j and dv_j in registers.
//     One CTA per head (the TPU kernel's partition) would not fit a head of
//     T 200, dh 64 with its two 64 x 64 tiles in 227 KB; the split covers
//     every T and keeps N x ceil(T / 64) CTAs a kernel.
//   - Staging through registers, one slot. A CTA walks at most ceil(T / 64)
//     tiles (2 at T 100, 4 at T 200), and the two CTAs an SM holds (128
//     registers a thread; shared memory 57-106 KB a CTA at dh 16-64)
//     overlap one CTA's loads with the other's arithmetic. A variant that
//     staged the walked tiles by cp.async into two slots (dh 16 and 32;
//     one at dh 64, where two would leave one CTA an SM) was no faster:
//     58.4 against 56.9 us at 256 x 100 x 32 rate 0.1, 173.0 against 171.9
//     at T 200, 42.7 against 42.6 at dh 16, 61.2 against 58.1 at 128 x 100
//     x 64 (port_tools/time_kernels.py, both in one call; NVIDIA H100 80GB
//     HBM3, 700 W).
//   The kernels do ~16*dh FLOPs per pair (q.k and dout.v are recomputed in
//   both, dq takes two products).
//   The tile staging, the mask bytes, the score product and the score
//   pass's lane layout live in flash_attention_common.cuh, one copy for this
//   and the forward kernel, so both sum every score in the same order.
// Measured (NVIDIA H100 80GB HBM3, 700 W; port_tools/time_kernels.py, calls
// queued on the device behind a sleep kernel, the first port in the same
// call): 56.8-56.9 us at 256 x 100 x 32 float32 rate 0.1 (first port 91.6),
// 12% of the bound; 50.9-51.3 at rate 0 (68.8); 174.1-174.2 at T 200
// (221.2-221.3); 42.6-42.7 at 256 x 100 x 16 (64.1); 59.0-59.2 at 128 x 100
// x 64 (98.5-98.6). PERF.md section 6, row 2, keeps both.
//
// Interface: a plain C function (no PyTorch headers), built by nvcc into a
// shared library and called through ctypes. It launches both kernels on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cmath>

#include "flash_attention_common.cuh"
#include "philox.cuh"

namespace {

using flash::kGroups;
using flash::kLog2e;
using flash::kThreads;
using flash::kTile;
using flash::kWld;
using flash::ScoreLane;

// A CTA's shared memory (dynamic): four (64, dh) row tiles, the two 64 x 64
// tiles of the products, the staged query rows' lse and D, and
// the tile's keep bits.
template <int DH>
struct Smem {
  static constexpr int kLd = DH + 4;
  float q[kTile * kLd];
  float dout[kTile * kLd];
  float k[kTile * kLd];
  float v[kTile * kLd];
  float w1[kTile * kWld];
  float w2[kTile * kWld];
  float lse[kTile];
  float delta[kTile];
  uint8_t mask[kTile * kGroups];
};

// P_ij = exp(s_ij * scale - lse_i) from the raw score s_ij, as the plain
// version forms it: s * scale rounded on its own (no fmaf), then lse taken
// away. The forward sums s in the same order (flash::score_tile), so for a
// row's top key s * scale rounds to the value its lse was built on, and P
// of a saturated row is exactly 1 at any magnitude (an exact product would
// leave lse's rounding in the exponent, up to 4 at lse 1e8, and a gradient
// that does not vanish). The exponent cannot pass 0 then; the clamp keeps P
// a probability for an lse from elsewhere.
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return exp2f(fminf(__fsub_rn(__fmul_rn(s, scale), lse), 0.f) * kLog2e);
}

// 64 values src[r0 ..] into dst, zeros past seq.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int seq) {
  if (threadIdx.x < kTile) {
    dst[threadIdx.x] = r0 + threadIdx.x < seq ? src[r0 + threadIdx.x] : 0.f;
  }
}

// N consecutive floats of shared memory in one load (N = 1, 2 or 4).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = *p;
  }
}

// Product geometry of a thread: outputs x0 .. x0 + kXt - 1 of the tile,
// elements 4 dg .. 4 dg + 3 of dh; its warp's outputs are x_lo .. x_hi.
template <int DH>
struct ProductLane {
  static constexpr int kDg = DH / 4;
  static constexpr int kXt = DH / 16;
  int x0, dg, x_lo, x_hi;
  __device__ ProductLane()
      : x0(kXt * (threadIdx.x / kDg)),
        dg(threadIdx.x % kDg),
        x_lo(kXt * ((threadIdx.x & ~31) / kDg)),
        x_hi(kXt * (((threadIdx.x & ~31) + 31) / kDg) + kXt - 1) {}
};

// S = q k^T and dP = dout v^T over the first nb key groups (a warp-uniform
// count, 1-4), each count its own unrolled code.
template <int DH>
__device__ __forceinline__ void score_pair(const Smem<DH>& sm, int r0, int tx, int nb, float (&s)[4][4],
                                           float (&dp)[4][4]) {
  switch (nb) {
    case 1:
      flash::score_tile<DH, 1>(sm.q, sm.k, r0, tx, s);
      flash::score_tile<DH, 1>(sm.dout, sm.v, r0, tx, dp);
      break;
    case 2:
      flash::score_tile<DH, 2>(sm.q, sm.k, r0, tx, s);
      flash::score_tile<DH, 2>(sm.dout, sm.v, r0, tx, dp);
      break;
    case 3:
      flash::score_tile<DH, 3>(sm.q, sm.k, r0, tx, s);
      flash::score_tile<DH, 3>(sm.dout, sm.v, r0, tx, dp);
      break;
    default:
      flash::score_tile<DH, 4>(sm.q, sm.k, r0, tx, s);
      flash::score_tile<DH, 4>(sm.dout, sm.v, r0, tx, dp);
  }
}

// acc1[t] += sum_y w1[y][x0 + t] m1[y][4 dg ..], and the same for acc2, over
// y0 <= y < y1 (bounds that are the same for the whole warp): a thread's
// (dh / 16) x 4 output micro-tiles of two products whose 64 x 64 factors sit
// in shared memory with the reduced index first.
template <int DH>
__device__ __forceinline__ void product2(float (&acc1)[DH / 16][4], const float* w1, const float* m1,
                                         float (&acc2)[DH / 16][4], const float* w2, const float* m2,
                                         int y0, int y1, const ProductLane<DH>& pl) {
  constexpr int kXt = DH / 16;
  constexpr int kLd = DH + 4;
#pragma unroll 4
  for (int y = y0; y < y1; ++y) {
    float a[kXt], b[kXt];
    load_vec<kXt>(w1 + y * kWld + pl.x0, a);
    load_vec<kXt>(w2 + y * kWld + pl.x0, b);
    const float4 p = *reinterpret_cast<const float4*>(m1 + y * kLd + 4 * pl.dg);
    const float4 q = *reinterpret_cast<const float4*>(m2 + y * kLd + 4 * pl.dg);
#pragma unroll
    for (int t = 0; t < kXt; ++t) {
      flash::axpy4(acc1[t], a[t], p);
      flash::axpy4(acc2[t], b[t], q);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const int64_t* __restrict__ seed, T* __restrict__ dq, float* __restrict__ delta, int seq,
                    float scale, int dropout, uint32_t threshold, float keep_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  constexpr int kXt = ProductLane<DH>::kXt;
  const ScoreLane sl;
  const ProductLane<DH> pl;
  const int n = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const size_t head = static_cast<size_t>(n) * seq * DH;
  const philox::Key key = dropout ? philox::key_of(seed) : philox::Key{0u, 0u};
  const bool rows_in = q0 + 8 * sl.warp < seq;

  flash::stage2<DH>(sm.q, q + head, sm.dout, dout + head, q0, seq);
  stage_rows(sm.lse, lse + static_cast<size_t>(n) * seq, q0, seq);
  float acc_a[kXt][4] = {};  // sum_j P dP k_j
  float acc_b[kXt][4] = {};  // sum_j P k_j
  float d_part[4] = {};      // this thread's part of D for its rows

  const int key_end = min(q0 + kTile, seq);
  for (int k0 = 0; k0 < key_end; k0 += kTile) {
    flash::stage2<DH>(sm.k, k + head, sm.v, v + head, k0, seq);
    if (dropout) flash::stage_mask(sm.mask, key, n, q0, k0, seq, threshold);
    __syncthreads();
    const int nb = sl.groups(k0 == q0, seq - k0);
    float s[4][4], dp[4][4];
    if (rows_in) score_pair(sm, sl.r0, sl.tx, nb, s, dp);
    // P dP and P, transposed (key-major): a thread stores its 4 rows of a key
    // as one float4.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = sl.tx + 16 * j;
      float pd[4], pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sl.r0 + i;
        pd[i] = pv[i] = 0.f;
        if (rows_in && j < nb && q0 + r < seq && k0 + col <= q0 + r) {
          pv[i] = prob(s[i][j], scale, sm.lse[r]);
          float dpv = dp[i][j];
          if (dropout) dpv = flash::kept(sm.mask, r, col) ? dpv * keep_scale : 0.f;
          pd[i] = pv[i] * dpv;
          d_part[i] += pd[i];
        }
      }
      *reinterpret_cast<float4*>(sm.w1 + col * kWld + sl.r0) = make_float4(pd[0], pd[1], pd[2], pd[3]);
      *reinterpret_cast<float4*>(sm.w2 + col * kWld + sl.r0) = make_float4(pv[0], pv[1], pv[2], pv[3]);
    }
    __syncthreads();
    // Keys after the warp's last row are masked on the diagonal; a warp whose
    // rows all lie past T has no output.
    const int y1 = k0 == q0 ? min(seq - k0, pl.x_hi + 1) : min(kTile, seq - k0);
    if (q0 + pl.x_lo < seq) product2<DH>(acc_a, sm.w1, sm.k, acc_b, sm.w2, sm.k, 0, y1, pl);
    __syncthreads();
  }
  // D of each row: the 16 lanes of a row are the 16 lanes of a half-warp.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) d_part[i] += __shfl_xor_sync(0xffffffffu, d_part[i], off);
    if (sl.tx == 0) sm.delta[sl.r0 + i] = d_part[i];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kXt; ++t) {
    const int x = pl.x0 + t;
    const int row = q0 + x;
    if (row < seq) {
      const float di = sm.delta[x];
      float g[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) g[e] = fmaf(-di, acc_b[t][e], acc_a[t][e]);
      flash::store_scaled(dq + head + static_cast<size_t>(row) * DH + 4 * pl.dg, g, scale);
      if (pl.dg == 0) delta[static_cast<size_t>(n) * seq + row] = di;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int64_t* __restrict__ seed, T* __restrict__ dk,
                      T* __restrict__ dv, int seq, float scale, int dropout, uint32_t threshold,
                      float keep_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  constexpr int kXt = ProductLane<DH>::kXt;
  const ScoreLane sl;
  const ProductLane<DH> pl;
  const int n = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const size_t head = static_cast<size_t>(n) * seq * DH;
  const philox::Key key = dropout ? philox::key_of(seed) : philox::Key{0u, 0u};

  flash::stage2<DH>(sm.k, k + head, sm.v, v + head, k0, seq);
  float acc_k[kXt][4] = {};
  float acc_v[kXt][4] = {};

  for (int q0 = k0; q0 < seq; q0 += kTile) {
    flash::stage2<DH>(sm.q, q + head, sm.dout, dout + head, q0, seq);
    stage_rows(sm.lse, lse + static_cast<size_t>(n) * seq, q0, seq);
    stage_rows(sm.delta, delta + static_cast<size_t>(n) * seq, q0, seq);
    if (dropout) flash::stage_mask(sm.mask, key, n, q0, k0, seq, threshold);
    __syncthreads();
    const bool rows_in = q0 + 8 * sl.warp < seq;
    const int nb = sl.groups(q0 == k0, seq - k0);
    float s[4][4], dp[4][4];
    if (rows_in) score_pair(sm, sl.r0, sl.tx, nb, s, dp);
    // P~ and dS, query-major.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sl.r0 + i;
      const float lse_r = sm.lse[r];
      const float di = sm.delta[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = sl.tx + 16 * j;
        float pk = 0.f, ds = 0.f;
        if (rows_in && j < nb && q0 + r < seq && k0 + col <= q0 + r) {
          const float p = prob(s[i][j], scale, lse_r);
          float dpv = dp[i][j];
          pk = p;
          if (dropout) {
            const bool keep = flash::kept(sm.mask, r, col);
            pk = keep ? p * keep_scale : 0.f;
            dpv = keep ? dpv * keep_scale : 0.f;
          }
          ds = p * (dpv - di);
        }
        sm.w1[r * kWld + col] = pk;
        sm.w2[r * kWld + col] = ds;
      }
    }
    __syncthreads();
    // Rows before the warp's first key are masked on the diagonal; a warp
    // whose keys all lie past T has no output.
    const int y0 = q0 == k0 ? pl.x_lo : 0;
    if (k0 + pl.x_lo < seq) product2<DH>(acc_v, sm.w1, sm.dout, acc_k, sm.w2, sm.q, y0, min(kTile, seq - q0), pl);
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < kXt; ++t) {
    const int col = k0 + pl.x0 + t;
    if (col < seq) {
      const size_t at = head + static_cast<size_t>(col) * DH + 4 * pl.dg;
      flash::store_scaled(dk + at, acc_k[t], scale);
      flash::store_scaled(dv + at, acc_v[t], 1.f);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* seed,
           void* dq, void* dk, void* dv, void* delta, int n, int seq, int dropout, uint32_t threshold,
           float keep_scale, cudaStream_t stream) {
  // 1/sqrt(dh) rounded once to float32, as the forward takes it.
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  const dim3 grid(n, (seq + kTile - 1) / kTile);
  constexpr int kBytes = sizeof(Smem<DH>);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, DH><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const int64_t*>(seed),
      static_cast<T*>(dq), static_cast<float*>(delta), seq, scale, dropout, threshold, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, DH><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int64_t*>(seed), static_cast<T*>(dk), static_cast<T*>(dv), seq, scale, dropout, threshold,
      keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* seed,
              void* dq, void* dk, void* dv, void* delta, int n, int seq, int dh, int dropout, uint32_t threshold,
              float keep_scale, cudaStream_t s) {
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
  if (n <= 0 || seq <= 0 || seq > 65535 * kTile || (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dh<__nv_bfloat16>(q, k, v, dout, lse, seed, dq, dk, dv, delta, n, seq, dh,
                                         dropout, threshold, keep_scale, s)
              : launch_dh<float>(q, k, v, dout, lse, seed, dq, dk, dv, delta, n, seq, dh,
                                 dropout, threshold, keep_scale, s);
}
