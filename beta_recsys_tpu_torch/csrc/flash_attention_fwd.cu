// Causal flash attention, forward, written by hand for Hopper (sm_90a).
//
// Replaces beta_recsys_tpu/ops/pallas/flash_attention.py:_fwd_kernel (reached
// through _flash_call), attention dropout included. For q, k, v of shape
// (N = batch * heads, T, dh), contiguous, float32 or bfloat16, dh 16, 32 or 64:
//   P   = softmax(q k^T / sqrt(dh) + causal mask)
//   out = (P * keep / (1 - rate)) v                 (N, T, dh), q's type
//   lse = m + log(sum_j exp(s_j - m))              (N, T, 1), float32
// keep is the Philox mask of philox.cuh (all ones at rate 0). Dropout acts
// after the normalisation, as in the TPU kernel: the row sum l (and so lse)
// sums every visible key, kept or dropped, and only the output takes the
// mask and the 1/(1 - rate) factor. All arithmetic is float32 on the CUDA
// cores (no TF32, no tensor cores), whatever the input type; the output is
// rounded once to q's type.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores, 989 TFLOP/s bf16 in them). The function moves N*T*(4*dh*b + 4) bytes
// (b = 4 for float32, 2 for bf16) and needs 4*dh FLOPs per visible (query, key)
// pair, N*T*(T+1)/2 pairs. At the training shape (N 256, T 100, dh 32,
// float32): 13 MB against 0.17 GFLOP, bytes 3.9 us. At the checkpoint's
// serving shape (N 1,886, T 100) bytes bound it (29.1 us); at the default
// config's recommend() blocks (N 8,192, T 200, float32) the operations
// (0.315 ms).
//
// The first port gave each thread of a 64-thread CTA one query row: about
// 1,000 resident warps of the card's 8,448 at the training shape, one
// float4 load from shared memory per four FMAs, a rescale of the 16-64
// accumulators every 8 keys, two Philox calls per 8 keys of a row, and rows
// 100-127 of the second tile idle. This design takes the backward's tiles
// (flash_attention_bwd.cu):
//   - A 256-thread CTA owns one (n, 64-row query tile) and walks the 64-key
//     tiles up to the diagonal; no tile past it is loaded. The query tiles
//     that walk the most key tiles are launched first. The first key and
//     value tiles are loaded together with the query tile.
//   - S = q k^T is a register-tiled 64 x 64 product (flash::score_tile): a
//     thread owns a 4 x 4 micro-tile (rows 4 ty .. 4 ty + 3, keys tx + 16 b)
//     and sums over d from 0 upward in float4 steps by fmaf, the order in
//     which the backward recomputes it, so every score has the same bits in
//     both kernels. Tiles sit in shared memory with a row stride of dh + 4.
//   - The online softmax runs once a tile: a row's maximum over the 16 lanes
//     that hold it (shuffles), one rescale of O and l, and P~ = P * keep /
//     (1 - rate) written key-major into a 64 x 64 tile in shared memory.
//     Each lane keeps its own part of l; the 16 parts are summed at the end.
//   - O += P~ v is a product over the tile with a 4 x 4 output micro-tile a
//     thread (2 float4 loads per 16 FMAs): at dh 32 and 16 the 2 or 4 lanes
//     of a micro-tile split the tile's keys between them and sum their
//     parts once, by shuffles, at the end. A warp's output rows are its
//     score rows, so P~ and the rescale pass between its lanes after a
//     __syncwarp; a tile takes two CTA barriers.
//   - The keep bits of a tile pair are made once, by 1,024 Philox calls (4
//     keys each, the backward's counters), into bytes in shared memory
//     (flash::stage_mask, shared with the backward).
//   - Work skipped a warp at a time: warps whose rows lie past T skip the
//     score product and the output product; on a diagonal tile a warp
//     computes only the key groups at or before its last row and its product
//     stops there. Rows and keys past T are masked; T = 1 works.
//   - Shared memory (dynamic): three (64, dh + 4) tiles, the P~ tile, two
//     row vectors and 1 KB of mask bytes: 34 KB at dh 16, 46 KB at dh 32,
//     70 KB at dh 64 (opted in through cudaFuncAttributeMaxDynamicShared-
//     MemorySize); two CTAs an SM (128 registers a thread).
//   No tensor cores in either type: an mma product sums s in another order
//   than the backward's CUDA-core product, and at lr 0.5 (lse past 1e7) a
//   saturated row's gradient vanishes only when its top score has the same
//   bits in both kernels. Tensor cores wait until both kernels share one S
//   product.
// Measured (port_tools/time_kernels.py, float32, calls queued on the device
// behind a sleep kernel, the first port in the same call; NVIDIA H100 80GB
// HBM3, 700 W): 19.0 us at 256 x 100 x 32 rate 0.1 (first port 23.6), 15.7
// at rate 0 (21.8), 55.1 at 256 x 200 x 32 (59.6), 15.4 at 256 x 100 x 16
// (16.1), 17.0 at 128 x 100 x 64 (25.5); serving 107.5 at 1886 x 100 x 32
// (121.1) and 1.320 ms at 8192 x 200 x 32 (1.390). 13-27% of the bound: the
// CUDA-core FMAs and the shared-memory loads that feed them both run near
// their rates. Three variants measured no better in the same calls: the
// next key tile loaded into registers during the current one (1.286 ms at
// 8192 x 200 x 32, else within 1% or slower: 18.3 against 17.3 at dh 64),
// three CTAs an SM (84 registers: 97.8 us and 1.250 ms at the serving
// shapes, but 20.6-21.0 against 19.0-19.2 at the training shape and 16.5
// against 15.4 at dh 16), and 128-thread CTAs with 8 x 4 score micro-tiles
// (spills: 25.0 at the training shape, 36.2 at dh 64). PERF.md section 6,
// row 1, keeps the times.
//
// Interface: a plain C function (no PyTorch headers), built by nvcc into a
// shared library and called through ctypes. It launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <math_constants.h>

#include <cmath>

#include "flash_attention_common.cuh"
#include "philox.cuh"

namespace {

using flash::kLog2e;
using flash::kThreads;
using flash::kTile;
using flash::kWld;
using flash::ScoreLane;

// A CTA's shared memory (dynamic): the query tile and the walked key and
// value tiles, the tile of P~ (key-major: a thread's four rows of a key are
// one float4), each row's rescale of the tile and final sum, and the tile's
// keep bits.
template <int DH>
struct Smem {
  static constexpr int kLd = DH + 4;
  float q[kTile * kLd];
  float k[kTile * kLd];
  float v[kTile * kLd];
  float p[kTile * kWld];
  float alpha[kTile];
  float l[kTile];
  uint8_t mask[kTile * flash::kGroups];
};

// Output geometry of a thread in O += P~ v: rows 4 rg .. 4 rg + 3 of the
// tile (its score rows), elements 4 dg .. 4 dg + 3 of dh, and the keys
// y = split (mod kSplit) of each tile. The 16 lanes of a half-warp hold one
// row group: dh / 4 lanes of consecutive elements a split, so the lanes of
// a quarter-warp read one key's row of v without bank conflicts; the kSplit
// parts of an output sum by shuffles at the end. P~ and the rescale pass
// within a warp.
template <int DH>
struct OutLane {
  static constexpr int kSplit = 64 / DH;  // 4, 2, 1 at dh 16, 32, 64
  int split, dg, rg;
  __device__ OutLane()
      : split((threadIdx.x / (DH / 4)) % kSplit), dg(threadIdx.x % (DH / 4)), rg(threadIdx.x / 16) {}
};

static_assert(kThreads == 16 * 16, "16 row groups of 4, 16 lanes a row group");

// Rows q0 .. q0 + 63 of q and rows 0 .. 63 of k and v into their tiles,
// float32, zeros past seq: the loads of all three issued together.
template <int DH, typename T>
__device__ __forceinline__ void stage_first(Smem<DH>& sm, const T* q, const T* k, const T* v, int q0, int seq) {
  constexpr int kLd = DH + 4;
  constexpr int kVecs = kTile * DH / 4;
  static_assert(kVecs % kThreads == 0, "every thread moves the same number of vectors");
#pragma unroll
  for (int it = 0; it < kVecs / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (DH / 4);
    const int d = (i % (DH / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b = a;
    float4 c = a;
    if (q0 + r < seq) a = flash::load4(q + static_cast<size_t>(q0 + r) * DH + d);
    if (r < seq) {
      b = flash::load4(k + static_cast<size_t>(r) * DH + d);
      c = flash::load4(v + static_cast<size_t>(r) * DH + d);
    }
    *reinterpret_cast<float4*>(sm.q + r * kLd + d) = a;
    *reinterpret_cast<float4*>(sm.k + r * kLd + d) = b;
    *reinterpret_cast<float4*>(sm.v + r * kLd + d) = c;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int64_t* __restrict__ seed, int seq, float scale, int dropout,
                 uint32_t threshold, float keep_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  constexpr int kSplit = OutLane<DH>::kSplit;
  constexpr int kLd = DH + 4;
  const ScoreLane sl;
  const OutLane<DH> ol;
  const int n = blockIdx.x;
  // The last query tile, which walks the most key tiles, is launched first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t head = static_cast<size_t>(n) * seq * DH;
  const philox::Key key = dropout ? philox::key_of(seed) : philox::Key{0u, 0u};
  const bool rows_in = q0 + 8 * sl.warp < seq;  // the warp's score rows, and its output rows
  // Exponents are taken in base 2 as (s - m) * scale * log2(e), m the
  // running maximum of a row's raw scores s.
  const float c = scale * kLog2e;

  float m[4], l[4];  // per row of the thread: m, and this lane's part of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  float acc[4][4] = {};  // rows 4 rg + i, elements 4 dg + e: this lane's keys

  stage_first<DH>(sm, q + head, k + head, v + head, q0, seq);
  const int key_end = min(q0 + kTile, seq);  // keys the tile's last row sees
  for (int k0 = 0; k0 < key_end; k0 += kTile) {
    if (k0 > 0) flash::stage2<DH>(sm.k, k + head, sm.v, v + head, k0, seq);
    if (dropout) flash::stage_mask(sm.mask, key, n, q0, k0, seq, threshold);
    __syncthreads();
    const int nb = sl.groups(k0 == q0, seq - k0);
    float s[4][4];
    if (rows_in) flash::score_groups<DH>(sm.q, sm.k, sl.r0, sl.tx, nb, s);
    // The online softmax, once a tile: each row's maximum over its 16
    // lanes, one rescale, and P~ = P * keep / (1 - rate) into the tile (in
    // place of s).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sl.r0 + i;
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = sl.tx + 16 * j;
        const bool visible = rows_in && j < nb && q0 + r < seq && k0 + col <= q0 + r;
        s[i][j] = visible ? s[i][j] : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      // A row with no visible key so far (one past T) takes 0 as its
      // maximum, so that no exponent is inf - inf.
      const float m_ref = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f((m[i] - m_ref) * c);  // 0 on a row's first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f((s[i][j] - m_ref) * c);  // 0 for a masked key
        sum += p;  // every visible key, kept or dropped
        s[i][j] = !dropout ? p : (flash::kept(sm.mask, r, sl.tx + 16 * j) ? p * keep_scale : 0.f);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      if (sl.tx == 0) sm.alpha[r] = alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(sm.p + (sl.tx + 16 * j) * kWld + sl.r0) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncwarp();  // a warp reads back only its own rows of P~ and alpha
    // O = alpha O + P~ v over this lane's keys. Keys after the warp's last
    // row are masked on the diagonal; a warp whose rows all lie past T has
    // no output.
    if (rows_in) {
      const float4 a = *reinterpret_cast<const float4*>(sm.alpha + 4 * ol.rg);
      const float al[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= al[i];
      }
      const int y1 = k0 == q0 ? min(seq - k0, 8 * sl.warp + 8) : min(kTile, seq - k0);
#pragma unroll 4
      for (int y = ol.split; y < y1; y += kSplit) {
        const float4 w = *reinterpret_cast<const float4*>(sm.p + y * kWld + 4 * ol.rg);
        const float4 x = *reinterpret_cast<const float4*>(sm.v + y * kLd + 4 * ol.dg);
        flash::axpy4(acc[0], w.x, x);
        flash::axpy4(acc[1], w.y, x);
        flash::axpy4(acc[2], w.z, x);
        flash::axpy4(acc[3], w.w, x);
      }
    }
    __syncthreads();  // every warp is done with this tile's k, v and mask
  }
  // l of each row: the 16 lanes of a row are the 16 lanes of a half-warp.
  // lse = m * scale + log(l), m * scale rounded on its own, as the plain
  // version forms it: for a saturated row (l = 1) lse is the rounded top
  // score that the backward's P takes away.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = sl.r0 + i;
    if (sl.tx == 0) {
      sm.l[r] = li;
      if (q0 + r < seq) lse[static_cast<size_t>(n) * seq + q0 + r] = __fadd_rn(__fmul_rn(m[i], scale), logf(li));
    }
  }
  // The kSplit parts of each output, summed over neighbouring lanes.
#pragma unroll
  for (int off = DH / 4; off < 16; off <<= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
    }
  }
  __syncwarp();
  if (ol.split == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = 4 * ol.rg + i;
      if (q0 + x < seq) {
        flash::store_scaled(out + head + static_cast<size_t>(q0 + x) * DH + 4 * ol.dg, acc[i], 1.f / sm.l[x]);
      }
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const void* seed, int n, int seq, int dropout, uint32_t threshold,
           float keep_scale, cudaStream_t stream) {
  // 1/sqrt(dh) rounded once to float32, as the reference computes it.
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  const dim3 grid(n, (seq + kTile - 1) / kTile);
  constexpr int kBytes = sizeof(Smem<DH>);
  if constexpr (kBytes > 48 * 1024) {  // dh 64: an opt-in above the default
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_fwd_kernel<T, DH><<<grid, kThreads, kBytes, stream>>>(
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
  if (n <= 0 || seq <= 0 || seq > 65535 * kTile || (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dh<__nv_bfloat16>(q, k, v, out, lse, seed, n, seq, dh, dropout, threshold, keep_scale, s)
              : launch_dh<float>(q, k, v, out, lse, seed, n, seq, dh, dropout, threshold, keep_scale, s);
}
