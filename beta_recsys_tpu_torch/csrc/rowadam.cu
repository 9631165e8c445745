// Lazy-Adam row update, in place, written by hand for Hopper (sm_90a).
//
// Replaces beta_recsys_tpu/ops/pallas/rowadam.py:_rowadam_kernel (reached
// through fused_rowadam), with its contract, for one table or several. For a
// table, m, v of shape (n_rows, d) float32, ids (L,) sorted with duplicates
// carrying all-zero gradient rows (the output of the segment dedup), int64
// as torch.sort returns them, grads (L, d) float32 and the bias corrections
// bc1 = 1/(1-b1^t), bc2 = 1/(1-b2^t), every row r whose gradient is not all
// zero updates row ids[r]:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   t' = t + (-lr * (m'*bc1)) / (sqrt(v'*bc2) + eps)
// in the order of rowadam.py:105-108. A row whose gradient is all zero is
// skipped: no moment decay, no write. That also makes the update race-free,
// since only the first occurrence of an id carries a gradient.
//
// Design. The TPU kernel walks the rows in order on one core and hides the
// HBM latency with a hand-built ring of N_SLOTS row DMAs. Here the card's
// many resident warps hide the latency:
//   - One launch updates every 2-D table of a training step (up to 8): the
//     call's tables arrive by value as a kernel parameter (no host-to-device
//     copy), each with the first warp of its rows; a warp finds its table
//     from those prefixes. MF's step (user and item tables) is one launch.
//   - A row takes the fewest lanes, a power of two up to 32, that give each
//     of its vectors a lane: at d 64 (16 float4) half a warp, so a warp
//     keeps two rows in flight.
//   - A row's lanes read its gradient and its id together and vote
//     (__ballot_sync, each group reading its own lanes); an untouched row
//     returns before it reads table, m or v.
//   - Loads and stores are float4 (16 bytes a lane) when d % 4 == 0 and every
//     base pointer of the table is 16-byte aligned, one float a lane
//     otherwise. No padding of d: the TPU's 128-column constraint came from
//     its DMA engine.
// The first port gave each row a whole warp, one launch per table.
// Measured (port_tools/time_kernels.py, calls queued on the device behind a
// sleep kernel, the first port in the same call; NVIDIA H100 80GB HBM3,
// 700 W): MF's step 3.13 us in one launch against 5.66-5.70 us in two, a
// call through the trainer's prebuilt group 15-25 us of host time against
// 33-35 us for two; 1,000,000 x 64 with L 16,384 zipf ids 4.55-4.58 us
// against 5.52-5.53 us.
//
// What bounds it on the H100 (3.35 TB/s): bytes. Each touched row reads
// table, m, v and its gradient row and writes table, m and v: 7*d*4 bytes,
// plus the ids, for ~12 FLOPs per 28 bytes. At the MF path's shapes (L = 400
// and 800 rows of d = 64) that is 0.45 us for the step, under a launch's
// latency; at a production shape (L = 16,384 ids into a 1,000,000 x 64
// table) at most ~9 us, ~2 us for zipf ids that touch ~3,700 distinct rows.
// Ids outside [0, n_rows) are not written (a wrong id must not overwrite
// another allocation); the trainer's ids are the data's dense ids.
//
// Packed row layouts. fused_rowadam_packed and fused_rowadam_packed_bf16
// are the row write of the lazy-Adam trainer's "unified"/"compact" and
// "unified_bf16" layouts (beta_recsys_tpu/core/sparse_optim.py:380-700,
// which the JAX package leaves to XLA): every row table of a step lives in
// one array, each table a rectangle of it (a row range, a column offset and
// a width); roles stack vertically, a role's tables sit side by side.
//   fp32: rows of stride 3*w, [param | m | v], each w float32 wide;
//   bf16: rows of stride 4*w uint16, [p_hi | p_lo | m | v]: the float32
//         parameter split into its two 16-bit halves (bit-exact master
//         weights) and the moments rounded to bfloat16.
// One sorted, deduplicated id array (packed row ids) and its (L, w) float32
// gradients serve every table. A table of a row is touched when the row's id
// lies in its row range and its gradient columns are not all zero; only a
// touched table's columns update, in the order of the plain version
// (ops/kernels/rowadam.py, which follows the JAX package's epoch function):
//   m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*(g*g)
//   delta = (-lr * (m'/d1)) / (sqrt(v'/d2) + eps),  d = 1 - b^t
//   fp32: p += delta; m += (m' - m); v += (v' - v)
//   bf16: p += delta; m, v = bfloat16(m'), bfloat16(v') round to nearest even
// Untouched columns keep their bytes, rows of ids outside every table are
// not written, and a duplicate id writes nothing, so one launch a step is
// race-free.
//
// The packed write relies on the call's contract that the ids are sorted
// and every non-first occurrence of an id carries an all-zero gradient row
// (_segment_dedup, then compact_rows, in core/sparse_optim.py): a row r > 0
// with ids[r] == ids[r-1] is never read. That gives the write what the JAX
// "compact" layout's compaction gives its scatter, without a compaction
// pass. Design (packed_rowadam_kernel):
//   - One grid of resident warps, 32 an SM (no more warps than ids). Lane
//     l of warp g reads the id at g + l * G (G warps): every warp holds ids
//     from the whole sorted array, so the distinct ids, which sorting packs
//     into the tail of each role under zipf draws, spread evenly over the
//     warps, and no block waits for a slot. The lanes read each id and its
//     predecessor together and vote the first occurrences inside a table.
//   - Their gradient rows and packed rows are copied into the warp's shared
//     memory with cp.async, all copies of a round (up to 8 rows in 7 KB) in
//     flight before anything is stored: 16-byte copies between the
//     source's 16-byte boundaries and 4-byte ones at its ends (the fp32 row
//     of 780 bytes at w 65 is only 4-byte aligned; the bf16 row of 512
//     bytes at w 64 is one 16-byte copy a lane), each row placed at its
//     source's offset within 16 bytes.
//   - A row of up to 96 columns updates in one pass, lane l taking columns
//     l, l + 32 and l + 64: the lanes load every column of the tables
//     holding the row, vote the touched tables from those loads (one
//     reduction), compute, and store the touched columns straight to the
//     packed row. MF's embedding and bias columns share the pass. Wider
//     rows vote first, then pass over 64 columns at a time.
//   - Every column takes packed_adam's arithmetic, each operation rounded
//     on its own (IEEE division and square root), so the kernel and the
//     plain version agree bit for bit.
// The first packed design gave every id a warp, duplicates included, and
// walked each row in 32-column passes of dependent scalar loads and stores.
// Measured (port_tools/time_kernels.py packed: device time queued behind a
// sleep kernel, the first design in the same call, two calls; NVIDIA H100
// 80GB HBM3, 700 W): at 1,100,000 rows, L 49,152 zipf ids (11,692 first
// occurrences, 10,302 touched rows) 14.0-14.3 us against 26.6-26.8 us in
// float32 and 11.6-12.1 us against 17.3-17.5 us in bf16; at MF's step (L
// 1,200), where launch latency sets the floor, 4.2-4.3 us against 5.1-5.2
// us in float32 and 3.94-4.01 us against 3.91-3.94 us in bf16. With uniform
// ids at that table scale (44,126 first occurrences, ~11 a warp) it gains
// little: 44.0-45.0 us against 46.4-46.7 us in float32, and bf16 30.8-30.9
// us trails the first design's 29.6-30.0 us.
// What bounds it: on paper bytes (each touched row read and written, each
// first occurrence's gradient row and every id read: 5.8 us fp32, 4.2 us
// bf16 at the zipf table scale, 21.4 and 15.2 us with uniform ids). Where
// the rest of its time goes is not measured; staging each warp's rounds
// through two buffers, so that copies overlap arithmetic, made it slower
// at every shape.
//
// Interface: plain C functions (no PyTorch headers), built by nvcc into a
// shared library and called through ctypes with a pointer to a RowAdamCall
// or a RowAdamPackedCall. Each launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// One table of a packed call: rows [row0, row0 + n_rows) of the packed
// array, columns [col0, col0 + width) of each component.
struct PackedRect {
  long long row0;
  long long n_rows;
  int col0;
  int width;
};

namespace {

constexpr int kMaxTables = 8;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// The update in the order of the plain version's torch ops, each rounded on
// its own (no contraction into FMAs), so kernel and plain version agree bit
// for bit and no compiler's choice of FMAs changes a training run.
struct Adam {
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2;

  __device__ __forceinline__ void update(float g, float& t, float& m, float& v) const {
    m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
    v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(omb2, g), g));
    const float step = __fdiv_rn(__fmul_rn(-lr, __fmul_rn(m, bc1)), __fadd_rn(__fsqrt_rn(__fmul_rn(v, bc2)), eps));
    t = __fadd_rn(t, step);
  }
};

// One table of a launch, as the kernel reads it: its rows are served by the
// warps warp0 .. warp0 + ceil(n_ids / (32 >> shift)) - 1, 2^shift lanes a
// row.
struct KernelTable {
  float* table;
  float* m;
  float* v;
  const int64_t* ids;
  const float* grads;
  long long n_rows;
  int n_ids;
  int n_vec;  // vectors a row: d / 4 float4 when vec4, else d floats
  int warp0;
  int shift;
  int vec4;
};

struct KernelArgs {
  KernelTable t[kMaxTables];
  int count;
  int n_warps;
  Adam adam;
};

// The update of the rows of one lane group: a row's lanes read its gradient
// and its id together, vote, and only a row with a non-zero gradient and an
// id in [0, n_rows) reads and writes table, m and v.
template <bool kVec4>
__device__ __forceinline__ void update_rows(const KernelTable& tb, const Adam& adam, int r, int j0, int lanes,
                                            unsigned group) {
  const bool has_row = r < tb.n_ids;
  const float* g_row = tb.grads + static_cast<int64_t>(r) * tb.n_vec * (kVec4 ? 4 : 1);
  int64_t id = -1;
  bool nonzero = false;
  if (has_row) {
    id = tb.ids[r];
    for (int j = j0; j < tb.n_vec; j += lanes) {
      if (kVec4) {
        const float4 g = reinterpret_cast<const float4*>(g_row)[j];
        nonzero |= (g.x != 0.f) | (g.y != 0.f) | (g.z != 0.f) | (g.w != 0.f);
      } else {
        nonzero |= g_row[j] != 0.f;
      }
    }
  }
  // Every lane of the warp votes; each group reads its own lanes' votes.
  if (!(__ballot_sync(kFullMask, nonzero) & group)) return;  // untouched: no read, no write
  if (id < 0 || id >= tb.n_rows) return;

  const int64_t base = id * tb.n_vec * (kVec4 ? 4 : 1);
  for (int j = j0; j < tb.n_vec; j += lanes) {
    if (kVec4) {
      const float4 g = reinterpret_cast<const float4*>(g_row)[j];
      float4 t = reinterpret_cast<const float4*>(tb.table + base)[j];
      float4 mm = reinterpret_cast<const float4*>(tb.m + base)[j];
      float4 vv = reinterpret_cast<const float4*>(tb.v + base)[j];
      adam.update(g.x, t.x, mm.x, vv.x);
      adam.update(g.y, t.y, mm.y, vv.y);
      adam.update(g.z, t.z, mm.z, vv.z);
      adam.update(g.w, t.w, mm.w, vv.w);
      reinterpret_cast<float4*>(tb.table + base)[j] = t;
      reinterpret_cast<float4*>(tb.m + base)[j] = mm;
      reinterpret_cast<float4*>(tb.v + base)[j] = vv;
    } else {
      float t = tb.table[base + j], mm = tb.m[base + j], vv = tb.v[base + j];
      adam.update(g_row[j], t, mm, vv);
      tb.table[base + j] = t;
      tb.m[base + j] = mm;
      tb.v[base + j] = vv;
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rowadam_kernel(const __grid_constant__ KernelArgs args) {
  const int w = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (w >= args.n_warps) return;  // uniform across the warp
  int ti = 0;  // the warp's table: warps are numbered table by table
  for (int i = 1; i < args.count; ++i) ti = w >= args.t[i].warp0 ? i : ti;
  const KernelTable& tb = args.t[ti];
  const int lane = threadIdx.x % 32;
  const int lanes = 1 << tb.shift;
  const int r = (w - tb.warp0) * (32 >> tb.shift) + (lane >> tb.shift);
  const unsigned group = lanes == 32 ? kFullMask : ((1u << lanes) - 1u) << (lane & ~(lanes - 1));
  if (tb.vec4) {
    update_rows<true>(tb, args.adam, r, lane & (lanes - 1), lanes, group);
  } else {
    update_rows<false>(tb, args.adam, r, lane & (lanes - 1), lanes, group);
  }
}

// The packed kernel's grid: kPackedWarpsPerSm warps an SM (no more than a
// step has ids), in blocks of kPackedWarps; a warp stages up to
// kPackedSlots rows at once within kPackedWarpStage bytes of shared memory.
constexpr int kPackedWarps = 4;
constexpr int kPackedWarpsPerSm = 32;
constexpr int kPackedSlots = 8;
constexpr int kPackedWarpStage = 7 * 1024;
constexpr int kMaxDynamicSmem = 232448;  // 227 KB, the most a block can have on Hopper

struct PackedArgs {
  void* packed;
  const int64_t* ids;
  const float* grads;
  int n_ids;
  int w;
  int count;
  PackedRect t[kMaxTables];
  float lr, b1, omb1, b2, omb2, eps, d1, d2;
  int slots;          // rows a warp stages at once
  int grad_words;     // 32-bit words of a staged gradient row's region (w, rounded up to 16 bytes, + 16 bytes)
  int slot_words;     // 32-bit words of a slot: the gradient's region, then the packed row's (w words + 16 bytes)
  int grad_unit;      // copy_unit() of the gradients: 4 (cp.async) or 2 (plain loads)
  int row_unit;       // copy_unit() of the packed array
};

// The packed update of one column, each operation rounded on its own.
__device__ __forceinline__ void packed_adam(const PackedArgs& a, float g, float m, float v, float& m_new,
                                            float& v_new, float& delta) {
  m_new = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  v_new = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  const float m_hat = __fdiv_rn(m_new, a.d1);
  const float v_hat = __fdiv_rn(v_new, a.d2);
  delta = __fdiv_rn(__fmul_rn(-a.lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), a.eps));
}

// float32 -> bfloat16 bits, round to nearest even (NaN stays a quiet NaN), as
// torch's and XLA's conversions round.
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return static_cast<uint16_t>((u >> 16) | 0x40u);
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ void cp_async16(char* dst, const char* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(__cvta_generic_to_global(src)) : "memory");
}

__device__ __forceinline__ void cp_async4(char* dst, const char* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(__cvta_generic_to_global(src)) : "memory");
}

// Where a row copied by stage() starts in its shared-memory region: at the
// source's offset within 16 bytes, so that source and copy share their
// 16-byte boundaries (a 2-byte-aligned source starts the region).
__device__ __forceinline__ int staged_at(const void* src, int unit) {
  return unit == 2 ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
}

// Copies n_bytes (a multiple of 4) from global memory into a region of
// shared memory 16 bytes longer, at staged_at(src), with the warp's lanes on
// consecutive units: cp.async of 16 bytes between the source's 16-byte
// boundaries and of 4 bytes before and after them (no register holds the
// data, so every copy of the warp is in flight at once until
// cp_async_wait_all), or 2-byte loads and stores where the source is only
// 2-byte aligned.
__device__ __forceinline__ void stage(void* region, const void* src, int n_bytes, int unit, int lane) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(region) + staged_at(src, unit);
  if (unit == 2) {
    for (int i = lane * 2; i < n_bytes; i += 32 * 2) {
      *reinterpret_cast<uint16_t*>(d + i) = __ldg(reinterpret_cast<const unsigned short*>(s + i));
    }
    return;
  }
  const int head = min((16 - staged_at(src, unit)) & 15, n_bytes);
  const int body = (n_bytes - head) & ~15;
  if (lane * 4 < head) cp_async4(d + lane * 4, s + lane * 4);
  for (int i = head + lane * 16; i < head + body; i += 32 * 16) cp_async16(d + i, s + i);
  if (lane * 4 < n_bytes - head - body) cp_async4(d + head + body + lane * 4, s + head + body + lane * 4);
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// One pass over columns base + l, base + l + 32, ... (kCols of them a lane
// l) of a staged row (g, row): each lane loads its columns of the given
// tables and computes their update; with kVote, tables holds the tables
// that hold the row and the pass votes, from those loads, the ones whose
// gradient columns are not all zero (a row of w <= 32 * kCols columns in
// one pass, MF's embedding and bias columns together); without, tables
// holds the touched tables, voted before. The columns of touched tables
// are stored straight to the packed row.
template <bool kBf16, int kCols, bool kVote>
__device__ __forceinline__ void column_pass(const PackedArgs& a, const float* g, const uint32_t* row, int64_t row_id,
                                            unsigned tables, int base, int lane) {
  const int w = a.w;
  float gv[kCols], p[kCols], m[kCols], v[kCols], m_new[kCols], v_new[kCols], delta[kCols];
  unsigned table[kCols];  // the bit of the table that holds the column, 0 for none
#pragma unroll
  for (int u = 0; u < kCols; ++u) table[u] = 0;
  for (unsigned h = tables; h; h &= h - 1) {
    const int t = __ffs(h) - 1;
    const int col0 = a.t[t].col0, width = a.t[t].width;
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      if (static_cast<unsigned>(base + lane + 32 * u - col0) < static_cast<unsigned>(width)) table[u] = 1u << t;
    }
  }
  unsigned nonzero = 0;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int j = base + lane + 32 * u;
    gv[u] = p[u] = m[u] = v[u] = 0.f;
    if (table[u]) {
      gv[u] = g[j];
      if (kBf16) {
        const uint16_t* s = reinterpret_cast<const uint16_t*>(row) + j;
        p[u] = __uint_as_float((static_cast<uint32_t>(s[0]) << 16) | s[w]);
        m[u] = __uint_as_float(static_cast<uint32_t>(s[2 * w]) << 16);
        v[u] = __uint_as_float(static_cast<uint32_t>(s[3 * w]) << 16);
      } else {
        const float* s = reinterpret_cast<const float*>(row) + j;
        p[u] = s[0];
        m[u] = s[w];
        v[u] = s[2 * w];
      }
    }
    if (gv[u] != 0.f) nonzero |= table[u];
    packed_adam(a, gv[u], m[u], v[u], m_new[u], v_new[u], delta[u]);
  }
  const unsigned touched = kVote ? tables & __reduce_or_sync(kFullMask, nonzero) : tables;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    if (!(table[u] & touched)) continue;
    const int j = base + lane + 32 * u;
    if (kBf16) {
      uint16_t* out = static_cast<uint16_t*>(a.packed) + row_id * 4 * w + j;
      const uint32_t pu = __float_as_uint(__fadd_rn(p[u], delta[u]));
      out[0] = static_cast<uint16_t>(pu >> 16);
      out[w] = static_cast<uint16_t>(pu & 0xffffu);
      out[2 * w] = bf16_bits(m_new[u]);
      out[3 * w] = bf16_bits(v_new[u]);
    } else {
      float* out = static_cast<float*>(a.packed) + row_id * 3 * w + j;
      out[0] = __fadd_rn(p[u], delta[u]);
      out[w] = __fadd_rn(m[u], __fsub_rn(m_new[u], m[u]));
      out[2 * w] = __fadd_rn(v[u], __fsub_rn(v_new[u], v[u]));
    }
  }
}

// Warp g of a grid of G warps serves the ids at g, g + G, g + 2G, ...,
// lane l the ones at g + l * G (+ 32 * G ...): every warp holds ids from the
// whole sorted array, so the distinct ids, which sorting gathers (the tail
// of each role under zipf draws), spread evenly over the warps, and one
// grid of resident warps covers a step. For its ids a warp
//   1. reads each id and its predecessor, lanes together. Row r is a
//      candidate when it is a first occurrence (r == 0 or ids[r] !=
//      ids[r-1]) and its id lies in a table's rows; a duplicate carries a
//      zero gradient by the call's contract, so it is never read;
//   2. copies the candidates' gradient rows and packed rows into its shared
//      memory, up to `slots` rows a round, all copies of a round in flight
//      at once, before anything is stored;
//   3. updates each candidate from shared memory (column_pass): a row of up
//      to 96 columns in one pass that also votes its touched tables (a table
//      holding its id whose gradient columns are not all zero); a wider row
//      votes first, then passes over 64 columns at a time.
template <bool kBf16>
__global__ void __launch_bounds__(kPackedWarps * 32)
packed_rowadam_kernel(const __grid_constant__ PackedArgs a) {
  extern __shared__ __align__(16) uint32_t stage_smem[];
  const int lane = threadIdx.x % 32;
  const long long n_warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  const long long gw = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int64_t* __restrict__ ids = a.ids;
  const float* __restrict__ grads = a.grads;
  const int w = a.w;
  const int row_bytes = (kBf16 ? 8 : 12) * w;
  const char* packed = static_cast<const char*>(a.packed);
  uint32_t* slots = stage_smem + static_cast<long long>(threadIdx.x / 32) * a.slots * a.slot_words;

  for (long long base = gw; base < a.n_ids; base += 32 * n_warps) {  // uniform across the warp
    int64_t id = -1;
    unsigned holds = 0;  // bit t: table t's rows hold this lane's id
    const long long r = base + lane * n_warps;
    if (r < a.n_ids) {
      id = __ldg(ids + r);
      if (r == 0 || __ldg(ids + r - 1) != id) {
        for (int t = 0; t < a.count; ++t) {
          holds |= static_cast<unsigned>(id >= a.t[t].row0 && id < a.t[t].row0 + a.t[t].n_rows) << t;
        }
      }
    }
    unsigned rest = __ballot_sync(kFullMask, holds != 0);
    while (rest) {  // rounds of up to `slots` candidates
      unsigned round = 0;
      for (int n = 0; rest && n < a.slots; ++n) {
        round |= rest & (0u - rest);
        rest &= rest - 1;
      }
      int i = 0;
      for (unsigned b = round; b; b &= b - 1, ++i) {
        const int k = __ffs(b) - 1;
        uint32_t* slot = slots + i * a.slot_words;
        stage(slot, grads + (base + k * n_warps) * w, 4 * w, a.grad_unit, lane);
        stage(slot + a.grad_words, packed + __shfl_sync(kFullMask, id, k) * row_bytes, row_bytes, a.row_unit, lane);
      }
      cp_async_wait_all();
      __syncwarp();
      i = 0;
      for (unsigned b = round; b; b &= b - 1, ++i) {
        const int k = __ffs(b) - 1;
        const int64_t row_id = __shfl_sync(kFullMask, id, k);
        const unsigned held = __shfl_sync(kFullMask, holds, k);
        const char* slot = reinterpret_cast<const char*>(slots + i * a.slot_words);
        const float* g =
            reinterpret_cast<const float*>(slot + staged_at(grads + (base + k * n_warps) * w, a.grad_unit));
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            slot + 4 * a.grad_words + staged_at(packed + row_id * row_bytes, a.row_unit));
        if (w <= 64) {
          column_pass<kBf16, 2, true>(a, g, row, row_id, held, 0, lane);
          continue;
        }
        if (w <= 96) {
          column_pass<kBf16, 3, true>(a, g, row, row_id, held, 0, lane);
          continue;
        }
        unsigned touched = 0;  // wider rows: vote first, then pass over 64 columns at a time
        for (unsigned h = held; h; h &= h - 1) {
          const int t = __ffs(h) - 1;
          const int end = a.t[t].col0 + a.t[t].width;
          bool nonzero = false;
          for (int j = a.t[t].col0 + lane; j < end; j += 32) nonzero |= g[j] != 0.f;
          if (__any_sync(kFullMask, nonzero)) touched |= 1u << t;
        }
        for (int col = 0; col < w; col += 64) {
          column_pass<kBf16, 2, false>(a, g, row, row_id, touched, col, lane);
        }
      }
      __syncwarp();  // every lane has read the slots before the next round refills them
    }
  }
}

}  // namespace

// One table of a call, as the wrapper fills it: table, m, v (n_rows, d)
// float32, contiguous, updated in place; ids (n_ids,) int64; grads (n_ids, d)
// float32, contiguous. No two tables of a call share memory.
struct RowAdamTable {
  void* table;
  void* m;
  void* v;
  const void* ids;
  const void* grads;
  long long n_rows;
  int n_ids;
  int d;
};

// A call: up to kMaxTables tables and the Adam constants, omb1 = 1 - b1 and
// omb2 = 1 - b2 rounded once from double, as the plain version's
// Python-float constants are.
struct RowAdamCall {
  RowAdamTable t[kMaxTables];
  int count;
  float lr;
  float b1;
  float omb1;
  float b2;
  float omb2;
  float eps;
  float bc1;
  float bc2;
};

// Updates every table of *call in one launch on the given stream of the
// given device (made current for the launch, then restored). *call is read
// before the function returns.
extern "C" int fused_rowadam_tables(const RowAdamCall* call, int device, void* stream) {
  if (call == nullptr || call->count < 1 || call->count > kMaxTables) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KernelArgs args{};
  args.count = call->count;
  args.adam = Adam{call->lr, call->b1, call->omb1, call->b2, call->omb2, call->eps, call->bc1, call->bc2};
  long long n_warps = 0;
  for (int i = 0; i < call->count; ++i) {
    const RowAdamTable& in = call->t[i];
    if (in.n_ids < 0 || in.d <= 0 || in.n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
    KernelTable& out = args.t[i];
    out.table = static_cast<float*>(in.table);
    out.m = static_cast<float*>(in.m);
    out.v = static_cast<float*>(in.v);
    out.ids = static_cast<const int64_t*>(in.ids);
    out.grads = static_cast<const float*>(in.grads);
    out.n_rows = in.n_rows;
    out.n_ids = in.n_ids;
    out.vec4 = in.d % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(in.table) | reinterpret_cast<uintptr_t>(in.m) |
          reinterpret_cast<uintptr_t>(in.v) | reinterpret_cast<uintptr_t>(in.grads)) % 16) == 0;
    out.n_vec = out.vec4 ? in.d / 4 : in.d;
    // The fewest lanes, a power of two up to 32, that give every vector of
    // a row its own lane: d 64 (16 float4) takes half a warp a row.
    out.shift = 0;
    while ((1 << out.shift) < out.n_vec && out.shift < 5) ++out.shift;
    out.warp0 = static_cast<int>(n_warps);
    const int rows_per_warp = 32 >> out.shift;
    n_warps += (in.n_ids + rows_per_warp - 1) / rows_per_warp;
  }
  if (n_warps > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_warps == 0) return static_cast<int>(cudaSuccess);
  args.n_warps = static_cast<int>(n_warps);

  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  rowadam_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(args);
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// A packed call: the packed array (total_rows rows of 3*w float32, or 4*w
// uint16 for the bf16 form), contiguous and updated in place; ids (n_ids,)
// int64 sorted, duplicates carrying all-zero gradient rows; grads (n_ids, w)
// float32, contiguous; up to kMaxTables disjoint rectangles inside the array;
// the Adam constants (omb = 1 - b rounded once from double) and the bias
// denominators d1 = 1 - b1^t, d2 = 1 - b2^t in float32.
struct RowAdamPackedCall {
  void* packed;
  const void* ids;
  const void* grads;
  long long total_rows;
  int n_ids;
  int w;
  int count;
  PackedRect t[kMaxTables];
  float lr;
  float b1;
  float omb1;
  float b2;
  float omb2;
  float eps;
  float d1;
  float d2;
};

namespace {

// How stage() copies the rows of an array at base (every row a multiple of
// 4 bytes long): 4 when base is 4-byte aligned (cp.async), 2 when only
// 2-byte aligned (plain loads); 0 for an odd base.
int copy_unit(const void* base) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  return p % 4 == 0 ? 4 : p % 2 == 0 ? 2 : 0;
}

int round_up4(long long words) { return static_cast<int>((words + 3) / 4 * 4); }

template <bool kBf16>
int launch_packed(const RowAdamPackedCall* call, int device, void* stream) {
  if (call == nullptr || call->count < 1 || call->count > kMaxTables || call->n_ids < 0 || call->w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackedArgs args{};
  args.packed = call->packed;
  args.ids = static_cast<const int64_t*>(call->ids);
  args.grads = static_cast<const float*>(call->grads);
  args.n_ids = call->n_ids;
  args.w = call->w;
  args.count = call->count;
  for (int i = 0; i < call->count; ++i) {
    const PackedRect& rc = call->t[i];
    if (rc.row0 < 0 || rc.n_rows < 0 || rc.row0 + rc.n_rows > call->total_rows || rc.col0 < 0 || rc.width < 0 ||
        rc.col0 + rc.width > call->w) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    args.t[i] = rc;
  }
  args.lr = call->lr;
  args.b1 = call->b1;
  args.omb1 = call->omb1;
  args.b2 = call->b2;
  args.omb2 = call->omb2;
  args.eps = call->eps;
  args.d1 = call->d1;
  args.d2 = call->d2;
  const long long row_bytes = (kBf16 ? 8LL : 12LL) * call->w;
  args.row_unit = copy_unit(call->packed);
  args.grad_unit = copy_unit(call->grads);
  if (args.row_unit == 0 || args.grad_unit == 0) return static_cast<int>(cudaErrorInvalidValue);
  args.grad_words = round_up4(call->w) + 4;  // 16 bytes more: a row starts at its source's offset in 16
  args.slot_words = args.grad_words + round_up4(row_bytes / 4) + 4;
  const long long slot_bytes = 4LL * args.slot_words;
  if (slot_bytes > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);  // a row too wide to stage
  if (call->n_ids == 0) return static_cast<int>(cudaSuccess);
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One resident grid: kPackedWarpsPerSm warps an SM, no more warps than
  // ids; each warp stages as many rows at once as its budget holds, and no
  // more than it has ids.
  const long long n_warps = std::min<long long>(call->n_ids, static_cast<long long>(sms) * kPackedWarpsPerSm);
  const long long ids_a_warp = (call->n_ids + n_warps - 1) / n_warps;
  args.slots = static_cast<int>(
      std::max(1LL, std::min({static_cast<long long>(kPackedSlots), kPackedWarpStage / slot_bytes, ids_a_warp})));
  // A row too wide for four warps' staging takes a block of one warp.
  const int warps = kPackedWarps * args.slots * slot_bytes <= kMaxDynamicSmem ? kPackedWarps : 1;
  const long long smem = warps * args.slots * slot_bytes;
  const int blocks = static_cast<int>((n_warps + warps - 1) / warps);

  int current = -1;
  err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(packed_rowadam_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    packed_rowadam_kernel<kBf16>
        <<<blocks, warps * 32, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(args);
    err = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

// The "unified"/"compact" row write: float32 [param | m | v] rows, in place,
// one launch on the given stream of the given device.
extern "C" int fused_rowadam_packed(const RowAdamPackedCall* call, int device, void* stream) {
  return launch_packed<false>(call, device, stream);
}

// The "unified_bf16" row write: uint16 [p_hi | p_lo | m_bf16 | v_bf16] rows,
// in place, one launch on the given stream of the given device.
extern "C" int fused_rowadam_packed_bf16(const RowAdamPackedCall* call, int device, void* stream) {
  return launch_packed<true>(call, device, stream);
}
