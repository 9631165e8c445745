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
// not written, and a duplicate id (its gradient row all zero) writes nothing,
// so one launch a step is race-free. One warp a row, a lane a column: a
// simple first design. The work is bound by bytes: each touched row reads and
// writes its 3*w float32 (bf16: 4*w uint16) and reads its gradient row.
//
// Interface: plain C functions (no PyTorch headers), built by nvcc into a
// shared library and called through ctypes with a pointer to a RowAdamCall
// or a RowAdamPackedCall. Each launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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

struct PackedArgs {
  void* packed;
  const int64_t* ids;
  const float* grads;
  int n_ids;
  int w;
  int count;
  PackedRect t[kMaxTables];
  float lr, b1, omb1, b2, omb2, eps, d1, d2;
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

template <bool kBf16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
packed_rowadam_kernel(const __grid_constant__ PackedArgs args) {
  const int r = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (r >= args.n_ids) return;  // uniform across the warp
  const int lane = threadIdx.x % 32;
  const int64_t id = args.ids[r];
  const float* g_row = args.grads + static_cast<int64_t>(r) * args.w;
  // Bit t: table t holds the id and its gradient columns are not all zero.
  unsigned touched = 0;
  for (int t = 0; t < args.count; ++t) {
    const PackedRect& rc = args.t[t];
    bool nonzero = false;
    for (int j = rc.col0 + lane; j < rc.col0 + rc.width; j += 32) nonzero |= g_row[j] != 0.f;
    const bool holds = id >= rc.row0 && id < rc.row0 + rc.n_rows;  // uniform: one id a warp
    if (__any_sync(kFullMask, nonzero) && holds) touched |= 1u << t;
  }
  if (!touched) return;  // untouched or outside every table: no read, no write
  const int w = args.w;
  for (int j = lane; j < w; j += 32) {
    bool mine = false;
    for (int t = 0; t < args.count; ++t) {
      mine |= ((touched >> t) & 1u) && j >= args.t[t].col0 && j < args.t[t].col0 + args.t[t].width;
    }
    if (!mine) continue;
    const float g = g_row[j];
    float m_new, v_new, delta;
    if (kBf16) {
      uint16_t* row = static_cast<uint16_t*>(args.packed) + id * 4 * w;
      const float p = __uint_as_float((static_cast<uint32_t>(row[j]) << 16) | row[w + j]);
      const float m = __uint_as_float(static_cast<uint32_t>(row[2 * w + j]) << 16);
      const float v = __uint_as_float(static_cast<uint32_t>(row[3 * w + j]) << 16);
      packed_adam(args, g, m, v, m_new, v_new, delta);
      const uint32_t pu = __float_as_uint(__fadd_rn(p, delta));
      row[j] = static_cast<uint16_t>(pu >> 16);
      row[w + j] = static_cast<uint16_t>(pu & 0xffffu);
      row[2 * w + j] = bf16_bits(m_new);
      row[3 * w + j] = bf16_bits(v_new);
    } else {
      float* row = static_cast<float*>(args.packed) + id * 3 * w;
      const float p = row[j], m = row[w + j], v = row[2 * w + j];
      packed_adam(args, g, m, v, m_new, v_new, delta);
      row[j] = __fadd_rn(p, delta);
      row[w + j] = __fadd_rn(m, __fsub_rn(m_new, m));
      row[2 * w + j] = __fadd_rn(v, __fsub_rn(v_new, v));
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
  if (call->n_ids == 0) return static_cast<int>(cudaSuccess);

  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (call->n_ids + kWarpsPerBlock - 1) / kWarpsPerBlock;
  packed_rowadam_kernel<kBf16><<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(args);
  err = cudaGetLastError();
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
