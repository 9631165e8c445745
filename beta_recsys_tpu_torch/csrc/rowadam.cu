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
// Interface: a plain C function (no PyTorch headers), built by nvcc into a
// shared library and called through ctypes with a pointer to a RowAdamCall.
// It launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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
