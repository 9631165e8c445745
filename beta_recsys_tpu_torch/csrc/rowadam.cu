// Lazy-Adam row update, in place, written by hand for Hopper (sm_90a).
//
// Replaces beta_recsys_tpu/ops/pallas/rowadam.py:_rowadam_kernel (reached
// through fused_rowadam), with its contract. For tables table, m, v of shape
// (n_rows, d) float32, ids (L,) sorted with duplicates carrying all-zero
// gradient rows (the output of the segment dedup), int64 as torch.sort
// returns them, grads (L, d) float32 and
// the bias corrections bc1 = 1/(1-b1^t), bc2 = 1/(1-b2^t), every row r whose
// gradient is not all zero updates row ids[r]:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   t' = t + (-lr * (m'*bc1)) / (sqrt(v'*bc2) + eps)
// in the order of rowadam.py:105-108. A row whose gradient is all zero is
// skipped: no moment decay, no write. That also makes the update race-free,
// since only the first occurrence of an id carries a gradient.
//
// Design. The TPU kernel walks the rows in order on one core and hides the
// HBM latency with a hand-built ring of N_SLOTS row DMAs. Here one warp owns
// one row of ids and the card's many resident warps hide the latency. A warp
// first reads its gradient row and votes (__any_sync) on whether any entry is
// non-zero; an untouched row returns before it reads table, m or v. Loads and
// stores are float4 (16 bytes a lane) when d % 4 == 0 and every base pointer
// is 16-byte aligned, one float a lane otherwise. No padding of d: the TPU's
// 128-column constraint came from its DMA engine.
//
// What bounds it on the H100 (3.35 TB/s): bytes. Each touched row reads
// table, m, v and its gradient row and writes table, m and v: 7*d*4 bytes,
// plus the ids, for ~12 FLOPs per 28 bytes. At the MF path's shapes (L = 400
// or 800 rows of d = 64) that is 0.15-0.3 us, under a launch's latency; at a
// production shape (L = 16,384 ids into a 1,000,000 x 64 table) at most
// ~9 us, ~2 us for zipf ids that touch ~3,700 distinct rows.
// Ids outside [0, n_rows) are not written (a wrong id must not overwrite
// another allocation); the trainer's ids are the data's dense ids.
//
// Interface: a plain C function (no PyTorch headers), built by nvcc into a
// shared library and called through ctypes. It launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

struct Adam {
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2;

  __device__ __forceinline__ void update(float g, float& t, float& m, float& v) const {
    m = b1 * m + omb1 * g;
    v = b2 * v + omb2 * g * g;
    t = t + (-lr * (m * bc1)) / (sqrtf(v * bc2) + eps);
  }
};

template <bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rowadam_kernel(float* __restrict__ table, float* __restrict__ m, float* __restrict__ v,
               const int64_t* __restrict__ ids, const float* __restrict__ grads,
               int64_t n_rows, int n_ids, int d, Adam adam) {
  const int r = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_ids) return;  // uniform across the warp
  const float* g_row = grads + static_cast<int64_t>(r) * d;
  const int n_vec = kVec4 ? d / 4 : d;

  bool nonzero = false;
  for (int j = lane; j < n_vec; j += 32) {
    if (kVec4) {
      const float4 g = reinterpret_cast<const float4*>(g_row)[j];
      nonzero |= (g.x != 0.f) | (g.y != 0.f) | (g.z != 0.f) | (g.w != 0.f);
    } else {
      nonzero |= g_row[j] != 0.f;
    }
  }
  if (!__any_sync(kFullMask, nonzero)) return;  // untouched: no read, no write
  const int64_t id = ids[r];
  if (id < 0 || id >= n_rows) return;

  const int64_t base = id * d;
  for (int j = lane; j < n_vec; j += 32) {
    if (kVec4) {
      const float4 g = reinterpret_cast<const float4*>(g_row)[j];
      float4 t = reinterpret_cast<const float4*>(table + base)[j];
      float4 mm = reinterpret_cast<const float4*>(m + base)[j];
      float4 vv = reinterpret_cast<const float4*>(v + base)[j];
      adam.update(g.x, t.x, mm.x, vv.x);
      adam.update(g.y, t.y, mm.y, vv.y);
      adam.update(g.z, t.z, mm.z, vv.z);
      adam.update(g.w, t.w, mm.w, vv.w);
      reinterpret_cast<float4*>(table + base)[j] = t;
      reinterpret_cast<float4*>(m + base)[j] = mm;
      reinterpret_cast<float4*>(v + base)[j] = vv;
    } else {
      float t = table[base + j], mm = m[base + j], vv = v[base + j];
      adam.update(g_row[j], t, mm, vv);
      table[base + j] = t;
      m[base + j] = mm;
      v[base + j] = vv;
    }
  }
}

}  // namespace

// table, m, v: (n_rows, d) float32, contiguous, updated in place; ids: (n_ids,)
// int64; grads: (n_ids, d) float32, contiguous.
// omb1 = 1 - b1 and omb2 = 1 - b2 come rounded once from double, as the
// plain version's Python-float constants do.
extern "C" int fused_rowadam(void* table, void* m, void* v, const void* ids,
                             const void* grads, long long n_rows, int n_ids, int d,
                             float lr, float b1, float omb1, float b2, float omb2,
                             float eps, float bc1, float bc2, void* stream) {
  if (n_ids < 0 || d <= 0 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_ids == 0) return static_cast<int>(cudaSuccess);
  const Adam adam{lr, b1, omb1, b2, omb2, eps, bc1, bc2};
  const bool vec4 = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(m) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(grads)) % 16) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(table);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  const int64_t* id = static_cast<const int64_t*>(ids);
  const float* g = static_cast<const float*>(grads);
  const dim3 grid((n_ids + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  if (vec4) {
    rowadam_kernel<true><<<grid, block, 0, s>>>(t, mm, vv, id, g, n_rows, n_ids, d, adam);
  } else {
    rowadam_kernel<false><<<grid, block, 0, s>>>(t, mm, vv, id, g, n_rows, n_ids, d, adam);
  }
  return static_cast<int>(cudaGetLastError());
}
