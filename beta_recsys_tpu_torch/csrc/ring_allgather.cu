// All-gather of one block per rank, written by hand for Hopper (sm_90a).
//
// Replaces beta_recsys_tpu/ops/pallas/ring_exchange.py:_ring_allgather_kernel
// (reached through ring_allgather), with its contract. Each of n ranks holds
// one block x_r of B bytes; every rank ends with out_r[s] = x_s for all s,
// bit for bit (the kernel moves 16-byte vectors, whatever the dtype).
//
// What bounds it on the H100. Bytes. When every rank lives on one card
// (loopback: the one-card mesh of the trainer), the card reads n blocks and
// writes n * n (3.35 TB/s): 0.31 us at the MF path's blocks (n 4, C 200 x 64
// float32, 51.2 KB each). Across cards each card receives n - 1 blocks over
// NVLink (450 GB/s each way): 0.34 us there. A launch costs more than either.
//
// Design. The TPU kernel forwards blocks around the ring, n - 1 dependent
// hops, because a chip of the ICI torus reaches only its neighbours. The
// first port kept that order, and paid a flag round trip a hop: 1.5 us a hop
// in loopback (8.8 us at the path's shape, device time) and ~20 us a hop
// across 4 cards with launch skew (30.3 us) (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py). An HGX H100 reaches every peer over NVLink directly, and in
// loopback every block already sits in one card's memory, so:
//   - Loopback: ring_allgather_copy_kernel, one ordinary launch on the
//     card's stream. A CTA reads a slice of x_s once and stores it n times,
//     to out_r[s] for every r. One stream orders every rank's work, so no
//     rank can race another: no flags, no epoch, no cooperative launch.
//   - Across cards: ring_allgather_oneshot_kernel, one launch per card (the
//     ranks on that card in blockIdx.y), all from one C call so nothing on
//     the host waits between them. A CTA of rank r owns a fixed slice of
//     block r and stores it straight into out_p[r] of every rank p through
//     peer pointers, all n - 1 remote stores in flight at once; then it
//     raises one release flag per peer and waits for the n - 1 flags of the
//     same slice coming in. Two flag rounds instead of n - 1 hops; each byte
//     still crosses NVLink once. What stays from the ring:
//       * the entry barrier. A store into out_p before rank p's stream
//         reached this kernel could hit memory that earlier work on p still
//         uses (the caching allocator orders reuse only within a device's own
//         stream). So each CTA first tells the same CTA of every rank on
//         another card "entered, epoch e" and waits for their words before
//         its first remote store: one all-to-all round;
//       * per-CTA flags that are never reset: each call passes a new epoch
//         (a call counter) and waits for flag >= epoch. Writer: stores, a
//         system-scope fence, __syncthreads(), then release stores of the
//         flags. Reader: acquire loads in a spin (one thread per peer), then
//         __syncthreads(). A rank returns only after its incoming flags, so
//         every incoming store is visible to later work on its stream;
//       * the cooperative launch, which guarantees that every CTA a flag waits
//         on is resident;
//       * the timeout: a wait longer than kTimeoutNs traps, so a broken peer
//         ends the process with an error instead of hanging the card.
//     Ranks that share a card run in one launch: between them the end of the
//     kernel orders everything, so they exchange no flags.
// A pull (each rank reading its peers' blocks) would need the same entry
// round and the same completion round, so push was kept.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; port_tools/time_kernels.py, the
// ring design of the first port in the same call; device time of calls
// queued behind a sleep kernel): loopback n 4 x (200, 64) float32 3.3 us
// (the ring 10.0), 13.4 us at C 8192 (25.5; the bytes bound 12.5 us); across
// 4 cards 13.0-20.5 us at C 200 (34.2), 30.5-38.1 at C 8192 (48.7-49.3),
// where the skew of one launch a card sets the pace. Across cards a call is
// paced by the host, ~60 us to issue for either design.
//
// Interface: plain C functions (no PyTorch headers), built by nvcc into a
// shared library and called through ctypes. Every entry point sets the
// device it works on and restores the previous one: the library links its
// own static CUDA runtime, whose current device is not PyTorch's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 16;
constexpr int kThreads = 256;
constexpr int kCopyVecs = 4;  // 16-byte vectors a thread of the copy kernel moves
constexpr unsigned long long kTimeoutNs = 20ull * 1000ull * 1000ull * 1000ull;

// One call, as the wrapper fills it (the layout of _RingCall in
// ops/kernels/ring_exchange.py). The wrapper writes the pointers, streams,
// sizes and the epoch before each call; the rest is fixed for a ring.
struct RingCall {
  const void* x[kMaxRanks];  // each rank's block: block_vecs 16-byte vectors
  void* out[kMaxRanks];      // each rank's output: n blocks
  void* flags[kMaxRanks];    // each rank's flags: 2n rows of flag_stride words
  void* streams[kMaxRanks];  // per launch: the stream of its device
  int devs[kMaxRanks];       // per launch: its device
  int n_local[kMaxRanks];    // per launch: how many ranks it runs
  int ranks[kMaxRanks];      // the ranks of launch 0, then of launch 1, ...
  int group[kMaxRanks];      // per rank: the launch that runs it
  int n;
  int n_launch;
  int n_ctas;       // CTAs a rank (one-shot)
  int flag_stride;  // words of a flag row: entry rows 0..n-1, arrival rows n..2n-1
  long long block_vecs;
  unsigned epoch;
};

// What one launch of a kernel reads: pointers, not the whole call.
struct KernelArgs {
  const uint4* x[kMaxRanks];
  uint4* out[kMaxRanks];
  unsigned* flags[kMaxRanks];
  int group[kMaxRanks];
  int ranks[kMaxRanks];  // the ranks of this launch, one per blockIdx.y
  int n;
  int flag_stride;
  long long block_vecs;
  unsigned epoch;
};

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *flag reaches epoch (modulo 2^32); traps after kTimeoutNs.
__device__ __forceinline__ void spin_until(const unsigned* flag, unsigned epoch) {
  const unsigned long long start = global_ns();
  while (static_cast<int>(ld_acquire_sys(flag) - epoch) < 0) {
    if (global_ns() - start > kTimeoutNs) __trap();
  }
}

// Loopback: grid (chunks, n); blockIdx.y is the source rank s. Each thread
// loads kCopyVecs vectors of x_s and stores each to out_r[s], r = 0 .. n-1.
__global__ void __launch_bounds__(kThreads) ring_allgather_copy_kernel(const KernelArgs a) {
  const int s = blockIdx.y;
  const long long bv = a.block_vecs;
  const uint4* const x = a.x[s];
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kCopyVecs + threadIdx.x;
  uint4 v[kCopyVecs];
#pragma unroll
  for (int i = 0; i < kCopyVecs; ++i) {
    const long long j = base + i * kThreads;
    if (j < bv) v[i] = x[j];
  }
  for (int r = 0; r < a.n; ++r) {
    uint4* const dst = a.out[r] + s * bv;
#pragma unroll
    for (int i = 0; i < kCopyVecs; ++i) {
      const long long j = base + i * kThreads;
      if (j < bv) dst[j] = v[i];
    }
  }
}

// Across cards: grid (n_ctas, ranks of this card). CTA c of rank r moves
// slice c of block r to every rank; threadIdx.x < n speaks for peer
// threadIdx.x in the flag rounds.
__global__ void __launch_bounds__(kThreads) ring_allgather_oneshot_kernel(const KernelArgs a) {
  const int r = a.ranks[blockIdx.y];
  const int n = a.n;
  const int c = blockIdx.x;
  const int stride = a.flag_stride;
  const long long bv = a.block_vecs;
  const long long per = (bv + gridDim.x - 1) / gridDim.x;
  const long long lo = min(static_cast<long long>(c) * per, bv);
  const long long hi = min(lo + per, bv);
  const int peer = threadIdx.x;
  const bool remote = peer < n && a.group[peer] != a.group[r];

  // Entry round: "rank r entered" to every remote peer, then wait for theirs.
  if (remote) {
    st_release_sys(a.flags[peer] + r * stride + c, a.epoch);
    spin_until(a.flags[r] + peer * stride + c, a.epoch);
  }
  __syncthreads();

  const uint4* const x = a.x[r];
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    const uint4 v = x[j];
    for (int p = 0; p < n; ++p) a.out[p][r * bv + j] = v;
  }
  __threadfence_system();
  __syncthreads();

  // Completion round: slice c of block r is in every remote peer's output;
  // wait until slice c of every remote block is in this rank's.
  if (remote) {
    st_release_sys(a.flags[peer] + (n + r) * stride + c, a.epoch);
    spin_until(a.flags[r] + (n + peer) * stride + c, a.epoch);
  }
  __syncthreads();
}

struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int dev) {
    cudaGetDevice(&prev);
    err = cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// Enable peer access from device `dev` to device `peer` (idempotent).
// Returns cudaErrorPeerAccessUnsupported when the pair has no peer path.
extern "C" int ring_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  DeviceGuard guard(dev);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: access is what was asked for
    err = cudaSuccess;
  }
  return static_cast<int>(err);
}

// How many CTAs of the one-shot kernel can be resident on device `dev` at
// once (the most a cooperative launch there may hold).
extern "C" int ring_resident_ctas(int dev, int* out) {
  DeviceGuard guard(dev);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  int per_sm = 0, sms = 0, coop = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_allgather_oneshot_kernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = coop ? per_sm * sms : 0;
  return static_cast<int>(cudaSuccess);
}

// One all-gather. With one launch (every rank on one card) the copy kernel;
// otherwise one cooperative launch of the one-shot kernel per card, each on
// its stream, with nothing between them that waits on a device. Returns the
// first launch's error; a launch that fails leaves the ones before it to
// trap at their timeout. call_ptr points to a RingCall (a void pointer, so
// that the symbol keeps C linkage: RingCall lives in this file only).
extern "C" int ring_allgather(const void* call_ptr) {
  const RingCall* const call = static_cast<const RingCall*>(call_ptr);
  const int n = call->n;
  if (n < 2 || n > kMaxRanks || call->n_launch < 1 || call->n_launch > n || call->block_vecs < 1 ||
      (call->n_launch > 1 && (call->n_ctas < 1 || call->n_ctas > call->flag_stride))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KernelArgs a;
  for (int r = 0; r < n; ++r) {
    a.x[r] = static_cast<const uint4*>(call->x[r]);
    a.out[r] = static_cast<uint4*>(call->out[r]);
    a.flags[r] = static_cast<unsigned*>(call->flags[r]);
    a.group[r] = call->group[r];
  }
  a.n = n;
  a.flag_stride = call->flag_stride;
  a.block_vecs = call->block_vecs;
  a.epoch = call->epoch;
  int prev = -1;
  cudaGetDevice(&prev);
  cudaError_t err = cudaSetDevice(call->devs[0]);
  if (call->n_launch == 1) {
    const long long per_cta = static_cast<long long>(kThreads) * kCopyVecs;
    const dim3 grid(static_cast<unsigned>((a.block_vecs + per_cta - 1) / per_cta), n);
    if (err == cudaSuccess) {
      ring_allgather_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(call->streams[0])>>>(a);
      err = cudaGetLastError();
    }
  } else {
    void* args[] = {&a};
    for (int l = 0, first = 0; l < call->n_launch && err == cudaSuccess; first += call->n_local[l], ++l) {
      if (call->n_local[l] < 1 || first + call->n_local[l] > n) {
        err = cudaErrorInvalidValue;
        break;
      }
      for (int i = 0; i < call->n_local[l]; ++i) a.ranks[i] = call->ranks[first + i];
      err = cudaSetDevice(call->devs[l]);
      if (err == cudaSuccess) {
        err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ring_allgather_oneshot_kernel),
                                          dim3(call->n_ctas, call->n_local[l]), dim3(kThreads), args, 0,
                                          static_cast<cudaStream_t>(call->streams[l]));
      }
      const cudaError_t last = cudaGetLastError();
      if (err == cudaSuccess) err = last;
    }
  }
  if (prev >= 0) cudaSetDevice(prev);
  return static_cast<int>(err);
}
