// Ring all-gather over peer-mapped memory, written by hand for Hopper (sm_90a).
//
// Replaces beta_recsys_tpu/ops/pallas/ring_exchange.py:_ring_allgather_kernel
// (reached through ring_allgather), with its contract. Each of n ranks holds
// one block x_r of B bytes; every rank ends with out_r[s] = x_s for all s. Its
// order is the TPU kernel's: rank r writes its own block to out_r[r], then
// n-1 dependent hops follow; at hop i rank r forwards block (r - i) mod n to
// its right neighbour r+1. Each byte crosses each link of the ring once.
//
// Design. The TPU kernel moves each hop through a 2-slot VMEM buffer with a
// remote DMA and an ACK semaphore for slot reuse. Here a rank stores straight
// into its right neighbour's output through a peer pointer: every slot of
// every output is written exactly once, so no buffer and no ACK. What stays:
//   - the entry barrier (the TPU kernel's barrier semaphore). A peer's store
//     into out_{r+1} before rank r+1's stream reached this kernel could hit
//     memory that earlier work on r+1 still uses (the caching allocator orders
//     reuse only within a device's own stream). So each CTA of rank r first
//     tells its left neighbour "entered, epoch e", and waits for its right
//     neighbour's word before its first remote store;
//   - per-hop flags. Each CTA owns a fixed slice of a block's bytes, moved in
//     16-byte vectors (so the kernel takes any dtype). At hop i it waits for
//     its own flag (hop i-1 arrived from the left, epoch e), forwards its
//     slice, and raises the right neighbour's flag for hop i. Flags are per
//     CTA: a slice depends only on the same slice one hop back, so no
//     grid-wide barrier. A rank returns only after its last incoming flag, so
//     every incoming store is visible to later work on its stream.
// The flags are words the wrapper allocates once per rank and never resets:
// each call passes a new epoch (a call counter) and waits for flag >= epoch.
// Writer: stores, a fence, __syncthreads(), then one release store of the
// flag. Reader: an acquire load in a spin by one thread, then
// __syncthreads(). Across cards the fence, the release and the acquire are
// system-scope; when every rank is on one card, device-scope (kSys false),
// which keeps a hop's round trip inside the card's L2. A wait that lasts
// longer than kTimeoutNs traps, so a broken peer ends the process with an
// error instead of hanging the card.
//
// Launch. Across cards: one cooperative launch per device, on that device's
// stream, all from one C call, so nothing on the host waits between them (a
// rank spins from its launch until its neighbours' launches enter).
// All ranks on one card (loopback, as the one-card mesh of the trainer
// runs it): one launch whose grid covers every rank (blockIdx.y), running the
// same device function. Cooperative launches guarantee that every CTA a flag
// waits on is resident.
//
// What bounds it on the H100. Bytes: across cards each rank receives (n-1)*B
// bytes over NVLink (450 GB/s each way) and writes n*B to its HBM; in loopback
// the card reads n blocks and writes n*n (3.35 TB/s). At the MF path's blocks
// (n 4, C 200 x 64 float32: 51.2 KB) that is under half a microsecond either
// way, so the n-1 dependent flag hops (a round trip through L2 or NVLink
// each) and the launch set the pace, not the bytes.
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
constexpr unsigned long long kTimeoutNs = 20ull * 1000ull * 1000ull * 1000ull;

struct RingArgs {
  const uint4* x[kMaxRanks];  // each rank's block: block_vecs 16-byte vectors
  uint4* out[kMaxRanks];      // each rank's output: n blocks
  unsigned* flags[kMaxRanks]; // each rank's flags: n rows of flag_stride words
  int ranks[kMaxRanks];       // the ranks this launch runs, one per blockIdx.y
  int n;
  int flag_stride;            // row 0: entry; row 1 + i: hop i arrived
  long long block_vecs;
  unsigned epoch;
};

template <bool kSys>
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  if (kSys) {
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  } else {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  }
  return v;
}

template <bool kSys>
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  if (kSys) {
    asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  } else {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread spins until *flag reaches epoch (modulo 2^32), then the CTA syncs.
template <bool kSys>
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned epoch) {
  if (threadIdx.x == 0) {
    const unsigned long long start = global_ns();
    while (static_cast<int>(ld_acquire<kSys>(flag) - epoch) < 0) {
      if (global_ns() - start > kTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// Every thread's stores become visible to the reader before the flag does.
template <bool kSys>
__device__ __forceinline__ void raise_flag(unsigned* flag, unsigned epoch) {
  if (kSys) {
    __threadfence_system();
  } else {
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) st_release<kSys>(flag, epoch);
}

template <bool kSys>
__global__ void __launch_bounds__(kThreads) ring_allgather_kernel(const RingArgs a) {
  const int r = a.ranks[blockIdx.y];
  const int n = a.n;
  const int right = (r + 1) % n;
  const int left = (r + n - 1) % n;
  const int c = blockIdx.x;
  const long long per = (a.block_vecs + gridDim.x - 1) / gridDim.x;
  const long long lo = min(static_cast<long long>(c) * per, a.block_vecs);
  const long long hi = min(lo + per, a.block_vecs);
  const long long bv = a.block_vecs;
  unsigned* const mine_flags = a.flags[r];
  unsigned* const right_flags = a.flags[right];
  uint4* const mine = a.out[r];
  uint4* const theirs = a.out[right];

  // Entry barrier: the left neighbour may now store into out_r; wait until
  // the right neighbour lets this rank store into out_{r+1}.
  if (threadIdx.x == 0) st_release<kSys>(a.flags[left] + c, a.epoch);
  wait_flag<kSys>(mine_flags + c, a.epoch);

  // Hop 0: the own block, to out_r[r] and out_{r+1}[r].
  const uint4* const x = a.x[r];
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    const uint4 v = x[j];
    mine[r * bv + j] = v;
    theirs[r * bv + j] = v;
  }
  raise_flag<kSys>(right_flags + a.flag_stride + c, a.epoch);

  // Hops 1 .. n-2: forward block (r - i) mod n, which arrived at hop i-1.
  for (int i = 1; i < n - 1; ++i) {
    wait_flag<kSys>(mine_flags + i * a.flag_stride + c, a.epoch);
    const long long s = (r - i + n) % n;
    for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
      theirs[s * bv + j] = __ldcg(mine + s * bv + j);  // written by a peer: skip L1
    }
    raise_flag<kSys>(right_flags + (i + 1) * a.flag_stride + c, a.epoch);
  }
  // The last hop from the left brings block r + 1.
  wait_flag<kSys>(mine_flags + (n - 1) * a.flag_stride + c, a.epoch);
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

// How many CTAs of the kernel can be resident on device `dev` at once (the
// most a cooperative launch there may hold).
extern "C" int ring_resident_ctas(int dev, int* out) {
  DeviceGuard guard(dev);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  int per_sm = 0, per_sm_sys = 0, sms = 0, coop = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_allgather_kernel<false>, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_sys, ring_allgather_kernel<true>, kThreads, 0);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = coop ? (per_sm < per_sm_sys ? per_sm : per_sm_sys) * sms : 0;
  return static_cast<int>(cudaSuccess);
}

// One call of the ring: a launch on each of the n_launch devices `devs`, on
// its stream `streams[l]`, for the n_local[l] ranks that live there (their
// ids one after another in `ranks`), with nothing between the launches that
// waits on a device. x, out, flags: n pointers each (every rank's, wherever
// it lives); a rank's flags are n rows of flag_stride zero-initialised 32-bit
// words. Each grid is (n_ctas, n_local[l]); n_ctas <= flag_stride. block_vecs:
// 16-byte vectors a block. sys: the ranks span several cards (system-scope
// flags). Returns the first launch's error; a launch that fails leaves the
// ones before it to trap at their timeout.
extern "C" int ring_allgather(int n_launch, const int* devs, void* const* streams, const int* ranks,
                              const int* n_local, const void* const* x, void* const* out,
                              void* const* flags, int n, int n_ctas, int flag_stride,
                              long long block_vecs, unsigned epoch, int sys) {
  if (n < 2 || n > kMaxRanks || n_launch < 1 || n_launch > n || n_ctas < 1 ||
      n_ctas > flag_stride || block_vecs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs a;
  for (int r = 0; r < n; ++r) {
    a.x[r] = static_cast<const uint4*>(x[r]);
    a.out[r] = static_cast<uint4*>(out[r]);
    a.flags[r] = static_cast<unsigned*>(flags[r]);
  }
  a.n = n;
  a.flag_stride = flag_stride;
  a.block_vecs = block_vecs;
  a.epoch = epoch;
  const void* kernel = sys ? reinterpret_cast<const void*>(ring_allgather_kernel<true>)
                           : reinterpret_cast<const void*>(ring_allgather_kernel<false>);
  void* args[] = {&a};
  int prev = -1;
  cudaGetDevice(&prev);
  cudaError_t err = cudaSuccess;
  for (int l = 0, first = 0; l < n_launch && err == cudaSuccess; first += n_local[l], ++l) {
    if (n_local[l] < 1 || first + n_local[l] > n) {
      err = cudaErrorInvalidValue;
      break;
    }
    for (int i = 0; i < n_local[l]; ++i) a.ranks[i] = ranks[first + i];
    err = cudaSetDevice(devs[l]);
    if (err == cudaSuccess) {
      err = cudaLaunchCooperativeKernel(kernel, dim3(n_ctas, n_local[l]), dim3(kThreads), args, 0,
                                        static_cast<cudaStream_t>(streams[l]));
    }
    const cudaError_t last = cudaGetLastError();
    if (err == cudaSuccess) err = last;
  }
  if (prev >= 0) cudaSetDevice(prev);
  return static_cast<int>(err);
}
