// K3 remote_put and K4 landing_copy — the one-sided put of the port's comm
// layer, Hopper counterparts of the Pallas TPU kernels in
// src/repro/comm/pallas_backend.py (`_remote_put_kernel` /
// `_tpu_remote_put`, and `_landing_kernel` / `landing_copy`).
//
// What they compute.  A put moves n tensors from each of P ranks.  Entry
// e = r * n + i is tensor i of rank r.
//   * K3 (remote_put): NVSHMEM's putmem_signal over a whole route.  Entry e
//     is copied into the receive buffer of tensor i of rank perm[r]
//     (dst[perm[r] * n + i]); once all of its bytes have landed, the word
//     signal[perm[r] * n + i] is release-stored with the put's epoch.  The
//     TPU kernel started the remote copies of one rank and then waited
//     them; here one launch carries every rank's copies, and every copy is
//     issued (all blocks of the grid run their shares) before any signal.
//   * K4 (landing_copy): the receive side of the emulated put — the bytes
//     were already moved between rank buffers by the transport; entry e is
//     copied into its delivered buffer dst[e] and signal[e] is the
//     completion flag of that tensor (the TPU kernel's DMA semaphore).
// The signal word is an epoch counter: the caller passes a fresh epoch per
// put, so words and receive buffers are reused without a reset.  `arrive`
// counts the blocks that finished an entry; the last one resets it to 0.
//
// Bound on an H100: bytes — each byte is read once and written once, so
// 2 · bytes / 3.35 TB/s.  Design: grid (blocks per entry, entries), 256
// threads; 16-byte vector loads and stores where source and destination
// are 16-byte aligned, byte copies for the tail and for unaligned entries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ENTRIES = 96;  // ranks x tensors of one launch
constexpr int THREADS = 256;

struct Table {  // passed by value as a kernel parameter (< 4 KB)
  const void* src[MAX_ENTRIES];  // by source entry
  void* dst[MAX_ENTRIES];        // by destination entry
  long long nbytes[MAX_ENTRIES];
  int perm[MAX_ENTRIES];  // K3: source rank -> destination rank
  int tensors;
};

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// This block's strided share of one entry, then the arrival protocol: the
// last block of the entry publishes `epoch` in its signal word.
__device__ __forceinline__ void copy_share(const void* src, void* dst,
                                           long long nbytes, unsigned* signal,
                                           unsigned* arrive, unsigned epoch) {
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  long long head = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const long long n_vec = nbytes / 16;
    const uint4* s = static_cast<const uint4*>(src);
    uint4* d = static_cast<uint4*>(dst);
    for (long long i = tid; i < n_vec; i += step) d[i] = s[i];
    head = n_vec * 16;
  }
  const unsigned char* s8 = static_cast<const unsigned char*>(src);
  unsigned char* d8 = static_cast<unsigned char*>(dst);
  for (long long i = head + tid; i < nbytes; i += step) d8[i] = s8[i];
  __threadfence();  // this thread's bytes are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    if (atomicAdd(arrive, 1u) == gridDim.x - 1) {
      *arrive = 0u;
      __threadfence();
      store_release(signal, epoch);
    }
  }
}

// K3: source entry e = r * tensors + i goes to rank perm[r]'s buffer i.
__global__ void __launch_bounds__(THREADS) remote_put_kernel(
    const Table t, unsigned* signal, unsigned* arrive, unsigned epoch) {
  const int e = blockIdx.y;
  const int to = t.perm[e / t.tensors] * t.tensors + e % t.tensors;
  copy_share(t.src[e], t.dst[to], t.nbytes[e], signal + to, arrive + to,
             epoch);
}

// K4: received entry e lands in its delivered buffer e.
__global__ void __launch_bounds__(THREADS) landing_copy_kernel(
    const Table t, unsigned* signal, unsigned* arrive, unsigned epoch) {
  const int e = blockIdx.y;
  copy_share(t.src[e], t.dst[e], t.nbytes[e], signal + e, arrive + e, epoch);
}

cudaError_t fill(Table& t, int ranks, int tensors, const void* const* src,
                 void* const* dst, const long long* nbytes, const int* perm,
                 dim3& grid) {
  const int entries = ranks * tensors;
  if (ranks <= 0 || tensors <= 0 || entries > MAX_ENTRIES)
    return cudaErrorInvalidValue;
  t.tensors = tensors;
  long long most = 0;
  for (int e = 0; e < entries; ++e) {
    t.src[e] = src[e];
    t.dst[e] = dst[e];
    t.nbytes[e] = nbytes[e];
    if (nbytes[e] > most) most = nbytes[e];
  }
  for (int r = 0; r < ranks; ++r) t.perm[r] = perm ? perm[r] : r;
  // about 8 16-byte vectors per thread, at most 256 blocks per entry
  long long blocks = (most + THREADS * 16 * 8 - 1) / (THREADS * 16 * 8);
  if (blocks < 1) blocks = 1;
  if (blocks > 256) blocks = 256;
  grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(entries));
  return cudaSuccess;
}

}  // namespace

// Entry e = r * tensors + i.  src[e] is rank r's tensor i; dst[e] rank r's
// receive buffer i; perm[r] the destination rank of rank r (a permutation).
// signal / arrive hold ranks * tensors words each.  Returns a cudaError_t.
extern "C" int remote_put(int ranks, int tensors, const void* const* src,
                          void* const* dst, const long long* nbytes,
                          const int* perm, unsigned* signal, unsigned* arrive,
                          unsigned epoch, void* stream) {
  Table t;
  dim3 grid;
  cudaError_t err = fill(t, ranks, tensors, src, dst, nbytes, perm, grid);
  if (err != cudaSuccess) return err;
  remote_put_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, signal, arrive, epoch);
  return cudaGetLastError();
}

// src[e] is a received tensor, dst[e] its delivered buffer, signal[e] its
// completion flag.
extern "C" int landing_copy(int ranks, int tensors, const void* const* src,
                            void* const* dst, const long long* nbytes,
                            unsigned* signal, unsigned* arrive, unsigned epoch,
                            void* stream) {
  Table t;
  dim3 grid;
  cudaError_t err = fill(t, ranks, tensors, src, dst, nbytes, nullptr, grid);
  if (err != cudaSuccess) return err;
  landing_copy_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, signal, arrive, epoch);
  return cudaGetLastError();
}

extern "C" const char* one_sided_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
