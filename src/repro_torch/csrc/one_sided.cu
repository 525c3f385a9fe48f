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
//     completion flag of that tensor (the TPU kernel's DMA semaphore).  It
//     is K3 with the identity for perm: both run one body.
// The signal word is an epoch counter: the caller passes a fresh epoch per
// put, so words and receive buffers are reused without a reset.  `arrive`
// counts the tiles of an entry that have landed; the block that lands the
// last of them resets it to 0.  Delivery is bitwise for any dtype, size and
// alignment.
//
// Bound on an H100: bytes — each byte is read once and written once, so
// 2 · bytes / 3.35 TB/s (0.0080 ms for the serve shape's 12.75 MiB).
//
// Design, for Hopper's asynchronous copies.
//   * A flat tile list over the whole put.  Each entry's 16-byte-aligned
//     body is cut into tiles of TILE bytes; Table.first holds each entry's
//     first tile (a prefix sum made on the host).  The grid is
//     min(tiles, BLOCKS_PER_SM x SMs) blocks and block b walks tiles b,
//     b + gridDim.x, ...: the grid follows the put's total bytes, not its
//     largest entry, so a small put still spreads over the SMs and uneven
//     entries leave no block idle.
//   * 1-D TMA bulk copies through shared memory.  Thread 0 alone moves the
//     bodies: cp.async.bulk loads tile k into stage k mod STAGES of a ring,
//     completing on that stage's mbarrier; once it lands, a bulk store
//     writes it to the destination as one bulk group, and the stage of the
//     previous tile is refilled as soon as its store has read it out.  So
//     up to STAGES tiles per block are in flight (BLOCKS_PER_SM x STAGES x
//     TILE bytes per SM, far above what Little's law asks of HBM), and no
//     register or thread sits on the bytes.  The other warps copy what the
//     bulk copies cannot: each entry's head up to 16-byte alignment and its
//     last nbytes mod 16 bytes, and whole entries whose source and
//     destination differ in alignment mod 16, in the widest words both
//     allow.  Every wait on a barrier traps after ~2^34 cycles
//     (mbarrier.cuh) instead of hanging the card.
//   * One arrival per tile batch.  Thread 0 counts the tiles the block
//     handled per entry in shared memory.  At the end it waits for its bulk
//     stores to complete (wait_group 0) and fences the async proxy's writes
//     for generic readers (fence.proxy.async.global); after the block's
//     barrier, one thread of warps 1-3 per touched entry (which read the
//     entry's destination and tile count while the tiles moved) adds the
//     count to arrive[entry] with one acquire-release atomic at gpu scope.
//     The add that completes the entry's tile count resets the word and
//     release-stores the epoch.  No thread fences per byte it copied, and
//     thread 0 starts its loads without waiting on the block's barrier.
// Across processes: the bulk store takes any global address, so dst may be
// a peer process's receive buffer mapped here over CUDA IPC, and signal its
// signal words (a process mesh, launch/procs.py; one launch per source
// rank, comm/kernel_backend.py deliver_procs).  The release-store of the
// signal is at system scope, so that the same body holds when the peer is
// another card; on one card, where every process's memory is the same
// card's, .gpu and .sys cannot be told apart.  Across cards over NVLink or
// InfiniBand it is unverified (ROADMAP Queue 1 item 8).
//
// signal_wait_on_stream / signal_write_on_stream: the stream side of the
// protocol, NVSHMEM's signal_wait_until_on_stream pattern.  The consumer's
// stream waits for a signal word (cuStreamWaitValue32, GEQ the epoch) and a
// sender's stream writes one behind its copies (cuStreamWriteValue32 with
// its default memory barrier).  Both are resolved through
// cudaGetDriverEntryPoint, so the library links no -lcuda.  The waits stay
// on the stream: a block spinning on a word would hold its time slice,
// while without MPS the processes' contexts on one card take turns.
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr int MAX_ENTRIES = 96;  // ranks x tensors of one launch
constexpr int THREADS = 128;     // thread 0: bulk copies; warps 1-3: the rest
constexpr int TILE = 16384;      // bytes of one tile, a multiple of 16
constexpr int STAGES = 4;        // tiles in one block's shared-memory ring
constexpr int BLOCKS_PER_SM = 2;
constexpr int SMEM = STAGES * TILE;  // dynamic shared memory of one block
static_assert(TILE % 16 == 0 && MAX_ENTRIES <= THREADS - 32,
              "tiles of whole 16-byte words, one arriving thread per entry");

struct Table {  // passed by value as a kernel parameter (< 4 KB)
  const void* src[MAX_ENTRIES];  // by source entry
  void* dst[MAX_ENTRIES];        // by destination entry
  long long nbytes[MAX_ENTRIES];
  int perm[MAX_ENTRIES];  // source rank -> destination rank (K4: identity)
  int first[MAX_ENTRIES + 1];  // entry e owns tiles first[e] .. first[e+1)-1
  int tensors;
  int entries;
};
static_assert(sizeof(Table) <= 4096, "a kernel parameter of at most 4 KB");

// Source entry e lands in destination entry to(e).
__host__ __device__ __forceinline__ int dest_of(const Table& t, int e) {
  return t.perm[e / t.tensors] * t.tensors + e % t.tensors;
}

// How an entry's bytes are cut: [0, head) and [head + body, nbytes) by the
// threads, [head, head + body) in bulk tiles — or, when source and
// destination differ mod 16, every byte by the threads (bulk = false).
struct Span {
  long long head, body;
  bool bulk;
};

__host__ __device__ __forceinline__ Span span_of(const void* src,
                                                 const void* dst, long long n) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (((s ^ d) & 15) != 0) return {0, n, false};
  long long head = static_cast<long long>((16 - (s & 15)) & 15);
  if (head > n) head = n;
  return {head, (n - head) & ~15LL, true};
}

__host__ __device__ __forceinline__ long long tiles_of(const Span& sp) {
  const long long t = (sp.body + TILE - 1) / TILE;
  return t < 1 ? 1 : t;  // an empty entry still takes one tile: its signal
}

// The entry holding tile j, searching upwards from entry e.
__device__ __forceinline__ int entry_at(const Table& t, int j, int e) {
  while (t.first[e + 1] <= j) ++e;
  return e;
}

struct Tile {
  const char* src;
  char* dst;
  long long off, len;  // bytes [off, off + len) of the entry
  Span sp;
};

__device__ __forceinline__ Tile tile_at(const Table& t, int j, int e) {
  Tile x;
  x.src = static_cast<const char*>(t.src[e]);
  x.dst = static_cast<char*>(t.dst[dest_of(t, e)]);
  x.sp = span_of(x.src, x.dst, t.nbytes[e]);
  const long long off = static_cast<long long>(j - t.first[e]) * TILE;
  const long long left = x.sp.body - off;
  x.off = x.sp.head + off;
  x.len = left < 0 ? 0 : (left < TILE ? left : TILE);
  return x;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// bytes [0, n) in words of W bytes where both pointers allow them, thread
// i0 of `step`
template <typename W>
__device__ __forceinline__ void copy_words(const char* __restrict__ s,
                                           char* __restrict__ d, long long n,
                                           int i0, int step) {
  const long long nw = n / static_cast<long long>(sizeof(W));
  const W* __restrict__ sw = reinterpret_cast<const W*>(s);
  W* __restrict__ dw = reinterpret_cast<W*>(d);
  for (long long i = i0; i < nw; i += step) dw[i] = sw[i];
  for (long long i = nw * sizeof(W) + i0; i < n; i += step) d[i] = s[i];
}

__device__ __forceinline__ void copy_bytes(const char* s, char* d,
                                           long long n, int i0, int step) {
  if (n <= 0) return;
  const uintptr_t a = reinterpret_cast<uintptr_t>(s) |
                      reinterpret_cast<uintptr_t>(d);
  if ((a & 7) == 0) return copy_words<unsigned long long>(s, d, n, i0, step);
  if ((a & 3) == 0) return copy_words<unsigned>(s, d, n, i0, step);
  if ((a & 1) == 0) return copy_words<unsigned short>(s, d, n, i0, step);
  copy_words<unsigned char>(s, d, n, i0, step);
}

// system scope: the word may lie in another process's (or card's) memory
__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// *p += v at gpu scope, releasing what this thread (and, through the
// block's barrier, its block) wrote before and acquiring what the adds
// before it released; returns the old value
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// The body of K3 and K4: this block's tiles, then its arrivals.
__device__ __forceinline__ void put_tiles(const Table& t, unsigned* signal,
                                          unsigned* arrive, unsigned epoch) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ int landed[MAX_ENTRIES];  // tiles of each entry this block moved
  const int tid = threadIdx.x, grid = gridDim.x;
  const int mine = (t.first[t.entries] - 1 - blockIdx.x) / grid + 1;
  // thread a = tid - 32 of warps 1-3 arrives for entry a: its destination
  // and tile count are read while the tiles move
  const int a = tid - 32;
  int to = 0;
  unsigned need = 0;
  if (a >= 0 && a < t.entries) {
    to = dest_of(t, a);
    need = static_cast<unsigned>(t.first[a + 1] - t.first[a]);
  }

  if (tid == 0) {
    // thread 0 alone touches the barriers and the counts until the
    // block's barrier below
    for (int e = 0; e < MAX_ENTRIES; ++e) landed[e] = 0;
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the bulk bodies: load tile k into stage k mod STAGES, store it once
    // it has landed, refill the stage of tile k - 1 once its store has
    // read it out
    const uint32_t ring0 = smem_u32(ring);
    int e_load = 0, e_store = 0;
    auto load = [&](int k) {
      const int j = blockIdx.x + k * grid;
      e_load = entry_at(t, j, e_load);
      ++landed[e_load];
      const Tile x = tile_at(t, j, e_load);
      const uint32_t bar = smem_u32(&full[k % STAGES]);
      if (x.sp.bulk && x.len > 0) {
        mbar_expect_tx(bar, static_cast<unsigned>(x.len));
        bulk_load(ring0 + (k % STAGES) * TILE, x.src + x.off,
                  static_cast<unsigned>(x.len), bar);
      } else {
        mbar_arrive(bar);  // nothing to load: the phase completes at once
      }
    };
    for (int k = 0; k < mine && k < STAGES; ++k) load(k);
    bool stored = false;  // whether tile k - 1 committed a bulk group
    for (int k = 0; k < mine; ++k) {
      const int j = blockIdx.x + k * grid;
      e_store = entry_at(t, j, e_store);
      const Tile x = tile_at(t, j, e_store);
      mbar_wait(smem_u32(&full[k % STAGES]), (k / STAGES) & 1);
      const bool stores = x.sp.bulk && x.len > 0;
      if (stores)
        bulk_store(x.dst + x.off, ring0 + (k % STAGES) * TILE,
                   static_cast<unsigned>(x.len));
      if (k >= 1 && k - 1 + STAGES < mine) {
        // tile k - 1's store must have read its stage: the newest group
        // (tile k's) may still be reading
        if (stores)
          asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        else if (stored)
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        load(k - 1 + STAGES);
      }
      stored = stores;
    }
    // every bulk write complete, then visible to the generic proxy
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    asm volatile("fence.proxy.async.global;" ::: "memory");
  } else if (tid >= 32) {
    // the bytes the bulk copies cannot move
    const int step = THREADS - 32;  // thread a of them
    int e = 0;
    for (int k = 0; k < mine; ++k) {
      const int j = blockIdx.x + k * grid;
      e = entry_at(t, j, e);
      const Tile x = tile_at(t, j, e);
      if (!x.sp.bulk) {  // the whole tile
        copy_bytes(x.src + x.off, x.dst + x.off, x.len, a, step);
        continue;
      }
      if (j == t.first[e]) copy_bytes(x.src, x.dst, x.sp.head, a, step);
      if (j == t.first[e + 1] - 1) {
        const long long end = x.sp.head + x.sp.body;
        copy_bytes(x.src + end, x.dst + end, t.nbytes[e] - end, a, step);
      }
    }
  }
  __syncthreads();

  // one arrival per (block, entry): the add that completes the entry's
  // tiles publishes its epoch
  if (need > 0 && landed[a] > 0) {
    const unsigned n = static_cast<unsigned>(landed[a]);
    if (add_acq_rel(arrive + to, n) + n == need) {
      arrive[to] = 0u;  // the release below orders it before the signal
      store_release(signal + to, epoch);
    }
  }
}

// K3: source entry e = r * tensors + i goes to rank perm[r]'s buffer i.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) remote_put_kernel(
    const __grid_constant__ Table t, unsigned* signal, unsigned* arrive,
    unsigned epoch) {
  put_tiles(t, signal, arrive, epoch);
}

// K4: received entry e lands in its delivered buffer e.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) landing_copy_kernel(
    const __grid_constant__ Table t, unsigned* signal, unsigned* arrive,
    unsigned epoch) {
  put_tiles(t, signal, arrive, epoch);
}

cudaError_t fill(Table& t, int ranks, int tensors, const void* const* src,
                 void* const* dst, const long long* nbytes, const int* perm,
                 unsigned& blocks) {
  const int entries = ranks * tensors;
  if (ranks <= 0 || tensors <= 0 || entries > MAX_ENTRIES)
    return cudaErrorInvalidValue;
  t.tensors = tensors;
  t.entries = entries;
  for (int r = 0; r < ranks; ++r) t.perm[r] = perm ? perm[r] : r;
  for (int e = 0; e < entries; ++e) {
    t.src[e] = src[e];
    t.dst[e] = dst[e];
    t.nbytes[e] = nbytes[e];
  }
  long long tiles = 0;
  for (int e = 0; e < entries; ++e) {
    t.first[e] = static_cast<int>(tiles);
    tiles += tiles_of(span_of(src[e], dst[dest_of(t, e)], nbytes[e]));
    if (tiles > INT_MAX) return cudaErrorInvalidValue;
  }
  t.first[entries] = static_cast<int>(tiles);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long most = static_cast<long long>(BLOCKS_PER_SM) * sms;
  blocks = static_cast<unsigned>(tiles < most ? tiles : most);
  return cudaSuccess;
}

// ``attr`` is the result of the kernel's one cudaFuncSetAttribute, made
// once per process by the caller, so that a launch inside a CUDA graph
// capture makes no call beside the launch itself.
cudaError_t launch(void (*kernel)(Table, unsigned*, unsigned*, unsigned),
                   cudaError_t attr, const Table& t, unsigned blocks,
                   unsigned* signal, unsigned* arrive, unsigned epoch,
                   void* stream) {
  if (attr != cudaSuccess) return attr;
  kernel<<<blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      t, signal, arrive, epoch);
  return cudaGetLastError();
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
  unsigned blocks = 0;
  cudaError_t err = fill(t, ranks, tensors, src, dst, nbytes, perm, blocks);
  if (err != cudaSuccess) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      remote_put_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  return launch(remote_put_kernel, attr, t, blocks, signal, arrive, epoch,
                stream);
}

// src[e] is a received tensor, dst[e] its delivered buffer, signal[e] its
// completion flag.
extern "C" int landing_copy(int ranks, int tensors, const void* const* src,
                            void* const* dst, const long long* nbytes,
                            unsigned* signal, unsigned* arrive, unsigned epoch,
                            void* stream) {
  Table t;
  unsigned blocks = 0;
  cudaError_t err = fill(t, ranks, tensors, src, dst, nbytes, nullptr, blocks);
  if (err != cudaSuccess) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      landing_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  return launch(landing_copy_kernel, attr, t, blocks, signal, arrive, epoch,
                stream);
}

extern "C" const char* one_sided_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

typedef CUresult (*StreamValue32)(CUstream, CUdeviceptr, cuuint32_t,
                                  unsigned int);

// A driver entry point of the CUDA 12 ABI, or null when the driver has none.
StreamValue32 driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<StreamValue32>(fn);
}

constexpr int NO_ENTRY = -1;  // the driver lacks the entry point

}  // namespace

// The stream waits until (int)(*word - value) >= 0: the epochs wrap as the
// kernels' do.  Returns a CUresult, or NO_ENTRY.
extern "C" int signal_wait_on_stream(const unsigned* word, unsigned value,
                                     void* stream) {
  static const StreamValue32 wait = driver_entry("cuStreamWaitValue32");
  if (wait == nullptr) return NO_ENTRY;
  return static_cast<int>(wait(static_cast<CUstream>(stream),
                               reinterpret_cast<CUdeviceptr>(word), value,
                               CU_STREAM_WAIT_VALUE_GEQ));
}

// *word = value once the stream's earlier work is done, behind a memory
// barrier (the default flags).  Returns a CUresult, or NO_ENTRY.
extern "C" int signal_write_on_stream(unsigned* word, unsigned value,
                                      void* stream) {
  static const StreamValue32 write = driver_entry("cuStreamWriteValue32");
  if (write == nullptr) return NO_ENTRY;
  return static_cast<int>(write(static_cast<CUstream>(stream),
                                reinterpret_cast<CUdeviceptr>(word), value,
                                CU_STREAM_WRITE_VALUE_DEFAULT));
}
