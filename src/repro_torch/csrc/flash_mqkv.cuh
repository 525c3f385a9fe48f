// flash_mqkv: FlashAttention forward over position-masked, possibly
// discontiguous Q/KV chunks, with a carried online-softmax state — the
// Hopper (sm_90a) counterpart of the Pallas TPU kernel
// src/repro/kernels/flash_mqkv.py (`_kernel` / `flash_mqkv`).
//
// This header holds the one kernel body of two kernels: flash_mqkv.cu
// instantiates it as K1 (FWD = false) and ring_flash.cu as K2 (FWD = true,
// the fused ring step of src/repro/kernels/ring_flash.py).  With FWD the
// K and V tiles that a block loads for its attention are also stored into
// the forward buffers (the next ring rank's receive buffers), and the last
// forwarding block release-stores the put's completion word; the attention
// is the same code, so K2's (o, l, m) are K1's bit for bit.
//
// What it computes (identical contract to the TPU kernel):
//   q [BH, Lq, D], k/v [BH/group, Lk, D] (f32 or bf16, row-major), int32
//   positions q_pos [Lq], k_pos [Lk].  Key j is visible to query i iff
//   k_pos[j] >= 0 (-1 marks padding), and, when set, causal
//   q_pos[i] >= k_pos[j] and window k_pos[j] > q_pos[i] - window.
//   GQA: q head bh reads kv head bh / group (no KV repeat in memory).
//   Optional carried-in (O', l, m) state (f32); the state is updated over
//   every KV tile and, with `finalize`, O' / l is written (l == 0 guarded)
//   in q's dtype, else O' in f32.  Rows with no visible key give O' = 0,
//   l = 0, m = -inf: -inf maxima are replaced by 0 before exponentiation
//   and a -inf previous maximum gives a correction factor of 0, exactly
//   as the TPU kernel's safe_m / corr do.
//
// Bound on an H100: 4·BH·Lq·Lk·D operations against (q, k, v, o) bytes,
// i.e. ~Lk/2 FLOP per byte for bf16 at D = 128 — far above the ~295
// FLOP/byte ridge once Lk is in the thousands, so the tensor cores bound
// it (232.7 GFLOP -> 0.235 ms at BH 24, L 4352 on 989 TFLOP/s bf16).
//
// Design.  The TPU grid's sequential KV axis becomes a loop inside one
// block, and the running (m, l, O) state lives in registers for the whole
// loop, so nothing carries between blocks.  Ragged edges are masked from
// bounds: keys past Lk read as zeros and count as k_pos = -1.
//
// bf16 inputs (flash_hopper_kernel), the fast path, built for Hopper:
//   * Warp-specialised block of BQ query rows of one head: one producer
//     warp issues every load; BQ / 64 consumer warpgroups each own 64 rows.
//     The producer warp is the first of a warpgroup that gives its
//     registers to the consumers (setmaxnreg: 40 against 232 at BQ 128,
//     216 at BQ 64).
//     The tile plan (BQ 64 or 128, BK = BQ keys per KV tile, 2 stages) is
//     chosen by the wrapper (kernels/flash_mqkv.py: tile_plan): BQ 128 where
//     the grid of 128-row blocks fills the 132 SMs, else BQ 64 (one
//     warpgroup, twice the blocks, two blocks per SM).
//   * TMA loads.  Q once per block; K and V tiles through a ring of STAGES
//     shared-memory stages.  Tensor maps are 3-D over [heads, L, D] and
//     built on the host per launch (cuTensorMapEncodeTiled, reached through
//     the runtime's driver entry point: no link to libcuda), so the hardware
//     zero-fills the ragged end of each head.  Rows are swizzled in spans of
//     ROWB = min(2·D, 128) bytes; D 128 is two 64-column blocks.
//   * mbarriers, for K and V apart.  full_k[s] completes when stage s's K
//     bytes have landed (transaction count) and the 32 producer lanes have
//     written the tile's k positions, full_v[s] when its V bytes have; a K
//     stage is free again once every consumer warp has read its scores and
//     positions, a V stage once every warpgroup's P·V on it is done.  So
//     the next K tile loads a whole iteration before it is needed.  The
//     producer also records whether the tile holds a key with k_pos < 0, so
//     tiles without padding and without a causal or window mask skip the
//     mask.
//   * wgmma for both products.  S = Q·K^T is m64nBKk16 with both operands
//     read from shared memory through K-major descriptors; the softmax runs
//     on S's accumulator registers; P is packed to bf16 in registers (the
//     TPU kernel's p.astype(v.dtype)) and is the A operand of O += P·V,
//     m64nDk16, whose B operand V is read MN-major from the same tile
//     through the descriptor's transpose bit: no transposed copy of V.
//     Inside a warpgroup, tile kt's Q·K^T and softmax run while tile
//     kt-1's P·V is in flight; O is rescaled once that product is done, so
//     O sees the same operations in the same order as without the overlap.
//     At BQ 128 the two warpgroups also take turns to issue their products
//     (ping-pong on two named barriers), so that one's softmax runs under
//     the other's products.
//   * K2's forward.  The blocks of each KV head's first q head (bh % group
//     == 0) TMA-store the K and V tiles they loaded into k_dst / v_dst,
//     tile t by block t mod gridDim.x, so each stores about one tile and no
//     block's load pipeline waits on a chain of stores; the last of those
//     blocks to finish resets the arrive counter and release-stores the
//     epoch into the completion word.
//   * Grid (ceil(Lq / BQ), BH): the blocks of one head are adjacent in
//     launch order, so a head's K and V come from HBM once and from the L2
//     for its other blocks.
//   Not yet done: persistent blocks, and skipping KV tiles that a causal or
//   window mask hides entirely (ROADMAP Queue 2 item 1: a causal prefill
//   computes the whole L x L square, about twice the visible work).
// f32 inputs (flash_f32_kernel): both products in full f32 on the CUDA
//   cores (4 threads per query row), so f32 results match a float32
//   reference to summation order.  This is the parity path, not the fast
//   one; with FWD every block first copies a strided share of the chunk.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "mbarrier.cuh"
#include "tensor_map.cuh"

namespace {

// The forwarded chunk of a fused ring step (K2): k and v are copied whole
// into k_dst / v_dst.  `flag` (may be null) receives `epoch` once the
// whole chunk has landed; `arrive` counts finished forwarding blocks and
// is reset to 0 by the last one, so the pair is reused without a memset.
struct Forward {
  const uint4* k_src;
  const uint4* v_src;
  uint4* k_dst;
  uint4* v_dst;
  long long n_vec;  // 16-byte vectors per tensor
  unsigned* flag;
  unsigned* arrive;
  unsigned epoch;
};

// system scope: on a process mesh the word lies in the next ring rank's
// heap, another process's (or, across cards, another card's) memory; one
// card cannot tell .gpu from .sys
__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The last of `nblocks` arriving blocks publishes the completion word.
__device__ __forceinline__ void signal_done(const Forward& f,
                                            unsigned nblocks) {
  if (atomicAdd(f.arrive, 1u) == nblocks - 1) {
    *f.arrive = 0u;
    __threadfence();
    store_release(f.flag, f.epoch);
  }
}

// f32 path: each block copies its strided share before any attention
// work; the block that finishes last publishes the completion word.
__device__ __forceinline__ void forward_chunk(const Forward& f) {
  const unsigned nblocks = gridDim.x * gridDim.y;
  const long long b = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  const long long step = static_cast<long long>(nblocks) * blockDim.x;
  for (long long i = b * blockDim.x + threadIdx.x; i < f.n_vec; i += step) {
    f.k_dst[i] = f.k_src[i];
    f.v_dst[i] = f.v_src[i];
  }
  if (f.flag == nullptr) return;
  __threadfence();  // this thread's share is visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) signal_done(f, nblocks);
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int has_window, int window) {
  if (kp < 0) return false;
  if (causal && qp < kp) return false;
  if (has_window &&
      static_cast<long long>(kp) <=
          static_cast<long long>(qp) - static_cast<long long>(window))
    return false;
  return true;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: the Hopper body (TMA, mbarriers, wgmma)
// ---------------------------------------------------------------------------

template <int D, int BQ>
struct Hop {
  static constexpr int NWG = BQ / 64;  // consumer warpgroups, 64 rows each
  static constexpr int BK = BQ;        // keys per KV tile
  static constexpr int STAGES = 2;     // KV tiles in flight
  // + a producer warpgroup whose first warp loads: setmaxnreg moves its
  // registers to the consumers (at an even split D 128 spills)
  static constexpr int THREADS = NWG * 128 + 128;
  static constexpr int MIN_BLOCKS = BQ == 64 ? 2 : 1;  // blocks per SM
  static constexpr int PRODUCER_REGS = 40;
  // the rest of the SM's 65,536 registers, in steps of 8: 232 or 216
  static constexpr int CONSUMER_REGS =
      (65536 / MIN_BLOCKS / 128 - PRODUCER_REGS) / NWG / 8 * 8;
  static_assert(MIN_BLOCKS * 128 * (PRODUCER_REGS + NWG * CONSUMER_REGS) <= 65536,
                "registers of the SM");
  static constexpr int ROWB = D * 2 < 128 ? D * 2 : 128;  // swizzle span
  static constexpr int CB = D * 2 / ROWB;  // column blocks of ROWB bytes
  // wgmma descriptor layout code: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr int LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or one V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int KPOS_OFF = BAR_OFF + 8 * (4 * STAGES + 1);
  static constexpr int KPAD_OFF = KPOS_OFF + 4 * STAGES * BK;
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
  static constexpr size_t SMEM = 1024 + KPAD_OFF + 4 * STAGES;
  static_assert(SMEM <= 232448, "shared memory of one block on Hopper");
};

// The bf16 body's tensor maps, passed by value as a __grid_constant__
// parameter: q [BH, Lq, D], k and v [BHkv, Lk, D], and (K2) the forward
// buffers shaped like k and v.
struct Bf16Maps {
  CUtensorMap q, k, v, k_dst, v_dst;
};

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// shared-memory matrix descriptor of wgmma (address, leading and stride
// byte offsets, swizzle layout)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from touching accumulator registers across the
// asynchronous products (issued before, read after wgmma_wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma m64nNk16 with bf16 inputs and f32 accumulators (d: N / 2 registers
// a thread): ss for S = Q·K^T (N = BK), rs for O += P·V (N = D).  Thread t of the warpgroup holds rows 16·(t / 32) + (t % 32) / 4
// (+ 8) and, in n8 group j, columns 8j + 2·(t % 4) (+ 1): element 4j + e is
// row + 8·(e / 2), column 8j + 2·(t % 4) + e % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // D[64 x 16] += A[64 x 16] * B[16 x 16], A from registers, B MN-major in
  // shared memory (the descriptor's transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // D[64 x 32] += A[64 x 16] * B[16 x 32], A from registers, B MN-major in
  // shared memory (the descriptor's transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared
  // memory (descriptors); scale_d 0 starts the sum at zero
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers, B MN-major in
  // shared memory (the descriptor's transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B K-major in shared
  // memory (descriptors); scale_d 0 starts the sum at zero
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers, B MN-major in
  // shared memory (the descriptor's transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <int D, int BQ, bool FWD>
__global__ void __launch_bounds__(Hop<D, BQ>::THREADS, Hop<D, BQ>::MIN_BLOCKS)
    flash_hopper_kernel(const __grid_constant__ Bf16Maps maps,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos,
                        const float* __restrict__ o_in,
                        const float* __restrict__ l_in,
                        const float* __restrict__ m_in,
                        void* __restrict__ o_out, float* __restrict__ l_out,
                        float* __restrict__ m_out, int lq, int lk, int group,
                        float scale, int causal, int has_window, int window,
                        int has_state, int finalize, Forward fwd) {
  using T = Hop<D, BQ>;
  constexpr int BK = T::BK, S = T::STAGES, ROWB = T::ROWB;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + T::Q_BYTES;        // stage s at + s · KV_BYTES
  const uint32_t sV = sK + S * T::KV_BYTES;
  // mbarriers: K and V of each stage apart, so that a K tile is released
  // as soon as its scores are out and the next one can load a whole
  // iteration ahead; then the Q tile's
  const uint32_t bar = base + T::BAR_OFF;
  auto full_k = [&](int s) { return bar + 8u * s; };
  auto full_v = [&](int s) { return bar + 8u * (S + s); };
  auto empty_k = [&](int s) { return bar + 8u * (2 * S + s); };
  auto empty_v = [&](int s) { return bar + 8u * (3 * S + s); };
  const uint32_t qbar = bar + 8u * (4 * S);
  int* const kps = reinterpret_cast<int*>(sm + T::KPOS_OFF);   // [S][BK]
  int* const kpad = reinterpret_cast<int*>(sm + T::KPAD_OFF);  // [S]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, kvh = bh / group;
  const int nk = (lk + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 32);           // the producer warp's lanes
      mbar_init(full_v(s), 1);            // its first lane
      mbar_init(empty_k(s), 4 * T::NWG);  // every consumer warp
      mbar_init(empty_v(s), T::NWG);      // every consumer warpgroup
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= T::NWG * 128) {
    // ---- producer warp: Q once, then K, V and k positions per tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(T::PRODUCER_REGS));
    if (tid >= T::NWG * 128 + 32) return;  // the warpgroup's idle warps
    const int lane = tid & 31;
    // K2: the blocks of a KV head's first q head store its tiles in turn,
    // tile t by block t mod gridDim.x, so no block's loads wait on stores
    const int nfwd = max(1, min(static_cast<int>(gridDim.x), nk));
    const bool forwards = FWD && bh % group == 0 && blockIdx.x < nfwd;
    auto mine = [&](int t) { return t % gridDim.x == blockIdx.x; };
    if (lane == 0) {
      mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CB; ++c)
        tma_load(sQ + c * BQ * ROWB, &maps.q, qbar, c * ROWB / 2, q0, bh);
    }
    // K2: store tile t from the stage it sits in once it has landed
    auto store_tile = [&](int t) {
      const int s = t % S;
      mbar_wait(full_k(s), (t / S) & 1);
      mbar_wait(full_v(s), (t / S) & 1);
#pragma unroll
      for (int c = 0; c < T::CB; ++c) {
        const uint32_t off = s * T::KV_BYTES + c * BK * ROWB;
        tma_store(&maps.k_dst, sK + off, c * ROWB / 2, t * BK, kvh);
        tma_store(&maps.v_dst, sV + off, c * ROWB / 2, t * BK, kvh);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    };
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S, k0 = kt * BK;
      const unsigned free_phase = ((kt / S) & 1) ^ 1;
      mbar_wait(empty_k(s), free_phase);
      bool pad = false;
#pragma unroll
      for (int j = lane; j < BK; j += 32) {
        const int kp = (k0 + j < lk) ? k_pos[k0 + j] : -1;
        kps[s * BK + j] = kp;
        pad |= kp < 0;
      }
      pad = __any_sync(0xffffffffu, pad);
      if (lane != 0) {
        mbar_arrive(full_k(s));
        continue;
      }
      kpad[s] = pad;
      // the stage's previous tile must have been read out by its store
      if (forwards && kt >= S)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      mbar_expect_tx(full_k(s), T::KV_BYTES);
#pragma unroll
      for (int c = 0; c < T::CB; ++c)
        tma_load(sK + s * T::KV_BYTES + c * BK * ROWB, &maps.k, full_k(s),
                 c * ROWB / 2, k0, kvh);
      mbar_wait(empty_v(s), free_phase);
      mbar_expect_tx(full_v(s), T::KV_BYTES);
#pragma unroll
      for (int c = 0; c < T::CB; ++c)
        tma_load(sV + s * T::KV_BYTES + c * BK * ROWB, &maps.v, full_v(s),
                 c * ROWB / 2, k0, kvh);
      if (forwards && kt >= 1 && mine(kt - 1)) store_tile(kt - 1);
    }
    if (forwards && lane == 0) {
      if (nk >= 1 && mine(nk - 1)) store_tile(nk - 1);
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      if (fwd.flag != nullptr) {
        // the chunk's writes (async proxy) before the generic release
        asm volatile("fence.proxy.async.global;" ::: "memory");
        __threadfence();
        signal_done(fwd, gridDim.y / group * nfwd);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::CONSUMER_REGS));
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = q0 + wg * 64 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const size_t qrow0 = static_cast<size_t>(bh) * lq;

  float acc[D / 2];  // O: element 4·dt + e is row r0 + 8·(e / 2), column
                     // 8·dt + 2·tig + e % 2
  float m_run[2], l_run[2];
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const bool in = row < lq;
    qp[h] = in ? q_pos[row] : 0;
    m_run[h] = (has_state && in) ? m_in[qrow0 + row] : -INFINITY;
    // l is kept as per-thread partial sums, reduced over the quad at the end
    l_run[h] = (has_state && in && tig == 0) ? l_in[qrow0 + row] : 0.f;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dt * 8 + 2 * tig + e;
        acc[4 * dt + 2 * h + e] =
            (has_state && in) ? o_in[(qrow0 + row) * D + col] : 0.f;
      }
    }
  }
  const bool masks = causal || has_window;

  // K-major operands (Q rows, K rows): 8-row groups ROWB · 8 bytes apart; a
  // k16 step is 32 bytes into the row, or the next column block
  const uint64_t dq = gmma_desc(sQ + wg * 64 * ROWB, 16, 8 * ROWB, T::LAYOUT);
  const uint64_t dk = gmma_desc(sK, 16, 8 * ROWB, T::LAYOUT);
  // V as an MN-major operand: column blocks BK · ROWB bytes apart (leading
  // offset), 8-key groups ROWB · 8 bytes apart; a k16 step is 16 rows
  const uint64_t dv = gmma_desc(sV, BK * ROWB, 8 * ROWB, T::LAYOUT);
  auto kstep = [](int kk, int rows) -> uint64_t {  // in 16-byte units
    return static_cast<uint64_t>(((kk * 32) / ROWB) * rows * ROWB / 16 +
                                 ((kk * 32) % ROWB) / 16);
  };

  float sc[BK / 2];         // S of the newest tile, then its p in place
  uint32_t pf[BK / 16][4];  // P in bf16: the A fragments of P·V
  // S = Q·K^T of the tile in stage s (issued, not waited)
  auto issue_qk = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK>::ss(sc, dq + kstep(kk, BQ),
                    dk + s * (T::KV_BYTES / 16) + kstep(kk, BK), kk > 0);
    wgmma_commit();
  };
  // O += P·V of the tile in stage s (issued, not waited)
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D>::rs(acc, pf[kk],
                   dv + s * (T::KV_BYTES / 16) + kk * 16 * ROWB / 16);
    wgmma_commit();
  };
  // the online softmax of the scores in sc (stage s): masks, new maxima,
  // corr, l; leaves p = exp(x - m) in sc.  Releases the K stage once its
  // positions are read.
  auto softmax = [&](int s, float (&corr)[2]) {
    float mx[2] = {-INFINITY, -INFINITY};
    float to_log2 = LOG2E;  // turns sc into base-2 exponents
    if (masks || kpad[s] || !(scale > 0.f)) {  // uniform: masks or padding
      const int* kp_tile = kps + s * BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int2 kp = *reinterpret_cast<const int2*>(kp_tile + j * 8 + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = sc[4 * j + e] * scale;
          if (!visible(qp[h], (e & 1) ? kp.y : kp.x, causal, has_window,
                       window))
            x = -INFINITY;
          sc[4 * j + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    } else {
      // every key visible: the maxima of the raw scores, scaled after (the
      // same values, as rounding is monotone for a positive scale), and
      // the scale folded into the exponent's multiply-add
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      mx[0] *= scale;
      mx[1] *= scale;
      to_log2 = scale * LOG2E;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_k(s));
    float neg[2];  // -safe_m · log2(e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      corr[h] = (m_run[h] == -INFINITY) ? 0.f : ex2((m_run[h] - safe) * LOG2E);
      m_run[h] = m_new;
      l_run[h] *= corr[h];
      neg[h] = -safe * LOG2E;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], to_log2, neg[h]));  // 0 at -inf
      l_run[h] += sc[i];
    }
  };
  // P to bf16 (the TPU kernel's p.astype(v.dtype)), and O rescaled to the
  // new maxima, once the previous P·V has completed
  auto pack_and_rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      pf[j / 2][2 * (j & 1)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pf[j / 2][2 * (j & 1) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
    // a warp whose maxima all stayed put skips the (exact) product by 1
    if (__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) return;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[4 * dt] *= corr[0];
      acc[4 * dt + 1] *= corr[0];
      acc[4 * dt + 2] *= corr[1];
      acc[4 * dt + 3] *= corr[1];
    }
  };
  // BQ 128: the two warpgroups take turns to issue their products (named
  // barriers 1 and 2), so that one's softmax runs under the other's
  // products.  Warpgroup 1 lets warpgroup 0 go first and, to leave both
  // barriers balanced, does not pass the turn back after its last issue.
  auto my_turn = [&]() {
    if constexpr (T::NWG == 2) asm volatile("bar.sync %0, 256;" ::"r"(1 + wg));
  };
  auto your_turn = [&](bool last) {
    if constexpr (T::NWG == 2) {
      if (wg == 0 || !last) asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg));
    }
  };

  // Tile kt's scores and softmax run while tile kt-1's P·V is in flight:
  // the products on O keep the order O·corr_kt + P_kt·V_kt of a loop
  // without the overlap.
  mbar_wait(qbar, 0);
  if (nk > 0) {
    if (wg == 1) your_turn(false);
    mbar_wait(full_k(0), 0);
    my_turn();
    wgmma_fence();
    issue_qk(0);
    your_turn(false);
    wgmma_wait<0>();
    fence_regs(sc);
    float corr[2];
    softmax(0, corr);
    pack_and_rescale(corr);
  }
  for (int kt = 1; kt < nk; ++kt) {
    const int s = kt % S, sp = (kt - 1) % S;
    mbar_wait(full_k(s), (kt / S) & 1);
    mbar_wait(full_v(sp), ((kt - 1) / S) & 1);
    my_turn();
    wgmma_fence();
    issue_qk(s);
    issue_pv(sp);
    your_turn(false);
    wgmma_wait<1>();  // the scores; P·V may still run
    fence_regs(sc);
    float corr[2];
    softmax(s, corr);
    fence_regs(sc);  // the exponentials stay ahead of the wait
    fence_regs(l_run);
    wgmma_wait<0>();
    fence_regs(acc);
    if ((tid & 127) == 0) mbar_arrive(empty_v(sp));
    pack_and_rescale(corr);
  }
  if (nk > 0) {
    const int sp = (nk - 1) % S;
    mbar_wait(full_v(sp), ((nk - 1) / S) & 1);
    my_turn();
    wgmma_fence();
    issue_pv(sp);
    your_turn(true);
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = quad_sum(l_run[h]);
    const int row = r0 + 8 * h;
    if (row >= lq) continue;
    const float inv = (finalize && l != 0.f) ? 1.f / l : 1.f;
    const size_t rbase = (qrow0 + row) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * tig;
      const float x0 = acc[4 * dt + 2 * h] * inv;
      const float x1 = acc[4 * dt + 2 * h + 1] * inv;
      if (finalize) {
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(o_out) + rbase + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(o_out) + rbase + col) =
            make_float2(x0, x1);
      }
    }
    if (tig == 0) {
      l_out[qrow0 + row] = l;
      m_out[qrow0 + row] = m_run[h];
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core path (parity)
// ---------------------------------------------------------------------------

template <int D>
struct F32Tile {
  static constexpr int BQ = 32;       // query rows per block, 4 threads each
  static constexpr int BK = 32;       // keys per KV tile
  static constexpr int THREADS = 128;
  static constexpr int QS = D + 1;    // padded strides: no bank conflicts
  static constexpr int KS = D + 1;
  static constexpr int VS = D;
  static constexpr int PS = BK + 1;
  static constexpr size_t SMEM =
      static_cast<size_t>(BQ * QS + BK * KS + BK * VS + BQ * PS + BK) * 4;
};

template <int D, bool FWD>
__global__ void __launch_bounds__(128) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, const float* __restrict__ o_in,
    const float* __restrict__ l_in, const float* __restrict__ m_in,
    float* __restrict__ o_out, float* __restrict__ l_out,
    float* __restrict__ m_out, int lq, int lk, int group, float scale,
    int causal, int has_window, int window, int has_state, int finalize,
    Forward fwd) {
  if constexpr (FWD) forward_chunk(fwd);
  using T = F32Tile<D>;
  constexpr int NK = T::BK / 4;  // keys per thread per tile
  constexpr int NC = D / 4;      // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + T::BQ * T::QS;
  float* Vs = Ks + T::BK * T::KS;
  float* Ps = Vs + T::BK * T::VS;
  int* kps = reinterpret_cast<int*>(Ps + T::BQ * T::PS);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * T::BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;  // row of the tile, lane in its quad
  const int row = q0 + r;
  const bool in = row < lq;
  const size_t qrow0 = static_cast<size_t>(bh) * lq;
  const float* qb = q + qrow0 * D;
  const float* kb = k + static_cast<size_t>(bh / group) * lk * D;
  const float* vb = v + static_cast<size_t>(bh / group) * lk * D;

  for (int idx = tid; idx < T::BQ * D; idx += T::THREADS) {
    const int rr = idx / D, dd = idx % D;
    Qs[rr * T::QS + dd] = (q0 + rr < lq) ? qb[static_cast<size_t>(q0 + rr) * D + dd] : 0.f;
  }
  const int qp = in ? q_pos[row] : 0;
  float m_run = (has_state && in) ? m_in[qrow0 + row] : -INFINITY;
  float l_run = (has_state && in) ? l_in[qrow0 + row] : 0.f;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i)
    acc[i] = (has_state && in) ? o_in[(qrow0 + row) * D + c + 4 * i] : 0.f;

  const int nk = (lk + T::BK - 1) / T::BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * T::BK;
    __syncthreads();
    for (int idx = tid; idx < T::BK * D; idx += T::THREADS) {
      const int j = idx / D, dd = idx % D;
      const bool ok = k0 + j < lk;
      const size_t off = static_cast<size_t>(k0 + j) * D + dd;
      Ks[j * T::KS + dd] = ok ? kb[off] : 0.f;
      Vs[j * T::VS + dd] = ok ? vb[off] : 0.f;
    }
    for (int idx = tid; idx < T::BK; idx += T::THREADS)
      kps[idx] = (k0 + idx < lk) ? k_pos[k0 + idx] : -1;
    __syncthreads();

    float s[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float qv = Qs[r * T::QS + dd];
#pragma unroll
      for (int i = 0; i < NK; ++i) s[i] = fmaf(qv, Ks[(c + 4 * i) * T::KS + dd], s[i]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      float x = s[i] * scale;
      if (!visible(qp, kps[c + 4 * i], causal, has_window, window)) x = -INFINITY;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m_run, quad_max(mx));
    const float safe = (m_new == -INFINITY) ? 0.f : m_new;
    const float corr = (m_run == -INFINITY) ? 0.f : expf(m_run - safe);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const float p = (s[i] == -INFINITY) ? 0.f : expf(s[i] - safe);
      Ps[r * T::PS + c + 4 * i] = p;
      psum += p;
    }
    l_run = l_run * corr + quad_sum(psum);
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= corr;
    __syncwarp();  // a row's P is written and read by its own quad
    for (int j = 0; j < T::BK; ++j) {
      const float p = Ps[r * T::PS + j];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = fmaf(p, Vs[j * T::VS + c + 4 * i], acc[i]);
    }
  }

  if (!in) return;
  const float div = (finalize && l_run != 0.f) ? l_run : 1.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) o_out[(qrow0 + row) * D + c + 4 * i] = acc[i] / div;
  if (c == 0) {
    l_out[qrow0 + row] = l_run;
    m_out[qrow0 + row] = m_run;
  }
}

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *k_pos;
  const float *o_in, *l_in, *m_in;
  void* o;
  float *l, *m;
  int bh, lq, lk, group;
  float scale;
  int causal, has_window, window, has_state, finalize;
  int bq, bk, stages;  // the bf16 body's tile plan (kernels/flash_mqkv.py)
  Forward fwd;  // read only by the FWD instantiations
  cudaStream_t stream;
};

// A tensor map over a row-major bf16 [heads, rows, d] tensor whose box is
// `box_rows` rows of one column block of `rowb` bytes, swizzled over
// `rowb` bytes; rows past `rows` read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int rows,
                int heads, int box_rows, int rowb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(rowb / 2),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      rowb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : rowb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BQ, bool FWD>
cudaError_t launch_hopper(const Args& a) {
  using T = Hop<D, BQ>;
  Bf16Maps maps;
  memset(&maps, 0, sizeof(maps));
  const int bhkv = a.bh / a.group;
  bool ok = tensor_map(&maps.q, a.q, D, a.lq, a.bh, BQ, T::ROWB);
  if (a.lk > 0) {  // no KV tile is loaded otherwise
    ok = ok && tensor_map(&maps.k, a.k, D, a.lk, bhkv, T::BK, T::ROWB) &&
         tensor_map(&maps.v, a.v, D, a.lk, bhkv, T::BK, T::ROWB);
    if (FWD)
      ok = ok &&
           tensor_map(&maps.k_dst, a.fwd.k_dst, D, a.lk, bhkv, T::BK, T::ROWB) &&
           tensor_map(&maps.v_dst, a.fwd.v_dst, D, a.lk, bhkv, T::BK, T::ROWB);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kern = flash_hopper_kernel<D, BQ, FWD>;
  // once per instantiation: a launch inside a CUDA graph capture then
  // makes no call beside the launch itself
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.lq + BQ - 1) / BQ, a.bh);
  kern<<<grid, T::THREADS, T::SMEM, a.stream>>>(
      maps, a.q_pos, a.k_pos, a.o_in, a.l_in, a.m_in, a.o, a.l, a.m, a.lq,
      a.lk, a.group, a.scale, a.causal, a.has_window, a.window, a.has_state,
      a.finalize, a.fwd);
  return cudaGetLastError();
}

template <int D, bool FWD>
cudaError_t launch_bf16(const Args& a) {
  // the plan must name an instantiation: BK = BQ, Hop's stage count
  if (a.bk != a.bq || a.stages != Hop<D, 64>::STAGES) return cudaErrorInvalidValue;
  if (a.bq == 64) return launch_hopper<D, 64, FWD>(a);
  if (a.bq == 128) return launch_hopper<D, 128, FWD>(a);
  return cudaErrorInvalidValue;
}

template <int D, bool FWD>
cudaError_t launch_f32(const Args& a) {
  using T = F32Tile<D>;
  auto kern = flash_f32_kernel<D, FWD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.bh, (a.lq + T::BQ - 1) / T::BQ);
  kern<<<grid, T::THREADS, T::SMEM, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.q_pos, a.k_pos, a.o_in, a.l_in, a.m_in,
      static_cast<float*>(a.o), a.l, a.m, a.lq, a.lk, a.group, a.scale,
      a.causal, a.has_window, a.window, a.has_state, a.finalize, a.fwd);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
template <bool FWD>
cudaError_t launch_flash(const Args& a, int d, int dtype) {
  if (a.bh <= 0 || a.lq <= 0) return cudaSuccess;
  if (dtype == 1) {
    switch (d) {
      case 16: return launch_bf16<16, FWD>(a);
      case 32: return launch_bf16<32, FWD>(a);
      case 64: return launch_bf16<64, FWD>(a);
      case 128: return launch_bf16<128, FWD>(a);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16, FWD>(a);
      case 32: return launch_f32<32, FWD>(a);
      case 64: return launch_f32<64, FWD>(a);
      case 128: return launch_f32<128, FWD>(a);
    }
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 body for a head dim and BQ (0 if
// there is no such instantiation): what kernels/flash_mqkv.py's
// smem_bytes must equal.
size_t hopper_smem(int d, int bq) {
#define HOP_SMEM(D_)                                         \
  if (d == D_) return bq == 64 ? Hop<D_, 64>::SMEM           \
                    : bq == 128 ? Hop<D_, 128>::SMEM : 0;
  HOP_SMEM(16) HOP_SMEM(32) HOP_SMEM(64) HOP_SMEM(128)
#undef HOP_SMEM
  return 0;
}

}  // namespace
