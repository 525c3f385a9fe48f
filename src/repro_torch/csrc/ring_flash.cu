// K2: ring_flash_step — the fused ring step, Hopper counterpart of the
// Pallas TPU kernel src/repro/kernels/ring_flash.py (`_ring_kernel` /
// `ring_flash_step`).
//
// What it computes: K1's (o, l, m) on the current KV chunk, from K1's own
// kernel body (flash_mqkv.cuh, instantiated with FWD = true), plus a copy
// of the whole K and V chunk into k_dst / v_dst.  On the TPU the copy was
// a local DMA into a staging buffer and the hop a separate ppermute; here
// k_dst / v_dst are the next ring rank's receive buffers, so the copy IS
// the one-sided put.  In the bf16 body the blocks of each KV head's first
// q head store the K and V tiles they have loaded for their own attention
// (TMA stores from shared memory, tile t by block t mod gridDim.x), so the
// chunk is read from device memory once for both uses; the last of those
// blocks release-stores `epoch` into the put's completion word (`flag`),
// after a device-wide fence.  The f32 body copies the chunk in a prologue
// shared by every block.
//
// Bound on an H100: K1's 4·BH·Lq·Lk·D operations plus reading and writing
// the chunk (2 · 2 · BHkv·Lk·D elements).  At the ring shapes (BH 6, Lk a
// few hundred) neither is large: the bytes bound it, and launch and
// pipeline fill dominate the time.
#include "flash_mqkv.cuh"

// dtype: 0 = float32, 1 = bfloat16.  k, v, k_dst, v_dst are 16-byte
// aligned, contiguous, of `n_vec` 16-byte vectors each.  `flag` may be
// null (no completion word); `arrive` must then be null too.
extern "C" int ring_flash_fwd(const void* q, const void* k, const void* v,
                              const int* q_pos, const int* k_pos,
                              const float* o_in, const float* l_in,
                              const float* m_in, void* o, float* l, float* m,
                              int bh, int lq, int lk, int d, int group,
                              int dtype, float scale, int causal,
                              int has_window, int window, int has_state,
                              int finalize, int bq, int bk, int stages,
                              void* k_dst, void* v_dst,
                              long long n_vec, unsigned* flag,
                              unsigned* arrive, unsigned epoch,
                              void* stream) {
  if (bh <= 0 || lq <= 0) return cudaErrorInvalidValue;  // nothing would copy
  const Forward fwd{static_cast<const uint4*>(k), static_cast<const uint4*>(v),
                    static_cast<uint4*>(k_dst), static_cast<uint4*>(v_dst),
                    n_vec, flag, arrive, epoch};
  const Args a{q, k, v, q_pos, k_pos, o_in, l_in, m_in, o, l, m,
               bh, lq, lk, group, scale, causal, has_window, window,
               has_state, finalize, bq, bk, stages, fwd,
               static_cast<cudaStream_t>(stream)};
  return launch_flash<true>(a, d, dtype);
}

extern "C" const char* ring_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
