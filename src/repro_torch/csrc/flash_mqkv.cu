// K1: flash_mqkv — the Hopper counterpart of the Pallas TPU kernel
// src/repro/kernels/flash_mqkv.py (`_kernel` / `flash_mqkv`).  The kernel
// body, its contract, bound and design notes are in flash_mqkv.cuh, which
// K2 (ring_flash.cu) instantiates too; this file is K1's C entry point.
#include "flash_mqkv.cuh"

// dtype: 0 = float32, 1 = bfloat16; (bq, bk, stages) is the bf16 body's
// tile plan.  Returns a cudaError_t (0 = launched).
extern "C" int flash_mqkv_fwd(const void* q, const void* k, const void* v,
                              const int* q_pos, const int* k_pos,
                              const float* o_in, const float* l_in,
                              const float* m_in, void* o, float* l, float* m,
                              int bh, int lq, int lk, int d, int group,
                              int dtype, float scale, int causal,
                              int has_window, int window, int has_state,
                              int finalize, int bq, int bk, int stages,
                              void* stream) {
  const Args a{q, k, v, q_pos, k_pos, o_in, l_in, m_in, o, l, m,
               bh, lq, lk, group, scale, causal, has_window, window,
               has_state, finalize, bq, bk, stages, Forward{},
               static_cast<cudaStream_t>(stream)};
  return launch_flash<false>(a, d, dtype);
}

// Dynamic shared memory of the bf16 body at head dim d and BQ rows.
extern "C" long long flash_mqkv_smem_bytes(int d, int bq) {
  return static_cast<long long>(hopper_smem(d, bq));
}

extern "C" const char* flash_mqkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
