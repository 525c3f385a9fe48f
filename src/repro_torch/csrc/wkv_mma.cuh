// Device helpers shared by the WKV scan K5 (rwkv6_wkv.cu) and its gradient
// K5b (rwkv6_wkv_bwd.cu): typed tile reads, and float32 products on the
// tensor cores as mma.sync m16n8k8 TF32 with the 3×TF32 split.
//
// Fragments of m16n8k8 (g8 = lane / 4, tq = lane % 4): A (16 x 8, row
// major) a0 = A[g8][tq], a1 = A[g8+8][tq], a2 = A[g8][tq+4], a3 =
// A[g8+8][tq+4]; B (8 x 8, B[k][n]) b0 = B[tq][g8], b1 = B[tq+4][g8]; the
// accumulator d0 = D[g8][2tq], d1 = D[g8][2tq+1], d2 = D[g8+8][2tq], d3 =
// D[g8+8][2tq+1].  An accumulator tile is the A operand of a following
// product once the k index inside each 8-wide slab is permuted (k ↔ 2k,
// k+4 ↔ 2k+1): pass (d0, d2, d1, d3) as (a0, a1, a2, a3) and read B's rows
// 2tq and 2tq+1 as b0 and b1.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// element i of a tile of bfloat16 (BF) or float32 values
template <bool BF>
__device__ __forceinline__ float ld_as(const unsigned char* p, int i) {
  if constexpr (BF)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  else
    return reinterpret_cast<const float*>(p)[i];
}

// f(std::true_type{}) if bf, else f(std::false_type{}): one copy of a loop
// per input type, with no branch on the type inside it
template <class F>
__device__ __forceinline__ void on_type(bool bf, F&& f) {
  if (bf)
    f(std::true_type{});
  else
    f(std::false_type{});
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to 10 mantissa bits,
// ties away from zero), in two integer operations: sm_90 has no native
// form of that cvt, and the compiler's emulation of it takes a dozen
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a·b, m16n8k8, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[OFF + j] += a·b[j] for the first n of T column tiles, each operand
// split into TF32 hi and lo parts: 3 products (lo·hi', hi·lo', hi·hi'),
// or 2 when b is exact in TF32 (`exact`: a bfloat16 input; bl unused).
// Each product is issued for every tile before the next, so that no MMA
// waits on the one before it.
template <int OFF = 0, int T, int TD>
__device__ __forceinline__ void mma3(float (&d)[TD][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[T][2],
                                     const uint32_t (&bl)[T][2], bool exact,
                                     int n = T) {
  static_assert(OFF + T <= TD, "tiles");
#pragma unroll
  for (int j = 0; j < T; ++j)
    if (j < n) mma(d[OFF + j], al, bh[j]);
  if (!exact) {
#pragma unroll
    for (int j = 0; j < T; ++j)
      if (j < n) mma(d[OFF + j], ah, bl[j]);
  }
#pragma unroll
  for (int j = 0; j < T; ++j)
    if (j < n) mma(d[OFF + j], ah, bh[j]);
}

// b[j] = (b0, b1) as float32 values, split into hi and lo (or only hi where
// they are exact in TF32)
template <int T>
__device__ __forceinline__ void b_split(const float (&b)[T][2], bool exact,
                                        uint32_t (&bh)[T][2],
                                        uint32_t (&bl)[T][2]) {
#pragma unroll
  for (int j = 0; j < T; ++j) {
    if (exact) {
      bh[j][0] = __float_as_uint(b[j][0]);
      bh[j][1] = __float_as_uint(b[j][1]);
    } else {
      split(b[j][0], bh[j][0], bl[j][0]);
      split(b[j][1], bh[j][1], bl[j][1]);
    }
  }
}

// A fragment of a row-major tile at p (row g8, column tq; row stride ld),
// split into TF32 hi and lo parts
__device__ __forceinline__ void a_frag(const float* p, int ld, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split(p[0], ah[0], al[0]);
  split(p[8 * ld], ah[1], al[1]);
  split(p[4], ah[2], al[2]);
  split(p[8 * ld + 4], ah[3], al[3]);
}

}  // namespace
