// flash_mqkv: FlashAttention-2 forward over position-masked, possibly
// discontiguous Q/KV chunks, with a carried online-softmax state — the
// Hopper (sm_90a) counterpart of the Pallas TPU kernel
// src/repro/kernels/flash_mqkv.py (`_kernel` / `flash_mqkv`).
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
// Design: the TPU grid's sequential KV axis becomes a loop inside one
// block; the grid is (BH, ceil(Lq / BQ)) and the running (m, l, acc) state
// lives in registers for the whole loop, so nothing carries between
// blocks.  Ragged edges are masked from bounds (out-of-range keys are
// zero-filled and treated as k_pos = -1).
//   * bf16 inputs: 4 warps x 16 query rows; QK^T and PV are
//     mma.sync.m16n8k16 bf16 products with f32 accumulators.  The S
//     accumulator fragments are re-packed in registers as the A operand of
//     PV (P is rounded to bf16 for that product, as the TPU kernel's
//     p.astype(v.dtype) does for bf16 storage); V is stored transposed in
//     shared memory so both B operands are 32-bit shared loads.
//   * f32 inputs: both products in full f32 on the CUDA cores (4 threads
//     per query row), so f32 results match a float32 reference to
//     summation order.  This is the parity path, not the fast one.
// Not yet done (later work): cp.async/TMA double buffering, ldmatrix, and
// wgmma — this version loads each tile synchronously.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
// bf16: tensor-core path
// ---------------------------------------------------------------------------

template <int D>
struct Bf16Tile {
  static constexpr int BQ = 64;       // query rows per block (4 warps x 16)
  static constexpr int BK = 64;       // keys per KV tile
  static constexpr int THREADS = 128;
  static constexpr int QS = D + 8;    // Qs/Ks row stride (bf16): no bank conflicts
  static constexpr int VS = BK + 8;   // Vt row stride (bf16)
  static constexpr size_t SMEM =
      static_cast<size_t>(BQ * QS + BK * QS + D * VS) * 2 + BK * 4;
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(128) flash_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, const float* __restrict__ o_in,
    const float* __restrict__ l_in, const float* __restrict__ m_in,
    void* __restrict__ o_out, float* __restrict__ l_out,
    float* __restrict__ m_out, int lq, int lk, int group, float scale,
    int causal, int has_window, int window, int has_state, int finalize) {
  using T = Bf16Tile<D>;
  constexpr int VEC = 8;  // bf16 per 16-byte vector
  constexpr int RVEC = D / VEC;
  constexpr int NT = T::BK / 8;  // n8 tiles of S per warp
  constexpr int DT = D / 8;      // n8 tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + T::BQ * T::QS;
  __nv_bfloat16* Vt = Ks + T::BK * T::QS;
  int* kps = reinterpret_cast<int*>(Vt + D * T::VS);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * T::BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const size_t qrow0 = static_cast<size_t>(bh) * lq;
  const __nv_bfloat16* qb = q + qrow0 * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh / group) * lk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh / group) * lk * D;

  for (int idx = tid; idx < T::BQ * RVEC; idx += T::THREADS) {
    const int r = idx / RVEC, c = (idx % RVEC) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < lq)
      val = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * T::QS + c) = val;
  }
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* base = Qs + r0 * T::QS + kc * 16 + 2 * tig;
    qf[kc][0] = ld32(base);
    qf[kc][1] = ld32(base + 8 * T::QS);
    qf[kc][2] = ld32(base + 8);
    qf[kc][3] = ld32(base + 8 * T::QS + 8);
  }

  float acc[DT][4];
  float m_run[2], l_run[2];
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    const bool in = row < lq;
    qp[h] = in ? q_pos[row] : 0;
    m_run[h] = (has_state && in) ? m_in[qrow0 + row] : -INFINITY;
    // l is kept as per-thread partial sums, reduced over the quad at the end
    l_run[h] = (has_state && in && tig == 0) ? l_in[qrow0 + row] : 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dt * 8 + 2 * tig + e;
        acc[dt][2 * h + e] =
            (has_state && in) ? o_in[(qrow0 + row) * D + col] : 0.f;
      }
    }
  }

  const int nk = (lk + T::BK - 1) / T::BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * T::BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < T::BK * RVEC; idx += T::THREADS) {
      const int r = idx / RVEC, c = (idx % RVEC) * VEC;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < lk)
        val = *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(k0 + r) * D + c);
      *reinterpret_cast<uint4*>(Ks + r * T::QS + c) = val;
    }
    // V transposed; consecutive threads take consecutive keys so the
    // 16-bit shared stores of a warp hit distinct banks
    for (int idx = tid; idx < T::BK * RVEC; idx += T::THREADS) {
      const int r = idx % T::BK, c = (idx / T::BK) * VEC;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < lk)
        val = *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(k0 + r) * D + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < VEC; ++i) Vt[(c + i) * T::VS + r] = e[i];
    }
    for (int idx = tid; idx < T::BK; idx += T::THREADS)
      kps[idx] = (k0 + idx < lk) ? k_pos[k0 + idx] : -1;
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * T::QS + kc * 16 + 2 * tig;
        mma_bf16(s[nt], qf[kc], ld32(kp), ld32(kp + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = nt * 8 + 2 * tig + (e & 1);
        float x = s[nt][e] * scale;
        if (!visible(qp[h], kps[col], causal, has_window, window)) x = -INFINITY;
        s[nt][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float safe[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      safe[h] = (m_new == -INFINITY) ? 0.f : m_new;
      corr[h] = (m_run[h] == -INFINITY) ? 0.f : __expf(m_run[h] - safe[h]);
      m_run[h] = m_new;
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float x = s[nt][e];
        const float p = (x == -INFINITY) ? 0.f : __expf(x - safe[h]);
        s[nt][e] = p;
        l_run[h] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
#pragma unroll
    for (int kc = 0; kc < T::BK / 16; ++kc) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vp = Vt + (dt * 8 + g) * T::VS + kc * 16 + 2 * tig;
        mma_bf16(acc[dt], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = quad_sum(l_run[h]);
    const int row = q0 + r0 + 8 * h;
    if (row >= lq) continue;
    const float div = (finalize && l != 0.f) ? l : 1.f;
    const size_t base = (qrow0 + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * tig;
      const float x0 = acc[dt][2 * h] / div, x1 = acc[dt][2 * h + 1] / div;
      if (finalize) {
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(o_out) + base + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(o_out) + base + col) =
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

template <int D>
__global__ void __launch_bounds__(128) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, const float* __restrict__ o_in,
    const float* __restrict__ l_in, const float* __restrict__ m_in,
    float* __restrict__ o_out, float* __restrict__ l_out,
    float* __restrict__ m_out, int lq, int lk, int group, float scale,
    int causal, int has_window, int window, int has_state, int finalize) {
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
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_bf16(const Args& a) {
  using T = Bf16Tile<D>;
  auto kern = flash_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.lq + T::BQ - 1) / T::BQ);
  kern<<<grid, T::THREADS, T::SMEM, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.q_pos, a.k_pos, a.o_in, a.l_in,
      a.m_in, a.o, a.l, a.m, a.lq, a.lk, a.group, a.scale, a.causal,
      a.has_window, a.window, a.has_state, a.finalize);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  using T = F32Tile<D>;
  auto kern = flash_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.lq + T::BQ - 1) / T::BQ);
  kern<<<grid, T::THREADS, T::SMEM, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.q_pos, a.k_pos, a.o_in, a.l_in, a.m_in,
      static_cast<float*>(a.o), a.l, a.m, a.lq, a.lk, a.group, a.scale,
      a.causal, a.has_window, a.window, a.has_state, a.finalize);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int flash_mqkv_fwd(const void* q, const void* k, const void* v,
                              const int* q_pos, const int* k_pos,
                              const float* o_in, const float* l_in,
                              const float* m_in, void* o, float* l, float* m,
                              int bh, int lq, int lk, int d, int group,
                              int dtype, float scale, int causal,
                              int has_window, int window, int has_state,
                              int finalize, void* stream) {
  const Args a{q, k, v, q_pos, k_pos, o_in, l_in, m_in, o, l, m,
               bh, lq, lk, group, scale, causal, has_window, window,
               has_state, finalize, static_cast<cudaStream_t>(stream)};
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  if (dtype == 1) {
    switch (d) {
      case 16: return launch_bf16<16>(a);
      case 32: return launch_bf16<32>(a);
      case 64: return launch_bf16<64>(a);
      case 128: return launch_bf16<128>(a);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16>(a);
      case 32: return launch_f32<32>(a);
      case 64: return launch_f32<64>(a);
      case 128: return launch_f32<128>(a);
    }
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_mqkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
