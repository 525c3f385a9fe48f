// K1b: flash_mqkv_bwd — the gradient of K1 (flash_mqkv.cu) for its
// finalized, stateless call: (dq, dk, dv) from q, k, v, the forward's
// saved (o, l, m) and dO.  It replaces no Pallas kernel: the reference
// trains through plain attention (src/repro/core/softmax.py:199,
// reference_attention) and takes the gradient from XLA's autodiff.  The
// port's attention runs through K1, whose output has no autograd graph, so
// kernels/flash_mqkv.py wraps K1 in a torch.autograd.Function whose
// backward is this kernel.
//
// What it computes (kernels/ref.py: flash_mqkv_bwd_plain, the FA2
// backward):
//   Δ  = rowsum(dO ∘ o)
//   P  = exp(S·scale − m) / l, zero where K1's mask hides the key and on
//        rows with l == 0 (no visible key: m = −inf, so exp(S − m) is
//        undefined and the row's gradient is zero)
//   dV = Pᵀ dO,  dS = P ∘ (dO Vᵀ − Δ),  dQ = dS K·scale,  dK = dSᵀ Q·scale
// with K1's masks (k_pos = −1 padding, causal on positions, the window
// (q − W, q]) and ragged edges (rows past Lq and keys past Lk are
// invisible).  GQA: q head bh reads kv head bh / group; dK and dV sum the
// group's q heads.  q, k, v, o, dO in f32 or bf16; all arithmetic f32.
//
// Work split, three launches on the caller's stream:
//   1. delta_kernel: Δ in f32, one warp per row;
//   2. dkdv_kernel: one block per (KV head, tile of BK keys); it loops over
//      the group's q heads and their tiles of BQ rows, recomputes S and P
//      from the saved m and l, and accumulates dK and dV in registers;
//   3. dq_kernel: one block per (q head, tile of BQ rows), looping over the
//      KV tiles.
// No atomics: every output element is written by one block, so two runs
// give bitwise-equal gradients.  A (q tile, KV tile) pair in which no key
// is visible to any row (a causal or window mask, padding) adds nothing
// and is skipped before its tiles are loaded.
//
// Bound on an H100: five products of 2·D operations per visible (q, key)
// pair — S, dP = dO·Vᵀ, dV, dK, dQ — against reading q, k, v, o, dO and
// writing dq, dk, dv.  At qwen2-1.5b's training shape (BH 48, L 1024,
// D 128, causal) that is ~3.2e10 operations against ~59 MB: the tensor
// cores bound it (~0.033 ms at 989 TFLOP/s bf16).  This first version
// runs every product on the CUDA cores in f32, from tiles in shared
// memory with a 2 x 4 (scores) or 4 x D/16 (gradients) register tile per
// thread, so it is far from that bound (4.1 ms there on an H100 SXM at
// 700 W: PERF.md); tensor cores (mma.sync / wgmma) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 32;  // query rows per tile
constexpr int BK = 32;  // keys per tile
constexpr int PLD = BK + 1;  // row stride of the P and dS tiles (floats)

// Shared memory of one block at head dim D: the Q, dO, K and V tiles in
// f32 with rows padded by 4 floats (16-byte aligned rows whose float4
// loads fall in distinct banks), the P and dS tiles, the per-row m, l and
// Δ, and the q and k positions.
template <int D>
struct Tiles {
  static constexpr int LD = D + 4;
  static constexpr int ROW_TILE = BQ * LD;  // == BK * LD
  static constexpr size_t BYTES =
      sizeof(float) * (4 * ROW_TILE + 2 * BQ * PLD + 3 * BQ) +
      sizeof(int) * (BQ + BK);
  float* q;
  float* dout;
  float* k;
  float* v;
  float* p;
  float* ds;
  float* m;
  float* l;
  float* delta;
  int* qpos;
  int* kpos;
  __device__ explicit Tiles(unsigned char* smem) {
    float* f = reinterpret_cast<float*>(smem);
    q = f;
    dout = q + ROW_TILE;
    k = dout + ROW_TILE;
    v = k + ROW_TILE;
    p = v + ROW_TILE;
    ds = p + BQ * PLD;
    m = ds + BQ * PLD;
    l = m + BQ;
    delta = l + BQ;
    qpos = reinterpret_cast<int*>(delta + BQ);
    kpos = qpos + BQ;
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16(x);
}

// K1's mask (csrc/flash_mqkv.cuh: visible)
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

template <typename T>
struct Params {
  const T *q, *k, *v, *o, *dout;
  const float *m, *l;
  const int *q_pos, *k_pos;
  float* delta;
  T *dq, *dk, *dv;
  int bh, lq, lk, group;
  float scale;
  int causal, has_window, window;
};

// rows [r0, r0 + 32) of a row-major [rows, D] matrix into a padded f32
// tile; rows past the end read as zeros
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int rows) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * Tiles<D>::LD + c] =
        r0 + r < rows ? to_f(src[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
  }
}

// m, l, Δ and the position of the q tile's rows; a row past Lq gets l = 0,
// which makes it invisible
template <int D>
__device__ __forceinline__ void load_row_stats(const Tiles<D>& t,
                                               const float* m, const float* l,
                                               const float* delta,
                                               const int* q_pos, size_t row0,
                                               int q0, int lq) {
  const int i = threadIdx.x;
  if (i < BQ) {
    const bool in = q0 + i < lq;
    t.m[i] = in ? m[row0 + q0 + i] : 0.f;
    t.l[i] = in ? l[row0 + q0 + i] : 0.f;
    t.delta[i] = in ? delta[row0 + q0 + i] : 0.f;
    t.qpos[i] = in ? q_pos[q0 + i] : 0;
  }
}

template <int D>
__device__ __forceinline__ void load_kpos(const Tiles<D>& t, const int* k_pos,
                                          int k0, int lk) {
  const int j = threadIdx.x;
  if (j < BK) t.kpos[j] = k0 + j < lk ? k_pos[k0 + j] : -1;
}

// Whether any (row, key) pair of the loaded tiles is visible, over the
// block (every thread must call it).  Thread (ti, tj) looks at rows ti,
// ti + 16 and keys tj + 8b, the pairs it scores.
template <typename T, int D>
__device__ __forceinline__ bool any_visible(const Tiles<D>& t,
                                            const Params<T>& a) {
  const int ti = threadIdx.x >> 3, tj = threadIdx.x & 7;
  bool any = false;
#pragma unroll
  for (int ra = 0; ra < 2; ++ra) {
    const int i = ti + 16 * ra;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      any |= t.l[i] > 0.f && visible(t.qpos[i], t.kpos[tj + 8 * b], a.causal,
                                     a.has_window, a.window);
  }
  return __syncthreads_or(any) != 0;
}

// P and dS of the loaded (q tile, KV tile) into t.p and t.ds.  Thread
// (ti, tj) computes rows {ti, ti + 16} x keys {tj, tj + 8, tj + 16, tj + 24}
// of S = Q·Kᵀ and dP = dO·Vᵀ, reading four columns at a time.
template <typename T, int D>
__device__ __forceinline__ void scores(const Tiles<D>& t, const Params<T>& a) {
  constexpr int LD = Tiles<D>::LD;
  const int ti = threadIdx.x >> 3, tj = threadIdx.x & 7;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int ra = 0; ra < 2; ++ra)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[ra][b] = dp[ra][b] = 0.f;
#pragma unroll 2
  for (int dd = 0; dd < D; dd += 4) {
    float4 qa[2], da[2], kb[4], vb[4];
#pragma unroll
    for (int ra = 0; ra < 2; ++ra) {
      qa[ra] = *reinterpret_cast<const float4*>(t.q + (ti + 16 * ra) * LD + dd);
      da[ra] = *reinterpret_cast<const float4*>(t.dout + (ti + 16 * ra) * LD + dd);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = *reinterpret_cast<const float4*>(t.k + (tj + 8 * b) * LD + dd);
      vb[b] = *reinterpret_cast<const float4*>(t.v + (tj + 8 * b) * LD + dd);
    }
#pragma unroll
    for (int ra = 0; ra < 2; ++ra)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[ra][b] = fmaf(qa[ra].x, kb[b].x, s[ra][b]);
        s[ra][b] = fmaf(qa[ra].y, kb[b].y, s[ra][b]);
        s[ra][b] = fmaf(qa[ra].z, kb[b].z, s[ra][b]);
        s[ra][b] = fmaf(qa[ra].w, kb[b].w, s[ra][b]);
        dp[ra][b] = fmaf(da[ra].x, vb[b].x, dp[ra][b]);
        dp[ra][b] = fmaf(da[ra].y, vb[b].y, dp[ra][b]);
        dp[ra][b] = fmaf(da[ra].z, vb[b].z, dp[ra][b]);
        dp[ra][b] = fmaf(da[ra].w, vb[b].w, dp[ra][b]);
      }
  }
#pragma unroll
  for (int ra = 0; ra < 2; ++ra) {
    const int i = ti + 16 * ra;
    const float li = t.l[i];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tj + 8 * b;
      float p = 0.f;
      if (li > 0.f && visible(t.qpos[i], t.kpos[j], a.causal, a.has_window,
                              a.window))
        p = expf(s[ra][b] * a.scale - t.m[i]) / li;
      t.p[i * PLD + j] = p;
      t.ds[i * PLD + j] = p * (dp[ra][b] - t.delta[i]);
    }
  }
}

// Δ = rowsum(dO ∘ o), one warp per row
template <typename T>
__global__ void __launch_bounds__(THREADS) delta_kernel(Params<T> a, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(a.bh) * a.lq) return;
  const T* o = a.o + row * d;
  const T* g = a.dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(o[c]), to_f(g[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) a.delta[row] = acc;
}

// dK and dV of one KV tile: thread (tj, td) owns keys tj + 8r (r < 4) and
// columns td + 16c (c < D/16) of both.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Params<T> a) {
  constexpr int LD = Tiles<D>::LD;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<D> t(smem);
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t kv_row0 = static_cast<size_t>(kvh) * a.lk;
  load_rows<D>(t.k, a.k + kv_row0 * D, k0, a.lk);
  load_rows<D>(t.v, a.v + kv_row0 * D, k0, a.lk);
  load_kpos(t, a.k_pos, k0, a.lk);

  const int tj = threadIdx.x >> 4, td = threadIdx.x & 15;
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  const int nq = (a.lq + BQ - 1) / BQ;
  for (int g = 0; g < a.group; ++g) {
    const int qh = kvh * a.group + g;
    const size_t q_row0 = static_cast<size_t>(qh) * a.lq;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_row_stats(t, a.m, a.l, a.delta, a.q_pos, q_row0, q0, a.lq);
      __syncthreads();
      if (!any_visible(t, a)) continue;
      load_rows<D>(t.q, a.q + q_row0 * D, q0, a.lq);
      load_rows<D>(t.dout, a.dout + q_row0 * D, q0, a.lq);
      __syncthreads();
      scores(t, a);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float p[4], s[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p[r] = t.p[i * PLD + tj + 8 * r];
          s[r] = t.ds[i * PLD + tj + 8 * r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float g_ = t.dout[i * LD + td + 16 * c];
          const float q_ = t.q[i * LD + td + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv[r][c] = fmaf(p[r], g_, dv[r][c]);
            dk[r][c] = fmaf(s[r], q_, dk[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + tj + 8 * r;
    if (j >= a.lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t off = (kv_row0 + j) * D + td + 16 * c;
      put(a.dk, off, dk[r][c] * a.scale);
      put(a.dv, off, dv[r][c]);
    }
  }
}

// dQ of one q tile: thread (ti, td) owns rows ti + 8r (r < 4) and columns
// td + 16c (c < D/16).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params<T> a) {
  constexpr int LD = Tiles<D>::LD;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<D> t(smem);
  const int qh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t q_row0 = static_cast<size_t>(qh) * a.lq;
  const size_t kv_row0 = static_cast<size_t>(qh / a.group) * a.lk;
  load_rows<D>(t.q, a.q + q_row0 * D, q0, a.lq);
  load_rows<D>(t.dout, a.dout + q_row0 * D, q0, a.lq);
  load_row_stats(t, a.m, a.l, a.delta, a.q_pos, q_row0, q0, a.lq);

  const int ti = threadIdx.x >> 4, td = threadIdx.x & 15;
  float dq[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.f;

  const int nk = (a.lk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_kpos(t, a.k_pos, k0, a.lk);
    __syncthreads();
    if (!any_visible(t, a)) continue;
    load_rows<D>(t.k, a.k + kv_row0 * D, k0, a.lk);
    load_rows<D>(t.v, a.v + kv_row0 * D, k0, a.lk);
    __syncthreads();
    scores(t, a);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float s[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r] = t.ds[(ti + 8 * r) * PLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float k_ = t.k[j * LD + td + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) dq[r][c] = fmaf(s[r], k_, dq[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ti + 8 * r;
    if (i >= a.lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      put(a.dq, (q_row0 + i) * D + td + 16 * c, dq[r][c] * a.scale);
  }
}

template <typename T, int D>
cudaError_t launch(const Params<T>& a, cudaStream_t stream) {
  constexpr size_t smem = Tiles<D>::BYTES;
  // once per instantiation: a launch inside a CUDA graph capture then
  // makes no call beside the launch itself
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const long long rows = static_cast<long long>(a.bh) * a.lq;
  const unsigned delta_blocks =
      static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  delta_kernel<T><<<delta_blocks, THREADS, 0, stream>>>(a, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.lk > 0) {
    const dim3 grid_kv((a.lk + BK - 1) / BK, a.bh / a.group);
    dkdv_kernel<T, D><<<grid_kv, THREADS, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q((a.lq + BQ - 1) / BQ, a.bh);
  dq_kernel<T, D><<<grid_q, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params<T>& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
Params<T> params(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* m, const float* l,
                 const int* q_pos, const int* k_pos, float* delta, void* dq,
                 void* dk, void* dv, int bh, int lq, int lk, int group,
                 float scale, int causal, int has_window, int window) {
  return Params<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(o),
                   static_cast<const T*>(dout), m, l, q_pos, k_pos, delta,
                   static_cast<T*>(dq), static_cast<T*>(dk),
                   static_cast<T*>(dv), bh, lq, lk, group, scale, causal,
                   has_window, window};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike);
// delta is f32 scratch of bh * lq.  Returns a cudaError_t (0 = launched).
extern "C" int flash_mqkv_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const float* m,
                              const float* l, const int* q_pos,
                              const int* k_pos, float* delta, void* dq,
                              void* dk, void* dv, int bh, int lq, int lk,
                              int d, int group, int dtype, float scale,
                              int causal, int has_window, int window,
                              void* stream) {
  if (group <= 0 || bh % group) return cudaErrorInvalidValue;
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch(params<float>(q, k, v, o, dout, m, l, q_pos, k_pos, delta,
                                  dq, dk, dv, bh, lq, lk, group, scale, causal,
                                  has_window, window),
                    d, s);
  if (dtype == 1)
    return dispatch(params<__nv_bfloat16>(q, k, v, o, dout, m, l, q_pos, k_pos,
                                          delta, dq, dk, dv, bh, lq, lk, group,
                                          scale, causal, has_window, window),
                    d, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_mqkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
