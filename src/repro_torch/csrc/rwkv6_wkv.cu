// K5: rwkv6_wkv — the chunked RWKV6 (Finch) WKV scan, Hopper (sm_90a)
// counterpart of the Pallas TPU kernel src/repro/kernels/rwkv6_wkv.py
// (`_kernel` / `rwkv6_wkv`).
//
// What it computes (the TPU kernel's contract): for every (batch, head)
// row bh, with r, k, v, w [L, N] and the bonus u [N], the recurrence
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
// from S_0 = 0, o in float32.  Decays are clipped to [1e-6, 1].  Chunk by
// chunk of c steps, with D the inclusive and D₋ the exclusive cumulative
// decay inside the chunk (from the cumulative sum of log w):
//     o = ((r·D₋)(k/D)^T ⊙ tril₋₁) v + diag(r·u·k) v + (r·D₋) S_in
//     S = a_c ⊙ S_in + ((k/D) ⊙ a_c)^T v,   a_c = D at the chunk's last step.
// Inputs are read through strides (batch, head, time; channels contiguous),
// so the model hands over its [B, L, H, N] projections without a
// transposed copy; each of r, k, v, w, u is float32 or bfloat16 on its own.
//
// Bound on an H100: at the main path's shape (BH 128, L 4096, N 64, chunk
// 64; r, k, v bf16, w f32, o f32) the kernel must move ~470 MB (0.14 ms at
// 3.35 TB/s) and do ~12.9 GFLOP in float32 (0.19 ms at 67 TFLOP/s on the
// CUDA cores), so operations bound it, narrowly.
//
// Design.  The TPU grid's sequential chunk axis becomes a loop inside the
// block, with the state S carried in shared memory in float32.  Value
// columns are independent (o[:, j] and S[:, j] read only v[:, j]), so the
// grid is (BH, N / TV) with TV = min(N, 32) value columns per block; every
// block recomputes the chunk's decays, r·D₋, k/D and the c x c matrix att
// for its columns, which doubles the number of blocks at B 2 (64 rows) and
// fills the card's 132 SMs.  Per chunk, 256 threads:
//   1. load r, k and log(clip(w)) transposed to [N][c] and the v tile;
//   2. r·u·k per step; per-segment cumulative sums of log w;
//   3. log D = segment sum + the sum of earlier segments; r·D₋ and k/D in
//      place; a_c from the last step;
//   4. att = (r·D₋)(k/D)^T, strictly lower triangle, register tiles;
//   5. o = att·v + diag·v + (r·D₋)·S to device memory, and the state's
//      increment (k/D)^T v in registers;
//   6. S = a_c ⊙ (S + increment).
// All arithmetic is float32 on the CUDA cores (no TF32), as the reference's
// preferred_element_type=float32.  Not yet done (later work): tensor cores
// (mma/wgmma), asynchronous loads and overlap of one chunk's loads with the
// previous chunk's products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float EPS = 1e-6f;

struct In {  // one input: base pointer, element type, strides in elements
  const void* p;
  int bf16;
  long long sb, sh, sl;  // batch, head, time (channels are contiguous)
};

struct Args {
  In r, k, v, w;
  const void* u;  // u[(bh % u_rows) * N + n]
  int u_bf16, u_rows;
  float* o;
  long long ob, oh, ol;
  int heads;  // row bh = b * heads + h
  int l;
};

__device__ __forceinline__ float ld(const void* p, long long i, int bf16) {
  if (bf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int C, int N>
struct Shape {
  static constexpr int TV = cmin(N, 32);  // value columns per block
  static constexpr int LD = C + 4;        // row stride of the [N][C] buffers
  static constexpr int ALD = C + 1;       // row stride of att
  // cumulative sum: NSEG segments of SEG steps per channel
  static constexpr int NSEG = cmin(THREADS / N, C);
  static constexpr int SEG = C / NSEG;
  // att: TPA x TPA threads, RA x RA outputs each (strided by TPA)
  static constexpr int TPA = cmin(C, 16);
  static constexpr int RA = C / TPA;
  // o [C][TV] and the state [N][TV]: TPJ threads along the value columns
  static constexpr int TPJ = cmin(TV, 16);
  static constexpr int CO = TV / TPJ;
  static constexpr int TPT = cmin(THREADS / TPJ, C);
  static constexpr int RO = C / TPT;
  static constexpr int TPN = cmin(THREADS / TPJ, N);
  static constexpr int RN = N / TPN;
  static constexpr int FLOATS =
      3 * N * LD + C * TV + C * ALD + N * TV + C + 2 * N + N * NSEG;
};

template <int C, int N>
__global__ void __launch_bounds__(THREADS, 2) wkv_kernel(const Args a) {
  using S = Shape<C, N>;
  constexpr int TV = S::TV, LD = S::LD, ALD = S::ALD, NSEG = S::NSEG,
                SEG = S::SEG, TPA = S::TPA, RA = S::RA, TPJ = S::TPJ,
                CO = S::CO, TPT = S::TPT, RO = S::RO, TPN = S::TPN,
                RN = S::RN;
  extern __shared__ float smem[];
  float* rT = smem;            // [N][LD]: r, then r·D₋
  float* kT = rT + N * LD;     // [N][LD]: k, then k/D
  float* lw = kT + N * LD;     // [N][LD]: log w, then in-segment sums
  float* vs = lw + N * LD;     // [C][TV]: this block's v columns
  float* att = vs + C * TV;    // [C][ALD]
  float* st = att + C * ALD;   // [N][TV]: the carried state's columns
  float* dg = st + N * TV;     // [C]: r·u·k
  float* ac = dg + C;          // [N]: decay over the chunk
  float* us = ac + N;          // [N]
  float* seg = us + N;         // [N][NSEG]: segment totals of log w

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * TV;
  const long long b = bh / a.heads, h = bh % a.heads;
  const long long rb = b * a.r.sb + h * a.r.sh, kb = b * a.k.sb + h * a.k.sh,
                  vb = b * a.v.sb + h * a.v.sh, wb = b * a.w.sb + h * a.w.sh;
  float* o = a.o + b * a.ob + h * a.oh + j0;

  for (int i = tid; i < N * TV; i += THREADS) st[i] = 0.f;
  if (tid < N)
    us[tid] = ld(a.u, static_cast<long long>(bh % a.u_rows) * N + tid, a.u_bf16);

  for (int t0 = 0; t0 < a.l; t0 += C) {
    // 1. loads (row-major in device memory, transposed into shared memory)
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, n = e % N;
      const long long tt = t0 + t;
      rT[n * LD + t] = ld(a.r.p, rb + tt * a.r.sl + n, a.r.bf16);
      kT[n * LD + t] = ld(a.k.p, kb + tt * a.k.sl + n, a.k.bf16);
      const float wv = ld(a.w.p, wb + tt * a.w.sl + n, a.w.bf16);
      lw[n * LD + t] = logf(fminf(fmaxf(wv, EPS), 1.f));
    }
    for (int e = tid; e < C * TV; e += THREADS) {
      const int t = e / TV, j = e % TV;
      vs[e] = ld(a.v.p, vb + static_cast<long long>(t0 + t) * a.v.sl + j0 + j,
                 a.v.bf16);
    }
    __syncthreads();

    // 2. the bonus diagonal r·(u ⊙ k), and in-segment cumulative sums
    if (tid < C) {
      float s = 0.f;
      for (int n = 0; n < N; ++n) s += rT[n * LD + tid] * us[n] * kT[n * LD + tid];
      dg[tid] = s;
    }
    if (tid < N * NSEG) {
      const int n = tid % N, g = tid / N;
      float* row = lw + n * LD + g * SEG;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        acc += row[i];
        row[i] = acc;
      }
      seg[n * NSEG + g] = acc;
    }
    __syncthreads();

    // 3. log D, then r·D₋ and k/D in place; a_c = D at the last step
    if (tid < N * NSEG) {
      const int n = tid % N, g = tid / N;
      float off = 0.f;
      for (int q = 0; q < g; ++q) off += seg[n * NSEG + q];
      float prev = off;  // log D one step before this segment
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int t = g * SEG + i;
        const float log_d = lw[n * LD + t] + off;
        const float d = expf(log_d);
        rT[n * LD + t] *= expf(prev);
        kT[n * LD + t] /= d;
        if (t == C - 1) ac[n] = d;
        prev = log_d;
      }
    }
    __syncthreads();

    // 4. att[t][s] = (r·D₋)_t · (k/D)_s for s < t, else 0
    if (tid < TPA * TPA) {
      const int ti = tid / TPA, si = tid % TPA;
      float acc[RA][RA];
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < RA; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float x[RA], y[RA];
#pragma unroll
        for (int i = 0; i < RA; ++i) x[i] = rT[n * LD + ti + i * TPA];
#pragma unroll
        for (int j = 0; j < RA; ++j) y[j] = kT[n * LD + si + j * TPA];
#pragma unroll
        for (int i = 0; i < RA; ++i)
#pragma unroll
          for (int j = 0; j < RA; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < RA; ++j) {
          const int t = ti + i * TPA, s = si + j * TPA;
          att[t * ALD + s] = s < t ? acc[i][j] : 0.f;
        }
    }
    __syncthreads();

    // 5. o = att·v + diag·v + (r·D₋)·S; the state's increment (k/D)^T v
    if (tid < TPT * TPJ) {
      const int to = tid / TPJ, jo = tid % TPJ;
      float acc[RO][CO];
#pragma unroll
      for (int i = 0; i < RO; ++i)
#pragma unroll
        for (int q = 0; q < CO; ++q) acc[i][q] = 0.f;
      for (int s = 0; s < C; ++s) {
        float x[RO], y[CO];
#pragma unroll
        for (int i = 0; i < RO; ++i) x[i] = att[(to + i * TPT) * ALD + s];
#pragma unroll
        for (int q = 0; q < CO; ++q) y[q] = vs[s * TV + jo + q * TPJ];
#pragma unroll
        for (int i = 0; i < RO; ++i)
#pragma unroll
          for (int q = 0; q < CO; ++q) acc[i][q] = fmaf(x[i], y[q], acc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        const int t = to + i * TPT;
#pragma unroll
        for (int q = 0; q < CO; ++q)
          acc[i][q] = fmaf(dg[t], vs[t * TV + jo + q * TPJ], acc[i][q]);
      }
      for (int n = 0; n < N; ++n) {
        float x[RO], y[CO];
#pragma unroll
        for (int i = 0; i < RO; ++i) x[i] = rT[n * LD + to + i * TPT];
#pragma unroll
        for (int q = 0; q < CO; ++q) y[q] = st[n * TV + jo + q * TPJ];
#pragma unroll
        for (int i = 0; i < RO; ++i)
#pragma unroll
          for (int q = 0; q < CO; ++q) acc[i][q] = fmaf(x[i], y[q], acc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        const long long t = t0 + to + i * TPT;
#pragma unroll
        for (int q = 0; q < CO; ++q) o[t * a.ol + jo + q * TPJ] = acc[i][q];
      }
    }
    float inc[RN][CO];
    if (tid < TPN * TPJ) {
      const int nn = tid / TPJ, jo = tid % TPJ;
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int q = 0; q < CO; ++q) inc[i][q] = 0.f;
      for (int s = 0; s < C; ++s) {
        float x[RN], y[CO];
#pragma unroll
        for (int i = 0; i < RN; ++i) x[i] = kT[(nn + i * TPN) * LD + s];
#pragma unroll
        for (int q = 0; q < CO; ++q) y[q] = vs[s * TV + jo + q * TPJ];
#pragma unroll
        for (int i = 0; i < RN; ++i)
#pragma unroll
          for (int q = 0; q < CO; ++q) inc[i][q] = fmaf(x[i], y[q], inc[i][q]);
      }
    }
    __syncthreads();  // every read of S in step 5 is done

    // 6. S = a_c ⊙ S + a_c ⊙ increment (each thread owns its entries)
    if (tid < TPN * TPJ) {
      const int nn = tid / TPJ, jo = tid % TPJ;
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        const int n = nn + i * TPN;
#pragma unroll
        for (int q = 0; q < CO; ++q) {
          float* p = st + n * TV + jo + q * TPJ;
          *p = ac[n] * *p + inc[i][q] * ac[n];
        }
      }
    }
    // the next chunk's loads touch none of S, ac or the registers above;
    // its step 5 reads S only after two more barriers
  }
}

template <int C, int N>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  using S = Shape<C, N>;
  constexpr int bytes = S::FLOATS * static_cast<int>(sizeof(float));
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_kernel<C, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(bh, N / S::TV);
  wkv_kernel<C, N><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_n(const Args& a, int bh, int n, cudaStream_t stream) {
  switch (n) {
    case 8: return launch<C, 8>(a, bh, stream);
    case 16: return launch<C, 16>(a, bh, stream);
    case 32: return launch<C, 32>(a, bh, stream);
    case 64: return launch<C, 64>(a, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 15 values, (batch, head, time) for r, k, v, w and o in turn.
// bf16: bit 0 r, 1 k, 2 v, 3 w, 4 u.  The chunk c divides l; c and n are
// 8, 16, 32 or 64 (the wrapper checks, and so does this).
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, float* o, int bh,
                             int heads, int l, int n, int chunk, int u_rows,
                             int bf16, const long long* strides, void* stream) {
  if (bh <= 0 || heads <= 0 || l <= 0 || u_rows <= 0 || chunk <= 0 ||
      l % chunk)
    return cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{{r, bf16 & 1, s[0], s[1], s[2]},
               {k, (bf16 >> 1) & 1, s[3], s[4], s[5]},
               {v, (bf16 >> 2) & 1, s[6], s[7], s[8]},
               {w, (bf16 >> 3) & 1, s[9], s[10], s[11]},
               u, (bf16 >> 4) & 1, u_rows,
               o, s[12], s[13], s[14],
               heads, l};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 8: return launch_n<8>(a, bh, n, st);
    case 16: return launch_n<16>(a, bh, n, st);
    case 32: return launch_n<32>(a, bh, n, st);
    case 64: return launch_n<64>(a, bh, n, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
