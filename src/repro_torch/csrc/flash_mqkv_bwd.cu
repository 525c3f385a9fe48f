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
// group's q heads.  q, k, v, o, dO in f32 or bf16; all sums in f32.
// No atomics: every output element is written by one block, and every sum
// is taken in a fixed order, so two runs give bitwise-equal gradients.
//
// Bound on an H100: five products of 2·D operations per visible (q, key)
// pair — S, dP = dO·Vᵀ, dV, dK, dQ — against reading q, k, v, o, dO and
// writing dq, dk, dv.  At qwen2-1.5b's training shape (BH 48, L 1024,
// D 128, causal) that is ~3.2e10 operations against ~59 MB: the tensor
// cores bound it (~0.033 ms at 989 TFLOP/s bf16).
//
// bf16 (the training path): a Hopper body built from K1's parts in
// flash_mqkv.cuh — the wgmma m64nNk16 wrappers with shared-memory and
// register A operands, the descriptors and swizzle (ROWB, LAYOUT), the TMA
// tensor maps with the hardware's zero fill at ragged ends, mbarrier.cuh,
// and a producer warp beside consumer warpgroups that take its registers
// (setmaxnreg).  Five launches on the caller's stream:
//   1. delta_bf16_kernel: Δ in f32 from 16-byte loads, D / 8 threads a row;
//   2. bounds_kernel: per 64-row tile of q and of keys, the least and
//      greatest position of a valid row or key and whether the key tile
//      holds padding.  From them a block decides which (q tile, key tile)
//      pairs a causal or window mask hides entirely (never loaded) and
//      which it cuts (masked element by element); the rest run unmasked;
//   3. dkdv_hopper_kernel: one block per (KV head, key tile of 64·NWG
//      keys, share of the GQA group).  K and V are loaded once by TMA; the
//      Q and dO tiles of the visible 64-row q tiles of each q head of the
//      share stream through a ring of two stages, with their rows' m, l,
//      Δ and positions, which the producer lanes write beside them.  Each
//      consumer warpgroup owns 64 keys: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are
//      m64n64k16 wgmma with both operands in shared memory (K-major, as
//      K1's S = Q·Kᵀ); Pᵀ = exp(Sᵀ·scale − m)/l and dSᵀ = Pᵀ ∘ (dPᵀ − Δ)
//      are formed in the accumulator registers, packed to bf16 (as K1
//      rounds P before P·V) and are the register A operands of dV += Pᵀ·dO
//      and dK += dSᵀ·Q, whose B operands dO and Q are read MN-major
//      through the descriptor's transpose bit, as K1 reads V: no
//      transposed copy.  dK and dV stay in f32 registers for the whole
//      loop and are scaled, cast and stored once;
//   4. reduce_dkdv_kernel (only when the group is split): the shares'
//      f32 partial dK and dV summed in share order, scaled and cast;
//   5. dq_hopper_kernel: one block per (q head, 64·NWG rows), looping over
//      the visible key tiles of 64 through a TMA ring: S = Q·Kᵀ and
//      dP = dO·Vᵀ from shared memory, dS in registers packed to bf16 as
//      the A operand of dQ += dS·K, K read MN-major.  It recomputes S and
//      dP (7 products where the bound counts 5): the price of writing
//      each dQ element from one block without atomics.  Under a causal
//      mask the blocks with the most key tiles launch first.
// The tile plan (kv_wg, splits, pair) comes from the wrapper
// (kernels/flash_mqkv.py: bwd_tile_plan).  What the design had to answer:
//   1. Registers.  At D 128 a consumer warpgroup holding 64 keys carries
//      dK and dV (128 f32 a thread) beside the Sᵀ and dPᵀ accumulators
//      (2 × 32 at 64 q rows a tile) and their bf16 packs: D 128 runs two
//      consumer warpgroups a block at 232 registers each (one block an
//      SM); D <= 64 one warpgroup at 216 (two blocks an SM).  Each
//      warpgroup waits for its own products, so the two warpgroups of an
//      SM overlap one's exponentials with the other's products.  The
//      build phase of chip_smoke.py fails on any spill.
//   2. Load balance under a causal mask.  Key tile j sees the q tiles
//      from j on, so a dK/dV block takes key tiles j and n−1−j (`pair`):
//      every block does the same work.  Where (key tiles / 2) × KV heads
//      would leave SMs idle, the group's q heads are split over `splits`
//      blocks that write f32 partial sums, and launch 4 adds them in a
//      fixed order: the result stays bitwise on repeat.
//   3. The spill gate.  chip_smoke.py's build phase matches these kernels'
//      names (delta_bf16, bounds, dkdv_hopper, reduce_dkdv, dq_hopper)
//      beside the f32 ones.
//   4. Precision.  P and dS are rounded to bf16 before the second
//      products, as K1 rounds P; the sums are f32.  The gate (2e-2 of
//      max|ref|) holds it to the f32 plain version.
// Not done (PERF.md §7): one fused pass with an ordered dQ reduction, and
// overlapping a warpgroup's exponentials with its own products.
//
// f32 (the parity path, CUDA cores, as K1's flash_f32_kernel): three
// launches — delta_kernel (Δ, one warp per row), dkdv_kernel (one block
// per (KV head, tile of 32 keys), looping over the group's q heads and
// their tiles of 32 rows, recomputing S and P from the saved m and l) and
// dq_kernel (one block per (q head, tile of 32 rows)) — with every product
// in f32 FMAs from padded tiles in shared memory, so f32 gradients match a
// float32 reference to summation order.  A (q tile, KV tile) pair in which
// no key is visible to any row is skipped before its tiles are loaded.
#include "flash_mqkv.cuh"  // K1's Hopper parts (wgmma, TMA maps, visible)

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core path (parity)
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void put(float* p, size_t i, float x) { p[i] = x; }

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

cudaError_t dispatch_f32(const Params<float>& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<float, 16>(a, stream);
    case 32: return launch<float, 32>(a, stream);
    case 64: return launch<float, 64>(a, stream);
    case 128: return launch<float, 128>(a, stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: the Hopper body (TMA, mbarriers, wgmma)
// ---------------------------------------------------------------------------

constexpr int TILE = 64;  // rows of a bounds tile, of a streamed Q/dO tile
                          // (dK/dV) and of a K/V tile (dQ)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int POS_MAX = 0x7fffffff, POS_MIN = -POS_MAX - 1;

// consumer warpgroups of a dK/dV block at head dim d (kernels/flash_mqkv.py:
// bwd_tile_plan): D 128 needs 232 registers a thread (two warpgroups, one
// block an SM); smaller heads fit one warpgroup at 216 (two blocks an SM)
constexpr int kv_warpgroups(int d) { return d == 128 ? 2 : 1; }
constexpr int Q_WARPGROUPS = 1;  // consumer warpgroups of a dQ block

struct Bf16Args {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float *m, *l;
  const int *q_pos, *k_pos;
  float* delta;    // [BH, Lq]
  int4* tab;       // bounds of the 64-row tiles: q tiles, then key tiles
  float* partial;  // [2][splits][BHkv][Lk][D] when splits > 1
  __nv_bfloat16 *dq, *dk, *dv;
  int bh, lq, lk, group;
  float scale;
  int causal, has_window, window;
  int splits, pair;  // the tile plan
};

// tensor maps of the bf16 kernels: q and dO [BH, Lq, D], k and v
// [BHkv, Lk, D]
struct BwdMaps {
  CUtensorMap q, dout, k, v;
};

// Positions of a run of 64-row tiles: the least and greatest position of a
// valid q row or key (lo > hi: none), and whether a key tile of the run
// holds a key that is padding or past Lk.
struct Span {
  int lo, hi, pad;
};

// the union of tiles [first, first + count) of tab; tiles at or past n
// hold no valid row
__device__ __forceinline__ Span span_of(const int4* tab, int first, int count,
                                        int n) {
  Span s{POS_MAX, POS_MIN, 0};
  for (int i = first; i < first + count; ++i) {
    if (i >= n) {
      s.pad = 1;
      continue;
    }
    const int4 t = tab[i];
    s.lo = min(s.lo, t.x);
    s.hi = max(s.hi, t.y);
    s.pad |= t.z;
  }
  return s;
}

// whether some q row of `q` may see some key of `k` (a tile pair for
// which this is false is never loaded)
__device__ __forceinline__ bool maybe_visible(const Span& q, const Span& k,
                                              int causal, int has_window,
                                              int window) {
  if (q.lo > q.hi || k.lo > k.hi) return false;
  if (causal && q.hi < k.lo) return false;
  if (has_window && static_cast<long long>(k.hi) <=
                        static_cast<long long>(q.lo) - window)
    return false;
  return true;
}

// whether every valid q row of `q` sees every key of `k` (such a pair
// needs no mask: rows past Lq and rows with l == 0 get P = 0 from their
// statistics)
__device__ __forceinline__ bool all_visible(const Span& q, const Span& k,
                                            int causal, int has_window,
                                            int window) {
  if (k.pad || k.lo > k.hi) return false;
  if (causal && q.lo < k.hi) return false;
  if (has_window && static_cast<long long>(k.lo) <=
                        static_cast<long long>(q.hi) - window)
    return false;
  return true;
}

// Δ = rowsum(dO ∘ o) from 16-byte loads: D / 8 threads a row, summed over
// the row's lanes in a fixed order
template <int D>
__global__ void __launch_bounds__(256)
    delta_bf16_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      float* __restrict__ delta, long long rows) {
  constexpr int TPR = D / 8;
  const long long t = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long row = t / TPR;
  const int part = static_cast<int>(t % TPR);
  float acc = 0.f;
  if (row < rows) {
    const uint4 a = reinterpret_cast<const uint4*>(o + row * D)[part];
    const uint4 b = reinterpret_cast<const uint4*>(dout + row * D)[part];
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
#pragma unroll
  for (int s = TPR / 2; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (row < rows && part == 0) delta[row] = acc;
}

// One warp per 64-row tile, the nq q tiles first, then the nk key tiles:
// tab[i] = (lo, hi, pad, 0) over the tile's valid rows (q rows below Lq;
// keys below Lk with k_pos >= 0)
__global__ void __launch_bounds__(128)
    bounds_kernel(const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                  int4* __restrict__ tab, int lq, int lk, int nq, int nk) {
  const int tile = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (tile >= nq + nk) return;  // uniform over the warp
  const bool is_q = tile < nq;
  const int first = (is_q ? tile : tile - nq) * TILE;
  int lo = POS_MAX, hi = POS_MIN, pad = 0;
  for (int r = lane; r < TILE; r += 32) {
    const int i = first + r;
    int p;
    bool ok;
    if (is_q) {
      ok = i < lq;
      p = ok ? q_pos[i] : 0;
    } else {
      p = i < lk ? k_pos[i] : -1;
      ok = p >= 0;
    }
    if (ok) {
      lo = min(lo, p);
      hi = max(hi, p);
    } else {
      pad = 1;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, s));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, s));
    pad |= __shfl_xor_sync(0xffffffffu, pad, s);
  }
  if (lane == 0) tab[tile] = make_int4(lo, hi, pad, 0);
}

// Shared memory, threads and registers of the dK/dV kernel at head dim D
// with NWG consumer warpgroups of 64 keys each
template <int D, int NWG>
struct KvTiles {
  static constexpr int BK = 64 * NWG;  // keys a block
  static constexpr int BQ = TILE;      // q rows a streamed tile
  static constexpr int STAGES = 2;     // Q/dO tiles in flight
  static constexpr int THREADS = NWG * 128 + 128;  // + the producer's group
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;  // blocks an SM
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS =
      (65536 / MIN_BLOCKS / 128 - PRODUCER_REGS) / NWG / 8 * 8;
  static_assert(MIN_BLOCKS * 128 * (PRODUCER_REGS + NWG * CONSUMER_REGS) <= 65536,
                "registers of the SM");
  static constexpr int ROWB = Hop<D, 64>::ROWB, CB = Hop<D, 64>::CB;
  static constexpr int LAYOUT = Hop<D, 64>::LAYOUT;
  static constexpr int KV_BYTES = BK * D * 2;  // the K or the V tile
  static constexpr int Q_BYTES = BQ * D * 2;   // one Q or dO tile
  static constexpr int BAR_OFF = 2 * KV_BYTES + 2 * STAGES * Q_BYTES;
  // full and empty per stage, K/V full and empty
  static constexpr int STAT_OFF = BAR_OFF + 8 * (2 * STAGES + 2);
  // per stage: -m·log2(e), 1/l, Δ and the position of each row
  static constexpr size_t SMEM = 1024 + STAT_OFF + 16 * STAGES * BQ;
  static_assert(SMEM * MIN_BLOCKS <= 232448, "shared memory of an SM");
};

// ... and of the dQ kernel, NWG consumer warpgroups of 64 q rows each
template <int D, int NWG>
struct QTiles {
  static constexpr int BQ = 64 * NWG;  // q rows a block
  static constexpr int BK = TILE;      // keys a K/V tile
  static constexpr int STAGES = 2;     // K/V tiles in flight
  static constexpr int THREADS = NWG * 128 + 128;
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS =
      (65536 / MIN_BLOCKS / 128 - PRODUCER_REGS) / NWG / 8 * 8;
  static_assert(MIN_BLOCKS * 128 * (PRODUCER_REGS + NWG * CONSUMER_REGS) <= 65536,
                "registers of the SM");
  static constexpr int ROWB = Hop<D, 64>::ROWB, CB = Hop<D, 64>::CB;
  static constexpr int LAYOUT = Hop<D, 64>::LAYOUT;
  static constexpr int Q_BYTES = BQ * D * 2;   // the Q or the dO tile
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int BAR_OFF = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  // full and empty per stage, Q/dO full
  static constexpr int KPOS_OFF = BAR_OFF + 8 * (2 * STAGES + 1);
  static constexpr size_t SMEM = 1024 + KPOS_OFF + 4 * STAGES * BK;
  static_assert(SMEM * MIN_BLOCKS <= 232448, "shared memory of an SM");
};

// k16 step kk of a K-major operand of `rows` rows, in 16-byte units: 32
// bytes into the row, or the next column block (K1's kstep)
template <int ROWB>
__device__ __forceinline__ uint64_t kstep(int kk, int rows) {
  return static_cast<uint64_t>(((kk * 32) / ROWB) * rows * ROWB / 16 +
                               ((kk * 32) % ROWB) / 16);
}

// an m64nNk16 accumulator (N / 2 floats a thread) packed to bf16 as the A
// fragments of N / 16 k16 steps (K1's P fragments)
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2],
                                       uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    f[j / 2][2 * (j & 1)] = pack_bf16(x[4 * j], x[4 * j + 1]);
    f[j / 2][2 * (j & 1) + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

template <int D, int NWG>
__global__ void __launch_bounds__(KvTiles<D, NWG>::THREADS,
                                  KvTiles<D, NWG>::MIN_BLOCKS)
    dkdv_hopper_kernel(const __grid_constant__ BwdMaps maps, const Bf16Args a) {
  using T = KvTiles<D, NWG>;
  constexpr int BK = T::BK, BQ = T::BQ, S = T::STAGES, ROWB = T::ROWB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t sK = base, sV = sK + T::KV_BYTES;
  const uint32_t sQ = sV + T::KV_BYTES;     // stage s at + s · Q_BYTES
  const uint32_t sD = sQ + S * T::Q_BYTES;  // dO, likewise
  const uint32_t bar = base + T::BAR_OFF;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (S + s); };
  const uint32_t kv_full = bar + 8u * (2 * S), kv_empty = kv_full + 8u;
  float* const stats = reinterpret_cast<float*>(sm + T::STAT_OFF);

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int nq64 = (a.lq + TILE - 1) / TILE, nk64 = (a.lk + TILE - 1) / TILE;
  const int4* const qtab = a.tab;
  const int4* const ktab = a.tab + nq64;
  // the block's key tiles: blockIdx.x and, paired, nkt - 1 - blockIdx.x
  const int nkt = (a.lk + BK - 1) / BK;
  const int t0 = blockIdx.x, t1 = a.pair ? nkt - 1 - t0 : t0;
  const int ntiles = t1 != t0 ? 2 : 1;
  // the block's q heads: share blockIdx.z of the group
  const int share = a.group / a.splits;
  const int h0 = kvh * a.group + blockIdx.z * share, h1 = h0 + share;
  const int causal = a.causal, has_window = a.has_window, window = a.window;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);         // the producer warp's lanes
      mbar_init(empty(s), 4 * NWG);   // every consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * NWG);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer warp: K and V per key tile, then the q tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(T::PRODUCER_REGS));
    if (tid >= NWG * 128 + 32) return;  // the warpgroup's idle warps
    const int lane = tid & 31;
    int it = 0;
    for (int i = 0; i < ntiles; ++i) {
      const int t = i == 0 ? t0 : t1;
      mbar_wait(kv_empty, (i & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::CB; ++c) {
          tma_load(sK + c * BK * ROWB, &maps.k, kv_full, c * ROWB / 2, t * BK, kvh);
          tma_load(sV + c * BK * ROWB, &maps.v, kv_full, c * ROWB / 2, t * BK, kvh);
        }
      }
      const Span ks = span_of(ktab, t * NWG, NWG, nk64);
      for (int h = h0; h < h1; ++h) {
        const size_t row0 = static_cast<size_t>(h) * a.lq;
        for (int qt = 0; qt < nq64; ++qt) {
          if (!maybe_visible(span_of(qtab, qt, 1, nq64), ks, causal,
                             has_window, window))
            continue;
          const int s = it % S;
          mbar_wait(empty(s), ((it / S) & 1) ^ 1);
          float* const st = stats + s * 4 * BQ;
#pragma unroll
          for (int r = lane; r < BQ; r += 32) {
            const int row = qt * BQ + r;
            const bool in = row < a.lq;
            const float l = in ? a.l[row0 + row] : 0.f;
            const bool live = l > 0.f;
            st[r] = live ? -a.m[row0 + row] * LOG2E : -INFINITY;
            st[BQ + r] = live ? 1.f / l : 0.f;
            st[2 * BQ + r] = in ? a.delta[row0 + row] : 0.f;
            reinterpret_cast<int*>(st)[3 * BQ + r] = in ? a.q_pos[row] : 0;
          }
          if (lane != 0) {
            mbar_arrive(full(s));
          } else {
            mbar_expect_tx(full(s), 2 * T::Q_BYTES);
#pragma unroll
            for (int c = 0; c < T::CB; ++c) {
              const uint32_t off = s * T::Q_BYTES + c * BQ * ROWB;
              tma_load(sQ + off, &maps.q, full(s), c * ROWB / 2, qt * BQ, h);
              tma_load(sD + off, &maps.dout, full(s), c * ROWB / 2, qt * BQ, h);
            }
          }
          ++it;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::CONSUMER_REGS));
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float sl2 = a.scale * LOG2E;
  const int bhkv = a.bh / a.group;
  // K-major operands: this warpgroup's K and V rows (A of Sᵀ and dPᵀ), a
  // stage's Q and dO rows (their B)
  const uint64_t dk_a = gmma_desc(sK + wg * 64 * ROWB, 16, 8 * ROWB, T::LAYOUT);
  const uint64_t dv_a = gmma_desc(sV + wg * 64 * ROWB, 16, 8 * ROWB, T::LAYOUT);
  const uint64_t dq_b = gmma_desc(sQ, 16, 8 * ROWB, T::LAYOUT);
  const uint64_t dd_b = gmma_desc(sD, 16, 8 * ROWB, T::LAYOUT);
  // Q and dO as MN-major B operands of dK += dSᵀ·Q and dV += Pᵀ·dO:
  // column blocks BQ · ROWB bytes apart, a k16 step is 16 rows (K1's V)
  const uint64_t dq_t = gmma_desc(sQ, BQ * ROWB, 8 * ROWB, T::LAYOUT);
  const uint64_t dd_t = gmma_desc(sD, BQ * ROWB, 8 * ROWB, T::LAYOUT);

  float dk[D / 2], dv[D / 2];  // element 4·dt + e: key row + 8·(e / 2),
                               // column 8·dt + 2·tig + e % 2
  float st[BQ / 2], dp[BQ / 2];  // Sᵀ then Pᵀ; dPᵀ then dSᵀ
  uint32_t pf[BQ / 16][4], df[BQ / 16][4];  // Pᵀ and dSᵀ in bf16
  int it = 0;
  for (int i = 0; i < ntiles; ++i) {
    const int t = i == 0 ? t0 : t1;
    const Span ks = span_of(ktab, t * NWG, NWG, nk64);
    const Span own = span_of(ktab, t * NWG + wg, 1, nk64);
    const int key0 = t * BK + wg * 64 + warp * 16 + g;  // and key0 + 8
    int kp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      kp[h] = key0 + 8 * h < a.lk ? a.k_pos[key0 + 8 * h] : -1;
    zero(dk);
    zero(dv);
    mbar_wait(kv_full, i & 1);
    for (int h = h0; h < h1; ++h) {
      for (int qt = 0; qt < nq64; ++qt) {
        const Span qs = span_of(qtab, qt, 1, nq64);
        if (!maybe_visible(qs, ks, causal, has_window, window)) continue;
        const int s = it % S;
        const bool mask = !all_visible(qs, own, causal, has_window, window);
        const uint64_t so = s * (T::Q_BYTES / 16);
        mbar_wait(full(s), (it / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BQ>::ss(st, dk_a + kstep<ROWB>(kk, BK),
                        dq_b + so + kstep<ROWB>(kk, BQ), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BQ>::ss(dp, dv_a + kstep<ROWB>(kk, BK),
                        dd_b + so + kstep<ROWB>(kk, BQ), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dp);
        const float* const sts = stats + s * 4 * BQ;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int c0 = 8 * j + 2 * tig;  // this thread's q rows: c0, c0 + 1
          const float2 nm = *reinterpret_cast<const float2*>(sts + c0);
          const float2 il = *reinterpret_cast<const float2*>(sts + BQ + c0);
          const float2 dl = *reinterpret_cast<const float2*>(sts + 2 * BQ + c0);
          const int2 qp =
              *reinterpret_cast<const int2*>(reinterpret_cast<const int*>(sts) + 3 * BQ + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            float p = ex2(fmaf(st[4 * j + e], sl2, odd ? nm.y : nm.x)) *
                      (odd ? il.y : il.x);
            if (mask && !visible(odd ? qp.y : qp.x, kp[e >> 1], causal,
                                 has_window, window))
              p = 0.f;
            st[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - (odd ? dl.y : dl.x));
          }
        }
        pack_a<BQ>(st, pf);
        pack_a<BQ>(dp, df);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          Wgmma<D>::rs(dv, pf[kk], dd_t + so + kk * 16 * ROWB / 16);
          Wgmma<D>::rs(dk, df[kk], dq_t + so + kk * 16 * ROWB / 16);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
        ++it;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty);
    // the key tile's dK (scaled) and dV, or the share's f32 partial sums
    const size_t n = static_cast<size_t>(bhkv) * a.lk * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= a.lk) continue;
      const size_t rbase = (static_cast<size_t>(kvh) * a.lk + key) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const size_t off = rbase + dt * 8 + 2 * tig;
        const float k0 = dk[4 * dt + 2 * h], k1 = dk[4 * dt + 2 * h + 1];
        const float v0 = dv[4 * dt + 2 * h], v1 = dv[4 * dt + 2 * h + 1];
        if (a.splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(a.dk + off) =
              __floats2bfloat162_rn(k0 * a.scale, k1 * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + off) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(a.partial + blockIdx.z * n + off) =
              make_float2(k0, k1);
          *reinterpret_cast<float2*>(a.partial + (a.splits + blockIdx.z) * n + off) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

// dK = scale · Σ_share partial, dV = Σ_share partial, the shares in order;
// n4 = BHkv·Lk·D / 4
__global__ void __launch_bounds__(256)
    reduce_dkdv_kernel(const float4* __restrict__ partial,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, long long n4,
                       int splits, float scale) {
  const long long step = static_cast<long long>(gridDim.x) * 256;
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < 2 * n4; i += step) {
    const bool is_v = i >= n4;
    const long long j = is_v ? i - n4 : i;
    const float4* p = partial + (is_v ? splits : 0) * n4 + j;
    float4 sum = p[0];
    for (int s = 1; s < splits; ++s) {
      const float4 x = p[s * n4];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const float f = is_v ? 1.f : scale;
    __nv_bfloat162 out[2] = {__floats2bfloat162_rn(sum.x * f, sum.y * f),
                             __floats2bfloat162_rn(sum.z * f, sum.w * f)};
    reinterpret_cast<uint2*>(is_v ? dv : dk)[j] =
        *reinterpret_cast<const uint2*>(out);
  }
}

template <int D, int NWG>
__global__ void __launch_bounds__(QTiles<D, NWG>::THREADS,
                                  QTiles<D, NWG>::MIN_BLOCKS)
    dq_hopper_kernel(const __grid_constant__ BwdMaps maps, const Bf16Args a) {
  using T = QTiles<D, NWG>;
  constexpr int BQ = T::BQ, BK = T::BK, S = T::STAGES, ROWB = T::ROWB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t sQ = base, sD = sQ + T::Q_BYTES;
  const uint32_t sK = sD + T::Q_BYTES;       // stage s at + s · KV_BYTES
  const uint32_t sV = sK + S * T::KV_BYTES;  // V, likewise
  const uint32_t bar = base + T::BAR_OFF;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (S + s); };
  const uint32_t qbar = bar + 8u * (2 * S);
  int* const kps = reinterpret_cast<int*>(sm + T::KPOS_OFF);  // [S][BK]

  const int tid = threadIdx.x;
  const int qh = blockIdx.x, kvh = qh / a.group;
  // under a causal mask the blocks with the most key tiles go first
  const int qb = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * BQ;
  const int nq64 = (a.lq + TILE - 1) / TILE, nk64 = (a.lk + TILE - 1) / TILE;
  const int4* const qtab = a.tab;
  const int4* const ktab = a.tab + nq64;
  const Span qs = span_of(qtab, qb * NWG, NWG, nq64);
  const int causal = a.causal, has_window = a.has_window, window = a.window;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), 4 * NWG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer warp: Q and dO once, then K, V and k positions ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(T::PRODUCER_REGS));
    if (tid >= NWG * 128 + 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CB; ++c) {
        tma_load(sQ + c * BQ * ROWB, &maps.q, qbar, c * ROWB / 2, q0, qh);
        tma_load(sD + c * BQ * ROWB, &maps.dout, qbar, c * ROWB / 2, q0, qh);
      }
    }
    int it = 0;
    for (int kt = 0; kt < nk64; ++kt) {
      if (!maybe_visible(qs, span_of(ktab, kt, 1, nk64), causal, has_window,
                         window))
        continue;
      const int s = it % S;
      mbar_wait(empty(s), ((it / S) & 1) ^ 1);
#pragma unroll
      for (int j = lane; j < BK; j += 32) {
        const int key = kt * BK + j;
        kps[s * BK + j] = key < a.lk ? a.k_pos[key] : -1;
      }
      if (lane != 0) {
        mbar_arrive(full(s));
      } else {
        mbar_expect_tx(full(s), 2 * T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::CB; ++c) {
          const uint32_t off = s * T::KV_BYTES + c * BK * ROWB;
          tma_load(sK + off, &maps.k, full(s), c * ROWB / 2, kt * BK, kvh);
          tma_load(sV + off, &maps.v, full(s), c * ROWB / 2, kt * BK, kvh);
        }
      }
      ++it;
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::CONSUMER_REGS));
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float sl2 = a.scale * LOG2E;
  const int r0 = q0 + wg * 64 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const size_t qrow0 = static_cast<size_t>(qh) * a.lq;
  float nm[2], il[2], dl[2];  // -m·log2(e), 1/l, Δ
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const bool in = row < a.lq;
    const float l = in ? a.l[qrow0 + row] : 0.f;
    const bool live = l > 0.f;
    nm[h] = live ? -a.m[qrow0 + row] * LOG2E : -INFINITY;
    il[h] = live ? 1.f / l : 0.f;
    dl[h] = in ? a.delta[qrow0 + row] : 0.f;
    qp[h] = in ? a.q_pos[row] : 0;
  }
  const Span own = span_of(qtab, qb * NWG + wg, 1, nq64);
  // K-major operands: this warpgroup's Q and dO rows (A of S and dP), a
  // stage's K and V rows (their B); K as the MN-major B of dQ += dS·K
  const uint64_t dq_a = gmma_desc(sQ + wg * 64 * ROWB, 16, 8 * ROWB, T::LAYOUT);
  const uint64_t dd_a = gmma_desc(sD + wg * 64 * ROWB, 16, 8 * ROWB, T::LAYOUT);
  const uint64_t dk_b = gmma_desc(sK, 16, 8 * ROWB, T::LAYOUT);
  const uint64_t dv_b = gmma_desc(sV, 16, 8 * ROWB, T::LAYOUT);
  const uint64_t dk_t = gmma_desc(sK, BK * ROWB, 8 * ROWB, T::LAYOUT);

  float acc[D / 2];  // dQ: element 4·dt + e is row r0 + 8·(e / 2), column
                     // 8·dt + 2·tig + e % 2
  float sc[BK / 2], dp[BK / 2];  // S then P; dP then dS
  uint32_t df[BK / 16][4];       // dS in bf16
  zero(acc);
  mbar_wait(qbar, 0);
  int it = 0;
  for (int kt = 0; kt < nk64; ++kt) {
    const Span ks = span_of(ktab, kt, 1, nk64);
    if (!maybe_visible(qs, ks, causal, has_window, window)) continue;
    const int s = it % S;
    const bool mask = !all_visible(own, ks, causal, has_window, window);
    const uint64_t so = s * (T::KV_BYTES / 16);
    mbar_wait(full(s), (it / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK>::ss(sc, dq_a + kstep<ROWB>(kk, BQ),
                    dk_b + so + kstep<ROWB>(kk, BK), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK>::ss(dp, dd_a + kstep<ROWB>(kk, BQ),
                    dv_b + so + kstep<ROWB>(kk, BK), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int* const kpt = kps + s * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int2 kp = *reinterpret_cast<const int2*>(kpt + j * 8 + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = ex2(fmaf(sc[4 * j + e], sl2, nm[h])) * il[h];
        if (mask && !visible(qp[h], (e & 1) ? kp.y : kp.x, causal,
                             has_window, window))
          p = 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[h]);
      }
    }
    pack_a<BK>(dp, df);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D>::rs(acc, df[kk], dk_t + so + kk * 16 * ROWB / 16);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    ++it;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= a.lq) continue;
    const size_t rbase = (qrow0 + row) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(a.dq + rbase + dt * 8 + 2 * tig) =
          __floats2bfloat162_rn(acc[4 * dt + 2 * h] * a.scale,
                                acc[4 * dt + 2 * h + 1] * a.scale);
  }
}

template <int D, int NWG>
cudaError_t launch_dkdv(const Bf16Args& a, cudaStream_t stream) {
  using T = KvTiles<D, NWG>;
  BwdMaps maps;
  memset(&maps, 0, sizeof(maps));
  const int bhkv = a.bh / a.group;
  if (!(tensor_map(&maps.q, a.q, D, a.lq, a.bh, T::BQ, T::ROWB) &&
        tensor_map(&maps.dout, a.dout, D, a.lq, a.bh, T::BQ, T::ROWB) &&
        tensor_map(&maps.k, a.k, D, a.lk, bhkv, T::BK, T::ROWB) &&
        tensor_map(&maps.v, a.v, D, a.lk, bhkv, T::BK, T::ROWB)))
    return cudaErrorInvalidValue;
  auto kern = dkdv_hopper_kernel<D, NWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (attr != cudaSuccess) return attr;
  const int nkt = (a.lk + T::BK - 1) / T::BK;
  const dim3 grid(a.pair ? (nkt + 1) / 2 : nkt, bhkv, a.splits);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(maps, a);
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t launch_dq(const Bf16Args& a, cudaStream_t stream) {
  using T = QTiles<D, NWG>;
  BwdMaps maps;
  memset(&maps, 0, sizeof(maps));
  bool ok = tensor_map(&maps.q, a.q, D, a.lq, a.bh, T::BQ, T::ROWB) &&
            tensor_map(&maps.dout, a.dout, D, a.lq, a.bh, T::BQ, T::ROWB);
  if (a.lk > 0)  // no K/V tile is loaded otherwise
    ok = ok && tensor_map(&maps.k, a.k, D, a.lk, a.bh / a.group, T::BK, T::ROWB) &&
         tensor_map(&maps.v, a.v, D, a.lk, a.bh / a.group, T::BK, T::ROWB);
  if (!ok) return cudaErrorInvalidValue;
  auto kern = dq_hopper_kernel<D, NWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.bh, (a.lq + T::BQ - 1) / T::BQ);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(maps, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_bf16(const Bf16Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.bh) * a.lq;
  const long long threads = rows * (D / 8);
  delta_bf16_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                         stream>>>(a.o, a.dout, a.delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nq64 = (a.lq + TILE - 1) / TILE, nk64 = (a.lk + TILE - 1) / TILE;
  bounds_kernel<<<(nq64 + nk64 + 3) / 4, 128, 0, stream>>>(
      a.q_pos, a.k_pos, a.tab, a.lq, a.lk, nq64, nk64);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.lk > 0) {
    err = launch_dkdv<D, kv_warpgroups(D)>(a, stream);
    if (err != cudaSuccess) return err;
    if (a.splits > 1) {
      const long long n4 = static_cast<long long>(a.bh / a.group) * a.lk * D / 4;
      const long long blocks = (2 * n4 + 255) / 256;
      reduce_dkdv_kernel<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056),
                           256, 0, stream>>>(
          reinterpret_cast<const float4*>(a.partial), a.dk, a.dv, n4, a.splits,
          a.scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return launch_dq<D, Q_WARPGROUPS>(a, stream);
}

cudaError_t dispatch_bf16(const Bf16Args& a, int d, int kv_wg,
                          cudaStream_t stream) {
  // the plan must name an instantiation, and its scratch must be there
  if (kv_wg != kv_warpgroups(d) || a.splits < 1 ||
      a.group % a.splits || a.tab == nullptr ||
      (a.splits > 1 && a.partial == nullptr))
    return cudaErrorInvalidValue;
  switch (d) {
    case 16: return run_bf16<16>(a, stream);
    case 32: return run_bf16<32>(a, stream);
    case 64: return run_bf16<64>(a, stream);
    case 128: return run_bf16<128>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike);
// delta is f32 scratch of bh * lq.  The bf16 body also takes the tile plan
// (kv_wg, splits, pair; kernels/flash_mqkv.py: bwd_tile_plan), int32
// scratch `tiles` of 4 · (ceil(lq / 64) + ceil(lk / 64)) and, when splits
// > 1, f32 scratch `partial` of 2 · splits · (bh / group) · lk · d; the f32
// path reads none of them.  Returns a cudaError_t (0 = launched).
extern "C" int flash_mqkv_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const float* m,
                              const float* l, const int* q_pos,
                              const int* k_pos, float* delta, void* dq,
                              void* dk, void* dv, int bh, int lq, int lk,
                              int d, int group, int dtype, float scale,
                              int causal, int has_window, int window,
                              int* tiles, float* partial, int kv_wg,
                              int splits, int pair, void* stream) {
  if (group <= 0 || bh % group) return cudaErrorInvalidValue;
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(
        Params<float>{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<const float*>(o),
                      static_cast<const float*>(dout), m, l, q_pos, k_pos, delta,
                      static_cast<float*>(dq), static_cast<float*>(dk),
                      static_cast<float*>(dv), bh, lq, lk, group, scale, causal,
                      has_window, window},
        d, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    const Bf16Args a{static_cast<const B*>(q), static_cast<const B*>(k),
                     static_cast<const B*>(v), static_cast<const B*>(o),
                     static_cast<const B*>(dout), m, l, q_pos, k_pos, delta,
                     reinterpret_cast<int4*>(tiles), partial,
                     static_cast<B*>(dq), static_cast<B*>(dk),
                     static_cast<B*>(dv), bh, lq, lk, group, scale, causal,
                     has_window, window, splits, pair};
    return dispatch_bf16(a, d, kv_wg, s);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 body's kernel (0 = dK/dV, 1 = dQ) at
// head dim d (0 if there is no such instantiation): what
// kernels/flash_mqkv.py's bwd_smem_bytes must equal.
extern "C" long long flash_mqkv_bwd_smem_bytes(int kernel, int d) {
#define BWD_SMEM(D_)                                                        \
  if (d == D_) {                                                            \
    if (kernel == 0)                                                        \
      return static_cast<long long>(KvTiles<D_, kv_warpgroups(D_)>::SMEM);  \
    if (kernel == 1)                                                        \
      return static_cast<long long>(QTiles<D_, Q_WARPGROUPS>::SMEM);        \
    return 0;                                                               \
  }
  BWD_SMEM(16) BWD_SMEM(32) BWD_SMEM(64) BWD_SMEM(128)
#undef BWD_SMEM
  return 0;
}

extern "C" const char* flash_mqkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
