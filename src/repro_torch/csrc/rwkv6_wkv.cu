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
// D spans the whole chunk, so at chunk 64 a mean decay of ~0.25 or less
// underflows it, as in the TPU kernel (ROADMAP F3): mirrored, not fixed.
// Inputs are read through strides (batch, head, time; channels
// contiguous), so the model hands over its [B, L, H, N] projections
// without a transposed copy; each of r, k, v, w, u is float32 or bfloat16
// on its own.
//
// Bound on an H100: at the main path's shape (BH 128, L 4096, N 64, chunk
// 64; r, k, v bf16, w f32, o f32) the kernel must move ~470 MB (0.140 ms
// at 3.35 TB/s) and do ~13.2 GFLOP: 0.196 ms on the CUDA cores in float32,
// but 0.027 ms on the tensor cores in TF32, or ~0.080 ms at the 3 products
// per float32 product used here.  With the products on the tensor cores,
// bytes bound it.
//
// Design.  One block per (row, block of TV value columns): value columns
// are independent, so the wrapper splits them over 1, 2 or 4 blocks where
// there are too few rows to fill the card, and each block recomputes the
// decays and att.  The TPU grid's sequential chunk axis becomes a loop
// inside the block.  16 warps, 128 registers each:
//   * Loads.  Thread 0 brings each chunk's r, k, v, w tiles with TMA (one
//     4-D tensor map per input over (N, head, time, batch), built on the
//     host; box (N, 1, c, 1), v's box only the block's TV columns) into a
//     ring of up to three shared-memory stages (two at the main path's
//     shape), each completing on its mbarrier.  A stage is refilled with
//     the chunk `stages` ahead as soon as this chunk's operands are formed
//     from it, so those loads land while the products run.  There is no
//     producer warp: a 17th warp would lower every warp's register cap
//     below 128 (ptxas sizes the register file for groups of four warps;
//     a 9-warp block of this kernel was capped at 168 and spilled).
//   * Decays in parallel: log(clip(w)) over the tile, lanes along
//     channels; then an inclusive warp scan (shuffles, one lane per step,
//     steps 32..63 in a second half) for N/16 channels per warp at once;
//     D and D₋ = exp(log D - log w) as the TPU kernel forms them, and a_c;
//     then r·D₋, k/D and the bonus diagonal r·u·k (a shuffle reduction
//     over 32 channels), lanes along channels.  Every shared-memory access
//     of these passes is free of bank conflicts.
//   * All four chunk products run on the tensor cores, mma.sync m16n8k8
//     TF32 with float32 accumulators: att = (r·D₋)(k/D)^T (only the groups
//     of column tiles that reach the diagonal), att·v, (r·D₋)·S_in and the
//     increment (k/D)^T v.  Each float32 operand is split x = hi + lo (hi
//     = tf32(x), lo = tf32(x - hi)) and a·b taken as lo·hi' + hi·lo' +
//     hi·hi' (3×TF32), which keeps float32 accuracy (single TF32 keeps ~3
//     digits); a bfloat16 v is exact in TF32, so att·v and the increment
//     take 2 products then.  att never leaves registers: its accumulator
//     fragments are the A operand of att·v once the k index inside each
//     8-wide slab is permuted (k ↔ 2k, k+4 ↔ 2k+1), and v's fragments are
//     loaded in the same order.  Operand buffers are padded so that every
//     fragment load is free of bank conflicts.  c or N below 16 pad the
//     MMA's 16 rows with zeros.
//   * Warps 0-7 ("o warps") take att, att·v and diag·v for a row tile of o
//     and half the block's columns; warps 8-15 ("S warps") take (r·D₋)·S_in
//     for a row tile of o (into shared memory, added to o after the next
//     barrier) and the state's update for a row tile of S.  The warps on
//     each of the SM's four schedulers hold o tiles k and 3 - k, so the
//     triangular att work is even across them.
//   * Only the S chain is serial: S warps keep their rows of S in
//     registers in float32, add the increment onto them and scale by a_c;
//     S is stored to shared memory once per chunk for the next chunk's
//     (r·D₋)·S_in.  att, att·v, the diagonal and the increment read no S.
//   What bounds it (scripts/wkv_phases.py on an H100): the decays and the
//   operands, then the products, one after the other, each about half of
//   a chunk's clocks; neither overlaps the other.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "mbarrier.cuh"
#include "tensor_map.cuh"
#include "wkv_mma.cuh"

namespace {

constexpr int WARPS = 16;            // warps of a block
constexpr int OWARPS = 8;            // of which o warps (the rest S warps)
constexpr int THREADS = WARPS * 32;
constexpr int MAX_STAGES = 3;
constexpr int MIN_SPLIT_COLUMNS = 16;  // value columns of a block of a split row
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block can use
constexpr float EPS = 1e-6f;

// Phase probes, compiled in only with -DK5_PROBES (scripts/wkv_phases.py):
// lane 0 of every warp adds the SM clocks spent in each phase of the chunk
// loop to k5_probes[warp][phase], summed over blocks: 0 wait for the
// stage, 1 the decays and the operands, 2 their barrier and the refill, 3
// the products, 4 the S barrier and the stores of o and S.
#ifdef K5_PROBES
constexpr int PROBES = 5;
__device__ unsigned long long k5_probes[WARPS][PROBES];
#define PROBE_INIT             \
  long long probe_t = clock64(); \
  long long probe_acc[PROBES] = {};
#define PROBE(i)                     \
  {                                  \
    const long long now = clock64(); \
    probe_acc[i] += now - probe_t;   \
    probe_t = now;                   \
  }
#define PROBE_SAVE                         \
  if (lane == 0)                           \
    for (int p = 0; p < PROBES; ++p)       \
      atomicAdd(&k5_probes[warp][p],       \
                static_cast<unsigned long long>(probe_acc[p]));
#else
#define PROBE_INIT
#define PROBE(i)
#define PROBE_SAVE
#endif

struct Maps {  // r, k, v, w: 4-D over (N, then head, time, batch in `order`)
  CUtensorMap r, k, v, w;
};

struct Args {
  const void* u;  // u[(bh % u_rows) * N + n]
  int u_bf16, u_rows;
  int bf16;  // bit 0 r, 1 k, 2 v, 3 w
  float* o;
  long long ob, oh, ol;
  int heads;  // row bh = b * heads + h
  int l;
  int stages;
  // per map: which coordinate (0 head, 1 time, 2 batch) dims 1, 2, 3 take,
  // two bits each
  unsigned order[4];
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int up128(int x) { return (x + 127) / 128 * 128; }

// The ring's stage: r, k, v, w tiles at 128-byte aligned offsets.
struct Ring {
  int k, v, w;  // byte offsets (r at 0)
  int bytes;    // a stage
  int tx;       // bytes the stage's four loads bring
};

__host__ __device__ inline Ring ring_of(int c, int n, int tv, int bf16) {
  const int r = c * n * ((bf16 & 1) ? 2 : 4), k = c * n * ((bf16 & 2) ? 2 : 4),
            v = c * tv * ((bf16 & 4) ? 2 : 4), w = c * n * ((bf16 & 8) ? 2 : 4);
  Ring g;
  g.k = up128(r);
  g.v = g.k + up128(k);
  g.w = g.v + up128(v);
  g.bytes = g.w + up128(w);
  g.tx = r + k + v + w;
  return g;
}

// Shared-memory plan of one block (float offsets), for chunk c, head size
// n and tv value columns.  Row strides make every MMA fragment load free
// of bank conflicts (see the loads in the kernel).
struct Plan {
  int CP, NP;   // time and channel rows, padded to the MMA's 16
  int MT, MS;   // row tiles of o and of S (two warps each, a column half
                // apiece)
  int JT;       // 8-column tiles of o and S
  int CPW;      // channels per warp in the decays' scans
  int LD, LDV, LDS, LDX;  // row strides of rs/ks, vs, st/ob, lx/dx
  int RS, KS, VS, ST, OB, LX, DX, DG, AC, US, FLOATS;
  int BARS, RING;  // byte offsets: the stages' mbarriers; the stages
};

__host__ __device__ constexpr Plan plan_of(int c, int n, int tv) {
  Plan p{};
  p.CP = cmax(c, 16);
  p.NP = cmax(n, 16);
  p.MT = p.CP / 16;
  p.MS = p.NP / 16;
  p.JT = tv / 8;
  p.CPW = n >= WARPS ? n / WARPS : 1;
  p.LD = p.NP + 4;            // rs, ks [CP][LD]
  p.LDV = tv + 4;             // vs [CP][LDV]
  p.LDS = tv / 16 * 16 + 8;   // st [NP][LDS], ob [CP][LDS]
  p.LDX = n + 1;              // lx, dx [c][LDX]
  p.RS = 0;                    // r·D₋
  p.KS = p.RS + p.CP * p.LD;   // k/D
  p.VS = p.KS + p.CP * p.LD;   // v, float32
  p.ST = p.VS + p.CP * p.LDV;  // S_in
  p.OB = p.ST + p.NP * p.LDS;  // (r·D₋)·S_in, from the S warps
  p.LX = p.OB + p.CP * p.LDS;  // log w, then D₋
  p.DX = p.LX + c * p.LDX;     // D
  p.DG = p.DX + c * p.LDX;     // [2][c] partial r·u·k
  p.AC = p.DG + 2 * c;         // a_c [NP]
  p.US = p.AC + p.NP;          // u [NP]
  p.FLOATS = p.US + p.NP;
  p.BARS = up128(p.FLOATS * 4);
  p.RING = p.BARS + 128;
  return p;
}

// Ring stages that fit beside the plan (at most MAX_STAGES; 0 if none).
__host__ __device__ inline int stages_of(const Plan& p, const Ring& g) {
  const int s = (SMEM_LIMIT - p.RING) / g.bytes;
  return s > MAX_STAGES ? MAX_STAGES : s;
}

// B fragments of v for the rows s0 .. s0 + 7 in the order k ↔ 2k,
// k+4 ↔ 2k+1, one per 8-column tile from column j0
template <int JT, int LDV>
struct VFrag {
  float b[JT][2];
};

template <int JT, int LDV>
__device__ __forceinline__ VFrag<JT, LDV> v_frag(const float* vs, int s0,
                                                 int j0, int tq, int g8) {
  VFrag<JT, LDV> f;
  const float* p = vs + (s0 + 2 * tq) * LDV + j0 + g8;
#pragma unroll
  for (int jn = 0; jn < JT; ++jn) {
    f.b[jn][0] = p[8 * jn];
    f.b[jn][1] = p[LDV + 8 * jn];
  }
  return f;
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, unsigned order, int col,
                                         int h, int t, int b) {
  int crd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const unsigned which = (order >> (2 * i)) & 3u;
    crd[i] = which == 0 ? h : which == 1 ? t : b;
  }
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
      "r"(col), "r"(crd[0]), "r"(crd[1]), "r"(crd[2]) : "memory");
}

template <int C, int N, int TV>
__global__ void __launch_bounds__(THREADS, 1)
    wkv_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr Plan P = plan_of(C, N, TV);
  static_assert((N % WARPS == 0 || N < WARPS) && TV % 8 == 0 && TV >= 8,
                "shape");
  static_assert(MAX_STAGES * 8 <= 128, "barriers");
  constexpr int LD = P.LD, LDV = P.LDV, LDS = P.LDS, LDX = P.LDX,
                CPW = P.CPW, JT = P.JT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* const f = reinterpret_cast<float*>(smem);
  float* const rs = f + P.RS;
  float* const ks = f + P.KS;
  float* const vs = f + P.VS;
  float* const st = f + P.ST;
  float* const ob = f + P.OB;
  float* const lx = f + P.LX;
  float* const dx = f + P.DX;
  float* const dg = f + P.DG;
  float* const ac = f + P.AC;
  float* const us = f + P.US;
  const uint32_t bars = smem_u32(smem + P.BARS);
  auto full = [&](int s) { return bars + 8u * s; };
  unsigned char* const ring = smem + P.RING;
  const Ring g = ring_of(C, N, TV, a.bf16);

  // the warp index read through a shuffle, which the compiler knows to be
  // the same on every lane: branches on it need no reconvergence
  const int tid = threadIdx.x, lane = tid % 32,
            warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int bh = blockIdx.x, j0 = blockIdx.y * TV;
  const int b = bh / a.heads, h = bh % a.heads;
  const int chunks = a.l / C, stages = a.stages;

  // padding rows and columns stay zero for the whole launch; S_0 = 0
  for (int i = tid; i < P.US; i += THREADS) f[i] = 0.f;
  if (tid < P.NP) {
    const unsigned char* const u = static_cast<const unsigned char*>(a.u);
    const int i = (bh % a.u_rows) * N + tid;
    us[tid] = tid >= N ? 0.f : a.u_bf16 ? ld_as<true>(u, i) : ld_as<false>(u, i);
  }
  // chunk i's tiles go to stage i mod stages, whose mbarrier completes
  // when they have landed; thread 0 issues them (expect-tx arrival)
  auto load = [&](int i) {
    const int s = i % stages, t0 = i * C;
    unsigned char* const stage = ring + s * g.bytes;
    mbar_expect_tx(full(s), g.tx);
    tma_load(stage, &maps.r, full(s), a.order[0], 0, h, t0, b);
    tma_load(stage + g.k, &maps.k, full(s), a.order[1], 0, h, t0, b);
    tma_load(stage + g.v, &maps.v, full(s), a.order[2], j0, h, t0, b);
    tma_load(stage + g.w, &maps.w, full(s), a.order[3], 0, h, t0, b);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < stages && i < chunks; ++i) load(i);
  }
  __syncthreads();


  const bool rbf = a.bf16 & 1, kbf = a.bf16 & 2, vbf = a.bf16 & 4,
             wbf = a.bf16 & 8;
  const int g8 = lane / 4, tq = lane % 4;  // MMA fragment coordinates
  // Warps [0, OWARPS) own o, the others S, each a row tile and one half
  // of the block's TV columns (JH 8-column tiles from column jh; with one
  // tile of columns only the first half works).  Warp w runs on the SM's
  // scheduler w mod 4, which takes o tiles k and 3 - k and S tile k: the
  // lower-triangular att work is the same on every scheduler.  Each kind
  // runs its own copy of the chunk loop, so that neither holds the
  // other's registers.
  constexpr int JH = JT > 1 ? JT / 2 : 1;
  const int half = (warp % OWARPS) / 4, quad = warp % 4;
  const int tile = warp < OWARPS && half == 1 ? 3 - quad : quad;
  const int jh = 8 * JH * half;
  float* const o = a.o + b * a.ob + h * a.oh + j0;
  auto consume = [&](auto o_kind) {
    constexpr bool O = decltype(o_kind)::value;
    // an o warp's row tile of o, an S warp's of S (its (r·D₋)·S_in runs
    // while tile < MT)
    const bool busy = tile < (O ? P.MT : P.MS) && jh < TV;
    // an S warp's rows 16·tile + g8 and + 8 of S, its JH column tiles
    constexpr int SJ = O ? 1 : JH;
    float sreg[SJ][4];
#pragma unroll
    for (int jn = 0; jn < SJ; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sreg[jn][e] = 0.f;

    PROBE_INIT
    for (int i = 0; i < chunks; ++i) {
      const int s = i % stages;
      mbar_wait(full(s), (i / stages) & 1);
      const unsigned char* const stage = ring + s * g.bytes;
      PROBE(0)

      // 1. decays.  log(clip(w)) over the whole tile, lanes along channels
      constexpr int TILE_IT = (C * N + WARPS * 32 - 1) / (WARPS * 32);
      constexpr bool FULL = C * N % (WARPS * 32) == 0;  // no ragged pass
      on_type(wbf, [&](auto wb) {
#pragma unroll 4
        for (int it = 0; it < TILE_IT; ++it) {
          const int e = tid + it * WARPS * 32, t = e / N, n = e % N;
          if (FULL || e < C * N) {
            const float wv = ld_as<decltype(wb)::value>(stage + g.w, e);
            lx[t * LDX + n] = logf(fminf(fmaxf(wv, EPS), 1.f));
          }
        }
      });
      __syncthreads();
      {  // inclusive scans over the steps of this warp's channels n0 ..
         // n0 + CPW - 1, one lane per step, all of them at once (steps
         // 32..63 in a second half); D, D₋ = exp(log D - log w) and a_c
        const int n0 = warp * CPW;
        constexpr int H2 = C > 32 ? 2 : 1;
        if (n0 < N) {
        float x[H2][CPW], sc[H2][CPW];
#pragma unroll
        for (int hf = 0; hf < H2; ++hf)
#pragma unroll
          for (int q = 0; q < CPW; ++q) {
            const int t = lane + 32 * hf;
            x[hf][q] = t < C ? lx[t * LDX + n0 + q] : 0.f;
            sc[hf][q] = x[hf][q];
          }
#pragma unroll
        for (int d = 1; d < 32; d <<= 1)
#pragma unroll
          for (int hf = 0; hf < H2; ++hf)
#pragma unroll
            for (int q = 0; q < CPW; ++q) {
              const float y = __shfl_up_sync(0xffffffffu, sc[hf][q], d);
              if (lane >= d) sc[hf][q] += y;
            }
#pragma unroll
        for (int q = 0; q < CPW; ++q) {
          if (H2 == 2) sc[H2 - 1][q] += __shfl_sync(0xffffffffu, sc[0][q], 31);
#pragma unroll
          for (int hf = 0; hf < H2; ++hf) {
            const int t = lane + 32 * hf;
            if (t < C) {
              const float d = expf(sc[hf][q]);
              lx[t * LDX + n0 + q] = expf(sc[hf][q] - x[hf][q]);
              dx[t * LDX + n0 + q] = d;
              if (t == C - 1) ac[n0 + q] = d;
            }
          }
        }
        }
      }
      __syncthreads();
      // r·D₋, k/D and r·u·k, lanes along channels: LN lanes share a step and
      // reduce r·u·k over their channels into dg[n / LN][t].  C·N is a
      // multiple of 32, so a warp is in or out of an iteration as a whole,
      // and the shuffles run converged.
      constexpr int LN = N < 32 ? N : 32;
      on_type(rbf, [&](auto rb) {
        on_type(kbf, [&](auto kb) {
#pragma unroll 4
          for (int it = 0; it < TILE_IT; ++it) {
            const int e = tid + it * WARPS * 32, t = e / N, n = e % N;
            if (FULL || e < C * N) {
              const float rv = ld_as<decltype(rb)::value>(stage, e),
                          kv = ld_as<decltype(kb)::value>(stage + g.k, e);
              rs[t * LD + n] = rv * lx[t * LDX + n];
              ks[t * LD + n] = __fdividef(kv, dx[t * LDX + n]);
              float p = rv * us[n] * kv;
#pragma unroll
              for (int m = LN / 2; m > 0; m >>= 1)
                p += __shfl_xor_sync(0xffffffffu, p, m);
              if (n % LN == 0) dg[n / LN * C + t] = p;
            }
          }
        });
      });
      on_type(vbf, [&](auto vb) {
#pragma unroll 4
        for (int e = tid; e < C * TV; e += WARPS * 32)
          vs[e / TV * LDV + e % TV] = ld_as<decltype(vb)::value>(stage + g.v, e);
      });
      PROBE(1)
      __syncthreads();  // operands ready, stage s read; S_in stored
      // refill stage s: its loads land while the next chunks are processed
      if (tid == 0 && i + stages < chunks) load(i + stages);
      PROBE(2)

      // 2. o warps: o rows [16·tile, 16·tile + 16), columns [jh, jh +
      //    8·JH): att on and below the diagonal, att·v and diag·v; the S
      //    warps' (r·D₋)·S_in is added after the next barrier
      constexpr int AT = 2 * P.MT;  // att's 8-column tiles, at most
      constexpr int AG = AT > 4 ? 4 : AT;  // taken AG at a time
      float acc[O ? JH : 1][4];
      if constexpr (O) if (busy) {
        const int t_lo = 16 * tile + g8;
        // the groups of AG column tiles that reach the diagonal; tiles
        // above it are computed and masked (straight-line code)
        const int groups = (2 * tile + 1) / AG + 1;
        float att[AT][4];
#pragma unroll
        for (int jt = 0; jt < AT; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) att[jt][e] = 0.f;
#pragma unroll
        for (int jn = 0; jn < JH; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
        // att = (r·D₋)(k/D)^T over the channels; B[n][s] = ks[s][n]
        auto att_group = [&](auto off) {
          constexpr int G0 = decltype(off)::value;
#pragma unroll
          for (int kk = 0; kk < P.NP / 8; ++kk) {
            uint32_t ah[4], al[4], bh[AG][2], bl[AG][2];
            a_frag(rs + t_lo * LD + 8 * kk + tq, LD, ah, al);
            float kb[AG][2];
#pragma unroll
            for (int q = 0; q < AG; ++q) {
              const float* p = ks + (8 * (G0 + q) + g8) * LD + 8 * kk + tq;
              kb[q][0] = p[0];
              kb[q][1] = p[4];
            }
            b_split(kb, false, bh, bl);
            mma3<G0>(att, ah, al, bh, bl, false);
          }
        };
        att_group(std::integral_constant<int, 0>{});
        if constexpr (AT > AG)
          if (groups > 1) att_group(std::integral_constant<int, AG>{});
#pragma unroll
        for (int jt = 0; jt < AT; ++jt) {
          if (jt < groups * AG) {
            // strictly lower triangle: s < t
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = t_lo + (e >= 2 ? 8 : 0), sc = 8 * jt + 2 * tq + (e & 1);
              if (sc >= t) att[jt][e] = 0.f;
            }
            // att's accumulator fragment as the A operand, k ↔ 2k, k+4 ↔ 2k+1
            uint32_t ah[4], al[4];
            split(att[jt][0], ah[0], al[0]);
            split(att[jt][2], ah[1], al[1]);
            split(att[jt][1], ah[2], al[2]);
            split(att[jt][3], ah[3], al[3]);
            uint32_t bh[JH][2], bl[JH][2];
            b_split(v_frag<JH, LDV>(vs, 8 * jt, jh, tq, g8).b, vbf, bh, bl);
            mma3(acc, ah, al, bh, bl, vbf);
          }
        }
        float d0 = 0.f, d1 = 0.f;  // r·u·k at rows t_lo and t_lo + 8
#pragma unroll
        for (int q = 0; q < (N > 32 ? 2 : 1); ++q) {
          if (t_lo < C) d0 += dg[q * C + t_lo];
          if (t_lo + 8 < C) d1 += dg[q * C + t_lo + 8];
        }
#pragma unroll
        for (int jn = 0; jn < JH; ++jn) {
          const float* v0 = vs + t_lo * LDV + jh + 8 * jn + 2 * tq;
          acc[jn][0] = fmaf(d0, v0[0], acc[jn][0]);
          acc[jn][1] = fmaf(d0, v0[1], acc[jn][1]);
          acc[jn][2] = fmaf(d1, v0[8 * LDV], acc[jn][2]);
          acc[jn][3] = fmaf(d1, v0[8 * LDV + 1], acc[jn][3]);
        }
      }

      // 3. S warps: (r·D₋)·S_in for o rows [16·tile, 16·tile + 16) into
      //    ob, then S rows [16·tile, 16·tile + 16): S = a_c ⊙ (S_in +
      //    (k/D)^T v), k ↔ 2k, k+4 ↔ 2k+1 in A (ks read transposed) and B
      //    (vs); columns [jh, jh + 8·JH) in both
      if constexpr (!O) if (tile < P.MT && jh < TV) {
        const int t_lo = 16 * tile + g8;
        float rsi[JH][4];
#pragma unroll
        for (int jn = 0; jn < JH; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) rsi[jn][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < P.NP / 8; ++kk) {
          uint32_t ah[4], al[4], bh[JH][2], bl[JH][2];
          a_frag(rs + t_lo * LD + 8 * kk + tq, LD, ah, al);
          float sb[JH][2];  // B[n][j] = st[n][j]
#pragma unroll
          for (int jn = 0; jn < JH; ++jn) {
            const float* p = st + (8 * kk + tq) * LDS + jh + 8 * jn + g8;
            sb[jn][0] = p[0];
            sb[jn][1] = p[4 * LDS];
          }
          b_split(sb, false, bh, bl);
          mma3(rsi, ah, al, bh, bl, false);
        }
#pragma unroll
        for (int jn = 0; jn < JH; ++jn) {
          float* p = ob + t_lo * LDS + jh + 8 * jn + 2 * tq;
          *reinterpret_cast<float2*>(p) = make_float2(rsi[jn][0], rsi[jn][1]);
          *reinterpret_cast<float2*>(p + 8 * LDS) =
              make_float2(rsi[jn][2], rsi[jn][3]);
        }
      }
      if constexpr (!O) if (busy) {
        const int n_lo = 16 * tile + g8;
#pragma unroll
        for (int kk = 0; kk < P.CP / 8; ++kk) {
          uint32_t ah[4], al[4], bh[JH][2], bl[JH][2];
          const float* ka = ks + (8 * kk + 2 * tq) * LD + n_lo;
          split(ka[0], ah[0], al[0]);
          split(ka[8], ah[1], al[1]);
          split(ka[LD], ah[2], al[2]);
          split(ka[LD + 8], ah[3], al[3]);
          b_split(v_frag<JH, LDV>(vs, 8 * kk, jh, tq, g8).b, vbf, bh, bl);
          mma3(sreg, ah, al, bh, bl, vbf);
        }
        const float a0 = ac[n_lo], a1 = ac[n_lo + 8];
#pragma unroll
        for (int jn = 0; jn < JH; ++jn) {
          sreg[jn][0] *= a0;
          sreg[jn][1] *= a0;
          sreg[jn][2] *= a1;
          sreg[jn][3] *= a1;
        }
      }
      PROBE(3)
      __syncthreads();  // ob written; every read of the operands and S_in done
      if constexpr (O) if (busy) {  // o = att·v + diag·v + (r·D₋)·S_in
        const int t_lo = 16 * tile + g8;
        const long long t0 = static_cast<long long>(i) * C;
#pragma unroll
        for (int jn = 0; jn < JH; ++jn) {
          const int j = jh + 8 * jn + 2 * tq;
          const float* p = ob + t_lo * LDS + j;
          if (t_lo < C)
            *reinterpret_cast<float2*>(o + (t0 + t_lo) * a.ol + j) =
                make_float2(acc[jn][0] + p[0], acc[jn][1] + p[1]);
          if (t_lo + 8 < C)
            *reinterpret_cast<float2*>(o + (t0 + t_lo + 8) * a.ol + j) =
                make_float2(acc[jn][2] + p[8 * LDS], acc[jn][3] + p[8 * LDS + 1]);
        }
      }
      if constexpr (!O) if (busy) {
        const int n_lo = 16 * tile + g8;
#pragma unroll
        for (int jn = 0; jn < JH; ++jn) {
          float* p = st + n_lo * LDS + jh + 8 * jn + 2 * tq;
          *reinterpret_cast<float2*>(p) = make_float2(sreg[jn][0], sreg[jn][1]);
          *reinterpret_cast<float2*>(p + 8 * LDS) =
              make_float2(sreg[jn][2], sreg[jn][3]);
        }
      }
      PROBE(4)
    }
    PROBE_SAVE
  };
  if (warp < OWARPS)
    consume(std::true_type{});
  else
    consume(std::false_type{});
}

// One input's tensor map: dim 0 the channels (n_cols, a box of box_cols),
// then head, time and batch, those of extent > 1 by stride and those of
// extent 1 after them (with a packed stride, which TMA never steps), the
// time box c.  `order` receives which coordinate each dim takes.
bool input_map(CUtensorMap* map, unsigned* order, const void* p, int bf16,
               const long long* strides, int heads, int l, int batch,
               int n_cols, int box_cols, int c) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long es = bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  // strides arrive as (batch, head, time); dims here as (head, time, batch)
  const long long size[3] = {heads, l, batch};
  const long long step[3] = {strides[1] * es, strides[2] * es, strides[0] * es};
  int idx[3] = {0, 1, 2};
  auto before = [&](int x, int y) {  // x ahead of y
    if ((size[x] == 1) != (size[y] == 1)) return size[y] == 1;
    return size[x] > 1 && step[x] < step[y];
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(idx[j], idx[j - 1]); --j) {
      const int t = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = t;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(n_cols), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  long long packed = (n_cols * es + 15) / 16 * 16;
  *order = 0;
  for (int i = 0; i < 3; ++i) {
    const int d = idx[i];
    const long long sb = size[d] > 1 ? step[d] : packed;
    if (sb <= 0 || sb % 16) return false;
    dims[i + 1] = static_cast<cuuint64_t>(size[d]);
    gstride[i] = static_cast<cuuint64_t>(sb);
    if (d == 1) box[i + 1] = static_cast<cuuint32_t>(c);
    *order |= static_cast<unsigned>(d) << (2 * i);
    packed = sb * size[d];
  }
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(p), dims, gstride, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Launch {
  const void* in[4];  // r, k, v, w
  const long long* strides;  // (batch, head, time) for r, k, v, w, o
  int bh, batch;
  cudaStream_t stream;
};

template <int C, int N, int TV>
cudaError_t launch(const Launch& x, Args a) {
  constexpr Plan P = plan_of(C, N, TV);
  const Ring g = ring_of(C, N, TV, a.bf16);
  const int stages = stages_of(P, g);
  if (stages < 1) return cudaErrorInvalidValue;
  a.stages = stages;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  CUtensorMap* m[4] = {&maps.r, &maps.k, &maps.v, &maps.w};
  for (int i = 0; i < 4; ++i) {
    const bool v = i == 2;
    if (!input_map(m[i], &a.order[i], x.in[i], (a.bf16 >> i) & 1,
                   x.strides + 3 * i, a.heads, a.l, x.batch, N, v ? TV : N, C))
      return cudaErrorInvalidValue;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_kernel<C, N, TV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(x.bh, N / TV);
  wkv_kernel<C, N, TV><<<grid, THREADS, P.RING + stages * g.bytes, x.stream>>>(
      maps, a);
  return cudaGetLastError();
}

template <int C, int N>
cudaError_t launch_split(const Launch& x, const Args& a, int split) {
  if (split == 1) return launch<C, N, N>(x, a);
  if constexpr (N / 2 >= MIN_SPLIT_COLUMNS)
    if (split == 2) return launch<C, N, N / 2>(x, a);
  if constexpr (N / 4 >= MIN_SPLIT_COLUMNS)
    if (split == 4) return launch<C, N, N / 4>(x, a);
  return cudaErrorInvalidValue;
}

template <int C>
cudaError_t launch_n(const Launch& x, const Args& a, int n, int split) {
  switch (n) {
    case 8: return launch_split<C, 8>(x, a, split);
    case 16: return launch_split<C, 16>(x, a, split);
    case 32: return launch_split<C, 32>(x, a, split);
    case 64: return launch_split<C, 64>(x, a, split);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 15 values, (batch, head, time) for r, k, v, w and o in turn.
// bf16: bit 0 r, 1 k, 2 v, 3 w, 4 u.  The chunk c divides l; c and n are
// 8, 16, 32 or 64; `split` blocks of n / split value columns per row (1,
// or 2 and 4 while n / split >= MIN_SPLIT_COLUMNS).  r, k, v, w need 16-byte aligned
// bases and 16-byte multiples as strides of their dims of extent > 1 (the
// wrapper checks, and so does this).
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, float* o, int bh,
                             int heads, int l, int n, int chunk, int u_rows,
                             int bf16, int split, const long long* strides,
                             void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads || l <= 0 || u_rows <= 0 ||
      chunk <= 0 || l % chunk)
    return cudaErrorInvalidValue;
  const long long* s = strides;
  Args a;
  memset(&a, 0, sizeof(a));
  a.u = u;
  a.u_bf16 = (bf16 >> 4) & 1;
  a.u_rows = u_rows;
  a.bf16 = bf16 & 15;
  a.o = o;
  a.ob = s[12];
  a.oh = s[13];
  a.ol = s[14];
  a.heads = heads;
  a.l = l;
  const Launch x{{r, k, v, w}, s, bh, bh / heads,
                 static_cast<cudaStream_t>(stream)};
  switch (chunk) {
    case 8: return launch_n<8>(x, a, n, split);
    case 16: return launch_n<16>(x, a, n, split);
    case 32: return launch_n<32>(x, a, n, split);
    case 64: return launch_n<64>(x, a, n, split);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block at (chunk, n, split) and the dtypes
// `bf16` (bits as rwkv6_wkv_fwd's), and its ring stages in *stages; 0 for
// a shape the kernel does not take.
extern "C" int rwkv6_wkv_smem(int chunk, int n, int split, int bf16,
                              int* stages) {
  *stages = 0;
  const bool sizes = (chunk == 8 || chunk == 16 || chunk == 32 || chunk == 64) &&
                     (n == 8 || n == 16 || n == 32 || n == 64);
  if (!sizes || (split != 1 && split != 2 && split != 4) ||
      (split > 1 && n / split < MIN_SPLIT_COLUMNS))
    return 0;
  const Plan p = plan_of(chunk, n, n / split);
  const Ring g = ring_of(chunk, n, n / split, bf16);
  *stages = stages_of(p, g);
  return *stages < 1 ? 0 : p.RING + *stages * g.bytes;
}

#ifdef K5_PROBES
// The phase probes' sums since the last call, [WARPS][PROBES] clocks
// (see PROBE), then reset to 0.
extern "C" int rwkv6_wkv_probes(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k5_probes, sizeof(k5_probes));
  if (err != cudaSuccess) return err;
  static const unsigned long long zero[WARPS][PROBES] = {};
  return cudaMemcpyToSymbol(k5_probes, zero, sizeof(k5_probes));
}
#endif

extern "C" const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
