// K5b: rwkv6_wkv_bwd — the gradient of K5 (csrc/rwkv6_wkv.cu, the chunked
// RWKV6 WKV scan), for sm_90a.  It replaces no Pallas kernel: the
// reference trains through models/ssm.py:rwkv6_chunk_scan (src/repro), which
// XLA differentiates.  A CUDA kernel's output has no autograd graph, so the
// port's rwkv6 training needs this backward (kernels/rwkv6_wkv.py:WKV).
//
// What it computes (kernels/ref.py:rwkv6_wkv_bwd_plain is the plain
// version, written as the same three passes): for every (batch, head) row
// bh, the gradients of
//     o = rwkv6_wkv(r, k, v, w, u)  (S_0 = 0, decays clipped to [1e-6, 1])
// with respect to r, k, v, w [L, N] and the bonus u, given dO [L, N].  Per
// chunk of c steps, with D the inclusive and D₋ the exclusive cumulative
// decay (from the cumulative sum of log w), r_sc = r·D₋, k_sc = k/D, a = D
// at the chunk's end, A = tril(r_sc k_scᵀ, −1), S_in the chunk's entry
// state and dS the gradient of its exit state (0 after the last chunk):
//     dv    = Aᵀ dO + diag(r·u·k) dO + (k_sc ⊙ a) dS
//     dr_sc = tril(dO vᵀ, −1) k_sc + dO S_inᵀ
//     dk_sc = tril(dO vᵀ, −1)ᵀ r_sc + a ⊙ (v dSᵀ)
//     da    = rowsum(S_in ⊙ dS) + colsum(k_sc ⊙ v dSᵀ)
// then dr = dr_sc·D₋ + u·k (dO_t·v_t), dk = dk_sc/D + u·r (dO_t·v_t), and
// d log w_s = Σ_{t>s} dr_sc·r_sc − Σ_{t≥s} dk_sc·k_sc + da·a summed back
// through the chunk.  The clip's rule is torch.clamp's: dw = d log w / w
// where 1e-6 ≤ w ≤ 1, both ends included, else 0.  du = Σ_t r ⊙ k
// (dO_t·v_t) summed over the rows that read the same u row.  Only the
// states are serial, and only elementwise between chunks:
//     S_{g+1}  = a_g ⊙ S_g + (k_sc ⊙ a)_gᵀ v_g
//     dS_{g−1} = a_g ⊙ dS_g + r_sc,gᵀ dO_g
// D spans the chunk, so k/D grows as the decay falls: at chunk 64 a mean
// decay of ~0.25 or less overflows it, as in the forward (ROADMAP F3).
//
// Bound on an H100: at rwkv6-1.6b's training shape (B 4 x L 1024, H 32, N
// 64, chunk 64: 128 rows of 16 chunks; r, k, v bfloat16, w and dO float32)
// the function must read ~134 MB and write ~67 MB (0.060 ms at 3.35 TB/s)
// and do ~8.3 GFLOP (0.017 ms on the tensor cores in TF32): bytes bound it.
//
// Design: three launches, every order-dependent sum in a fixed order (a
// repeat is bitwise equal; no atomics).  The wrapper's plan
// (kernels/rwkv6_wkv.py:k5b_plan) gives each launch's grid and shared memory.
//   1. wkv_bwd_chain: the states.  Value columns are independent in both
//      chains, so a block is (row, block of TV value columns, chain), 8
//      warps; the plan splits a row's columns while the blocks stay within
//      two per SM.  Chain 0 walks the chunks forward and stores each S_in[g]
//      (transposed, [m][n]); chain 1 walks them backward and stores each
//      dS[g] ([n][m]), or zeros where carry is 0 (a negative control): both
//      float32 scratch [BH, nc, N, N].  The next chunk's tiles come by
//      cp.async into a stage while this chunk is computed.  Per chunk: the
//      tiles as float32 (log of the clipped w at row stride N + 1), a warp
//      scan per channel (lanes along the steps) for D or D₋ and a, k/D or
//      r·D₋ in place, then the increment (k_sc ⊙ a)ᵀ v or r_scᵀ dO on the
//      tensor cores (a 16-row x 8·JW-column tile of the state a warp), added
//      to a ⊙ state in registers.
//   2. wkv_bwd_chunk: the chunk gradients, one block per (row, chunk): 2,048
//      blocks at the training shape, 6 warps and 106,752 B of shared memory
//      (C = N = 64; 145 registers), so two share an SM.  One round of loads:
//      float32 tiles by cp.async straight into their buffers, bfloat16 ones
//      through registers, S_in[g] held in registers until the decays are
//      done.  Then the row sums r·u·k and dO·v (four lanes a step), the
//      decays (a warp scan per channel: r·D₋ and k/D in place, a, and du's
//      partial Σ_t r·k·(dO·v)), and the products: twelve units, three items
//      of a 16-row tile each, all through one code path:
//        dv    = (k_sc ⊙ a) dS + Aᵀ dO        (Aᵀ from k_sc r_scᵀ)
//        dr_sc = dO S_inᵀ + dA k_sc           (dA from dO vᵀ)
//        dk_sc = a ⊙ (v dSᵀ) + dAᵀ r_sc       (dAᵀ from v dOᵀ; and da's
//                                              column sums of k_sc ⊙ v dSᵀ)
//      warps 2i and 2i+1 take item i's row tiles {0, 3} and {1, 2}, which
//      evens out the triangles (the heaviest pair of tiles is 864 of the
//      block's 4,608 MMAs).  The triangular factors are computed only on
//      the 8-column tiles that reach the diagonal and never leave registers:
//      their accumulators are the A operand of the next product.  dv is
//      stored from registers; dr_sc and dk_sc go back to shared memory for
//      the log-decay scan (a thread per channel, backward), then every thread
//      forms dr, dk and dw, eight neighbouring channels at a time.
//   3. wkv_bwd_du: du sums the (row, chunk) partials in row, then chunk
//      order, over the rows that read each u row.
//   Every product is mma.sync m16n8k8 TF32 with the 3×TF32 split of
//   wkv_mma.cuh (K5's); an operand that is exact in TF32 (a bfloat16 v or
//   dO) takes 2 products.  The chain's log and exponentials and the last
//   epilogue's are the fast intrinsics (__logf, __expf, __fdividef): float32
//   parity with the plain version stays ~2e-6 of max|ref| (gate 1e-4).
//   What bounds it now (NVIDIA H100, PERF.md; scripts/wkv_phases.py --bwd
//   reads the phases): latency, not bytes or MMAs.  The chain is 15 serial
//   steps of ~11 µs (five barriers a step, 16 warps an SM); the chunk pass
//   spends ~40 % of a block in the products (mma.sync TF32 at ~half the
//   rate its instructions allow: each MMA also needs ~5 instructions of
//   operand loads and splits), the rest in phases of one to a few warps'
//   serial work (loads, scans, epilogue) that 12 warps an SM cannot hide.
//   Unrolling more, more channels a scan, prefetching more or staggering
//   the blocks was measured and did not help (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wkv_mma.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block can use
constexpr int CHAIN_THREADS = 256;  // 8 warps
constexpr int CHUNK_THREADS = 192;  // 6 warps: 3 items x 2 tile pairs
constexpr int MIN_SPLIT_COLUMNS = 16;
constexpr float EPS = 1e-6f;

enum { R = 0, K = 1, V = 2, W = 3, DOUT = 4, U = 5 };  // bits of Args::bf16

// Phase probes, compiled in only with -DK5B_PROBES (scripts/wkv_phases.py
// --bwd): lane 0 of every warp adds the SM clocks of each phase (each
// ending at a barrier) to k5b_probes[kernel][warp][phase], summed over
// blocks.  Chain (kernel 0), per chunk: 0 the state's store, 1 the tiles'
// commit and the next fetch, 2 the decays, 3 the increment.  Chunk (kernel
// 1): 0 the loads, 1 the row sums, 2 the decays, 3 S_in's load, 4 the
// products, 5 the row sums of S_in ⊙ dS and the wait for every product,
// 6 dr_sc, dk_sc and log w to shared memory, 7 the scans, 8 dr, dk, dw.
#ifdef K5B_PROBES
constexpr int PROBES = 9;
__device__ unsigned long long k5b_probes[2][8][PROBES];
#define PROBE_INIT             \
  long long probe_t = clock64(); \
  long long probe_acc[PROBES] = {};
#define PROBE(i)                     \
  {                                  \
    const long long now = clock64(); \
    probe_acc[i] += now - probe_t;   \
    probe_t = now;                   \
  }
#define PROBE_SAVE(kernel)                        \
  if (lane == 0)                                  \
    for (int p = 0; p < PROBES; ++p)              \
      atomicAdd(&k5b_probes[kernel][warp][p],     \
                static_cast<unsigned long long>(probe_acc[p]));
#else
#define PROBE_INIT
#define PROBE(i)
#define PROBE_SAVE(kernel)
#endif

struct Args {
  const void* in[5];   // r, k, v, w, dO: [B, L, H, N] through strides
  long long st[5][3];  // their (batch, head, time) strides, in elements
  const void* u;       // [u_rows, N]: row bh reads u[bh % u_rows]
  void* out[4];        // dr, dk, dv, dw: [B, L, H, N] contiguous
  float* states;       // [BH, nc, N, N]: S_in[g] transposed, [m][n]
  float* dstates;      // [BH, nc, N, N]: dS[g], [n][m]
  float* du_parts;     // [BH, nc, N]: Σ_t r·k·(dO·v) per (row, chunk)
  int bf16;            // bit i set: input i is bfloat16 (its gradient too)
  int heads, l, u_rows;
  int carry;           // 0: dS dropped between chunks (a negative control)
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ bool is_bf(const Args& a, int i) {
  return ((a.bf16 >> i) & 1) != 0;
}

// byte address of element (t0, c0) of input i's row (b, h); bytes between
// its time steps in *row
__device__ __forceinline__ const unsigned char* tile_of(const Args& a, int i,
                                                        int b, int h, int t0,
                                                        int c0,
                                                        long long* row) {
  const int es = is_bf(a, i) ? 2 : 4;
  *row = a.st[i][2] * es;
  return static_cast<const unsigned char*>(a.in[i]) +
         (b * a.st[i][0] + h * a.st[i][1] + t0 * a.st[i][2] + c0) * es;
}

// 16 bytes at p through the read-only path; volatile, so that the compiler
// issues the load where it is written (ahead of its use)
__device__ __forceinline__ uint4 ldg16(const unsigned char* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// 16 bytes from global p to shared dst, asynchronously (cp.async)
__device__ __forceinline__ void async16(void* dst, const unsigned char* p) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(p)
               : "memory");
}

// every asynchronous copy of this thread landed (the block's, after a
// barrier)
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// rows of `bytes` bytes (a multiple of 16) from p (row stride `row`) to
// shared dst (row stride `dst_row`), asynchronously
template <int THREADS>
__device__ __forceinline__ void copy_rows(void* dst, int dst_row,
                                          const unsigned char* p, long long row,
                                          int rows, int bytes, int tid) {
  const int per_row = bytes / 16;
  for (int q = tid; q < rows * per_row; q += THREADS) {
    const int t = q / per_row, c = q % per_row;
    async16(static_cast<unsigned char*>(dst) + t * dst_row + c * 16,
            p + t * row + c * 16);
  }
}

// WORDS 16-byte words of a tile in registers, PER_ROW a row; word q = tid +
// i·THREADS
template <int WORDS, int PER_ROW, int THREADS>
struct Words {
  static constexpr int PER = (WORDS + THREADS - 1) / THREADS;
  uint4 x[PER];
  __device__ __forceinline__ void fetch(const unsigned char* p, long long row,
                                        int tid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = tid + i * THREADS;
      if (q < WORDS) x[i] = ldg16(p + (q / PER_ROW) * row + (q % PER_ROW) * 16);
    }
  }
  // as float32 into dst[t * ld + c]: 8 bfloat16 or 4 float32 values a word
  template <bool BF>
  __device__ __forceinline__ void commit(float* dst, int ld, int tid) const {
    constexpr int PER_WORD = BF ? 8 : 4;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = tid + i * THREADS;
      if (q < WORDS) {
        float* d = dst + (q / PER_ROW) * ld + (q % PER_ROW) * PER_WORD;
        const uint32_t w[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (BF) {
            d[2 * j] = __uint_as_float(w[j] << 16);
            d[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
          } else {
            d[j] = __uint_as_float(w[j]);
          }
        }
      }
    }
  }
};

// A [ROWS][COLS] bfloat16 tile
template <int ROWS, int COLS, int THREADS>
using Half = Words<ROWS * COLS / 8, COLS / 8, THREADS>;

// input i's [ROWS][COLS] tile at (t0, c0) as float32 into shared dst (row
// stride ld, a multiple of 4): float32 by asynchronous copies, bfloat16
// into half's registers (commit_tile after async_wait)
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(const Args& a, int i, int b, int h,
                                          int t0, int c0, float* dst, int ld,
                                          Half<ROWS, COLS, THREADS>& half,
                                          int tid) {
  long long row;
  const unsigned char* const p = tile_of(a, i, b, h, t0, c0, &row);
  if (is_bf(a, i))
    half.fetch(p, row, tid);
  else
    copy_rows<THREADS>(dst, ld * 4, p, row, ROWS, COLS * 4, tid);
}

template <class H>
__device__ __forceinline__ void commit_tile(const Args& a, int i, float* dst,
                                            int ld, const H& half, int tid) {
  if (is_bf(a, i)) half.template commit<true>(dst, ld, tid);
}

struct Same {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};
struct LogClip {  // log of the clipped decay
  __device__ __forceinline__ float operator()(float x) const {
    return logf(fminf(fmaxf(x, EPS), 1.f));
  }
};

__device__ __forceinline__ void store(void* p, long long i, float x, bool bf) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// two neighbouring values x, y at p[i], p[i + 1] (i even)
__device__ __forceinline__ void store2(void* p, long long i, float x, float y,
                                       bool bf) {
  if (bf)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i) =
        __floats2bfloat162_rn(x, y);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(x, y);
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// eight neighbouring values at p[i] (i a multiple of 8): 16 or 32 bytes
__device__ __forceinline__ void store8(void* p, long long i, const float (&x)[8],
                                       bool bf) {
  if (bf) {
    uint4 v;
    v.x = pack_bf16(x[0], x[1]);
    v.y = pack_bf16(x[2], x[3]);
    v.z = pack_bf16(x[4], x[5]);
    v.w = pack_bf16(x[6], x[7]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + i) = v;
  } else {
    uint4* const q = reinterpret_cast<uint4*>(static_cast<float*>(p) + i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 v;
      v.x = __float_as_uint(x[4 * h]);
      v.y = __float_as_uint(x[4 * h + 1]);
      v.z = __float_as_uint(x[4 * h + 2]);
      v.w = __float_as_uint(x[4 * h + 3]);
      q[h] = v;
    }
  }
}

// eight neighbouring values from the words a (bfloat16) or a, b (float32)
__device__ __forceinline__ void unpack8(const uint4& a, const uint4& b, bool bf,
                                        float (&x)[8]) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    x[j] = __uint_as_float(bf ? (j & 1 ? w[j / 2] & 0xFFFF0000u : w[j / 2] << 16)
                              : w[j]);
}

// d += a·b as mma3, with A exact in TF32 where a_exact (al unused): its
// lo·hi' product is then 0 and skipped
template <int T, int TD>
__device__ __forceinline__ void prod(float (&d)[TD][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[T][2],
                                     const uint32_t (&bl)[T][2], bool a_exact,
                                     bool b_exact) {
  if (a_exact) {
    if (!b_exact) {
#pragma unroll
      for (int j = 0; j < T; ++j) mma(d[j], ah, bl[j]);
    }
#pragma unroll
    for (int j = 0; j < T; ++j) mma(d[j], ah, bh[j]);
  } else {
    mma3(d, ah, al, bh, bl, b_exact);
  }
}

// an accumulator tile as the A operand of the next product (k ↔ 2k,
// k+4 ↔ 2k+1)
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// Inclusive sums over the C steps of ld(lx[t * ldx + n]) (log w) for
// channels n = n0 + q·dn (q < Q; those below N), a lane per step (steps
// 32..63 in a second half), all Q at once; then f(t, n, q, log w, log D)
// for every step and channel.
template <int C, int N, int Q, class L, class F>
__device__ __forceinline__ void scan_steps(const float* lx, int ldx, int n0,
                                           int dn, int lane, L ld, F f) {
  constexpr int H2 = C > 32 ? 2 : 1;
  float x[H2][Q], sc[H2][Q];
#pragma unroll
  for (int hf = 0; hf < H2; ++hf)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int t = lane + 32 * hf, n = n0 + q * dn;
      x[hf][q] = t < C && n < N ? ld(lx[t * ldx + n]) : 0.f;
      sc[hf][q] = x[hf][q];
    }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1)
#pragma unroll
    for (int hf = 0; hf < H2; ++hf)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float y = __shfl_up_sync(0xffffffffu, sc[hf][q], d);
        if (lane >= d) sc[hf][q] += y;
      }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (H2 == 2) sc[1][q] += __shfl_sync(0xffffffffu, sc[0][q], 31);
    const int n = n0 + q * dn;
#pragma unroll
    for (int hf = 0; hf < H2; ++hf) {
      const int t = lane + 32 * hf;
      if (t < C && n < N) f(t, n, q, x[hf][q], sc[hf][q]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. the states
// ---------------------------------------------------------------------------

template <int C, int N, int TV>
struct ChainPlan {
  static constexpr int CP = cmax(C, 16), NP = cmax(N, 16);
  static constexpr int LD = NP + 4, LDV = TV + 4, LDX = N + 1;
  static constexpr int KR = 0;              // k then k_sc, or r then r_sc
  static constexpr int WL = KR + CP * LD;   // log w, then D or D₋
  static constexpr int VD = WL + CP * LD;   // v or dO, TV columns
  static constexpr int AC = VD + CP * LDV;  // a
  static constexpr int FLOATS = AC + NP;
  // the next chunk's tiles as they are in memory (k or r, w, v or dO at
  // up to 4 bytes an element), filled by asynchronous copies
  static constexpr int STAGE = (FLOATS * 4 + 15) / 16 * 16;
  static constexpr int SA = STAGE, SW = SA + C * N * 4, SV = SW + C * N * 4;
  static constexpr int BYTES = SV + C * TV * 4;
  static constexpr int RT = NP / 16;        // 16-row tiles of the state
  static constexpr int JT = TV / 8;         // its 8-column tiles
  static constexpr int CG = 8 / RT;         // warps on a row tile
  static constexpr int JW = JT / CG > 0 ? JT / CG : 1;  // tiles of a warp
};

template <int C, int N, int TV>
__global__ void __launch_bounds__(CHAIN_THREADS, 2)
    wkv_bwd_chain(const Args a) {
  using P = ChainPlan<C, N, TV>;
  static_assert(TV % 8 == 0 && N % TV == 0, "shape");
  constexpr int LD = P::LD, LDV = P::LDV, LDX = P::LDX, JW = P::JW;
  constexpr int Q = N >= 16 ? 2 : 1;  // channels a warp scans at once
  extern __shared__ __align__(16) float smem[];
  float* const kr = smem + P::KR;
  float* const wl = smem + P::WL;
  float* const vd = smem + P::VD;
  float* const ac = smem + P::AC;
  unsigned char* const stage = reinterpret_cast<unsigned char*>(smem);

  const int tid = threadIdx.x, lane = tid % 32,
            warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int bh = blockIdx.x, j0 = blockIdx.y * TV, chain = blockIdx.z;
  const int b = bh / a.heads, h = bh % a.heads, nc = a.l / C;
  const int ia = chain == 0 ? K : R, iv = chain == 0 ? V : DOUT;
  const bool abf = is_bf(a, ia), wbf = is_bf(a, W), vbf = is_bf(a, iv);
  float* const out = (chain == 0 ? a.states : a.dstates) +
                     static_cast<long long>(bh) * nc * N * N;

  // chunk g's tiles into the stage, as they are in memory
  auto issue = [&](int g) {
    long long row;
    const unsigned char* p = tile_of(a, ia, b, h, g * C, 0, &row);
    copy_rows<CHAIN_THREADS>(stage + P::SA, N * (abf ? 2 : 4), p, row, C,
                             N * (abf ? 2 : 4), tid);
    p = tile_of(a, W, b, h, g * C, 0, &row);
    copy_rows<CHAIN_THREADS>(stage + P::SW, N * (wbf ? 2 : 4), p, row, C,
                             N * (wbf ? 2 : 4), tid);
    p = tile_of(a, iv, b, h, g * C, j0, &row);
    copy_rows<CHAIN_THREADS>(stage + P::SV, TV * (vbf ? 2 : 4), p, row, C,
                             TV * (vbf ? 2 : 4), tid);
  };
  // padding rows and columns stay zero
  for (int i = tid; i < P::FLOATS; i += CHAIN_THREADS) smem[i] = 0.f;
  const int first = chain == 0 ? 0 : nc - 1, step = chain == 0 ? 1 : -1;
  issue(first);

  // this warp's tile of the state: rows n_lo and n_lo + 8, column tiles
  // jc .. jc + JW - 1
  const int g8 = lane / 4, tq = lane % 4;
  const int n_lo = 16 * (warp % P::RT) + g8, jc = (warp / P::RT) * JW;
  const bool busy = jc < P::JT;
  float st[JW][4];
#pragma unroll
  for (int j = 0; j < JW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;

  PROBE_INIT
  for (int it = 0; it < nc; ++it) {
    const int g = first + step * it;
    // the state entering chunk g (chain 0) or the gradient of its exit
    // state (chain 1), to the scratch
    if (busy) {
      float* const o = out + static_cast<long long>(g) * N * N;
      const bool keep = chain == 0 || a.carry;
#pragma unroll
      for (int j = 0; j < JW; ++j) {
        const int m = j0 + 8 * (jc + j) + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = n_lo + 8 * hf;
          if (n >= N) continue;
          const float x = keep ? st[j][2 * hf] : 0.f,
                      y = keep ? st[j][2 * hf + 1] : 0.f;
          if (chain == 0) {
            o[m * N + n] = x;
            o[(m + 1) * N + n] = y;
          } else {
            *reinterpret_cast<float2*>(o + n * N + m) = make_float2(x, y);
          }
        }
      }
    }
    PROBE(0)
    if (it + 1 == nc) break;  // the last chunk's update is never read
    async_wait();
    __syncthreads();  // chunk g's tiles are in the stage
    // as float32: k or r, log w (row stride N + 1, for the scan; the fast
    // log, as the decays here only carry the states), v or dO
    for (int e = tid; e < C * N; e += CHAIN_THREADS) {
      const int t = e / N, n = e % N;
      kr[t * LD + n] = abf ? ld_as<true>(stage + P::SA, e)
                           : ld_as<false>(stage + P::SA, e);
      const float x = wbf ? ld_as<true>(stage + P::SW, e)
                          : ld_as<false>(stage + P::SW, e);
      wl[t * LDX + n] = __logf(fminf(fmaxf(x, EPS), 1.f));
    }
    for (int e = tid; e < C * TV; e += CHAIN_THREADS)
      vd[e / TV * LDV + e % TV] = vbf ? ld_as<true>(stage + P::SV, e)
                                      : ld_as<false>(stage + P::SV, e);
    __syncthreads();  // the stage is free
    if (it + 2 < nc) issue(g + step);  // lands while this chunk runs
    PROBE(1)
    // the cumulative decays (a warp scan per channel): D (chain 0) or D₋
    // (chain 1) over log w, and a; then k/D or r·D₋ in place
#pragma unroll 1
    for (int n0 = warp * Q; n0 < N; n0 += 8 * Q)
      scan_steps<C, N, Q>(wl, LDX, n0, 1, lane, Same{},
                          [&](int t, int n, int, float x, float sum) {
                            const float d = __expf(sum);
                            wl[t * LDX + n] = chain == 0 ? d : __expf(sum - x);
                            if (t == C - 1) ac[n] = d;
                          });
    __syncthreads();
    for (int e = tid; e < C * N; e += CHAIN_THREADS) {
      const int t = e / N, n = e % N;
      float* const x = kr + t * LD + n;
      *x = chain == 0 ? *x / wl[t * LDX + n] : *x * wl[t * LDX + n];
    }
    __syncthreads();
    PROBE(2)
    // the increment (k_sc ⊙ a)ᵀ v or r_scᵀ dO, then state = a ⊙ state +
    // increment; A[n][t] = kr[t][n] (times a[n] in chain 0), read with the
    // k ↔ 2k permutation, and v's rows in the same order
    if (busy) {
      float inc[JW][4];
#pragma unroll
      for (int j = 0; j < JW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) inc[j][e] = 0.f;
      const float s0 = chain == 0 ? ac[n_lo] : 1.f,
                  s1 = chain == 0 ? ac[n_lo + 8] : 1.f;
#pragma unroll 2
      for (int kk = 0; kk < P::CP / 8; ++kk) {
        uint32_t ah[4], al[4], bh[JW][2], bl[JW][2];
        const float* ka = kr + (8 * kk + 2 * tq) * LD + n_lo;
        split(ka[0] * s0, ah[0], al[0]);
        split(ka[8] * s1, ah[1], al[1]);
        split(ka[LD] * s0, ah[2], al[2]);
        split(ka[LD + 8] * s1, ah[3], al[3]);
        float vb[JW][2];
        const float* p = vd + (8 * kk + 2 * tq) * LDV + 8 * jc + g8;
#pragma unroll
        for (int j = 0; j < JW; ++j) {
          vb[j][0] = p[8 * j];
          vb[j][1] = p[LDV + 8 * j];
        }
        b_split(vb, vbf, bh, bl);
        mma3(inc, ah, al, bh, bl, vbf);
      }
      const float a0 = ac[n_lo], a1 = ac[n_lo + 8];
#pragma unroll
      for (int j = 0; j < JW; ++j) {
        st[j][0] = a0 * st[j][0] + inc[j][0];
        st[j][1] = a0 * st[j][1] + inc[j][1];
        st[j][2] = a1 * st[j][2] + inc[j][2];
        st[j][3] = a1 * st[j][3] + inc[j][3];
      }
    }
    __syncthreads();  // the next conversion overwrites the tiles
    PROBE(3)
  }
  PROBE_SAVE(0)
}
// ---------------------------------------------------------------------------
// 2. the chunk gradients
// ---------------------------------------------------------------------------

template <int C, int N>
struct ChunkPlan {
  static constexpr int CP = cmax(C, 16), NP = cmax(N, 16), MP = cmax(CP, NP);
  static constexpr int MT = CP / 16;  // 16-row tiles of the chunk
  static constexpr int CT = CP / 8;   // 8-column tiles over time
  static constexpr int NT = NP / 8;   // 8-column tiles over channels
  static constexpr int AG = 2;        // triangle tiles at a time
  static constexpr int LD = NP + 4;
  static constexpr int BUF = MP * LD;
  static constexpr int RS = 0;           // r, then r_sc
  static constexpr int KS = RS + BUF;    // k, then k_sc
  static constexpr int VS = KS + BUF;    // v, then dr_sc
  static constexpr int OS = VS + BUF;    // dO, then dk_sc
  static constexpr int DS = OS + BUF;    // dS, then d log w
  static constexpr int SI = DS + BUF;    // w, S_inᵀ, w, then log D
  static constexpr int US = SI + BUF;    // u
  static constexpr int AC = US + NP;     // a
  static constexpr int BON = AC + NP;    // r·u·k per step
  static constexpr int BD = BON + CP;    // dO·v per step
  static constexpr int RSUM = BD + CP;   // rowsum(S_in ⊙ dS)
  static constexpr int DAP = RSUM + NP;  // colsum(k_sc ⊙ v dSᵀ) per row tile
  static constexpr int FLOATS = DAP + MT * NP;
  static constexpr int BYTES = FLOATS * 4;
};

template <int C, int N>
__global__ void __launch_bounds__(CHUNK_THREADS, 2)
    wkv_bwd_chunk(const Args a) {
  using P = ChunkPlan<C, N>;
  constexpr int LD = P::LD, NT = P::NT, CT = P::CT, AG = P::AG, MT = P::MT;
  constexpr int KSTEPS = P::NP / 8;  // k steps over channels
  constexpr int WARPS = CHUNK_THREADS / 32;
  constexpr int T = CHUNK_THREADS;
  extern __shared__ __align__(16) float smem[];
  float* const rs = smem + P::RS;
  float* const ks = smem + P::KS;
  float* const vs = smem + P::VS;
  float* const os = smem + P::OS;
  float* const ds = smem + P::DS;
  float* const si = smem + P::SI;
  float* const us = smem + P::US;
  float* const ac = smem + P::AC;
  float* const bon = smem + P::BON;
  float* const bd = smem + P::BD;
  float* const rsum = smem + P::RSUM;
  float* const dap = smem + P::DAP;

  const int tid = threadIdx.x, lane = tid % 32,
            warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int nc = a.l / C;
  const int bh = blockIdx.x / nc, g = blockIdx.x % nc;
  const int b = bh / a.heads, h = bh % a.heads, t0 = g * C;
  const long long sq = (static_cast<long long>(bh) * nc + g) * N * N;
  const bool rbf = is_bf(a, R), kbf = is_bf(a, K), vbf = is_bf(a, V),
             wbf = is_bf(a, W), obf = is_bf(a, DOUT);
  const auto out_off = [&](int t, int n) {
    return ((static_cast<long long>(b) * a.l + t0 + t) * a.heads + h) * N + n;
  };

  PROBE_INIT
  if constexpr (C < 16 || N < 16) {  // padding rows and columns stay zero
    for (int i = tid; i < P::FLOATS; i += T) smem[i] = 0.f;
    __syncthreads();
  }
  // one round of loads: r, k, v, dO and w (float32 by asynchronous copies,
  // bfloat16 through registers), dS[g] (asynchronous) and S_in[g] (held in
  // registers until the decays are done)
  Words<N * N / 4, N / 4, T> s_in;
  {
    Half<C, N, T> hr, hk, hv, ho, hw;
    load_tile<C, N, T>(a, R, b, h, t0, 0, rs, LD, hr, tid);
    load_tile<C, N, T>(a, K, b, h, t0, 0, ks, LD, hk, tid);
    load_tile<C, N, T>(a, V, b, h, t0, 0, vs, LD, hv, tid);
    load_tile<C, N, T>(a, DOUT, b, h, t0, 0, os, LD, ho, tid);
    load_tile<C, N, T>(a, W, b, h, t0, 0, si, LD, hw, tid);
    copy_rows<T>(ds, LD * 4, reinterpret_cast<const unsigned char*>(a.dstates + sq),
                 N * 4, N, N * 4, tid);
    s_in.fetch(reinterpret_cast<const unsigned char*>(a.states + sq), N * 4, tid);
    if (tid < N) {
      const int i = (bh % a.u_rows) * N + tid;
      const unsigned char* u = static_cast<const unsigned char*>(a.u);
      us[tid] = is_bf(a, U) ? ld_as<true>(u, i) : ld_as<false>(u, i);
    }
    async_wait();
    commit_tile(a, R, rs, LD, hr, tid);
    commit_tile(a, K, ks, LD, hk, tid);
    commit_tile(a, V, vs, LD, hv, tid);
    commit_tile(a, DOUT, os, LD, ho, tid);
    commit_tile(a, W, si, LD, hw, tid);
  }
  __syncthreads();
  PROBE(0)

  // the row sums r·u·k and dO·v: four lanes a step, lane p of them over
  // channels p, p + 4, ... (free of bank conflicts), then summed across
  // the four
  for (int e = tid; e < 4 * 64; e += T) {  // C ≤ 64: one pass per lane
    const int t = e / 4, p = e % 4;
    float x = 0.f, y = 0.f;
    if (t < C) {
#pragma unroll 4
      for (int n = p; n < N; n += 4) {
        x += rs[t * LD + n] * us[n] * ks[t * LD + n];
        y += os[t * LD + n] * vs[t * LD + n];
      }
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    y += __shfl_xor_sync(0xffffffffu, y, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    y += __shfl_xor_sync(0xffffffffu, y, 2);
    if (p == 0 && t < C) {
      bon[t] = x;
      bd[t] = y;
    }
  }
  __syncthreads();
  PROBE(1)

  // the cumulative decays (a warp scan per channel, channels warp + 6q):
  // r·D₋ and k/D in place, a, and du's partial Σ_t r·k·(dO·v) (a warp
  // sum per channel)
#pragma unroll 1
  for (int n0 = warp; n0 < N; n0 += WARPS) {
    float du = 0.f;
    scan_steps<C, N, 1>(si, LD, n0, 0, lane, LogClip{},
                        [&](int t, int n, int, float x, float sum) {
                          const float rv = rs[t * LD + n], kv = ks[t * LD + n];
                          const float d = expf(sum);
                          du += rv * kv * bd[t];
                          rs[t * LD + n] = rv * expf(sum - x);
                          ks[t * LD + n] = kv / d;
                          if (t == C - 1) ac[n] = d;
                        });
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) du += __shfl_xor_sync(0xffffffffu, du, m);
    if (lane == 0)
      a.du_parts[(static_cast<long long>(bh) * nc + g) * N + n0] = du;
  }
  __syncthreads();
  PROBE(2)
  s_in.template commit<false>(si, LD, tid);  // S_in[g]ᵀ over w
  __syncthreads();
  PROBE(3)

  // the products.  Warp 2·item + pair takes row tiles pair and MT-1-pair of
  // its item, all items through one code path (a small instruction
  // footprint) with the item's operands:
  //   0 dv    = (k_sc ⊙ a) dS + Aᵀ dO,   Aᵀ[s][t] = k_sc[s]·r_sc[t], t > s
  //   1 dr_sc = dO S_inᵀ + dA k_sc,       dA[t][s] = dO[t]·v[s], s < t
  //   2 dk_sc = a ⊙ (v dSᵀ) + dAᵀ r_sc,   dAᵀ[s][t] = v[s]·dO[t], t > s
  // first the full product over the channels (B[k][n] = lb[k·kr + n·nr]),
  // then the triangle, 2 8-column tiles at a time, through the item's z.
  const int g8 = lane / 4, tq = lane % 4;
  const int item = warp / 2, pair = warp % 2;
  const int tiles = pair < MT - 1 - pair ? 2 : pair == MT - 1 - pair ? 1 : 0;
  const float* const la = item == 0 ? ks : item == 1 ? os : vs;
  const float* const lb = item == 1 ? si : ds;
  const int kr = item == 2 ? 1 : LD, nr = item == 2 ? LD : 1;
  const bool la_exact = item == 1 ? obf : item == 2 ? vbf : false;
  const float* const tx = item == 0 ? ks : item == 1 ? os : vs;
  const float* const ty = item == 0 ? rs : item == 1 ? vs : os;
  const float* const tz = item == 0 ? os : item == 1 ? ks : rs;
  const bool upper = item != 1;
  const bool tx_exact = item == 1 ? obf : item == 2 ? vbf : false;
  const bool ty_exact = item == 1 ? vbf : item == 2 ? obf : false;
  const bool tz_exact = item == 0 ? obf : false;
  float acc[NT][4], hold[NT][4];  // this tile's sums; the first tile's
  int i_acc = -1, i_hold = -1;
#pragma unroll 1
  for (int u = 0; u < tiles; ++u) {
    if (u == 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hold[j][e] = acc[j][e];
      i_hold = i_acc;
    }
    const int i = u == 0 ? pair : MT - 1 - pair;
    const int lo = 16 * i + g8;
    i_acc = i;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
      const float* pa = la + lo * LD + 8 * kk + tq;
      float x[4] = {pa[0], pa[8 * LD], pa[4], pa[8 * LD + 4]};
      if (item == 0) {  // k_sc ⊙ a
        const float a0 = ac[8 * kk + tq], a1 = ac[8 * kk + tq + 4];
        x[0] *= a0;
        x[1] *= a0;
        x[2] *= a1;
        x[3] *= a1;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e], ah[e], al[e]);
      const float* pb = lb + (8 * kk + tq) * kr + g8 * nr;
      float fb[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        fb[j][0] = pb[8 * j * nr];
        fb[j][1] = pb[4 * kr + 8 * j * nr];
      }
      b_split(fb, false, bh, bl);
      prod(acc, ah, al, bh, bl, la_exact, false);
    }
    if (item == 2) {
      // colsum(k_sc ⊙ v dSᵀ) over the tile's rows into dap[i], then a ⊙
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = 8 * j + 2 * tq + c;
          float x = ks[lo * LD + n] * acc[j][c] +
                    ks[(lo + 8) * LD + n] * acc[j][2 + c];
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
          if (g8 == 0) dap[i * P::NP + n] = x;
          acc[j][c] *= ac[n];
          acc[j][2 + c] *= ac[n];
        }
    }
    const int jb = upper ? 2 * i : 0, je = upper ? CT : 2 * i + 2;
#pragma unroll 1
    for (int j0 = jb; j0 < je; j0 += AG) {
      float tri[AG][4];
#pragma unroll
      for (int q = 0; q < AG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) tri[q][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ah[4], al[4], bh[AG][2], bl[AG][2];
        a_frag(tx + lo * LD + 8 * kk + tq, LD, ah, al);
        float yb[AG][2];
#pragma unroll
        for (int q = 0; q < AG; ++q) {
          const float* py = ty + (8 * (j0 + q) + g8) * LD + 8 * kk + tq;
          yb[q][0] = py[0];
          yb[q][1] = py[4];
        }
        b_split(yb, ty_exact, bh, bl);
        prod(tri, ah, al, bh, bl, tx_exact, ty_exact);
      }
      // the strict upper (col > row) or lower (col < row) triangle
#pragma unroll
      for (int q = 0; q < AG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = lo + (e >= 2 ? 8 : 0),
                    col = 8 * (j0 + q) + 2 * tq + (e & 1);
          if (upper ? col <= row : col >= row) tri[q][e] = 0.f;
        }
      // acc += tri · z over these time rows (tri's accumulators as the A
      // operand, z's rows read with the k ↔ 2k permutation)
#pragma unroll
      for (int q = 0; q < AG; ++q) {
        uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
        acc_as_a(tri[q], ah, al);
        const float* pz = tz + (8 * (j0 + q) + 2 * tq) * LD + g8;
        float zb[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          zb[j][0] = pz[8 * j];
          zb[j][1] = pz[LD + 8 * j];
        }
        b_split(zb, tz_exact, bh, bl);
        mma3(acc, ah, al, bh, bl, tz_exact);
      }
    }
    if (item == 0) {  // dv = acc + (r·u·k) dO, stored
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int s = lo + 8 * hf, m = 8 * j + 2 * tq;
          if (s < C && m < N) {
            const float x = bon[s];
            store2(a.out[V], out_off(s, m), acc[j][2 * hf] + x * os[s * LD + m],
                   acc[j][2 * hf + 1] + x * os[s * LD + m + 1], vbf);
          }
        }
    }
  }
  PROBE(4)
  if (item == 0) {  // rowsum(S_in ⊙ dS), skewed so that no bank conflicts
    for (int n = pair * 32 + lane; n < N; n += 64) {
      float x = 0.f;
      for (int m = 0; m < N; ++m) {
        const int mm = (m + n) & (N - 1);
        x += si[mm * LD + n] * ds[n * LD + mm];
      }
      rsum[n] = x;
    }
  }
  __syncthreads();  // every product done
  PROBE(5)

  // dr_sc into vs, dk_sc into os; w into si; r and k for the epilogue into
  // registers, eight neighbouring channels (16 or 32 bytes) a thread
  if (item == 1 || item == 2) {
    float* const dst = item == 1 ? vs : os;
    const auto put = [&](const float (&x)[NT][4], int i) {
      const int lo = 16 * i + g8;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float* p = dst + lo * LD + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(p) = make_float2(x[j][0], x[j][1]);
        *reinterpret_cast<float2*>(p + 8 * LD) = make_float2(x[j][2], x[j][3]);
      }
    };
    if (i_hold >= 0) put(hold, i_hold);
    if (i_acc >= 0) put(acc, i_acc);
  }
  constexpr int OPR = N / 8, OCTS = C * OPR;  // octets a row, a chunk
  constexpr int PER8 = (OCTS + T - 1) / T;
  uint4 rw8[PER8][2], kw8[PER8][2];
  {
    Half<C, N, T> hw;
    load_tile<C, N, T>(a, W, b, h, t0, 0, si, LD, hw, tid);
    long long rrow, krow;
    const unsigned char* const rp = tile_of(a, R, b, h, t0, 0, &rrow);
    const unsigned char* const kp = tile_of(a, K, b, h, t0, 0, &krow);
#pragma unroll
    for (int i = 0; i < PER8; ++i) {
      const int q = tid + i * T;
      if (q < OCTS) {
        const int t = q / OPR, n = 8 * (q % OPR);
        const unsigned char* const pr = rp + t * rrow + n * (rbf ? 2 : 4);
        const unsigned char* const pk = kp + t * krow + n * (kbf ? 2 : 4);
        rw8[i][0] = ldg16(pr);
        rw8[i][1] = ldg16(rbf ? pr : pr + 16);
        kw8[i][0] = ldg16(pk);
        kw8[i][1] = ldg16(kbf ? pk : pk + 16);
      }
    }
    async_wait();
    commit_tile(a, W, si, LD, hw, tid);
  }
  __syncthreads();
  PROBE(6)

  if (tid < N) {  // d log w, backward through the chunk, into ds
    const int n = tid;
    float da = rsum[n];
    for (int i = 0; i < MT; ++i) da += dap[i * P::NP + n];
    const float tail = da * ac[n];
    float p_after = 0.f, q_from = 0.f;
    for (int t = C - 1; t >= 0; --t) {
      q_from += os[t * LD + n] * ks[t * LD + n];
      ds[t * LD + n] = p_after - q_from + tail;
      p_after += vs[t * LD + n] * rs[t * LD + n];
    }
  }
  __syncthreads();
  if (tid < N) {  // log D, forward, into rs (r_sc is read no more)
    const int n = tid;
    float cum = 0.f;
    for (int t = 0; t < C; ++t) {
      cum += LogClip{}(si[t * LD + n]);
      rs[t * LD + n] = cum;
    }
  }
  __syncthreads();
  PROBE(7)

  // dr = dr_sc·D₋ + u·k (dO·v), dk = dk_sc/D + u·r (dO·v), dw = d log w / w
  // inside the clip, eight neighbouring channels a thread
#pragma unroll
  for (int i = 0; i < PER8; ++i) {
    const int q = tid + i * T;
    if (q < OCTS) {
      const int t = q / OPR, n = 8 * (q % OPR);
      float rv[8], kv[8], dr[8], dk[8], dw[8];
      unpack8(rw8[i][0], rw8[i][1], rbf, rv);
      unpack8(kw8[i][0], kw8[i][1], kbf, kv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = t * LD + n + j;
        const float wv = si[x], wc = fminf(fmaxf(wv, EPS), 1.f);
        const float cum = rs[x], ub = us[n + j] * bd[t];
        dr[j] = vs[x] * __expf(cum - __logf(wc)) + ub * kv[j];
        dk[j] = __fdividef(os[x], __expf(cum)) + ub * rv[j];
        dw[j] = wv >= EPS && wv <= 1.f ? __fdividef(ds[x], wc) : 0.f;
      }
      const long long o = out_off(t, n);
      store8(a.out[R], o, dr, rbf);
      store8(a.out[K], o, dk, kbf);
      store8(a.out[W], o, dw, wbf);
    }
  }
  PROBE(8)
  PROBE_SAVE(1)
}

// ---------------------------------------------------------------------------
// 3. du
// ---------------------------------------------------------------------------

// du[j] = Σ over rows bh ≡ j (mod u_rows), then chunks, in order
__global__ void wkv_bwd_du(const float* parts, void* du, int rows, int u_rows,
                           int nc, int n, int bf) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= u_rows * n) return;
  const int j = e / n, c = e % n;
  float x = 0.f;
  for (int bh = j; bh < rows; bh += u_rows)
    for (int g = 0; g < nc; ++g)
      x += parts[(static_cast<long long>(bh) * nc + g) * n + c];
  store(du, e, x, bf != 0);
}

template <int C, int N, int TV>
cudaError_t launch_chain(const Args& a, int bh, cudaStream_t stream) {
  constexpr int bytes = ChainPlan<C, N, TV>::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the block's limit");
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_bwd_chain<C, N, TV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(bh, N / TV, 2);
  wkv_bwd_chain<C, N, TV><<<grid, CHAIN_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int C, int N>
cudaError_t launch_chunk(const Args& a, int bh, cudaStream_t stream) {
  constexpr int bytes = ChunkPlan<C, N>::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the block's limit");
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_bwd_chunk<C, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(bh * (a.l / C));
  wkv_bwd_chunk<C, N><<<grid, CHUNK_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int C, int N>
cudaError_t launch_cn(const Args& a, int bh, int split, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  if (split == 1) err = launch_chain<C, N, N>(a, bh, s);
  if constexpr (N / 2 >= MIN_SPLIT_COLUMNS)
    if (split == 2) err = launch_chain<C, N, N / 2>(a, bh, s);
  if constexpr (N / 4 >= MIN_SPLIT_COLUMNS)
    if (split == 4) err = launch_chain<C, N, N / 4>(a, bh, s);
  if (err != cudaSuccess) return err;
  return launch_chunk<C, N>(a, bh, s);
}

template <int C>
cudaError_t launch_n(const Args& a, int bh, int n, int split, cudaStream_t s) {
  switch (n) {
    case 8: return launch_cn<C, 8>(a, bh, split, s);
    case 16: return launch_cn<C, 16>(a, bh, split, s);
    case 32: return launch_cn<C, 32>(a, bh, split, s);
    case 64: return launch_cn<C, 64>(a, bh, split, s);
    default: return cudaErrorInvalidValue;
  }
}

bool size_ok(int x) { return x == 8 || x == 16 || x == 32 || x == 64; }

bool split_ok(int n, int split) {
  return split == 1 || ((split == 2 || split == 4) && n / split >= MIN_SPLIT_COLUMNS);
}

}  // namespace

// strides: 15 values, (batch, head, time) in elements for r, k, v, w and dO
// in turn, channels contiguous; r, k, v, w and dO need 16-byte aligned
// bases and byte strides of 16-byte multiples (the wrapper checks).  bf16:
// bit 0 r, 1 k, 2 v, 3 w, 4 dO, 5 u; each gradient takes its input's
// dtype.  dr, dk, dv, dw are [B, L, H, N] contiguous, du [u_rows, N]; row
// bh = b * heads + h reads u[bh % u_rows].  states and dstates: float32
// scratch of bh * (l / chunk) * n * n each; du_parts: bh * (l / chunk) * n.
// The chunk c divides l; c and n are 8, 16, 32 or 64; `split` blocks of
// n / split value columns per row in the states' launch (1, or 2 and 4
// while n / split >= MIN_SPLIT_COLUMNS).  carry 0 drops the state's
// gradient between chunks: a wrong backward, for negative controls.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* dout, const void* u,
                             void* dr, void* dk, void* dv, void* dw, void* du,
                             float* states, float* dstates, float* du_parts,
                             int bh, int heads, int l, int n, int chunk,
                             int u_rows, int bf16, int carry, int split,
                             const long long* strides, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads || l <= 0 || u_rows <= 0 ||
      bh % u_rows || chunk <= 0 || l % chunk || !size_ok(chunk) ||
      !size_ok(n) || !split_ok(n, split))
    return cudaErrorInvalidValue;
  Args a;
  const void* ins[5] = {r, k, v, w, dout};
  void* outs[4] = {dr, dk, dv, dw};
  for (int i = 0; i < 5; ++i) {
    a.in[i] = ins[i];
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  }
  for (int i = 0; i < 4; ++i) a.out[i] = outs[i];
  a.u = u;
  a.states = states;
  a.dstates = dstates;
  a.du_parts = du_parts;
  a.bf16 = bf16;
  a.heads = heads;
  a.l = l;
  a.u_rows = u_rows;
  a.carry = carry;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (chunk) {
    case 8: err = launch_n<8>(a, bh, n, split, s); break;
    case 16: err = launch_n<16>(a, bh, n, split, s); break;
    case 32: err = launch_n<32>(a, bh, n, split, s); break;
    default: err = launch_n<64>(a, bh, n, split, s); break;
  }
  if (err != cudaSuccess) return err;
  const int total = u_rows * n;
  const dim3 grid((total + 255) / 256);
  wkv_bwd_du<<<grid, 256, 0, s>>>(du_parts, du, bh, u_rows, l / chunk, n,
                                  (bf16 >> U) & 1);
  return cudaGetLastError();
}

namespace {

// the states' launch's shared memory at a value split (0 if not taken)
template <int C, int N>
int chain_bytes(int split) {
  if (split == 1) return ChainPlan<C, N, N>::BYTES;
  if constexpr (N / 2 >= MIN_SPLIT_COLUMNS)
    if (split == 2) return ChainPlan<C, N, N / 2>::BYTES;
  if constexpr (N / 4 >= MIN_SPLIT_COLUMNS)
    if (split == 4) return ChainPlan<C, N, N / 4>::BYTES;
  return 0;
}

}  // namespace

// Dynamic shared memory of one block of `kernel` (0 the states' launch at
// `split`, 1 the chunk gradients') at (chunk, n); 0 for a shape the kernel
// does not take.
extern "C" int rwkv6_wkv_bwd_smem(int kernel, int chunk, int n, int split) {
  if (!size_ok(chunk) || !size_ok(n) || !split_ok(n, split)) return 0;
#define SMEM_CASE(c, nn)                                              \
  if (chunk == c && n == nn)                                          \
    return kernel == 1 ? ChunkPlan<c, nn>::BYTES                      \
                       : kernel == 0 ? chain_bytes<c, nn>(split) : 0;
#define SMEM_ROW(c) \
  SMEM_CASE(c, 8) SMEM_CASE(c, 16) SMEM_CASE(c, 32) SMEM_CASE(c, 64)
  SMEM_ROW(8) SMEM_ROW(16) SMEM_ROW(32) SMEM_ROW(64)
#undef SMEM_ROW
#undef SMEM_CASE
  return 0;
}

#ifdef K5B_PROBES
// The phase probes' sums since the last call, [2][8][PROBES] clocks (see
// PROBE), then reset to 0.
extern "C" int rwkv6_wkv_bwd_probes(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k5b_probes, sizeof(k5b_probes));
  if (err != cudaSuccess) return err;
  static const unsigned long long zero[2][8][PROBES] = {};
  return cudaMemcpyToSymbol(k5b_probes, zero, sizeof(k5b_probes));
}
#endif

extern "C" const char* rwkv6_wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
