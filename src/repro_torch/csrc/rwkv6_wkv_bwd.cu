// K5b: rwkv6_wkv_bwd — the gradient of K5 (csrc/rwkv6_wkv.cu, the chunked
// RWKV6 WKV scan), for sm_90a.  It replaces no Pallas kernel: the
// reference trains through models/ssm.py:rwkv6_chunk_scan (src/repro), which
// XLA differentiates.  A CUDA kernel's output has no autograd graph, so the
// port's rwkv6 training needs this backward (kernels/rwkv6_wkv.py:WKV).
//
// What it computes (kernels/ref.py:rwkv6_wkv_bwd_plain is the plain
// version): for every (batch, head) row bh, the gradients of
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
//     dS   ← r_scᵀ dO + diag(a) dS, carried to the previous chunk;
// then dr = dr_sc·D₋ + u·k (dO_t·v_t), dk = dk_sc/D + u·r (dO_t·v_t), and
// d log w_s = Σ_{t>s} dr_sc·r_sc − Σ_{t≥s} dk_sc·k_sc + da·a summed back
// through the chunk.  The clip's rule is torch.clamp's: dw = d log w / w
// where 1e-6 ≤ w ≤ 1, both ends included, else 0 (jnp.clip would pass half
// at w == 1 exactly, where bfloat16 decays above 0.998 round to).  du =
// Σ_t r ⊙ k (dO_t·v_t) is summed over the rows that read the same u row
// (over the batch: u is per head) in row order by a second launch, so the
// result is the same bit for bit on every run, with no atomics.
// D spans the chunk, so k/D grows as the decay falls: at chunk 64 a mean
// decay of ~0.25 or less overflows it, as in the forward (ROADMAP F3).
//
// Bound on an H100: at rwkv6-1.6b's training shape (B 4 x L 1024, H 32, N
// 64, chunk 64: 128 rows of 16 chunks; r, k, v bfloat16, w and dO float32)
// the kernel must read ~134 MB and write ~67 MB (0.060 ms at 3.35 TB/s)
// and do ~8 GFLOP (0.016 ms on the tensor cores in TF32, 0.12 ms on the
// CUDA cores in float32): bytes bound it.
//
// Design (a plain first version: float32 products on the CUDA cores).  One
// block of 256 threads per row; 128 rows fill one wave of the 132 SMs.
//   * The chunks' entry states come from a forward sweep in this kernel:
//     each thread keeps a tile of the [N, N] state in registers, writes it
//     to a float32 scratch [BH, nc, N, N] (32 MiB at the training shape,
//     L2-resident) before each chunk's update, and reads it back in the
//     reverse sweep.  K5 stays untouched (the serving paths are bitwise
//     what they were), and nothing outlives the backward.
//   * The reverse sweep walks the chunks last to first with dS [N, N] in
//     shared memory.  Per chunk: the loads (r, k, v, w, dO through their
//     strides, each in its own dtype; S_in from the scratch), the row sums
//     r·u·k and dO·v, the cumulative decays (one thread a column), the
//     products A, dA and v dSᵀ, then dv (stored), dr_sc, dk_sc and da, then
//     the new dS and the log-decay scan (one thread a column), then dr, dk
//     and dw stored in the inputs' dtypes.  Seven barriers a chunk.
//   * Every product is a register-tiled loop over the block: a thread holds
//     a TM x TN tile of the output whose rows and columns are strided by
//     the tile grid (threads of a warp on neighbouring columns), reading its
//     operands from shared memory tiles padded to an odd row stride, so that
//     no operand access has a bank conflict.  Triangular products compute
//     the whole square and mask it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block can use
constexpr float EPS = 1e-6f;

enum { R = 0, K = 1, V = 2, W = 3, DOUT = 4, U = 5 };  // bits of Args::bf16

struct Args {
  const void* in[5];   // r, k, v, w, dO: [B, L, H, N] through strides
  long long st[5][3];  // their (batch, head, time) strides, in elements
  const void* u;       // [u_rows, N]: row bh reads u[bh % u_rows]
  void* out[4];        // dr, dk, dv, dw: [B, L, H, N] contiguous
  float* states;       // [BH, nc, N, N] scratch: the chunks' entry states
  float* du_rows;      // [BH, N] scratch: each row's du
  int bf16;            // bit i set: input i is bfloat16 (its gradient too)
  int heads, l, u_rows;
  int carry;           // 0: dS dropped between chunks (a negative control)
};

__device__ __forceinline__ float load(const void* p, long long i, bool bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, long long i, float x, bool bf) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// A thread's tile of an M x NC product: TM x TN outputs, rows ti + x·RM and
// columns tj + y·RN; threads from USED on hold none.
template <int M, int NC>
struct Tiling {
  static constexpr int PER = M * NC / THREADS > 0 ? M * NC / THREADS : 1;
  static constexpr int TN0 = PER >= 16 ? 4 : PER >= 4 ? 2 : 1;
  static constexpr int TN = TN0 < NC ? TN0 : NC;
  static constexpr int TM0 = PER / TN < 1 ? 1 : PER / TN;
  static constexpr int TM = TM0 < M ? TM0 : M;
  static constexpr int RM = M / TM, RN = NC / TN;
  static constexpr int USED = RM * RN;
  static_assert(USED <= THREADS, "tile grid larger than the block");
};

// acc[x][y] += Σ_kk a(row x, kk) · b(kk, column y) over KD terms
template <int M, int NC, int KD, class FA, class FB>
__device__ __forceinline__ void mac(
    float (&acc)[Tiling<M, NC>::TM][Tiling<M, NC>::TN], int ti, int tj, FA a,
    FB b) {
  using T = Tiling<M, NC>;
#pragma unroll 4
  for (int kk = 0; kk < KD; ++kk) {
    float av[T::TM], bv[T::TN];
#pragma unroll
    for (int x = 0; x < T::TM; ++x) av[x] = a(ti + x * T::RM, kk);
#pragma unroll
    for (int y = 0; y < T::TN; ++y) bv[y] = b(kk, tj + y * T::RN);
#pragma unroll
    for (int x = 0; x < T::TM; ++x)
#pragma unroll
      for (int y = 0; y < T::TN; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// out(i, j, Σ_kk a(i, kk) · b(kk, j)) for every output of the block
template <int M, int NC, int KD, class FA, class FB, class FO>
__device__ __forceinline__ void product(FA a, FB b, FO out) {
  using T = Tiling<M, NC>;
  const int tid = threadIdx.x;
  if (tid >= T::USED) return;
  const int ti = tid / T::RN, tj = tid % T::RN;
  float acc[T::TM][T::TN] = {};
  mac<M, NC, KD>(acc, ti, tj, a, b);
#pragma unroll
  for (int x = 0; x < T::TM; ++x)
#pragma unroll
    for (int y = 0; y < T::TN; ++y)
      out(ti + x * T::RM, tj + y * T::RN, acc[x][y]);
}

// The block's shared memory, in floats: [C][N] and [N][N] tiles at row
// stride N + 1, [C][C] tiles at C + 1.
template <int C, int N>
struct Smem {
  static constexpr int PN = N + 1, PC = C + 1;
  static constexpr int CN = C * PN, CC = C * PC, NN = N * PN;
  static constexpr int RS = 0, KS = RS + CN, VV = KS + CN, DO = VV + CN,
                       LD = DO + CN, X = LD + CN, DRS = X + CN, DKS = DRS + CN,
                       A = DKS + CN, DA = A + CC, S = DA + CC, DS = S + NN,
                       UU = DS + NN, AC = UU + N, DAC = AC + N, BONUS = DAC + N,
                       BD = BONUS + C, FLOATS = BD + C;
  static constexpr int BYTES = FLOATS * 4;
};

template <int C, int N>
__global__ void __launch_bounds__(THREADS, 1) wkv_bwd_kernel(const Args a) {
  using M = Smem<C, N>;
  constexpr int PN = M::PN, PC = M::PC;
  extern __shared__ float smem[];
  float* rs = smem + M::RS;    // r, then r·D₋
  float* ks = smem + M::KS;    // k, then k/D
  float* vv = smem + M::VV;
  float* dO = smem + M::DO;
  float* ld = smem + M::LD;    // log w, then its cumulative sum log D
  float* xx = smem + M::X;     // v dSᵀ, then d log w
  float* drs = smem + M::DRS;  // d(r·D₋)
  float* dks = smem + M::DKS;  // d(k/D)
  float* att = smem + M::A;    // tril(r_sc k_scᵀ, −1)
  float* datt = smem + M::DA;  // tril(dO vᵀ, −1)
  float* s_in = smem + M::S;
  float* ds = smem + M::DS;
  float* uu = smem + M::UU;
  float* ac = smem + M::AC;    // a = D at the chunk's end
  float* dac = smem + M::DAC;  // da
  float* bonus = smem + M::BONUS;  // r_t·u·k_t
  float* bd = smem + M::BD;        // dO_t·v_t

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh % a.heads;
  const int nc = a.l / C;
  const auto bf = [&](int i) { return ((a.bf16 >> i) & 1) != 0; };
  const auto off = [&](int i, int time, int n) {
    return b * a.st[i][0] + h * a.st[i][1] + time * a.st[i][2] + n;
  };
  const auto in = [&](int i, int time, int n) {
    return load(a.in[i], off(i, time, n), bf(i));
  };
  const auto out_off = [&](int time, int n) {
    return ((static_cast<long long>(b) * a.l + time) * a.heads + h) * N + n;
  };
  float* states = a.states + static_cast<long long>(bh) * nc * N * N;

  for (int n = tid; n < N; n += THREADS)
    uu[n] = load(a.u, static_cast<long long>(bh % a.u_rows) * N + n, bf(U));

  // forward sweep: the chunks' entry states, into the scratch
  using TS = Tiling<N, N>;
  const bool owner = tid < TS::USED;
  const int si = tid / TS::RN, sj = tid % TS::RN;
  float state[TS::TM][TS::TN] = {};
  for (int g = 0; g < nc; ++g) {
    if (owner) {
#pragma unroll
      for (int x = 0; x < TS::TM; ++x)
#pragma unroll
        for (int y = 0; y < TS::TN; ++y)
          states[(g * N + si + x * TS::RM) * N + sj + y * TS::RN] = state[x][y];
    }
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, n = e % N, time = g * C + t;
      ks[t * PN + n] = in(K, time, n);
      vv[t * PN + n] = in(V, time, n);
      ld[t * PN + n] = logf(fminf(fmaxf(in(W, time, n), EPS), 1.f));
    }
    __syncthreads();
    for (int n = tid; n < N; n += THREADS) {
      float cum = 0.f;
      for (int t = 0; t < C; ++t) {
        cum += ld[t * PN + n];
        ks[t * PN + n] /= expf(cum);
      }
      ac[n] = expf(cum);
    }
    __syncthreads();
    if (owner) {
      float inc[TS::TM][TS::TN] = {};
      mac<N, N, C>(
          inc, si, sj, [&](int n, int s) { return ks[s * PN + n]; },
          [&](int s, int m) { return vv[s * PN + m]; });
#pragma unroll
      for (int x = 0; x < TS::TM; ++x) {
        const float an = ac[si + x * TS::RM];
#pragma unroll
        for (int y = 0; y < TS::TN; ++y)
          state[x][y] = an * state[x][y] + an * inc[x][y];
      }
    }
    __syncthreads();  // the next chunk's loads overwrite k/D, v and a
  }

  // reverse sweep
  for (int e = tid; e < N * N; e += THREADS) ds[(e / N) * PN + e % N] = 0.f;
  float du = 0.f;  // thread n < N: Σ r_n k_n (dO·v) over this row
  for (int g = nc - 1; g >= 0; --g) {
    if (!a.carry)
      for (int e = tid; e < N * N; e += THREADS) ds[(e / N) * PN + e % N] = 0.f;
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, n = e % N, time = g * C + t;
      rs[t * PN + n] = in(R, time, n);
      ks[t * PN + n] = in(K, time, n);
      vv[t * PN + n] = in(V, time, n);
      dO[t * PN + n] = in(DOUT, time, n);
      ld[t * PN + n] = logf(fminf(fmaxf(in(W, time, n), EPS), 1.f));
    }
    for (int e = tid; e < N * N; e += THREADS)
      s_in[(e / N) * PN + e % N] = states[g * N * N + e];
    __syncthreads();
    if (tid < C) {
      float x = 0.f;
      for (int n = 0; n < N; ++n) x += rs[tid * PN + n] * uu[n] * ks[tid * PN + n];
      bonus[tid] = x;
    } else if (tid < 2 * C) {
      const int t = tid - C;
      float x = 0.f;
      for (int n = 0; n < N; ++n) x += dO[t * PN + n] * vv[t * PN + n];
      bd[t] = x;
    }
    __syncthreads();
    for (int n = tid; n < N; n += THREADS) {
      float cum = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = ld[t * PN + n];
        cum += lw;
        ld[t * PN + n] = cum;
        rs[t * PN + n] *= expf(cum - lw);
        ks[t * PN + n] /= expf(cum);
      }
      ac[n] = expf(cum);
    }
    __syncthreads();
    product<C, C, N>([&](int t, int n) { return rs[t * PN + n]; },
                     [&](int n, int s) { return ks[s * PN + n]; },
                     [&](int t, int s, float x) {
                       att[t * PC + s] = s < t ? x : 0.f;
                     });
    product<C, C, N>([&](int t, int m) { return dO[t * PN + m]; },
                     [&](int m, int s) { return vv[s * PN + m]; },
                     [&](int t, int s, float x) {
                       datt[t * PC + s] = s < t ? x : 0.f;
                     });
    product<C, N, N>([&](int s, int m) { return vv[s * PN + m]; },
                     [&](int m, int n) { return ds[n * PN + m]; },
                     [&](int s, int n, float x) { xx[s * PN + n] = x; });
    __syncthreads();
    {
      using T = Tiling<C, N>;
      if (tid < T::USED) {
        const int ti = tid / T::RN, tj = tid % T::RN;
        {  // dv = Aᵀ dO + (k_sc ⊙ a) dS + bonus ⊙ dO, stored
          float acc[T::TM][T::TN] = {};
          mac<C, N, C>(
              acc, ti, tj, [&](int s, int t) { return att[t * PC + s]; },
              [&](int t, int m) { return dO[t * PN + m]; });
          mac<C, N, N>(
              acc, ti, tj, [&](int s, int n) { return ks[s * PN + n] * ac[n]; },
              [&](int n, int m) { return ds[n * PN + m]; });
#pragma unroll
          for (int x = 0; x < T::TM; ++x)
#pragma unroll
            for (int y = 0; y < T::TN; ++y) {
              const int s = ti + x * T::RM, m = tj + y * T::RN;
              store(a.out[V], out_off(g * C + s, m),
                    acc[x][y] + bonus[s] * dO[s * PN + m], bf(V));
            }
        }
        {  // d(r·D₋) = dA k_sc + dO S_inᵀ
          float acc[T::TM][T::TN] = {};
          mac<C, N, C>(
              acc, ti, tj, [&](int t, int s) { return datt[t * PC + s]; },
              [&](int s, int n) { return ks[s * PN + n]; });
          mac<C, N, N>(
              acc, ti, tj, [&](int t, int m) { return dO[t * PN + m]; },
              [&](int m, int n) { return s_in[n * PN + m]; });
#pragma unroll
          for (int x = 0; x < T::TM; ++x)
#pragma unroll
            for (int y = 0; y < T::TN; ++y)
              drs[(ti + x * T::RM) * PN + tj + y * T::RN] = acc[x][y];
        }
        {  // d(k/D) = dAᵀ r_sc + a ⊙ (v dSᵀ)
          float acc[T::TM][T::TN] = {};
          mac<C, N, C>(
              acc, ti, tj, [&](int s, int t) { return datt[t * PC + s]; },
              [&](int t, int n) { return rs[t * PN + n]; });
#pragma unroll
          for (int x = 0; x < T::TM; ++x)
#pragma unroll
            for (int y = 0; y < T::TN; ++y) {
              const int s = ti + x * T::RM, n = tj + y * T::RN;
              dks[s * PN + n] = acc[x][y] + ac[n] * xx[s * PN + n];
            }
        }
      }
    }
    for (int n = tid; n < N; n += THREADS) {  // da
      float x = 0.f;
      for (int m = 0; m < N; ++m) x += s_in[n * PN + m] * ds[n * PN + m];
      for (int s = 0; s < C; ++s) x += ks[s * PN + n] * xx[s * PN + n];
      dac[n] = x;
    }
    __syncthreads();
    // dS <- a ⊙ dS + r_scᵀ dO, in place: a thread reads only what it writes
    product<N, N, C>([&](int n, int t) { return rs[t * PN + n]; },
                     [&](int t, int m) { return dO[t * PN + m]; },
                     [&](int n, int m, float x) {
                       ds[n * PN + m] = ac[n] * ds[n * PN + m] + x;
                     });
    for (int n = tid; n < N; n += THREADS) {  // d log w (into xx) and du
      const float tail = dac[n] * ac[n];
      float p_after = 0.f, q_from = 0.f;
      for (int t = C - 1; t >= 0; --t) {
        const int time = g * C + t;
        q_from += dks[t * PN + n] * ks[t * PN + n];
        xx[t * PN + n] = p_after - q_from + tail;
        p_after += drs[t * PN + n] * rs[t * PN + n];
        du += in(R, time, n) * in(K, time, n) * bd[t];
      }
    }
    __syncthreads();
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, n = e % N, time = g * C + t;
      const float rv = in(R, time, n), kv = in(K, time, n),
                  wv = in(W, time, n);
      const float wc = fminf(fmaxf(wv, EPS), 1.f);
      const float cum = ld[t * PN + n];
      const float ub = uu[n] * bd[t];
      const long long o = out_off(time, n);
      store(a.out[R], o, drs[t * PN + n] * expf(cum - logf(wc)) + ub * kv,
            bf(R));
      store(a.out[K], o, dks[t * PN + n] / expf(cum) + ub * rv, bf(K));
      store(a.out[W], o, wv >= EPS && wv <= 1.f ? xx[t * PN + n] / wc : 0.f,
            bf(W));
    }
    __syncthreads();  // the next chunk's loads overwrite every tile
  }
  if (tid < N) a.du_rows[static_cast<long long>(bh) * N + tid] = du;
}

// du[j] = Σ over rows bh ≡ j (mod u_rows), in row order
__global__ void du_kernel(const float* du_rows, void* du, int rows, int u_rows,
                          int n, int bf) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= u_rows * n) return;
  const int j = e / n, c = e % n;
  float x = 0.f;
  for (int bh = j; bh < rows; bh += u_rows) x += du_rows[bh * n + c];
  store(du, e, x, bf != 0);
}

template <int C, int N>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  constexpr int bytes = Smem<C, N>::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the block's limit");
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_bwd_kernel<C, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  wkv_bwd_kernel<C, N><<<bh, THREADS, bytes, stream>>>(a);
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

bool sizes_ok(int chunk, int n) {
  const auto size = [](int x) { return x == 8 || x == 16 || x == 32 || x == 64; };
  return size(chunk) && size(n);
}

}  // namespace

// strides: 15 values, (batch, head, time) in elements for r, k, v, w and dO
// in turn, channels contiguous.  bf16: bit 0 r, 1 k, 2 v, 3 w, 4 dO, 5 u;
// each gradient takes its input's dtype.  dr, dk, dv, dw are [B, L, H, N]
// contiguous, du [u_rows, N]; row bh = b * heads + h reads u[bh % u_rows].
// states: float32 scratch of bh * (l / chunk) * n * n; du_rows: bh * n.
// The chunk c divides l; c and n are 8, 16, 32 or 64.  carry 0 drops the
// state's gradient between chunks: a wrong backward, for negative controls.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* dout, const void* u,
                             void* dr, void* dk, void* dv, void* dw, void* du,
                             float* states, float* du_rows, int bh, int heads,
                             int l, int n, int chunk, int u_rows, int bf16,
                             int carry, const long long* strides,
                             void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads || l <= 0 || u_rows <= 0 ||
      bh % u_rows || chunk <= 0 || l % chunk || !sizes_ok(chunk, n))
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
  a.du_rows = du_rows;
  a.bf16 = bf16;
  a.heads = heads;
  a.l = l;
  a.u_rows = u_rows;
  a.carry = carry;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (chunk) {
    case 8: err = launch_n<8>(a, bh, n, s); break;
    case 16: err = launch_n<16>(a, bh, n, s); break;
    case 32: err = launch_n<32>(a, bh, n, s); break;
    default: err = launch_n<64>(a, bh, n, s); break;
  }
  if (err != cudaSuccess) return err;
  const int total = u_rows * n;
  du_kernel<<<(total + 255) / 256, 256, 0, s>>>(du_rows, du, bh, u_rows, n,
                                                 (bf16 >> U) & 1);
  return cudaGetLastError();
}

// Dynamic shared memory of one block at (chunk, n); 0 for a shape the
// kernel does not take.
extern "C" int rwkv6_wkv_bwd_smem(int chunk, int n) {
  if (!sizes_ok(chunk, n)) return 0;
#define SMEM_CASE(c, nn) \
  if (chunk == c && n == nn) return Smem<c, nn>::BYTES;
#define SMEM_ROW(c) \
  SMEM_CASE(c, 8) SMEM_CASE(c, 16) SMEM_CASE(c, 32) SMEM_CASE(c, 64)
  SMEM_ROW(8) SMEM_ROW(16) SMEM_ROW(32) SMEM_ROW(64)
#undef SMEM_ROW
#undef SMEM_CASE
  return 0;
}

extern "C" const char* rwkv6_wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
