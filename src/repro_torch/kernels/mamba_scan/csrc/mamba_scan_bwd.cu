// Backward of the chunked SSD scan (Mamba) for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces no TPU kernel: the reference differentiates its jnp chunked form
// (src/repro/models/mamba.py ssd_scan; the forward's TPU kernel is
// mamba_scan_pallas, src/repro/kernels/mamba_scan/kernel.py:63).  It is the
// backward of csrc/mamba_scan.cu, so that the port trains Mamba layers on
// the card.  Per (batch row b, head h), chunk c of L steps (lcum the
// inclusive cumsum of loga within the chunk, e = exp(lcum), w = exp(lcum_L
// - lcum), a_c = exp(lcum_L), att = tril(C B^T o exp(lcum_s - lcum_t))):
//   y_c = att x_c + (C o e) h_{c-1},  h_c = a_c h_{c-1} + (B o w)^T x_c.
// Given dy and the final state's gradient dh (zeros if null), the forward's
// split runs in reverse, in four launches:
//   1. grad_in, per (chunk, b * H + h), in parallel: G_c = (C o e)^T dy_c,
//      what the chunk's outputs send into its entering state;
//   2. pass_grads, one block per (b * H + h), serial over the chunks: the
//      entering states h_{c-1} rebuilt in float32 from the forward's saved
//      chunk states S_c and decays a_c (its scratch: h_c = a_c h_{c-1} +
//      S_c from h0 by the forward's own fmaf, so they are the forward's
//      bits), then the reverse pass dH_{c-1} = a_c dH_c + G_c from dh,
//      writing dH_c (the gradient of the state after chunk c) and da_c =
//      <dH_c, h_{c-1}> (a block sum in a fixed order); dH_{-1} is h0's;
//   3. chunk_grads, per (chunk, b * H + h), in parallel: dx = att^T dy + (B
//      o w) dH_c, datt = dy x^T, each head's share of dB and dC (float32
//      scratch), and dloga, the reverse cumsum within the chunk of dlcum:
//      from att's decays (rows minus columns of datt o att), from e (C . dy
//      h_{c-1}^T), from w (B . x dH_c^T) and from a_c (da_c);
//   4. sum_heads: dB and dC, the heads' shares added in head order (B and C
//      are shared by the heads).
// Deterministic: no atomics, every sum in a fixed order; two calls give the
// same bits.
//
// Traps:
//   * Never exponentiate above the diagonal: lcum_s - lcum_t > 0 there, and
//     a chunk whose summed loga is below -88 overflows exp; the reference's
//     ssd_scan takes exp before its where and its gradient turns NaN (0 *
//     inf).  Every exp(lcum_s - lcum_t) here is taken for t <= s only, and
//     loga <= 0 keeps e, w, a_c and the decays in [0, 1].
//   * The casts of the forward: x, dy, B and C are read in their dtype
//     (bf16 or float32) and every product sums in float32; the entering
//     states are the float32 ones the forward passed (the plain version's h
//     is float32; the bf16 forward's tensor cores read them rounded, a
//     rounding far inside the bf16 gate); dloga and dh0 are float32, dx, dB
//     and dC are written in the inputs' dtype.
//   * The boot path saves no states: no h0 and one chunk, whose entering
//     state is zero (st and dec null).
//
// bfloat16 (the training dtype): the first three launches on the tensor
// cores (wgmma, sm90.cuh), bf16 operands and float32 accumulators:
//   * grad_in_tc: G_c = (C o e)^T dy_c (M = n, N = p, K = s), as the
//     forward's chunk states (csrc/mamba_scan.cu chunk_tc) take (B o w)^T
//     x: (C o e)^T written K-major by each step's thread, dy the N-major B;
//   * pass_tc: the pass split over the state (two blocks a (b, h) at
//     jamba's N P = 2048, as the forward's pass_states), dH_c into bf16 for
//     the chunk launch, da_c as the blocks' shares summed in order there;
//     the entering states in bf16 are the forward's own (its scratch);
//   * chunk_grads_tc: one block of two warpgroups a (chunk, b * H + h),
//     warpgroup w owning steps 64 w .. 64 w + 63 twice: as rows s (C B^T,
//     one wgmma a 64 x 64 tile as the forward; datt = dy x^T over t <= s,
//     both K-major as loaded; R = datt o att's row sums in registers; dcb =
//     datt o decay as register A fragments of dC's share dcb B (N = 16); Z
//     = dy h_{c-1}^T (N = 16)) and as rows t (the transposes B C^T and x
//     dy^T over s >= t, recomputed rather than moved through shared memory:
//     R's column sums are then row sums too, in registers; dcb^T C for
//     dB's share; U = x dH_c^T; dx = att^T dy + (B o w) dH_c with att^T
//     and B o w as register A fragments and dy and dH_c the N-major B).  dx
//     goes out through x's tile as 16-byte stores; dloga is the reverse
//     cumsum of the per-step terms (rows minus columns of R, e C . Z, w B .
//     U and da_c a_c) on one thread, in the scalar body's order;
//   * sum_heads: as float32.
// Every float32 operand goes in rounded once to bf16 (C o e, att, B o w and
// dH_c, h_{c-1}, dcb): att's and the states' rounding is the forward's, and
// the CPU mirror (ref.py mamba_scan_bwd_tiled, rounding="bf16") holds
// every gradient within a quarter of the 2e-2 gate at jamba's width
// (tests/test_torch_scan_bwd.py).  The decays go through the SFU's exp2
// (ex2.approx) below the diagonal only.  float32: the scalar bodies below,
// for the float32 parity paths only (their 2e-5 gate rules out bf16
// operands and TF32).
//
// What bounds it on this card: at jamba's training shape (B = 2, S = 2048,
// H = 64, P = 128, N = 16, L = 128) the function reads x and dy (bf16) and
// the saved states and writes dx, ~0.21 GB, ~0.06 ms at 3.35 TB/s; its
// products are ~22 GFLOP (~0.02 ms at the bf16 tensor-core rate).  The
// tensor-core chunk launch reads x and dy once more than that (G's and the
// chunk's launches) and holds 2 blocks an SM (~101 KB of shared memory
// each, 128 registers a thread); each block's chain of loads, wgmma groups
// and barriers, not the bytes, is what it waits on.  The scalar chunk_grads
// holds a (chunk, head) unit's datt = dy x^T and att^T dy over P in column
// tiles of 32, each thread an 8 x 8 block of datt in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_tile.cuh"
#include "sm90.cuh"
#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using kv_tile::store;
using kv_tile::to_float;

constexpr int kThreads = 256;
constexpr int kMaxL = 128;   // longest chunk
constexpr int kMaxN = 16;    // widest state
constexpr int kMaxNP = 2048; // N * P a (b, h) at most: eight floats a thread in the pass
constexpr int kPT = 32;      // columns of P a tile of launches 1 and 3
constexpr int kLd = kPT + 1; // padded tile rows

// ---------------------------------------------------------------------------
// The in-chunk cumsum, e and (where w is given) w of chunk c, serial on
// thread 0 (the forward's float32 order), for all threads after the
// barrier; zeros past the chunk.
// ---------------------------------------------------------------------------
__device__ void chunk_decays(const float* __restrict__ loga, size_t row0, int H, int h, int L,
                             int Lc, float* lc, float* e, float* w) {
  if (threadIdx.x == 0) {
    float x = 0.f;
    for (int t = 0; t < L; ++t) {
      if (t < Lc) x += loga[(row0 + t) * H + h];
      lc[t] = x;
    }
  }
  __syncthreads();
  const float l_last = lc[L - 1];
  for (int t = threadIdx.x; t < L; t += kThreads) {
    e[t] = t < Lc ? expf(lc[t]) : 0.f;
    if (w) w[t] = t < Lc ? expf(l_last - lc[t]) : 0.f;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1. G_c = (C o e)^T dy_c: one block per (chunk, b * H + h); a thread owns
// column p = tid % 32 of a tile and rows n = tid / 32, + 8, ... of G.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) grad_in(const T* __restrict__ dy,
                                                    const float* __restrict__ loga,
                                                    const T* __restrict__ Cm,
                                                    float* __restrict__ G, int S, int H, int P,
                                                    int N, int L) {
  __shared__ float lc[kMaxL], e[kMaxL];
  __shared__ float ce[kMaxL][kMaxN + 1];  // C o e
  __shared__ float dys[kMaxL][kLd];
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int n_chunks = gridDim.x, t0 = c * L, Lc = min(L, S - t0);
  const size_t row0 = (size_t)b * S + t0;
  chunk_decays(loga, row0, H, h, L, Lc, lc, e, nullptr);
  for (int i = tid; i < Lc * N; i += kThreads) {
    const int s = i / N, n = i - s * N;
    ce[s][n] = to_float(Cm[(row0 + s) * N + n]) * e[s];
  }
  const int pc = tid % kPT;
  float* Gb = G + ((size_t)bh * n_chunks + c) * N * P;
  for (int p0 = 0; p0 < P; p0 += kPT) {
    __syncthreads();  // ce is written; the last tile is consumed
    for (int i = tid; i < Lc * kPT; i += kThreads) {
      const int s = i / kPT, p = i - s * kPT;
      dys[s][p] = p0 + p < P ? to_float(dy[((row0 + s) * H + h) * P + p0 + p]) : 0.f;
    }
    __syncthreads();
    for (int n = tid / kPT; n < N; n += kThreads / kPT) {
      float acc = 0.f;
      for (int s = 0; s < Lc; ++s) acc = fmaf(ce[s][n], dys[s][pc], acc);
      if (p0 + pc < P) Gb[(size_t)n * P + p0 + pc] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. The pass: one block per b * H + h, element i = tid + 256 j of the N P
// state a thread's (at most kMaxNP / 256 = 8).  G (in D) is overwritten by
// dH_c; E receives the entering states.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) pass_grads(
    const float* __restrict__ st, const float* __restrict__ dec, const float* __restrict__ h0,
    const float* __restrict__ dh, float* __restrict__ D, float* __restrict__ E,
    float* __restrict__ da, float* __restrict__ dh0, int NP, int n_chunks) {
  constexpr int kPer = kMaxNP / kThreads;
  __shared__ float part[kThreads / 32];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const size_t sbase = (size_t)bh * NP, cbase = (size_t)bh * n_chunks * NP;
  float x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kThreads;
    x[j] = h0 && i < NP ? h0[sbase + i] : 0.f;
  }
  // the entering states, as the forward passed them: h = fmaf(a, h, S)
  for (int c = 0; c < n_chunks; ++c) {
    const float a = dec ? dec[(size_t)bh * n_chunks + c] : 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i >= NP) continue;
      E[cbase + (size_t)c * NP + i] = x[j];
      if (c + 1 < n_chunks) x[j] = fmaf(a, x[j], st[cbase + (size_t)c * NP + i]);
    }
  }
  // the reverse pass: x is now dH
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kThreads;
    x[j] = dh && i < NP ? dh[sbase + i] : 0.f;
  }
  for (int c = n_chunks - 1; c >= 0; --c) {
    const float a = dec ? dec[(size_t)bh * n_chunks + c] : 0.f;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i >= NP) continue;
      const size_t k = cbase + (size_t)c * NP + i;
      const float g = D[k];
      D[k] = x[j];
      dot = fmaf(x[j], E[k], dot);
      x[j] = fmaf(a, x[j], g);
    }
    // da_c = <dH_c, h_{c-1}>: warps, then the warps' sums in order
#pragma unroll
    for (int o = 16; o; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if ((tid & 31) == 0) part[tid >> 5] = dot;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int k = 0; k < kThreads / 32; ++k) s += part[k];
      da[(size_t)bh * n_chunks + c] = s;
    }
    __syncthreads();
  }
  if (dh0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < NP) dh0[sbase + i] = x[j];
    }
  }
}

// ---------------------------------------------------------------------------
// 3. The chunk's gradients: one block per (chunk, b * H + h).
// ---------------------------------------------------------------------------
// Shared memory (floats): lc, e, w, dw o w and dlcum (L each); B and C (L
// rows of N + 1); att (L x L, then datt o att, then datt o decay); the
// tiles of x and dy (L rows of 33; then U and Z, L rows of N + 1), of dH_c
// and h_{c-1} (N rows of 33).  ops.py bwd_plan mirrors it.
__host__ __device__ inline size_t chunk_smem_floats(int L, int N) {
  return 5 * (size_t)L + 2 * (size_t)L * (N + 1) + (size_t)L * L + 2 * (size_t)L * kLd +
         2 * (size_t)N * kLd;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_grads(
    const T* __restrict__ xbar, const float* __restrict__ loga, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ dy, const float* __restrict__ D,
    const float* __restrict__ E, const float* __restrict__ da, T* __restrict__ dx,
    float* __restrict__ dloga, float* __restrict__ dBh, float* __restrict__ dCh, int S, int H,
    int P, int N, int L) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* lc = smem;
  float* e = lc + L;
  float* w = e + L;
  float* rw = w + L;            // dw_t w_t
  float* dlc = rw + L;
  float* bs = dlc + L;          // [L][N + 1]
  float* cs = bs + L * ldn;     // [L][N + 1]
  float* att = cs + L * ldn;    // [L][L]
  float* xt = att + L * L;      // [L][33]
  float* dyt = xt + L * kLd;    // [L][33]
  float* Dt = dyt + L * kLd;    // [N][33] dH_c
  float* Et = Dt + N * kLd;     // [N][33] h_{c-1}

  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int n_chunks = gridDim.x, t0 = c * L, Lc = min(L, S - t0);
  const size_t row0 = (size_t)b * S + t0;
  const size_t sbase = ((size_t)bh * n_chunks + c) * N * P;
  chunk_decays(loga, row0, H, h, L, Lc, lc, e, w);
  for (int i = tid; i < L * N; i += kThreads) {
    const int t = i / N, n = i - t * N;
    const bool in = t < Lc;
    bs[t * ldn + n] = in ? to_float(Bm[(row0 + t) * N + n]) : 0.f;
    cs[t * ldn + n] = in ? to_float(Cm[(row0 + t) * N + n]) : 0.f;
  }
  __syncthreads();
  // att[s][t] = (C_s . B_t) exp(lc_s - lc_t) for t <= s < Lc, else 0: the
  // exponential only below the diagonal
  for (int i = tid; i < L * L; i += kThreads) {
    const int s = i / L, t = i - s * L;
    float a = 0.f;
    if (t <= s && s < Lc) {
      for (int n = 0; n < N; ++n) a = fmaf(cs[s * ldn + n], bs[t * ldn + n], a);
      a *= expf(lc[s] - lc[t]);
    }
    att[i] = a;
  }

  // datt: thread (sb, tb) = (tid / 16, tid % 16) owns rows s = sb + 16 r and
  // columns t = tb + 16 q, r, q < 8 (L <= 128)
  const int sb = tid >> 4, tb = tid & 15;
  float dat[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) dat[r][q] = 0.f;
  // U = x dH_c^T and Z = dy h_{c-1}^T: pairs (t, n) = i / N, i % N of
  // i = tid + 256 k (L N <= 2048)
  float U[8], Z[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) U[k] = Z[k] = 0.f;
  const int pc = tid % kPT;  // dx: column pc of the tile, rows tid / 32 + 8 k

  for (int p0 = 0; p0 < P; p0 += kPT) {
    __syncthreads();  // att is written; the last tile is consumed
    for (int i = tid; i < L * kPT; i += kThreads) {
      const int t = i / kPT, p = i - t * kPT;
      const bool in = t < Lc && p0 + p < P;
      const size_t g = ((row0 + t) * H + h) * P + p0 + p;
      xt[t * kLd + p] = in ? to_float(xbar[g]) : 0.f;
      dyt[t * kLd + p] = in ? to_float(dy[g]) : 0.f;
    }
    for (int i = tid; i < N * kPT; i += kThreads) {
      const int n = i / kPT, p = i - n * kPT;
      const bool in = p0 + p < P;
      Dt[n * kLd + p] = in ? D[sbase + (size_t)n * P + p0 + p] : 0.f;
      Et[n * kLd + p] = in ? E[sbase + (size_t)n * P + p0 + p] : 0.f;
    }
    __syncthreads();
    // dx[t][p] = sum_s att[s][t] dy[s][p] + w_t sum_n B[t][n] dH[n][p]
    for (int t = tid / kPT; t < Lc; t += kThreads / kPT) {
      float acc = 0.f;
      for (int s = t; s < Lc; ++s) acc = fmaf(att[s * L + t], dyt[s * kLd + pc], acc);
      float bd = 0.f;
      for (int n = 0; n < N; ++n) bd = fmaf(bs[t * ldn + n], Dt[n * kLd + pc], bd);
      if (p0 + pc < P) store(dx + ((row0 + t) * H + h) * P + p0 + pc, fmaf(w[t], bd, acc));
    }
    // datt[s][t] += sum_p dy[s][p] x[t][p]
    for (int p = 0; p < kPT; ++p) {
      float ds[8], xv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) ds[r] = dyt[min(sb + 16 * r, L - 1) * kLd + p];
#pragma unroll
      for (int q = 0; q < 8; ++q) xv[q] = xt[min(tb + 16 * q, L - 1) * kLd + p];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) dat[r][q] = fmaf(ds[r], xv[q], dat[r][q]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = tid + k * kThreads;
      if (i >= L * N) break;
      const int t = i / N, n = i - t * N;
      float u = U[k], z = Z[k];
      for (int p = 0; p < kPT; ++p) {
        u = fmaf(xt[t * kLd + p], Dt[n * kLd + p], u);
        z = fmaf(dyt[t * kLd + p], Et[n * kLd + p], z);
      }
      U[k] = u;
      Z[k] = z;
    }
  }
  __syncthreads();  // every thread is done with att, the tiles

  // R = datt o att into att's place; U and Z into the x and dy tiles
  float* Us = xt;   // [L][N + 1]
  float* Zs = dyt;  // [L][N + 1]
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = tid + k * kThreads;
    if (i >= L * N) break;
    const int t = i / N, n = i - t * N;
    Us[t * ldn + n] = U[k];
    Zs[t * ldn + n] = Z[k];
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int s = sb + 16 * r, t = tb + 16 * q;
      if (s < L && t < L) att[s * L + t] *= (t <= s && s < Lc) ? dat[r][q] : 0.f;
    }
  __syncthreads();
  // dlcum_s = (row s of R) - (column s of R) + e_s (C_s . Z_s) - w_s (B_s .
  // U_s), R = datt o att, and
  // into the last step sum_t w_t (B_t . U_t) + da_c a_c
  for (int s = tid; s < L; s += kThreads) {
    float rr = 0.f, cr = 0.f;
    for (int t = 0; t < L; ++t) {
      rr += att[s * L + t];
      cr += att[t * L + s];
    }
    float cz = 0.f, bu = 0.f;
    for (int n = 0; n < N; ++n) {
      cz = fmaf(cs[s * ldn + n], Zs[s * ldn + n], cz);
      bu = fmaf(bs[s * ldn + n], Us[s * ldn + n], bu);
    }
    rw[s] = w[s] * bu;
    dlc[s] = s < Lc ? rr - cr + e[s] * cz - w[s] * bu : 0.f;
  }
  __syncthreads();
  if (tid == 0) {  // the reverse cumsum, one serial pass
    float last = da[(size_t)bh * n_chunks + c] * expf(lc[L - 1]);
    for (int t = 0; t < Lc; ++t) last += rw[t];
    float acc = 0.f;
    for (int s = Lc - 1; s >= 0; --s) {
      acc += dlc[s] + (s == Lc - 1 ? last : 0.f);
      dloga[(row0 + s) * H + h] = acc;
    }
  }
  // datt o decay into att's place: datt o att / (C B^T) would divide by
  // zero, so the decay is taken again (below the diagonal only)
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int s = sb + 16 * r, t = tb + 16 * q;
      if (s < L && t < L)
        att[s * L + t] = (t <= s && s < Lc) ? dat[r][q] * expf(lc[s] - lc[t]) : 0.f;
    }
  __syncthreads();
  // this head's dC[s][n] = sum_t dcb[s][t] B[t][n] + e_s Z[s][n] and
  // dB[t][n] = sum_s dcb[s][t] C[s][n] + w_t U[t][n]
  const size_t hb = ((size_t)b * H + h) * S + t0;
  for (int i = tid; i < Lc * N; i += kThreads) {
    const int s = i / N, n = i - s * N;
    float dc = 0.f, db = 0.f;
    for (int t = 0; t <= s; ++t) dc = fmaf(att[s * L + t], bs[t * ldn + n], dc);
    for (int r = s; r < Lc; ++r) db = fmaf(att[r * L + s], cs[r * ldn + n], db);
    dCh[(hb + s) * N + n] = fmaf(e[s], Zs[s * ldn + n], dc);
    dBh[(hb + s) * N + n] = fmaf(w[s], Us[s * ldn + n], db);
  }
}

// 4. dB and dC: the heads' shares summed in head order, written in T.
template <typename T>
__global__ void __launch_bounds__(kThreads) sum_heads(const float* __restrict__ dBh,
                                                      const float* __restrict__ dCh,
                                                      T* __restrict__ dB, T* __restrict__ dC,
                                                      int B, int S, int H, int N) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t SN = (size_t)S * N;
  if (i >= (size_t)B * SN) return;
  const size_t b = i / SN, r = i - b * SN;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += dBh[(b * H + h) * SN + r];
    sc += dCh[(b * H + h) * SN + r];
  }
  store(dB + i, sb);
  store(dC + i, sc);
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core bodies
// ---------------------------------------------------------------------------
constexpr int kTileN = 16 * 128;  // a [16 n][64 columns] bf16 block: h_{c-1}, dH_c, B^T, C^T

using tc_tile::acc_col;
using tc_tile::acc_row;
using tc_tile::aligned_smem;
using tc_tile::chunk_cumsum;
using tc_tile::frag_col;
using tc_tile::frag_row;
using tc_tile::kLog2e;
using tc_tile::quad_sum;
using tc_tile::tile_at;

// Copies rows [0, KR) of a (steps, P) bf16 slice (step t at src + t *
// stride) into two 64-column swizzled blocks of KR rows at dst, by NT
// threads; rows past `rows` and columns past P zero-filled (read nothing).
template <int KR, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, size_t stride, int rows,
                                          int P) {
  for (int i = threadIdx.x; i < KR * 16; i += NT) {
    const int t = i >> 4, c16 = i & 15;
    const bool ok = t < rows && c16 * 8 < P;
    sm90::cp_async16(dst + (c16 >> 3) * (KR * 128) + sm90::swizzle128(t, c16 & 7),
                     ok ? src + t * stride + c16 * 8 : src, ok);
  }
}

// The same for a state (N <= 16 rows n of P) into two [16][64] blocks;
// rows past N, or all of them where src is null, zero-filled (`any`: a
// valid address the zero-filling copies name).
template <int NT>
__device__ __forceinline__ void load_state(uint32_t dst, const bf16* src, int N, int P,
                                           const bf16* any) {
  for (int i = threadIdx.x; i < kMaxN * 16; i += NT) {
    const int n = i >> 4, c16 = i & 15;
    const bool ok = src && n < N && c16 * 8 < P;
    sm90::cp_async16(dst + (c16 >> 3) * kTileN + sm90::swizzle128(n, c16 & 7),
                     ok ? src + (size_t)n * P + c16 * 8 : any, ok);
  }
}

// Step t's row of a (B, S, N) bf16 matrix (N <= 16), zeros past the chunk.
__device__ __forceinline__ void load_row16(const bf16* m, size_t row, int N, bool in, bf16 (&r)[16]) {
  uint4 v[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  if (in) {
    const uint4* src = reinterpret_cast<const uint4*>(m + row * N);
    v[0] = src[0];
    if (N > 8) v[1] = src[1];
  }
  const bf16* b = reinterpret_cast<const bf16*>(v);
#pragma unroll
  for (int n = 0; n < 16; ++n) r[n] = b[n];
}

// 1. grad_in_tc: G_c = (C o e)^T dy_c per (chunk, b * H + h), one
// warpgroup: M = n (N rows of 64; the rows past N are never written and
// feed only outputs past N, which are not stored), N = 64 columns p a
// block, K = s; (C o e)^T written K-major by the step's thread, dy the
// N-major B through the transpose bit.
template <int NWG>
struct GinLayout {
  static constexpr int kR = 64 * NWG;
  static constexpr int kDy = 0;                    // dy [2 blocks][kR s][64 p]
  static constexpr int kA = kDy + 2 * kR * 128;    // (C o e)^T [NWG blocks][64 n][64 s]
  static constexpr int kBytes = 1024 + kA + NWG * 64 * 128;
};

template <int NWG>
__global__ void __launch_bounds__(128) grad_in_tc(const bf16* __restrict__ dy,
                                                  const float* __restrict__ loga,
                                                  const bf16* __restrict__ Cm,
                                                  float* __restrict__ G, int S, int H, int P,
                                                  int N, int L) {
  using Lay = GinLayout<NWG>;
  constexpr int kR = Lay::kR;
  __shared__ float warp_sums[4];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sm_a = sm90::smem_addr(sm);
  const int c = blockIdx.x, bh = blockIdx.y, h = bh % H, tid = threadIdx.x;
  const int nc = gridDim.x, t0 = c * L, Lc = min(L, S - t0);
  const size_t row0 = (size_t)(bh / H) * S + t0;
  load_rows<kR, 128>(sm_a + Lay::kDy, dy + (row0 * H + h) * P, (size_t)H * P, Lc, P);
  sm90::cp_async_commit();
  float l_last;
  const float x = chunk_cumsum<kR>(tid < Lc ? loga[(row0 + tid) * H + h] : 0.f, warp_sums, l_last);
  if (tid < kR) {  // column t = tid of (C o e)^T
    bf16 cr[16];
    load_row16(Cm, row0 + tid, N, tid < Lc, cr);
    const float e = expf(x);
    uint8_t* a = sm + Lay::kA + (tid >> 6) * (64 * 128);
#pragma unroll
    for (int n = 0; n < 16; ++n) *tile_at(a, n, tid & 63) = __float2bfloat16(__bfloat162float(cr[n]) * e);
  }
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();
  float* Gb = G + ((size_t)bh * nc + c) * N * P;
#pragma unroll
  for (int cb = 0; cb < 2; ++cb) {
    if (cb * 64 >= P) break;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NWG; ++kk)
      if (16 * kk < Lc)
        sm90::wgmma_ss<64, 0, 1>(
            acc, sm90::desc128(sm_a + Lay::kA + (kk >> 2) * (64 * 128) + (kk & 3) * 32, 16, 1024),
            sm90::desc128(sm_a + Lay::kDy + cb * (kR * 128) + kk * 2048, 1024, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int n = acc_row(i), p = cb * 64 + acc_col(i);
      if (n < N && p < P)
        *reinterpret_cast<float2*>(Gb + (size_t)n * P + p) = make_float2(acc[i], acc[i + 1]);
    }
  }
}

// 2. pass_tc: the pass of pass_grads split over the state, one block per
// (b * H + h, 1024 floats of its N P state), a float4 a thread: the
// entering states rebuilt in float32 (h = fmaf(a, h, S), the forward's bits)
// into E, then dH_c (bf16, chunk_grads_tc's operand) and the block's share
// of da_c = <dH_c, h_{c-1}> (a block sum in a fixed order).
constexpr int kPassThreads = 256;

__global__ void __launch_bounds__(kPassThreads) pass_tc(
    const float* __restrict__ st, const float* __restrict__ dec, const float* __restrict__ h0,
    const float* __restrict__ dh, const float* __restrict__ G, float* __restrict__ E,
    bf16* __restrict__ Db, float* __restrict__ dap, float* __restrict__ dh0, int NP,
    int n_chunks) {
  __shared__ float part[kPassThreads / 32];
  const int bh = blockIdx.x, ny = gridDim.y, yb = blockIdx.y, tid = threadIdx.x;
  const int i = 4 * (yb * kPassThreads + tid);
  const bool ok = i < NP;
  const size_t sbase = (size_t)bh * NP + i, cbase = (size_t)bh * n_chunks * NP + i;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 x = ok && h0 ? *reinterpret_cast<const float4*>(h0 + sbase) : z;
  for (int c = 0; c < n_chunks; ++c) {
    const float a = dec ? dec[(size_t)bh * n_chunks + c] : 0.f;
    if (!ok) continue;
    const size_t k = cbase + (size_t)c * NP;
    *reinterpret_cast<float4*>(E + k) = x;
    if (c + 1 < n_chunks) {
      const float4 s = *reinterpret_cast<const float4*>(st + k);
      x = make_float4(fmaf(a, x.x, s.x), fmaf(a, x.y, s.y), fmaf(a, x.z, s.z), fmaf(a, x.w, s.w));
    }
  }
  x = ok && dh ? *reinterpret_cast<const float4*>(dh + sbase) : z;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const float a = dec ? dec[(size_t)bh * n_chunks + c] : 0.f;
    float dot = 0.f;
    if (ok) {
      const size_t k = cbase + (size_t)c * NP;
      const float4 g = *reinterpret_cast<const float4*>(G + k);
      const float4 e = *reinterpret_cast<const float4*>(E + k);
      *reinterpret_cast<uint2*>(Db + k) =
          make_uint2(sm90::pack_bf16(x.x, x.y), sm90::pack_bf16(x.z, x.w));
      dot = fmaf(x.x, e.x, fmaf(x.y, e.y, fmaf(x.z, e.z, x.w * e.w)));
      x = make_float4(fmaf(a, x.x, g.x), fmaf(a, x.y, g.y), fmaf(a, x.z, g.z), fmaf(a, x.w, g.w));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if ((tid & 31) == 0) part[tid >> 5] = dot;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kPassThreads / 32; ++w) s += part[w];
      dap[((size_t)bh * n_chunks + c) * ny + yb] = s;
    }
    __syncthreads();
  }
  if (dh0 && ok) *reinterpret_cast<float4*>(dh0 + sbase) = x;
}

// Shared memory of chunk_grads_tc: byte offsets from a 1024-aligned base
// (ops.py bwd_plan mirrors kBytes).
template <int NWG>
struct CgLayout {
  static constexpr int kR = 64 * NWG;                // rows (steps) of the tiles
  static constexpr int kX = 0;                       // x [2 blocks][kR][64 p]; then dx
  static constexpr int kDy = kX + 2 * kR * 128;      // dy [2 blocks][kR][64 p]
  static constexpr int kBC = kDy + 2 * kR * 128;     // C | B [kR][C 0..15, B 16..31]
  static constexpr int kH = kBC + kR * 128;          // h_{c-1} [2 blocks][16 n][64 p]
  static constexpr int kDH = kH + 2 * kTileN;        // dH_c [2 blocks][16 n][64 p]
  static constexpr int kBt = kDH + 2 * kTileN;       // B^T [NWG blocks][16 n][64 t]
  static constexpr int kCt = kBt + NWG * kTileN;     // C^T [NWG blocks][16 n][64 s]
  static constexpr int kVec = kCt + NWG * kTileN;    // f32 [7][kR]: lc log2(e), e, w, and
                                                     // the dlcum terms rr, cr, cz, rw
  static constexpr int kBytes = 1024 + kVec + 7 * kR * 4;
};

// 3. chunk_grads_tc: chunk_grads per (chunk, b * H + h) on the tensor cores,
// warpgroup w owning steps 64 w .. 64 w + 63 twice over: as rows s (C B^T
// and datt = dy x^T for t <= s, K = 16 and p; R = datt o att's row sums; dcb
// = datt o decay as register A fragments of dC's share dcb B, K = t; Z = dy
// h_{c-1}^T, N = 16) and as rows t (their transposes B C^T and x dy^T for s
// >= t; R's column sums; dcb^T C for dB's share; U = x dH_c^T, N = 16; then
// dx = att^T dy + (B o w) dH_c, att^T and B o w as register A fragments, dy
// and dH_c the N-major B).  dx goes out through x's tile as 16-byte
// stores; dloga is the reverse cumsum of dlcum on one thread.
template <int NWG>
__global__ void __launch_bounds__(128 * NWG, 2) chunk_grads_tc(
    const bf16* __restrict__ xbar, const float* __restrict__ loga, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ dy, const bf16* __restrict__ hin,
    const bf16* __restrict__ Db, const float* __restrict__ dap, bf16* __restrict__ dx, float* __restrict__ dloga, float* __restrict__ dBh,
    float* __restrict__ dCh, int S, int H, int P, int N, int L, int ny) {
  using Lay = CgLayout<NWG>;
  constexpr int kR = Lay::kR, kT = 128 * NWG;
  __shared__ float warp_sums[kR / 32];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sm_a = sm90::smem_addr(sm);
  float* l2 = reinterpret_cast<float*>(sm + Lay::kVec);
  float* ev = l2 + kR;
  float* wv = ev + kR;
  float* rr_s = wv + kR;
  float* cr_s = rr_s + kR;
  float* cz_s = cr_s + kR;
  float* rw_s = cz_s + kR;
  const int c = blockIdx.x, bh = blockIdx.y, h = bh % H, tid = threadIdx.x, wg = tid >> 7;
  const int nc = gridDim.x, t0 = c * L, Lc = min(L, S - t0);
  const size_t row0 = (size_t)(bh / H) * S + t0, HP = (size_t)H * P;
  const size_t sbase = ((size_t)bh * nc + c) * N * P;
  const uint32_t xa = sm_a + Lay::kX, dya = sm_a + Lay::kDy, bca = sm_a + Lay::kBC;
  const uint32_t ha = sm_a + Lay::kH, dha = sm_a + Lay::kDH;
  const uint32_t bta = sm_a + Lay::kBt, cta = sm_a + Lay::kCt;
  uint8_t* bc = sm + Lay::kBC;

  load_rows<kR, kT>(xa, xbar + (row0 * H + h) * P, HP, Lc, P);
  load_rows<kR, kT>(dya, dy + (row0 * H + h) * P, HP, Lc, P);
  for (int i = tid; i < kR * 4; i += kT) {  // C | B, K = N padded to 16 with zeros
    const int r = i >> 2, ch = i & 3, half = ch & 1;
    const bf16* src = ch < 2 ? Cm : Bm;
    const bool ok = r < Lc && half * 8 < N;
    sm90::cp_async16(bca + sm90::swizzle128(r, ch), ok ? src + (row0 + r) * N + half * 8 : src, ok);
  }
  load_state<kT>(ha, hin ? hin + sbase : nullptr, N, P, Db);
  load_state<kT>(dha, Db + sbase, N, P, Db);
  sm90::cp_async_commit();
  float l_last;
  const float x = chunk_cumsum<kR>(tid < Lc ? loga[(row0 + tid) * H + h] : 0.f, warp_sums, l_last);
  if (tid < kR) {
    const float wt = tid < Lc ? expf(l_last - x) : 0.f;
    l2[tid] = x * kLog2e;  // the decays by exp2
    ev[tid] = expf(x);
    wv[tid] = wt;
    bf16 br[16], cr[16];
    load_row16(Bm, row0 + tid, N, tid < Lc, br);
    load_row16(Cm, row0 + tid, N, tid < Lc, cr);
    uint8_t* bt = sm + Lay::kBt + (tid >> 6) * kTileN;
    uint8_t* ct = sm + Lay::kCt + (tid >> 6) * kTileN;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *tile_at(bt, n, tid & 63) = br[n];
      *tile_at(ct, n, tid & 63) = cr[n];
    }
  }
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();

  const int r0 = 64 * wg;
  auto decay = [&](int s, int t) { return sm90::fast_exp2(l2[s] - l2[t]); };
  // ---- rows s: Z, R's row sums, dC's share
  {
    float Z[8], dcs[8], rr[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) Z[i] = dcs[i] = 0.f;
    sm90::fence_regs(Z);
    sm90::wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<16, 0, 0>(Z, sm90::desc128(dya + cb * (kR * 128) + r0 * 128 + kk * 32, 16, 1024),
                                 sm90::desc128(ha + cb * kTileN + kk * 32, 16, 1024));
    sm90::wgmma_commit();
#pragma unroll
    for (int nb = 0; nb < NWG; ++nb) {
      if (nb > wg) continue;  // warpgroup-uniform: columns t <= s only
      float sc[32], da[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = da[i] = 0.f;
      sm90::fence_regs(sc);
      sm90::fence_regs(da);
      sm90::wgmma_fence();
      sm90::wgmma_ss<64, 0, 0>(sc, sm90::desc128(bca + r0 * 128, 16, 1024),
                               sm90::desc128(bca + nb * 64 * 128 + 32, 16, 1024));
#pragma unroll
      for (int cb = 0; cb < 2; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<64, 0, 0>(
              da, sm90::desc128(dya + cb * (kR * 128) + r0 * 128 + kk * 32, 16, 1024),
              sm90::desc128(xa + cb * (kR * 128) + nb * 64 * 128 + kk * 32, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(sc);
      sm90::fence_regs(da);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int s = r0 + acc_row(i), t = nb * 64 + acc_col(i);
        const float d = (t <= s && s < Lc) ? decay(s, t) : 0.f;
        rr[(i >> 1) & 1] = fmaf(da[i] * sc[i], d, rr[(i >> 1) & 1]);
        da[i] *= d;  // dcb = datt o decay
      }
      sm90::fence_regs(dcs);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t fr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) fr[q] = sm90::pack_bf16(da[8 * j + 2 * q], da[8 * j + 2 * q + 1]);
        sm90::wgmma_rs<16, 0>(dcs, fr, sm90::desc128(bta + nb * kTileN + j * 32, 16, 1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(dcs);
    }
    sm90::wgmma_wait0();
    sm90::fence_regs(Z);
    float cz[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int s = r0 + acc_row(i), n = acc_col(i);
      cz[(i >> 1) & 1] += __bfloat162float(*tile_at(bc, s, n)) * Z[i] +
                          __bfloat162float(*tile_at(bc, s, n + 1)) * Z[i + 1];
      if (s < Lc && n < N)
        *reinterpret_cast<float2*>(dCh + ((size_t)bh * S + t0 + s) * N + n) =
            make_float2(fmaf(ev[s], Z[i], dcs[i]), fmaf(ev[s], Z[i + 1], dcs[i + 1]));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = quad_sum(rr[e]), b = quad_sum(cz[e]);
      const int s = r0 + acc_row(2 * e);
      if ((tid & 3) == 0) {
        rr_s[s] = a;
        cz_s[s] = b;
      }
    }
  }
  // ---- rows t: U, R's column sums, dB's share
  {
    float U[8], dbs[8], cr[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) U[i] = dbs[i] = 0.f;
    sm90::fence_regs(U);
    sm90::wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<16, 0, 0>(U, sm90::desc128(xa + cb * (kR * 128) + r0 * 128 + kk * 32, 16, 1024),
                                 sm90::desc128(dha + cb * kTileN + kk * 32, 16, 1024));
    sm90::wgmma_commit();
#pragma unroll
    for (int nb = 0; nb < NWG; ++nb) {
      if (nb < wg) continue;  // warpgroup-uniform: columns s >= t only
      float sc[32], da[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = da[i] = 0.f;
      sm90::fence_regs(sc);
      sm90::fence_regs(da);
      sm90::wgmma_fence();
      sm90::wgmma_ss<64, 0, 0>(sc, sm90::desc128(bca + r0 * 128 + 32, 16, 1024),
                               sm90::desc128(bca + nb * 64 * 128, 16, 1024));
#pragma unroll
      for (int cb = 0; cb < 2; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<64, 0, 0>(
              da, sm90::desc128(xa + cb * (kR * 128) + r0 * 128 + kk * 32, 16, 1024),
              sm90::desc128(dya + cb * (kR * 128) + nb * 64 * 128 + kk * 32, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(sc);
      sm90::fence_regs(da);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = r0 + acc_row(i), s = nb * 64 + acc_col(i);
        const float d = (t <= s && s < Lc) ? decay(s, t) : 0.f;
        cr[(i >> 1) & 1] = fmaf(da[i] * sc[i], d, cr[(i >> 1) & 1]);
        da[i] *= d;  // dcb^T
      }
      sm90::fence_regs(dbs);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t fr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) fr[q] = sm90::pack_bf16(da[8 * j + 2 * q], da[8 * j + 2 * q + 1]);
        sm90::wgmma_rs<16, 0>(dbs, fr, sm90::desc128(cta + nb * kTileN + j * 32, 16, 1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(dbs);
    }
    sm90::wgmma_wait0();
    sm90::fence_regs(U);
    float bu[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int t = r0 + acc_row(i), n = acc_col(i);
      bu[(i >> 1) & 1] += __bfloat162float(*tile_at(bc, t, 16 + n)) * U[i] +
                          __bfloat162float(*tile_at(bc, t, 17 + n)) * U[i + 1];
      if (t < Lc && n < N)
        *reinterpret_cast<float2*>(dBh + ((size_t)bh * S + t0 + t) * N + n) =
            make_float2(fmaf(wv[t], U[i], dbs[i]), fmaf(wv[t], U[i + 1], dbs[i + 1]));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = quad_sum(cr[e]), b = quad_sum(bu[e]);
      const int t = r0 + acc_row(2 * e);
      if ((tid & 3) == 0) {
        cr_s[t] = a;
        rw_s[t] = wv[t] * b;
      }
    }
  }
  __syncthreads();  // every warpgroup is done with x's tile: it takes dx
  // ---- dx = att^T dy + (B o w) dH_c, rows t, one 64-column block at a time
#pragma unroll
  for (int cb = 0; cb < 2; ++cb) {
    if (cb * 64 >= P) break;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    uint32_t bw[4];  // B o w, rows t, K = n
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = r0 + frag_row(q), n = frag_col(0, q);
      bw[q] = sm90::pack_bf16(__bfloat162float(*tile_at(bc, t, 16 + n)) * wv[t],
                              __bfloat162float(*tile_at(bc, t, 17 + n)) * wv[t]);
    }
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    sm90::wgmma_rs<64, 1>(acc, bw, sm90::desc128(dha + cb * kTileN, 1024, 1024));
    sm90::wgmma_commit();
#pragma unroll
    for (int nb = 0; nb < NWG; ++nb) {
      if (nb < wg) continue;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
      sm90::wgmma_ss<64, 0, 0>(sc, sm90::desc128(bca + r0 * 128 + 32, 16, 1024),
                               sm90::desc128(bca + nb * 64 * 128, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(sc);
      sm90::fence_regs(acc);
      uint32_t pa[4][4];  // att^T, rows t, K = s: rounded to bf16 as the forward's att
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = r0 + acc_row(i), s = nb * 64 + acc_col(i);
        sc[i] = (t <= s && s < Lc) ? sc[i] * decay(s, t) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) pa[j][q] = sm90::pack_bf16(sc[8 * j + 2 * q], sc[8 * j + 2 * q + 1]);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (16 * (nb * 4 + j) < Lc)
          sm90::wgmma_rs<64, 1>(acc, pa[j],
                                sm90::desc128(dya + cb * (kR * 128) + (nb * 4 + j) * 2048, 1024, 1024));
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait0();
    sm90::fence_regs(acc);
    uint8_t* xs = sm + Lay::kX + cb * (kR * 128);
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<uint32_t*>(tile_at(xs, r0 + acc_row(i), acc_col(i))) =
          sm90::pack_bf16(acc[i], acc[i + 1]);
  }
  __syncthreads();
  for (int i = tid; i < kR * 16; i += kT) {  // dx: 16-byte pieces of whole rows
    const int t = i >> 4, c16 = i & 15;
    if (t < Lc && c16 * 8 < P)
      *reinterpret_cast<uint4*>(dx + (row0 + t) * HP + (size_t)h * P + c16 * 8) =
          *reinterpret_cast<const uint4*>(sm + Lay::kX + (c16 >> 3) * (kR * 128) +
                                          sm90::swizzle128(t, c16 & 7));
  }
  if (tid == 0) {  // dloga: the reverse cumsum of dlcum, one serial pass
    float da_c = 0.f;
    for (int y = 0; y < ny; ++y) da_c += dap[((size_t)bh * nc + c) * ny + y];
    float last = da_c * expf(l_last);
    for (int t = 0; t < Lc; ++t) last += rw_s[t];
    float acc = 0.f;
    for (int s = Lc - 1; s >= 0; --s) {
      const float dl = rr_s[s] - cr_s[s] + ev[s] * cz_s[s] - rw_s[s];
      acc += dl + (s == Lc - 1 ? last : 0.f);
      dloga[(row0 + s) * H + h] = acc;
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel* kernel, size_t smem, int (&set)[kv_tile::kMaxDevices]) {
  const cudaError_t err = kv_tile::raise_smem_limit(kernel, smem, set);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the next launch must not report it
  return err;
}

// One launch of a call: its grid, threads and dynamic shared memory.
struct Launch {
  dim3 grid;
  int threads;
  size_t smem;
};

// Blocks of pass_tc a (b, h): 1024 floats of the state each.
__host__ __device__ inline int pass_blocks(int NP) { return (NP + 4 * kPassThreads - 1) / (4 * kPassThreads); }

// The four launches of a call, in order (ops.py bwd_plan mirrors them), and
// the scratch's floats: float32 takes the scalar bodies (grad_in,
// pass_grads, chunk_grads, sum_heads); bf16 the tensor-core ones
// (grad_in_tc, pass_tc, chunk_grads_tc, then sum_heads), two warpgroups a
// chunk where L > 64.  The scratch: float32 G_c (later dH_c) and the
// entering states, da (bf16: pass_tc's shares, padded to 4 floats), each
// head's dB and dC; bf16 adds dH_c in bf16 after the entering states.
void plan(int B, int S, int H, int P, int N, int L, int dtype, Launch (&ls)[4], size_t& scratch) {
  const int nc = (S + L - 1) / L, BH = B * H, NP = N * P;
  const size_t n_st = (size_t)BH * nc * NP, n_bc = (size_t)B * S * N;
  const dim3 per_chunk(nc, BH);
  ls[3] = {dim3((unsigned)((n_bc + kThreads - 1) / kThreads)), kThreads, 0};
  if (dtype == 1) {
    const int nwg = L > 64 ? 2 : 1;
    const size_t dap = ((size_t)BH * nc * pass_blocks(NP) + 3) & ~(size_t)3;
    scratch = 2 * n_st + n_st / 2 + dap + 2 * (size_t)BH * S * N;
    ls[0] = {per_chunk, 128, (size_t)(nwg == 2 ? GinLayout<2>::kBytes : GinLayout<1>::kBytes)};
    ls[1] = {dim3(BH, pass_blocks(NP)), kPassThreads, 0};
    ls[2] = {per_chunk, 128 * nwg,
             (size_t)(nwg == 2 ? CgLayout<2>::kBytes : CgLayout<1>::kBytes)};
  } else {
    scratch = 2 * n_st + (size_t)BH * nc + 2 * (size_t)BH * S * N;
    ls[0] = {per_chunk, kThreads, 0};
    ls[1] = {dim3(BH), kThreads, 0};
    ls[2] = {per_chunk, kThreads, sizeof(float) * chunk_smem_floats(L, N)};
  }
}

#define LAUNCH(i, kernel, ...)                                                                 \
  do {                                                                                         \
    static int set[kv_tile::kMaxDevices] = {};                                                 \
    if (ls[i].smem && (err = prepare(kernel, ls[i].smem, set)) != cudaSuccess) return (int)err; \
    kernel<<<ls[i].grid, ls[i].threads, ls[i].smem, stream>>>(__VA_ARGS__);                    \
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;                            \
  } while (0)

int launch_f32(const float* xbar, const float* loga, const float* Bm, const float* Cm,
               const float* h0, const float* st, const float* dec, const float* dy,
               const float* dh, float* dx, float* dloga, float* dB, float* dC, float* dh0,
               float* scratch, int B, int S, int H, int P, int N, int L, cudaStream_t stream) {
  Launch ls[4];
  size_t n;
  plan(B, S, H, P, N, L, 0, ls, n);
  const int n_chunks = (S + L - 1) / L, NP = N * P;
  const size_t n_st = (size_t)B * H * n_chunks * NP;
  float* D = scratch;
  float* E = D + n_st;
  float* da = E + n_st;
  float* dBh = da + (size_t)B * H * n_chunks;
  float* dCh = dBh + (size_t)B * H * S * N;
  cudaError_t err;
  LAUNCH(0, grad_in<float>, dy, loga, Cm, D, S, H, P, N, L);
  LAUNCH(1, pass_grads, st, dec, h0, dh, D, E, da, dh0, NP, n_chunks);
  LAUNCH(2, chunk_grads<float>, xbar, loga, Bm, Cm, dy, D, E, da, dx, dloga, dBh, dCh, S, H, P,
         N, L);
  LAUNCH(3, sum_heads<float>, dBh, dCh, dB, dC, B, S, H, N);
  return 0;
}

template <int NWG>
int launch_tc(const bf16* xbar, const float* loga, const bf16* Bm, const bf16* Cm,
              const float* h0, const float* st, const bf16* hin, const float* dec, const bf16* dy,
              const float* dh, bf16* dx, float* dloga, bf16* dB, bf16* dC, float* dh0,
              float* scratch, int B, int S, int H, int P, int N, int L, cudaStream_t stream) {
  Launch ls[4];
  size_t n;
  plan(B, S, H, P, N, L, 1, ls, n);
  const int n_chunks = (S + L - 1) / L, NP = N * P, ny = pass_blocks(NP);
  const size_t n_st = (size_t)B * H * n_chunks * NP;
  float* G = scratch;
  float* E = G + n_st;
  bf16* Db = reinterpret_cast<bf16*>(E + n_st);
  float* dap = E + n_st + n_st / 2;
  float* dBh = dap + (((size_t)B * H * n_chunks * ny + 3) & ~(size_t)3);
  float* dCh = dBh + (size_t)B * H * S * N;
  cudaError_t err;
  LAUNCH(0, grad_in_tc<NWG>, dy, loga, Cm, G, S, H, P, N, L);
  LAUNCH(1, pass_tc, st, dec, h0, dh, G, E, Db, dap, dh0, NP, n_chunks);
  LAUNCH(2, chunk_grads_tc<NWG>, xbar, loga, Bm, Cm, dy, hin, Db, dap, dx, dloga, dBh, dCh, S, H,
         P, N, L, ny);
  LAUNCH(3, sum_heads<bf16>, dBh, dCh, dB, dC, B, S, H, N);
  return 0;
}

#undef LAUNCH

}  // namespace

// xbar, dy (B, S, H, P); loga (B, S, H) float32; Bm, Cm (B, S, N); h0 (B, H,
// N, P) float32 or null; st (B H, n_chunks, N, P) and dec (B H, n_chunks),
// float32, the forward's chunk states and decays, and hin, its bf16
// entering states (the bf16 forward's scratch; null for float32), all null
// on the boot path (no h0 and one chunk); dh (B, H, N, P) float32 or null
// (zeros); outputs dx (B, S, H, P), dloga (B, S, H) float32, dB, dC (B, S,
// N), dh0 (B, H, N, P) float32 or null (not wanted); scratch: float32, as
// plan() sizes it and the launchers carve it (mamba_scan_bwd_plan's floats).
// dtype 0 = float32 (the scalar bodies), 1 = bfloat16 (the tensor-core
// ones; xbar, Bm, Cm, dy and dx, dB, dC share it).  The wrapper guarantees
// contiguous 16-byte-aligned tensors, L <= 128, N <= 16 (bf16: 8 or 16), N
// P <= 2048 (bf16: P <= 128 and a multiple of 8), and the shared memory
// within the card's 227 KB.  Returns cudaGetLastError() after the launches
// (0 = success).
extern "C" int mamba_scan_bwd(const void* xbar, const void* loga, const void* Bm, const void* Cm,
                              const void* h0, const void* st, const void* hin, const void* dec,
                              const void* dy, const void* dh, void* dx, void* dloga, void* dB,
                              void* dC, void* dh0, void* scratch, int B, int S, int H, int P,
                              int N, int L, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > kMaxL || N > kMaxN || N * P > kMaxNP) return (int)cudaErrorInvalidValue;
  const float* la = static_cast<const float*>(loga);
  const float* hh = static_cast<const float*>(h0);
  const float* sst = static_cast<const float*>(st);
  const float* dd = static_cast<const float*>(dec);
  const float* g = static_cast<const float*>(dh);
  float* dla = static_cast<float*>(dloga);
  float* d0 = static_cast<float*>(dh0);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 1) {
    if (P > 128 || P % 8 || (N != 8 && N != 16)) return (int)cudaErrorInvalidValue;
    const bf16* x = static_cast<const bf16*>(xbar);
    const bf16* bm = static_cast<const bf16*>(Bm);
    const bf16* cm = static_cast<const bf16*>(Cm);
    const bf16* hi = static_cast<const bf16*>(hin);
    const bf16* d = static_cast<const bf16*>(dy);
    bf16* ox = static_cast<bf16*>(dx);
    bf16* ob = static_cast<bf16*>(dB);
    bf16* oc = static_cast<bf16*>(dC);
    if (L > 64)
      return launch_tc<2>(x, la, bm, cm, hh, sst, hi, dd, d, g, ox, dla, ob, oc, d0, sc, B, S, H,
                          P, N, L, s);
    return launch_tc<1>(x, la, bm, cm, hh, sst, hi, dd, d, g, ox, dla, ob, oc, d0, sc, B, S, H, P,
                        N, L, s);
  }
  return launch_f32(static_cast<const float*>(xbar), la, static_cast<const float*>(Bm),
                    static_cast<const float*>(Cm), hh, sst, dd, static_cast<const float*>(dy), g,
                    static_cast<float*>(dx), dla, static_cast<float*>(dB),
                    static_cast<float*>(dC), d0, sc, B, S, H, P, N, L, s);
}

// The plan of a call, as mamba_scan_bwd launches it: out[0] the scratch's
// floats, then for each of the four launches grid x, y, z, threads and
// dynamic shared memory (21 values).  ops.py bwd_plan mirrors it.
extern "C" int mamba_scan_bwd_plan(int B, int S, int H, int P, int N, int L, int dtype,
                                   long long* out) {
  if (L > kMaxL || N > kMaxN || N * P > kMaxNP) return (int)cudaErrorInvalidValue;
  Launch ls[4];
  size_t n;
  plan(B, S, H, P, N, L, dtype, ls, n);
  out[0] = (long long)n;
  for (int i = 0; i < 4; ++i) {
    long long* o = out + 1 + 5 * i;
    o[0] = ls[i].grid.x;
    o[1] = ls[i].grid.y;
    o[2] = ls[i].grid.z;
    o[3] = ls[i].threads;
    o[4] = (long long)ls[i].smem;
  }
  return 0;
}
