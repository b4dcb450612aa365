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
// What bounds it on this card: at jamba's training shape (B = 2, S = 2048,
// H = 64, P = 128, N = 16, L = 128) the function reads x and dy (bf16) and
// the saved states and writes dx, ~0.21 GB, ~0.06 ms at 3.35 TB/s; its
// products are ~22 GFLOP.  This first version is scalar float32 FMAs from
// shared memory (the tensor-core redesign is later work): launch 3
// dominates, a (chunk, head) unit's datt = dy x^T and att^T dy over P in
// column tiles of 32, each thread holding an 8 x 8 block of datt in
// registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_tile.cuh"

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

template <typename Kernel>
cudaError_t prepare(Kernel* kernel, size_t smem, int (&set)[kv_tile::kMaxDevices]) {
  const cudaError_t err = kv_tile::raise_smem_limit(kernel, smem, set);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the next launch must not report it
  return err;
}

template <typename T>
int launch(const T* xbar, const float* loga, const T* Bm, const T* Cm, const float* h0,
           const float* st, const float* dec, const T* dy, const float* dh, T* dx, float* dloga,
           T* dB, T* dC, float* dh0, float* scratch, int B, int S, int H, int P, int N, int L,
           cudaStream_t stream) {
  const int n_chunks = (S + L - 1) / L, NP = N * P;
  const size_t n_st = (size_t)B * H * n_chunks * NP;
  float* D = scratch;
  float* E = D + n_st;
  float* da = E + n_st;
  float* dBh = da + (size_t)B * H * n_chunks;
  float* dCh = dBh + (size_t)B * H * S * N;
  grad_in<T><<<dim3(n_chunks, B * H), kThreads, 0, stream>>>(dy, loga, Cm, D, S, H, P, N, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pass_grads<<<B * H, kThreads, 0, stream>>>(st, dec, h0, dh, D, E, da, dh0, NP, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * chunk_smem_floats(L, N);
  static int set[kv_tile::kMaxDevices] = {};
  if ((err = prepare(chunk_grads<T>, smem, set)) != cudaSuccess) return (int)err;
  chunk_grads<T><<<dim3(n_chunks, B * H), kThreads, smem, stream>>>(
      xbar, loga, Bm, Cm, dy, D, E, da, dx, dloga, dBh, dCh, S, H, P, N, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t n_bc = (size_t)B * S * N;
  sum_heads<T><<<(unsigned)((n_bc + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      dBh, dCh, dB, dC, B, S, H, N);
  return (int)cudaGetLastError();
}

}  // namespace

// xbar, dy (B, S, H, P); loga (B, S, H) float32; Bm, Cm (B, S, N); h0 (B, H,
// N, P) float32 or null; st (B H, n_chunks, N, P) and dec (B H, n_chunks),
// float32, the forward's chunk states and decays (null on the boot path: no
// h0 and one chunk); dh (B, H, N, P) float32 or null (zeros); outputs dx
// (B, S, H, P), dloga (B, S, H) float32, dB, dC (B, S, N), dh0 (B, H, N, P)
// float32 or null (not wanted); scratch: float32, dH_c and the entering
// states (B H n_chunks N P each), da (B H n_chunks), each head's dB and dC
// (B H S N each), as launch() carves it (ops.py bwd_plan mirrors it).
// dtype 0 = float32, 1 = bfloat16 (xbar, Bm, Cm, dy and dx, dB, dC share
// it).  The wrapper guarantees contiguous tensors, L <= 128, N <= 16, N P
// <= 2048, and the shared memory within the card's 227 KB.  Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int mamba_scan_bwd(const void* xbar, const void* loga, const void* Bm, const void* Cm,
                              const void* h0, const void* st, const void* dec, const void* dy,
                              const void* dh, void* dx, void* dloga, void* dB, void* dC,
                              void* dh0, void* scratch, int B, int S, int H, int P, int N,
                              int L, int dtype, void* stream) {
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
  if (dtype == 1)
    return launch<bf16>(static_cast<const bf16*>(xbar), la, static_cast<const bf16*>(Bm),
                        static_cast<const bf16*>(Cm), hh, sst, dd,
                        static_cast<const bf16*>(dy), g, static_cast<bf16*>(dx), dla,
                        static_cast<bf16*>(dB), static_cast<bf16*>(dC), d0, sc, B, S, H, P, N,
                        L, s);
  return launch<float>(static_cast<const float*>(xbar), la, static_cast<const float*>(Bm),
                       static_cast<const float*>(Cm), hh, sst, dd,
                       static_cast<const float*>(dy), g, static_cast<float*>(dx), dla,
                       static_cast<float*>(dB), static_cast<float*>(dC), d0, sc, B, S, H, P,
                       N, L, s);
}
