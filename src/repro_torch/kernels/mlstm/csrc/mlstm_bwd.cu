// Backward of the chunkwise mLSTM for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces no TPU kernel: the reference differentiates its jnp chunkwise
// form (src/repro/models/xlstm.py mlstm_forward; the forward's TPU kernel is
// mlstm_pallas, src/repro/kernels/mlstm/kernel.py:106).  It is the backward
// of csrc/mlstm.cu, so that the port trains xLSTM's mLSTM layers on the
// card.  Per (batch row b, head h), chunk of L steps, with Q = scale q, the
// gates of include/mlstm_gates.cuh (m_new, inter, w) and gate[s][t] =
// exp(b_s - b_t + log i_t - m_new_s) for t <= s:
//   att = gate o (Q k^T),  num = att v + inter o (Q C),  den = rowsum(att)
//   + inter o (Q n),  h = num / max(|den|, exp(-m_new)),
//   C' = inter_L C + (k o w)^T v,  n' = inter_L n + (k o w)^T 1.
//
// Traps:
//   * The stabiliser m needs no gradient.  With num_u and den_u the
//     unstabilised sums, h = num_u / max(|den_u|, 1): m_new cancels out of
//     num, den and exp(-m_new), so h does not depend on m, and every m,
//     m_new and inter is held constant here (their dependence on b and
//     log i stays).  Autograd of the plain version routes terms through
//     cummax and maximum that cancel only up to rounding (the CPU tests
//     hold the split equal to it at 1e-10 in float64).  Only the final
//     state, stabilised by the final m, does depend on it: C_fin =
//     exp(-m_fin) C_u, so a final-state gradient sends g_m = dm_fin -
//     <dC_fin, C_fin> - <dn_fin, n_fin> into m_fin, which reaches log i
//     and log f through the one step (or m0) whose running max it is (the
//     first step of the largest value: ties have measure zero); m0, paired
//     with C0 and n0, gets <dC0, C0> + <dn0, n0>.
//   * The denominator: max(|den|, exp(-m_new)) passes sign(den) into den
//     where |den| wins and nothing where exp(-m_new) does.
//   * The entering states C_{c-1}: saving them in the forward costs B H
//     n_chunks dh^2 4 bytes (512 MB at xlstm's B = 2, S = 1024; 256 MB as
//     bf16) held from the forward to the backward, and both forward bodies
//     (the bf16 one keeps C in wgmma accumulators, for serving too) would
//     have to write them.  The backward recomputes them in its own states
//     sweep instead: one more L dh^2 product a chunk (the sweep is about a
//     third of the bf16 backward's time; saving the states would spare it
//     and nothing else), no change to the forward, and the scratch (512 MB
//     for the scalar bodies, 256 MB of bf16 tiles for the tensor-core ones)
//     lives only during the backward call (under remat, one layer at a
//     time).
//
// Six launches over q, k, v and dh read in their dtype (bf16 or float32):
//   1. prep, per (chunk, b * H + h): the gates, S = Q k^T and DV = dh v^T
//      over dh, att, rowsum; into the chunk's record (float32 scratch);
//   2. states, per (b * H + h, 32 columns f of C), serial over the chunks:
//      each chunk's entering C (its columns) and n into the scratch, Q n,
//      and X = dh . (Q C) over its columns (X is the part of dh . num that
//      goes through the state), as the forward's recurrent kernel walks it;
//   3. steps, per (chunk, b * H + h): den, M = max(|den|, exp(-m_new)),
//      dh . num = sum_t att DV + inter X, dden, datt = DV / M + dden, dS =
//      datt o gate (into the record), the gate gradients of att (rows minus
//      columns of datt o att) and of inter (X / M + dden Q n);
//   4. reverse_rows, per (b * H + h, 32 rows e of C), serial over the chunks
//      backwards: the carried dC (its rows) and dn from the final state's
//      gradient; per chunk, rows e of dk = w (dC v + dn) + dS^T Q and dq =
//      scale (inter (C_{c-1} dnum + dden n_{c-1}) + dS k), dnum = dh / M;
//      its share of dw = k . (dC v + dn) and of d inter_L = <dC, C_{c-1}> +
//      <dn, n_{c-1}>; then dC_{c-1} = inter_L dC + sum_s inter_s Q_s^T
//      dnum_s (rows and columns of C are independent); at the end dC0, dn0;
//   5. reverse_cols, per (b * H + h, 32 columns f of C), the same carry by
//      columns: columns f of dv = w (k dC) + att^T dnum (dv reduces over
//      the rows e that launch 4 splits, dk and dq over the columns f);
//   6. gate_grads, per (chunk, b * H + h): the shares summed in order, log
//      f's gradient as the reverse cumsum within the chunk of b's, and the
//      m terms (each block chains the chunks' summaries for m_fin's step).
// Deterministic: no atomics, every sum in a fixed order; two calls give the
// same bits.
// A tensor-parallel rank holds Dv of every head's value columns (v, dh,
// dv, C's columns) with q and k whole (D): the states and column sweeps
// then have Dv / 32 blocks a head, the row sweep still D / 32, each over
// Dv columns; the rank's dq, dk and gate gradients are its share of the
// sum over the ranks' columns.  Dv = D is the unsplit call, unchanged.
//
// bfloat16 (the training dtype): launches 1, 2, 4 and 5 on the tensor cores
// (wgmma, sm90.cuh), bf16 operands and float32 accumulators, on the
// forward's machinery (csrc/mlstm.cu recurrent_tc and scores_tc):
//   * prep_tc: Q k^T and dh v^T as scores_tc's q k^T (M = s, N = t, K = e),
//     q, k, dh and v streamed in 64-column tiles through a cp.async ring;
//   * states_tc: the forward's walk, a block's (dh, 32) slice of C in
//     wgmma accumulators over four warpgroups of four 64-row e-tiles, each
//     warpgroup streaming its q and k tiles through its own 2-slot ring:
//     Q C (M = t, N = f, K = e) from the C^T tile (a bf16 pair), then C =
//     decay C + (k o w)^T v.  The tile's entering C goes to the scratch
//     already as bf16 (its hi half) in the swizzled K-major tiles (32 rows
//     e x 64 columns f) that rows_tc loads by cp.async;
//   * rows_tc: carries dC^T for the block's 32 rows e (M = f over all dh,
//     N = 32, the same accumulator layout); per f-tile, with v, dh and
//     C_{c-1}'s tile streamed through the warpgroup's ring: U = dC v_t (M =
//     t, N = e, K = f; dC as a bf16 tile from the accumulators), Y = dh
//     C_{c-1}^T (M = s, N = e, K = f; dq's C_{c-1} dnum is Y / M, so dh goes
//     in as it is and 1 / M scales the rows after), the share of <dC,
//     C_{c-1}>, then dC^T = decay dC^T + dh^T (inter / M o Q) (M = f, N =
//     e, K = s; dh's tile M-major through the transpose bit).  Per chunk
//     the warpgroups' partials are summed in order; dS^T Q and dS k (M = t
//     or s, N = 32, K = s or t) take dS as register A fragments;
//   * cols_tc: carries dC (M = e, N = f) as the forward carries C; per
//     e-tile k dC (M = t, N = f, K = e; dC^T's tile a bf16 pair), then dC
//     = decay dC + Q^T (scale
//     inter / M o dh) (M = e, N = f, K = s, q's tile M-major); per chunk dv
//     = w (k dC) + (att / M)^T dh, att / M as register A fragments;
//   * steps and gate_grads stay scalar (under 3% of the time).
// Precision: q, k, v and dh are bf16 already, so Q k^T, dh v^T and every
// product with them as both operands are exact up to the float32 sums.
// Of the float32 operands, two go in as hi + lo bf16 pairs (hi = x
// rounded, lo = x - hi rounded, a wgmma each, ~16 significant bits), as the
// forward's C: C for Q C (X = dh . (Q C) feeds dden = -(dh . num) / M^2
// through the cancelling denominator, as C feeds the forward's h) and dC
// for k dC (dv's k dC sums 1024 rows of a gradient that grows over the
// chunks).  The rest (k o w, the stored C_{c-1}, dC for dC v, the update's
// inter / M o Q or o dh, dS, att / M) go in rounded once.  At xlstm's
// training length (dh = 1024, 16 chunks of 64) the CPU mirror (ref.py
// mlstm_bwd_tiled, BWD_ROUNDING) puts one rounding of C past the 2e-2 gate
// on a seed (1.28 of it) and one of the column sweep's dC on another
// (1.05), while with these two pairs every gradient stays within a quarter
// of it over 40 seeds (tests/test_torch_mlstm_bwd.py).
// float32: the scalar bodies (prep, states, reverse_rows, reverse_cols:
// scalar FMAs from shared memory), for the float32 parity paths only:
// their gate (2e-4) rules out bf16 operands and TF32.
//
// What bounds it on this card: at xlstm-1.3b's training shape (B = 2, S =
// 1024, H = 4, dh = 1024, L = 64) about 91 GFLOP in five L dh^2 products a
// chunk (~0.09 ms at 989 TFLOP/s of bf16 tensor cores), while the
// recomputed entering states are 256 MB written and read (~0.15 ms at 3.35
// TB/s).  What holds the sweeps back, as in the forward, is each tile's
// chain of cp.async waits, barriers and small (N = 32) wgmma groups, and
// the column (or row) split, which has every block of a head read every
// tile of q, k, v and dh: 32 blocks a head, from L2.  Sweeps: 256 blocks
// of 512 threads (B H dh / 32), one an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_tile.cuh"
#include "mlstm_gates.cuh"
#include "sm90.cuh"
#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using kv_tile::store;
using kv_tile::to_float;
using mlstm_gates::chunk_gates;
using mlstm_gates::gate;
using mlstm_gates::GateSmem;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = mlstm_gates::kMaxL;  // longest chunk (64)
constexpr int kCols = 32;                  // rows or columns of C a sweep block owns; tile width
constexpr int kLd = kCols + 1;             // padded tile rows
constexpr int kRows = kMaxL / kWarps;      // chunk rows a warp holds (8)
constexpr float kNeg = mlstm_gates::kNeg;

// The backward's per-chunk record: L floats each of m_new, inter, w,
// rowsum(att), Q n, 1 / M, dden and the gate gradients of b and log i
// (zeros past the chunk), then att, gate (dS after launch 3) and DV = dh
// v^T, [L][L] each.
enum { kMn, kIt, kW, kRow, kQn, kInvM, kDden, kDb, kDgi, kVecs };
__host__ __device__ inline size_t brec_floats(int L) {
  return ((size_t)kVecs * L + 3 * (size_t)L * L + 3) & ~(size_t)3;
}

// The float32 scratch, carved in this order (ops.py bwd_plan mirrors it):
// the records (B H, n_chunks); the entering C (B H, n_chunks, cst_floats:
// float32 (D, Dv) for the scalar bodies, bf16 tiles for the tensor-core
// ones, cst_tc_floats) and n (B H, n_chunks, D); X's shares, one a column
// block (B H, n_chunks, Dv / 32, L); dw's, one a row block (B H, n_chunks,
// D / 32, L), and d inter_L's (B H, n_chunks, D / 32); the row blocks'
// shares of <dC_fin, C_fin> + <dn_fin, n_fin> and <dC0, C0> + <dn0, n0> (B
// H, D / 32 each).
struct Scratch {
  float *rec, *Cst, *nst, *Xp, *pdw, *pdi, *pfin, *p0;
};

// Floats a chunk's entering C takes in the tensor-core bodies' layout: bf16
// tiles of 32 rows e x 64 columns f (128-byte rows, swizzled as sm90.cuh
// describes), [D / 32][ceil(Dv / 64)] of them, the columns past Dv zeros.
__host__ __device__ inline size_t cst_tc_floats(int D, int Dv) {
  return (size_t)(D / kCols) * ((Dv + 63) / 64) * 32 * 64 / 2;
}

__host__ inline Scratch carve(float* base, int BH, int nc, int D, int Dv, int L, size_t cst) {
  const size_t nck = D / kCols, ncv = Dv / kCols, n = (size_t)BH * nc;
  Scratch s;
  s.rec = base;
  s.Cst = s.rec + n * brec_floats(L);
  s.nst = s.Cst + n * cst;
  s.Xp = s.nst + n * D;
  s.pdw = s.Xp + n * ncv * L;
  s.pdi = s.pdw + n * nck * L;
  s.pfin = s.pdi + n * nck;
  s.p0 = s.pfin + (size_t)BH * nck;
  return s;
}

__host__ inline size_t scratch_floats(int BH, int nc, int D, int Dv, int L, size_t cst) {
  const size_t nck = D / kCols, ncv = Dv / kCols, n = (size_t)BH * nc;
  return n * (brec_floats(L) + cst + D + ncv * L + nck * L + nck) + 2 * (size_t)BH * nck;
}

// The block's sum of v over NT threads, in a fixed order (lanes, then the
// warps' sums), on thread 0.  Every thread calls it.
template <int NT = kThreads>
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// ---------------------------------------------------------------------------
// 1. prep: one block per (chunk, b * H + h); thread (ty, tx) = (tid / 16,
// tid % 16) holds S and DV at rows s = ty + 16 i, columns t = tx + 16 j.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) prep(const T* __restrict__ q, const T* __restrict__ k,
                                                 const T* __restrict__ v, const T* __restrict__ dh,
                                                 const float* __restrict__ log_i,
                                                 const float* __restrict__ log_f,
                                                 const float* __restrict__ m0,
                                                 float* __restrict__ recs, int S, int H, int D,
                                                 int Dv, int L, float scale) {
  __shared__ float qs[kMaxL][kLd], ks[kMaxL][kLd], ds[kMaxL][kLd], vs[kMaxL][kLd];
  __shared__ GateSmem<kThreads> g;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int nc = gridDim.x, t0 = c * L, Lc = min(L, S - t0);
  const int ty = tid / 16, tx = tid % 16;
  const size_t rs = (size_t)H * D, base = ((size_t)b * S + t0) * rs + (size_t)h * D;
  const size_t rsv = (size_t)H * Dv, vbase = ((size_t)b * S + t0) * rsv + (size_t)h * Dv;
  chunk_gates<kThreads>(log_i, log_f, m0, b, h, H, S, L, c, g);
  float sc[4][4] = {}, dv[4][4] = {};
  for (int e0 = 0; e0 < max(D, Dv); e0 += kCols) {  // Q k^T over D, dh v^T over Dv
    __syncthreads();  // the last tile is consumed
    for (int i = tid; i < kMaxL * kCols; i += kThreads) {
      const int t = i / kCols, e = i - t * kCols;
      const bool ink = t < Lc && e0 < D, inv = t < Lc && e0 < Dv;
      const size_t o = base + t * rs + e0 + e, ov = vbase + t * rsv + e0 + e;
      qs[t][e] = ink ? to_float(q[o]) * scale : 0.f;
      ks[t][e] = ink ? to_float(k[o]) : 0.f;
      ds[t][e] = inv ? to_float(dh[ov]) : 0.f;
      vs[t][e] = inv ? to_float(v[ov]) : 0.f;
    }
    __syncthreads();
    for (int e = 0; e < kCols; ++e) {
      float a[4], d[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[ty + 16 * i][e];
        d[i] = ds[ty + 16 * i][e];
        kk[i] = ks[tx + 16 * i][e];
        vv[i] = vs[tx + 16 * i][e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
          dv[i][j] = fmaf(d[i], vv[j], dv[i][j]);
        }
    }
  }
  float* rec = recs + ((size_t)bh * nc + c) * brec_floats(L);
  float* att = rec + kVecs * L;
  float* gt = att + L * L;
  float* DV = gt + L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = ty + 16 * i;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tx + 16 * j;
      const bool in = t <= s && s < Lc;
      const float gv = in ? gate(g, s, t) : 0.f;
      const float a = gv * sc[i][j];
      rsum += a;
      if (s < L && t < L) {
        att[s * L + t] = a;
        gt[s * L + t] = gv;
        DV[s * L + t] = in ? dv[i][j] : 0.f;
      }
    }
    // the 16 threads of a row are one half-warp
    for (int off = 8; off; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    if (tx == 0 && s < L) rec[kRow * L + s] = rsum;
  }
  for (int t = tid; t < L; t += kThreads) {
    const bool in = t < Lc;
    rec[kMn * L + t] = in ? g.mn[t] : 0.f;
    rec[kIt * L + t] = in ? g.it[t] : 0.f;
    rec[kW * L + t] = g.w[t];
  }
}

// ---------------------------------------------------------------------------
// 2. states: one block per (b * H + h, columns f0 .. f0 + 31 of C); a thread
// holds Q C at rows s = warp + 8 i, column lane.
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t states_smem_floats(int D, int L) {
  return (size_t)D * kCols + D + 4 * (size_t)L * kCols + 2 * (size_t)L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) states(const T* __restrict__ q,
                                                   const T* __restrict__ k,
                                                   const T* __restrict__ v,
                                                   const T* __restrict__ dh,
                                                   const float* __restrict__ C0,
                                                   const float* __restrict__ n0, Scratch sc,
                                                   int S, int H, int D, int Dv, int L,
                                                   float scale) {
  extern __shared__ float smem[];
  float* Cs = smem;            // [D][32] the carried columns of C
  float* ns = Cs + D * kCols;  // [D] the carried n (every block carries all of it)
  float* qt = ns + D;          // [L][32] Q, one e-tile
  float* kt = qt + L * kCols;  // [L][32] k o w, one e-tile
  float* vt = kt + L * kCols;  // [L][32] this block's columns of v
  float* dt = vt + L * kCols;  // [L][32] and of dh
  float* it = dt + L * kCols;  // [L] inter
  float* wv = it + L;          // [L] w
  const int bh = blockIdx.x, b = bh / H, h = bh % H, fb = blockIdx.y, f0 = fb * kCols;
  const int ncb = gridDim.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (S + L - 1) / L;
  const size_t cbase = (size_t)bh * D * Dv, rs = (size_t)H * D, rsv = (size_t)H * Dv;
  for (int i = tid; i < D * kCols; i += kThreads) {
    const int e = i / kCols, f = i - e * kCols;
    Cs[i] = C0 ? C0[cbase + (size_t)e * Dv + f0 + f] : 0.f;
  }
  for (int e = tid; e < D; e += kThreads) ns[e] = n0 ? n0[(size_t)bh * D + e] : 0.f;
  int rows[kRows];  // this warp's chunk rows, clamped into the tiles
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t base = ((size_t)b * S + t0) * rs + (size_t)h * D;
    const size_t vbase = ((size_t)b * S + t0) * rsv + (size_t)h * Dv;
    const size_t pc = (size_t)bh * nc + c;
    float* rec = sc.rec + pc * brec_floats(L);
    float* Cst = sc.Cst + pc * D * Dv;
    __syncthreads();  // the previous chunk is done with shared memory
    for (int t = tid; t < L; t += kThreads) {
      it[t] = rec[kIt * L + t];
      wv[t] = rec[kW * L + t];
    }
    for (int i = tid; i < L * kCols; i += kThreads) {
      const int t = i / kCols, f = i - t * kCols;
      const bool in = t < Lc;
      const size_t o = vbase + t * rsv + f0 + f;
      vt[i] = in ? to_float(v[o]) : 0.f;
      dt[i] = in ? to_float(dh[o]) : 0.f;
    }
    __syncthreads();
    const float decay = it[Lc - 1];
#pragma unroll
    for (int i = 0; i < kRows; ++i) rows[i] = min(warp + kWarps * i, L - 1);
    float qc[kRows] = {}, qn[kRows] = {};
    for (int e0 = 0; e0 < D; e0 += kCols) {
      for (int i = tid; i < L * kCols; i += kThreads) {
        const int t = i / kCols, e = i - t * kCols;
        const bool in = t < Lc;
        const size_t o = base + t * rs + e0 + e;
        qt[i] = in ? to_float(q[o]) * scale : 0.f;
        kt[i] = in ? to_float(k[o]) * wv[t] : 0.f;
      }
      __syncthreads();
      // Q C and Q n from the state before this chunk, whose tile goes to the
      // scratch
      for (int e = 0; e < kCols; ++e) {
        const float cv = Cs[(e0 + e) * kCols + lane];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qc[i] = fmaf(qt[rows[i] * kCols + e], cv, qc[i]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) qn[i] = fmaf(qt[rows[i] * kCols + lane], ns[e0 + lane], qn[i]);
      for (int i = tid; i < kCols * kCols; i += kThreads) {
        const int e = i / kCols, f = i - e * kCols;
        Cst[(size_t)(e0 + e) * Dv + f0 + f] = Cs[(e0 + e) * kCols + f];
      }
      if (fb == 0 && tid < kCols) sc.nst[pc * D + e0 + tid] = ns[e0 + tid];
      __syncthreads();  // every read of the old tile is done
      {                 // the tile moves: rows e0 + 4 warp .. + 3, column lane
        const int e = 4 * warp;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int t = 0; t < Lc; ++t) {
          const float x = vt[t * kCols + lane];
          const float* kr = kt + t * kCols + e;
          a0 = fmaf(kr[0], x, a0);
          a1 = fmaf(kr[1], x, a1);
          a2 = fmaf(kr[2], x, a2);
          a3 = fmaf(kr[3], x, a3);
        }
        float* cr = Cs + (e0 + e) * kCols + lane;
        cr[0] = fmaf(decay, cr[0], a0);
        cr[kCols] = fmaf(decay, cr[kCols], a1);
        cr[2 * kCols] = fmaf(decay, cr[2 * kCols], a2);
        cr[3 * kCols] = fmaf(decay, cr[3 * kCols], a3);
        if (lane < 4) {
          float a = 0.f;
          for (int t = 0; t < Lc; ++t) a += kt[t * kCols + e + lane];
          ns[e0 + e + lane] = fmaf(decay, ns[e0 + e + lane], a);
        }
      }
      __syncthreads();  // the next tile overwrites qt and kt
    }
    // X's share over these columns, and Q n (block 0)
    float* xp = sc.Xp + pc * ncb * L + (size_t)fb * L;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = warp + kWarps * i;  // warp-uniform
      float x = dt[rows[i] * kCols + lane] * qc[i];
      float n = qn[i];
      for (int off = 16; off; off >>= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
        n += __shfl_xor_sync(0xffffffffu, n, off);
      }
      if (lane == 0 && s < Lc) {
        xp[s] = x;
        if (fb == 0) rec[kQn * L + s] = n;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. steps: one block per (chunk, b * H + h).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) steps(Scratch sc, int S, int L, int ncb) {
  __shared__ float R[kMaxL][kMaxL + 1];
  __shared__ float invM[kMaxL], dden[kMaxL], dint[kMaxL];
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x, tid = threadIdx.x;
  const int Lc = min(L, S - c * L);
  const size_t pc = (size_t)bh * nc + c;
  float* rec = sc.rec + pc * brec_floats(L);
  const float* att = rec + kVecs * L;
  float* gt = rec + kVecs * L + L * L;
  const float* DV = gt + L * L;
  if (tid < L) {
    const int s = tid;
    float im = 0.f, dd = 0.f, di = 0.f;
    if (s < Lc) {
      float X = 0.f;  // dh . (Q C), its shares in column order
      for (int fb = 0; fb < ncb; ++fb) X += sc.Xp[(pc * ncb + fb) * L + s];
      const float is = rec[kIt * L + s], qn = rec[kQn * L + s];
      const float den = fmaf(is, qn, rec[kRow * L + s]);
      const float fl = expf(-rec[kMn * L + s]);
      const float M = fmaxf(fabsf(den), fl);
      float hn = 0.f;  // dh . num
      for (int t = 0; t <= s; ++t) hn = fmaf(att[s * L + t], DV[s * L + t], hn);
      hn = fmaf(is, X, hn);
      im = 1.f / M;
      // d max(|den|, exp(-m_new)): sign(den) into den where |den| wins
      if (fabsf(den) > fl) dd = (den > 0.f ? -hn : hn) * im * im;
      di = fmaf(dd, qn, X * im);
    }
    invM[s] = im;
    dden[s] = dd;
    dint[s] = di;
    rec[kInvM * L + s] = im;
    rec[kDden * L + s] = dd;
  }
  __syncthreads();
  for (int i = tid; i < L * L; i += kThreads) {
    const int s = i / L, t = i - s * L;
    const float da = (t <= s && s < Lc) ? fmaf(DV[i], invM[s], dden[s]) : 0.f;
    R[s][t] = da * att[i];
    gt[i] *= da;  // dS = datt o gate
  }
  __syncthreads();
  if (tid < L) {
    const int s = tid;
    float rr = 0.f, cr = 0.f;
    for (int t = 0; t < L; ++t) {
      rr += R[s][t];
      cr += R[t][s];
    }
    rec[kDb * L + s] = s < Lc ? fmaf(dint[s], rec[kIt * L + s], rr - cr) : 0.f;
    rec[kDgi * L + s] = s < Lc ? cr : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 4. reverse_rows: one block per (b * H + h, rows e0 .. e0 + 31 of C); a
// thread holds dC v and C dnum at rows t (s) = warp + 8 i, row e = lane.
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t rows_smem_floats(int Dv, int L) {
  return (size_t)kCols * (Dv + 1) + 2 * kCols + 2 * (size_t)L * kCols + (size_t)L * L + 4 * L +
         2 * (size_t)L * kLd + kCols * kLd + kWarps;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) reverse_rows(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dh, const float* __restrict__ C0, const float* __restrict__ n0,
    const float* __restrict__ C_fin, const float* __restrict__ n_fin,
    const float* __restrict__ dC_fin, const float* __restrict__ dn_fin, T* __restrict__ dq,
    T* __restrict__ dk, float* __restrict__ dC0, float* __restrict__ dn0, Scratch sc, int S,
    int H, int D, int Dv, int L, float scale) {
  extern __shared__ float smem[];
  const int ldc = Dv + 1;  // padded rows: the 32 lanes read 32 rows at once
  float* dCs = smem;                  // [32][Dv + 1] rows e0.. of the carried dC
  float* dns = dCs + kCols * ldc;     // [32] and of dn
  float* np = dns + kCols;            // [32] n before the chunk, these rows
  float* Qe = np + kCols;             // [L][32] columns e0.. of Q
  float* ke = Qe + L * kCols;         // [L][32] and of k
  float* dS = ke + L * kCols;         // [L][L]
  float* it = dS + L * L;             // [L] inter
  float* wv = it + L;                 // [L] w
  float* im = wv + L;                 // [L] 1 / M
  float* dd = im + L;                 // [L] dden
  float* vt = dd + L;                 // [L][33] v, one f-tile
  float* dnt = vt + L * kLd;          // [L][33] dnum = dh / M, one f-tile
  float* Ct = dnt + L * kLd;          // [32][33] C before the chunk: these rows, one f-tile
  float* red = Ct + kCols * kLd;      // [8]
  const int bh = blockIdx.x, b = bh / H, h = bh % H, eb = blockIdx.y, e0 = eb * kCols;
  const int ncb = gridDim.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (S + L - 1) / L;
  const size_t rbase = (size_t)bh * D * Dv + (size_t)e0 * Dv;  // row e0 of (b, h)'s matrices
  const size_t rs = (size_t)H * D, rsv = (size_t)H * Dv;
  float pf = 0.f;  // this thread's share of <dC_fin, C_fin> + <dn_fin, n_fin>
  for (int i = tid; i < kCols * Dv; i += kThreads) {
    const int e = i / Dv, f = i - e * Dv;
    const float g = dC_fin ? dC_fin[rbase + i] : 0.f;
    dCs[e * ldc + f] = g;
    if (dC_fin) pf = fmaf(g, C_fin[rbase + i], pf);
  }
  if (tid < kCols) {
    const float g = dn_fin ? dn_fin[(size_t)bh * D + e0 + tid] : 0.f;
    dns[tid] = g;
    if (dn_fin) pf = fmaf(g, n_fin[(size_t)bh * D + e0 + tid], pf);
  }
  pf = block_sum(pf, red);
  if (tid == 0) sc.pfin[(size_t)bh * ncb + eb] = pf;
  int rows[kRows];
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t base = ((size_t)b * S + t0) * rs + (size_t)h * D;
    const size_t vbase = ((size_t)b * S + t0) * rsv + (size_t)h * Dv;
    const size_t pc = (size_t)bh * nc + c;
    const float* rec = sc.rec + pc * brec_floats(L);
    const float* Cprev = sc.Cst + pc * D * Dv + (size_t)e0 * Dv;
    __syncthreads();  // the previous chunk is done with shared memory
    for (int t = tid; t < L; t += kThreads) {
      it[t] = rec[kIt * L + t];
      wv[t] = rec[kW * L + t];
      im[t] = rec[kInvM * L + t];
      dd[t] = rec[kDden * L + t];
    }
    for (int i = tid; i < L * L; i += kThreads) dS[i] = rec[kVecs * L + L * L + i];
    for (int i = tid; i < L * kCols; i += kThreads) {
      const int t = i / kCols, e = i - t * kCols;
      const bool in = t < Lc;
      const size_t o = base + t * rs + e0 + e;
      Qe[i] = in ? to_float(q[o]) * scale : 0.f;
      ke[i] = in ? to_float(k[o]) : 0.f;
    }
    if (tid < kCols) np[tid] = sc.nst[pc * D + e0 + tid];
    __syncthreads();
    const float decay = it[Lc - 1];
#pragma unroll
    for (int i = 0; i < kRows; ++i) rows[i] = min(warp + kWarps * i, L - 1);
    float U[kRows] = {}, Y[kRows] = {};
    float pd = 0.f;  // this thread's share of <dC, C_{c-1}>
    for (int f0 = 0; f0 < Dv; f0 += kCols) {
      for (int i = tid; i < L * kCols; i += kThreads) {
        const int t = i / kCols, f = i - t * kCols;
        const bool in = t < Lc;
        const size_t o = vbase + t * rsv + f0 + f;
        vt[t * kLd + f] = in ? to_float(v[o]) : 0.f;
        dnt[t * kLd + f] = in ? to_float(dh[o]) * im[t] : 0.f;
      }
      for (int i = tid; i < kCols * kCols; i += kThreads) {
        const int e = i / kCols, f = i - e * kCols;
        Ct[e * kLd + f] = Cprev[(size_t)e * Dv + f0 + f];
      }
      __syncthreads();
      for (int f = 0; f < kCols; ++f) {
        const float g = dCs[lane * ldc + f0 + f], cv = Ct[lane * kLd + f];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          U[i] = fmaf(g, vt[rows[i] * kLd + f], U[i]);
          Y[i] = fmaf(cv, dnt[rows[i] * kLd + f], Y[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = 4 * warp + j;
        pd = fmaf(dCs[lane * ldc + f0 + f], Ct[lane * kLd + f], pd);
      }
      __syncthreads();  // every read of dC's tile is done
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // dC_{c-1} = inter_L dC + sum_s inter_s Q_s^T dnum_s
        const int f = 4 * warp + j;
        float a = 0.f;
        for (int s = 0; s < Lc; ++s) a = fmaf(it[s] * Qe[s * kCols + lane], dnt[s * kLd + f], a);
        float* g = dCs + lane * ldc + f0 + f;
        *g = fmaf(decay, *g, a);
      }
      __syncthreads();  // the next tile overwrites vt, dnt and Ct
    }
    // dk and dq at these rows; dw's share
    float* pdw = sc.pdw + (pc * ncb + eb) * L;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = warp + kWarps * i;  // warp-uniform
      if (t >= Lc) continue;
      const float u = U[i] + dns[lane];  // dC v_t + dn, row lane
      float kv = ke[t * kCols + lane] * u;
      for (int off = 16; off; off >>= 1) kv += __shfl_xor_sync(0xffffffffu, kv, off);
      if (lane == 0) pdw[t] = kv;
      float a = wv[t] * u;
      for (int s = t; s < Lc; ++s) a = fmaf(dS[s * L + t], Qe[s * kCols + lane], a);
      store(dk + base + (size_t)t * rs + e0 + lane, a);
      float b2 = it[t] * fmaf(dd[t], np[lane], Y[i]);
      for (int u2 = 0; u2 <= t; ++u2) b2 = fmaf(dS[t * L + u2], ke[u2 * kCols + lane], b2);
      store(dq + base + (size_t)t * rs + e0 + lane, scale * b2);
    }
    if (warp == 0) pd = fmaf(dns[lane], np[lane], pd);
    pd = block_sum(pd, red);
    if (tid == 0) sc.pdi[pc * ncb + eb] = pd;
    if (tid < kCols) {  // dn_{c-1} = inter_L dn + sum_s inter_s dden_s Q_s
      float a = 0.f;
      for (int s = 0; s < Lc; ++s) a = fmaf(it[s] * dd[s], Qe[s * kCols + tid], a);
      dns[tid] = fmaf(decay, dns[tid], a);
    }
  }
  __syncthreads();
  float p0 = 0.f;  // this thread's share of <dC0, C0> + <dn0, n0>
  for (int i = tid; i < kCols * Dv; i += kThreads) {
    const int e = i / Dv, f = i - e * Dv;
    const float g = dCs[e * ldc + f];
    if (dC0) dC0[rbase + i] = g;
    if (C0) p0 = fmaf(g, C0[rbase + i], p0);
  }
  if (tid < kCols) {
    if (dn0) dn0[(size_t)bh * D + e0 + tid] = dns[tid];
    if (n0) p0 = fmaf(dns[tid], n0[(size_t)bh * D + e0 + tid], p0);
  }
  p0 = block_sum(p0, red);
  if (tid == 0) sc.p0[(size_t)bh * ncb + eb] = p0;
}

// ---------------------------------------------------------------------------
// 5. reverse_cols: one block per (b * H + h, columns f0 .. f0 + 31 of C); a
// thread holds k dC at rows t = warp + 8 i, column f = lane.
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t cols_smem_floats(int D, int L) {
  return (size_t)D * kCols + (size_t)L * L + 3 * (size_t)L * kCols + 3 * (size_t)L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) reverse_cols(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ dh,
    const float* __restrict__ dC_fin, T* __restrict__ dv, Scratch sc, int S, int H, int D,
    int Dv, int L, float scale) {
  extern __shared__ float smem[];
  float* dCs = smem;            // [D][32] columns f0.. of the carried dC
  float* att = dCs + D * kCols; // [L][L]
  float* dnt = att + L * L;     // [L][32] dnum = dh / M, these columns
  float* qt = dnt + L * kCols;  // [L][32] Q, one e-tile
  float* kt = qt + L * kCols;   // [L][32] k, one e-tile
  float* it = kt + L * kCols;   // [L] inter
  float* wv = it + L;           // [L] w
  float* im = wv + L;           // [L] 1 / M
  const int bh = blockIdx.x, b = bh / H, h = bh % H, f0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (S + L - 1) / L;
  const size_t cbase = (size_t)bh * D * Dv, rs = (size_t)H * D, rsv = (size_t)H * Dv;
  for (int i = tid; i < D * kCols; i += kThreads) {
    const int e = i / kCols, f = i - e * kCols;
    dCs[i] = dC_fin ? dC_fin[cbase + (size_t)e * Dv + f0 + f] : 0.f;
  }
  int rows[kRows];
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t base = ((size_t)b * S + t0) * rs + (size_t)h * D;
    const size_t vbase = ((size_t)b * S + t0) * rsv + (size_t)h * Dv;
    const float* rec = sc.rec + ((size_t)bh * nc + c) * brec_floats(L);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int t = tid; t < L; t += kThreads) {
      it[t] = rec[kIt * L + t];
      wv[t] = rec[kW * L + t];
      im[t] = rec[kInvM * L + t];
    }
    for (int i = tid; i < L * L; i += kThreads) att[i] = rec[kVecs * L + i];
    __syncthreads();
    for (int i = tid; i < L * kCols; i += kThreads) {
      const int t = i / kCols, f = i - t * kCols;
      dnt[i] = t < Lc ? to_float(dh[vbase + t * rsv + f0 + f]) * im[t] : 0.f;
    }
    const float decay = it[Lc - 1];
#pragma unroll
    for (int i = 0; i < kRows; ++i) rows[i] = min(warp + kWarps * i, L - 1);
    float Vk[kRows] = {};
    for (int e0 = 0; e0 < D; e0 += kCols) {
      for (int i = tid; i < L * kCols; i += kThreads) {
        const int t = i / kCols, e = i - t * kCols;
        const bool in = t < Lc;
        const size_t o = base + t * rs + e0 + e;
        qt[i] = in ? to_float(q[o]) * scale : 0.f;
        kt[i] = in ? to_float(k[o]) : 0.f;
      }
      __syncthreads();
      for (int e = 0; e < kCols; ++e) {
        const float g = dCs[(e0 + e) * kCols + lane];
#pragma unroll
        for (int i = 0; i < kRows; ++i) Vk[i] = fmaf(kt[rows[i] * kCols + e], g, Vk[i]);
      }
      __syncthreads();  // every read of dC's tile is done
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // dC_{c-1} = inter_L dC + sum_s inter_s Q_s^T dnum_s
        const int e = 4 * warp + j;
        float a = 0.f;
        for (int s = 0; s < Lc; ++s) a = fmaf(it[s] * qt[s * kCols + e], dnt[s * kCols + lane], a);
        float* g = dCs + (e0 + e) * kCols + lane;
        *g = fmaf(decay, *g, a);
      }
      __syncthreads();  // the next tile overwrites qt and kt
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = warp + kWarps * i;
      if (t >= Lc) continue;
      float a = wv[t] * Vk[i];
      for (int s = t; s < Lc; ++s) a = fmaf(att[s * L + t], dnt[s * kCols + lane], a);
      store(dv + vbase + (size_t)t * rsv + f0 + lane, a);
    }
  }
}

// ---------------------------------------------------------------------------
// 6. gate_grads: one block of kMaxL threads per (chunk, b * H + h), a step a
// thread (the chunks' gate gradients are independent given g_m and its step).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxL) gate_grads(
    const float* __restrict__ log_i, const float* __restrict__ log_f,
    const float* __restrict__ m0, const float* __restrict__ dm_fin, float* __restrict__ dlog_i,
    float* __restrict__ dlog_f, float* __restrict__ dm0, Scratch sc, int S, int H, int L,
    int ncb) {
  __shared__ float rw[kMaxL], db[kMaxL], cum_s[kMaxL], run_s[kMaxL];
  __shared__ int arg_s[kMaxL];
  __shared__ float gm_s;
  __shared__ int win_s;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int nc = gridDim.x;
  auto at = [&](int s) { return ((size_t)b * S + s) * H + h; };
  // the step (-1: m0) whose running max m_fin is: each chunk's cumsum of
  // log f and first argmax of log i - cumsum, kMaxL chunks at a time, one
  // thread each, chained on thread 0 (m <- b_last + max(m, run_last), as
  // chunk_gates)
  float m = m0 ? m0[bh] : kNeg;
  int win = -1;
  for (int c0 = 0; c0 < nc; c0 += kMaxL) {
    if (c0 + tid < nc) {
      const int t0 = (c0 + tid) * L, Lc = min(L, S - t0);
      float cum = 0.f, run = kNeg;
      int arg = 0;
      for (int t = 0; t < Lc; ++t) {
        cum += log_f[at(t0 + t)];
        const float x = log_i[at(t0 + t)] - cum;
        if (x > run) {
          run = x;
          arg = t;
        }
      }
      cum_s[tid] = cum;
      run_s[tid] = run;
      arg_s[tid] = arg;
    }
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < min(kMaxL, nc - c0); ++i) {
        if (run_s[i] > m) win = (c0 + i) * L + arg_s[i];
        m = cum_s[i] + fmaxf(m, run_s[i]);
      }
    __syncthreads();
  }
  if (tid == 0) {  // m_fin's own gradient g_m
    float g = dm_fin ? dm_fin[bh] : 0.f;
    for (int fb = 0; fb < ncb; ++fb) g -= sc.pfin[(size_t)bh * ncb + fb];
    gm_s = g;
    win_s = win;
    if (dm0 && c == 0) {
      float p = 0.f;
      for (int fb = 0; fb < ncb; ++fb) p += sc.p0[(size_t)bh * ncb + fb];
      dm0[bh] = p + (win < 0 ? g : 0.f);
    }
  }
  __syncthreads();
  const float g = gm_s;
  win = win_s;
  const int t0 = c * L, Lc = min(L, S - t0);
  const size_t pc = (size_t)bh * nc + c;
  const float* rec = sc.rec + pc * brec_floats(L);
  if (tid < Lc) {
    float dw = 0.f;
    for (int fb = 0; fb < ncb; ++fb) dw += sc.pdw[(pc * ncb + fb) * L + tid];
    const float r = dw * rec[kW * L + tid];
    rw[tid] = r;
    db[tid] = rec[kDb * L + tid] - r;
    dlog_i[at(t0 + tid)] = rec[kDgi * L + tid] + r + (t0 + tid == win ? g : 0.f);
  }
  __syncthreads();
  if (tid == 0) {  // into b_last: d inter_L inter_L + sum_t dw_t w_t; then the cumsum
    float di = 0.f;
    for (int fb = 0; fb < ncb; ++fb) di += sc.pdi[pc * ncb + fb];
    float last = di * rec[kIt * L + Lc - 1];
    for (int t = 0; t < Lc; ++t) last += rw[t];
    float acc = last;
    for (int s = Lc - 1; s >= 0; --s) {
      acc += db[s];
      dlog_f[at(t0 + s)] = acc + (t0 + s > win ? g : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core bodies
// ---------------------------------------------------------------------------
// A tile of q, k, v or dh (tc_tile::kTile): 64 steps x 64 columns of bf16
// in the 128-byte-swizzled layout (sm90.cuh), step t's row at t * 128; rows
// past the chunk and columns past dh zero-filled.  A [32][64] tile (an
// operand transposed, or a stored entering state) is the same with 32 rows.
using tc_tile::acc_col;
using tc_tile::acc_row;
using tc_tile::aligned_smem;
using tc_tile::kTile;
using tc_tile::load_tile;
using tc_tile::quad_sum;
using tc_tile::split_bf16;
using tc_tile::tile_at;
using tc_tile::wg_bar;
constexpr int kHalf = 32 * 128;
constexpr int kWg = 4;                    // warpgroups of a sweep block
constexpr int kMt = 4;                    // 64-row tiles of C each: dh <= 1024
constexpr int kTc = 128 * kWg;            // a sweep block's threads
constexpr int kPrepStages = 4;            // q/k (then dh/v) tile pairs in prep_tc's ring
constexpr int kPrepSmem = 1024 + kPrepStages * 2 * kTile;

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// wgmma's A fragments for k-step kk (columns 16 kk .. 16 kk + 15) of a
// 64-row bf16 matrix given by value(row, col): the m16n8k16 A layout on
// each warp's 16 rows.
template <typename F>
__device__ __forceinline__ void a_frags(int kk, uint32_t (&a)[4], F value) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = tc_tile::frag_row(x), c = tc_tile::frag_col(kk, x);
    a[x] = pack2(value(r, c), value(r, c + 1));
  }
}

// Writes accumulator pair (i, i + 1) of value (r, c), (r, c + 1) as a
// bf16 pair into tiles hi and lo transposed (rows c, c + 1, column r).
__device__ __forceinline__ void store_pair_t(uint8_t* hi, uint8_t* lo, float x, float y, int r,
                                             int c) {
  uint32_t h, l;
  split_bf16(x, y, h, l);
  const bf16* h2 = reinterpret_cast<const bf16*>(&h);
  const bf16* l2 = reinterpret_cast<const bf16*>(&l);
  *tile_at(hi, c, r) = h2[0];
  *tile_at(hi, c + 1, r) = h2[1];
  *tile_at(lo, c, r) = l2[0];
  *tile_at(lo, c + 1, r) = l2[1];
}

// Offset (bf16 elements) of (e, f) in a chunk's entering C, tensor-core
// layout (cst_tc_floats): tile (e / 32, f / 64), row e % 32, column f % 64.
__device__ __forceinline__ size_t cst_at(int e, int f, int Dv) {
  return ((size_t)(e >> 5) * ((Dv + 63) >> 6) + (f >> 6)) * 2048 +
         (sm90::swizzle128(e & 31, (f & 63) >> 3) >> 1) + (f & 7);
}

// 1. prep_tc: prep's record with S = q k^T and DV = dh v^T on the tensor
// cores (one warpgroup per (chunk, b * H + h), both products exact up to
// their float32 sums: q, k, v and dh are bf16).
__global__ void __launch_bounds__(128) prep_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                               const bf16* __restrict__ v, const bf16* __restrict__ dh,
                                               const float* __restrict__ log_i,
                                               const float* __restrict__ log_f,
                                               const float* __restrict__ m0,
                                               float* __restrict__ recs, int S, int H, int D, int Dv,
                                               int L, float scale) {
  __shared__ GateSmem<128> g;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = sm90::smem_addr(aligned_smem(smem_raw));
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int nc = gridDim.x, t0 = c * L, Lc = min(L, S - t0);
  const size_t rs = (size_t)H * D, base = ((size_t)b * S + t0) * rs + (size_t)h * D;
  const size_t rsv = (size_t)H * Dv, vbase = ((size_t)b * S + t0) * rsv + (size_t)h * Dv;
  chunk_gates<128>(log_i, log_f, m0, b, h, H, S, L, c, g);
  float sc[32], dv[32];
  tc_tile::scores_tc_loop<kPrepStages>(sc, ring, q, k, base, rs, Lc, D);
  tc_tile::scores_tc_loop<kPrepStages>(dv, ring, dh, v, vbase, rsv, Lc, Dv);
  float* rec = recs + ((size_t)bh * nc + c) * brec_floats(L);
  float* att = rec + kVecs * L;
  float* gt = att + L * L;
  float* DV = gt + L * L;
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int s = acc_row(i), t = acc_col(i);
    const bool in = t <= s && s < Lc;
    const float gv = in ? gate(g, s, t) : 0.f;
    const float a = gv * (sc[i] * scale);
    rsum[(i >> 1) & 1] += a;
    if (s < L && t < L) {
      att[s * L + t] = a;
      gt[s * L + t] = gv;
      DV[s * L + t] = in ? dv[i] : 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float x = quad_sum(rsum[e]);
    const int s = acc_row(2 * e);
    if ((tid & 3) == 0 && s < L) rec[kRow * L + s] = x;
  }
  for (int t = tid; t < L; t += 128) {
    const bool in = t < Lc;
    rec[kMn * L + t] = in ? g.mn[t] : 0.f;
    rec[kIt * L + t] = in ? g.it[t] : 0.f;
    rec[kW * L + t] = g.w[t];
  }
}

// Rows [0, 64) of a swizzled tile times w[t] (k -> k o w; rows past `rows`
// zeros), rounded once to bf16 in place, by the 128 threads numbered wt.
__device__ __forceinline__ void scale_rows(uint8_t* tile, const float* w, int rows, int wt) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = wt + p * 128, t = i >> 3, ch = i & 7;
    uint4* at = reinterpret_cast<uint4*>(tile + sm90::swizzle128(t, ch));
    float f[8];
    kv_tile::Pack<bf16>::unpack(*at, f);
    const float s = t < rows ? w[t] : 0.f;
    *at = make_uint4(sm90::pack_bf16(f[0] * s, f[1] * s), sm90::pack_bf16(f[2] * s, f[3] * s),
                     sm90::pack_bf16(f[4] * s, f[5] * s), sm90::pack_bf16(f[6] * s, f[7] * s));
  }
}

// Shared memory of states_tc: byte offsets from a 1024-aligned base (ops.py
// bwd_plan mirrors kBytes).
struct StatesLayout {
  static constexpr int kRing = 0;                          // [kWg][2 slots][q, k tile]
  static constexpr int kVt = kRing + kWg * 2 * 2 * kTile;  // v^T [32 f][64 t]
  static constexpr int kV = kVt + kHalf;                   // [2] v [64 t][32 f] as loaded
  static constexpr int kD = kV + 2 * 64 * kCols * 2;       // [2] dh [64 t][32 f] as loaded
  static constexpr int kCt = kD + 2 * 64 * kCols * 2;      // [kWg][hi, lo] C^T [32 f][64 e]
  static constexpr int kRed = kCt + kWg * 2 * kHalf;       // [kWg - 1][64][32] q C partials
  static constexpr int kQn = kRed + (kWg - 1) * 64 * kCols * 4;  // [kWg][64] q n partials
  static constexpr int kGates = kQn + kWg * 64 * 4;        // [2][4][64] records' gates
  static constexpr int kN = kGates + 2 * 4 * kMaxL * 4;    // [kWg * kMt * 64] n
  static constexpr int kBytes = 1024 + kN + kWg * kMt * 64 * 4;  // + alignment slack
};

// 2. states_tc: the forward's bf16 recurrent walk (csrc/mlstm.cu
// recurrent_tc) per (b * H + h, 32 columns f of C), four warpgroups of four
// 64-row e-tiles of C in wgmma accumulators: per tile, Q C (M = t, N = f,
// K = e) from the C^T tile, the tile's entering C into the scratch (bf16
// tiles that rows_tc loads by cp.async), n's update and Q n in float32,
// then C = decay C + (k o w)^T v.  Per chunk X's share dh . (Q C) over the
// block's columns, and (block 0) Q n and the entering n.
__global__ void __launch_bounds__(kTc, 1) states_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dh, const float* __restrict__ C0, const float* __restrict__ n0,
    Scratch sc, int S, int H, int D, int Dv, int L, float scale) {
  using Lay = StatesLayout;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H, fb = blockIdx.y, f0 = fb * kCols;
  const int ncb = gridDim.y, tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sm_a = sm90::smem_addr(sm);
  uint8_t* vt = sm + Lay::kVt;
  uint8_t* ct = sm + Lay::kCt + wg * 2 * kHalf;
  float* red = reinterpret_cast<float*>(sm + Lay::kRed);
  float* qn_s = reinterpret_cast<float*>(sm + Lay::kQn);
  float* n_part = qn_s + wg * 64;  // during the tiles: the tile's sums for n's update
  float* n_s = reinterpret_cast<float*>(sm + Lay::kN);
  bf16* cst = reinterpret_cast<bf16*>(sc.Cst);

  const int n_et = (D + 63) / 64;
  const int my_tiles = max(0, min(kMt, n_et - wg * kMt));
  const size_t rs = (size_t)H * D, rsv = (size_t)H * Dv;
  const int nc = (S + L - 1) / L;
  const size_t cbase = (size_t)bh * D * Dv;
  const bool pad_half = (Dv & 63) && fb == ncb - 1;  // this block's tiles have 32 columns past Dv

  float C[kMt][16];
#pragma unroll
  for (int j = 0; j < kMt; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = (wg * kMt + j) * 64 + acc_row(i);
      C[j][i] = (C0 && e < D) ? C0[cbase + (size_t)e * Dv + f0 + acc_col(i)] : 0.f;
    }
  for (int e = tid; e < kWg * kMt * 64; e += kTc) n_s[e] = (n0 && e < D) ? n0[(size_t)bh * D + e] : 0.f;

  const uint32_t ring = sm_a + Lay::kRing + wg * 2 * 2 * kTile;
  const int n_units = nc * my_tiles;
  auto load = [&](int u) {
    const int c = u / my_tiles, j = u - c * my_tiles;
    const int e0 = (wg * kMt + j) * 64, t0 = c * L;
    const size_t base = ((size_t)b * S + t0) * rs + (size_t)hh * D + e0;
    const uint32_t qs = ring + (u & 1) * 2 * kTile;
    load_tile(qs, q, base, rs, min(L, S - t0), D - e0, wt);
    load_tile(qs + kTile, k, base, rs, min(L, S - t0), D - e0, wt);
  };
  if (n_units > 0) load(0);
  sm90::cp_async_commit();
  int u = 0;
  // chunk c's gates and the block's columns of v and dh into buffer c % 2
  auto load_gates_vd = [&](int c) {
    const int Lc = min(L, S - c * L), buf = c & 1;
    const float* rec = sc.rec + ((size_t)bh * nc + c) * brec_floats(L);
    for (int i = tid; i < L; i += kTc)  // m_new, inter, w, rowsum: 4 L floats
      sm90::cp_async16(sm_a + Lay::kGates + buf * 4 * kMaxL * 4 + i * 16, rec + i * 4, true);
    const size_t vbase = ((size_t)b * S + c * L) * rsv + (size_t)hh * Dv + f0;
    for (int i = tid; i < 2 * 64 * kCols / 8; i += kTc) {
      const int which = i >= 64 * kCols / 8, r = i - which * (64 * kCols / 8);
      const int t = r / (kCols / 8), ch = r % (kCols / 8);
      const bf16* src = which ? dh : v;
      sm90::cp_async16(sm_a + (which ? Lay::kD : Lay::kV) + buf * 64 * kCols * 2 + r * 16,
                       t < Lc ? src + vbase + t * rsv + ch * 8 : src, t < Lc);
    }
  };
  load_gates_vd(0);
  sm90::cp_async_commit();

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t pc = (size_t)bh * nc + c;
    const float* gv = reinterpret_cast<const float*>(sm + Lay::kGates + (c & 1) * 4 * kMaxL * 4);
    const float* inter = gv + kIt * L;
    const float* w = gv + kW * L;
    bf16* cst_c = cst + pc * (cst_tc_floats(D, Dv) * 2);
    sm90::cp_async_wait<0>();
    __syncthreads();  // the last chunk's X is written; this chunk's gates, v and dh landed
    {
      const bf16* v_s = reinterpret_cast<const bf16*>(sm + Lay::kV + (c & 1) * 64 * kCols * 2);
      for (int i = tid; i < 64 * kCols; i += kTc) {  // v^T [32 f][64 t], K-major
        const int t = i / kCols, f = i % kCols;
        *tile_at(vt, f, t) = v_s[i];
      }
      if (c + 1 < nc) load_gates_vd(c + 1);
      sm90::cp_async_commit();
    }
    sm90::fence_proxy_async();
    __syncthreads();
    const float decay = inter[Lc - 1];

    float qc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) qc[i] = 0.f;
    float qn = 0.f;  // row wt / 2's q n over this warpgroup's tiles
#pragma unroll
    for (int j = 0; j < kMt; ++j) {
      if (j >= my_tiles) continue;  // warpgroup-uniform
      const int e0 = (wg * kMt + j) * 64;
      // the tile's entering C: transposed (C^T [32 f][64 e]) as q C's B, a
      // bf16 pair; and its hi half into the scratch for rows_tc (rounded
      // once)
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = acc_row(i), f = acc_col(i);
        store_pair_t(ct, ct + kHalf, C[j][i], C[j][i + 1], r, f);
        const uint32_t pr = sm90::pack_bf16(C[j][i], C[j][i + 1]);
        if (e0 + r < D) {
          *reinterpret_cast<uint32_t*>(cst_c + cst_at(e0 + r, f0 + f, Dv)) = pr;
          if (pad_half) *reinterpret_cast<uint32_t*>(cst_c + cst_at(e0 + r, f0 + kCols + f, Dv)) = 0u;
        }
      }
      if (j == 0)
        sm90::cp_async_wait<1>();  // the next chunk's gates, v and dh may stay in flight
      else
        sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      wg_bar(wg);  // tile u landed and C^T is visible; tile u - 1's products are done
      if (u + 1 < n_units) load(u + 1);
      sm90::cp_async_commit();
      const uint32_t qs = ring + (u & 1) * 2 * kTile, ks = qs + kTile;
      uint8_t* qs_p = sm + (qs - sm_a);
      uint8_t* ks_p = qs_p + kTile;
      ++u;

      const uint32_t cta = sm_a + Lay::kCt + wg * 2 * kHalf, vta = sm_a + Lay::kVt;
      sm90::fence_regs(qc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          sm90::wgmma_ss<32, 0, 0>(qc, sm90::desc128(qs + kk * 32, 16, 1024),
                                   sm90::desc128(cta + half * kHalf + kk * 32, 16, 1024));
      sm90::wgmma_commit();

      // float32 sums from the tile as loaded, while q C runs: the tile's
      // rows of n's update, sum_t k[t][e] w[t], and q n (as recurrent_tc)
      {
        float n_add[8];
        const int ch = wt >> 4, tg = wt & 15;
#pragma unroll
        for (int e = 0; e < 8; ++e) n_add[e] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tg + 16 * i;
          float f[8];
          kv_tile::Pack<bf16>::unpack(*reinterpret_cast<const uint4*>(ks_p + sm90::swizzle128(t, ch)), f);
          const float wv = t < Lc ? w[t] : 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) n_add[e] = fmaf(f[e], wv, n_add[e]);
        }
#pragma unroll
        for (int half = 4; half >= 1; half >>= 1) {
          const bool up = tg & (2 * half);
#pragma unroll
          for (int e = 0; e < half; ++e) {
            const float keep = up ? n_add[e + half] : n_add[e];
            const float give = up ? n_add[e] : n_add[e + half];
            n_add[e] = keep + __shfl_xor_sync(0xffffffffu, give, 2 * half);
          }
        }
        n_add[0] += __shfl_xor_sync(0xffffffffu, n_add[0], 1);
        if ((tg & 1) == 0)  // read after the next barrier
          n_part[ch * 8 + ((tg >> 3) & 1) * 4 + ((tg >> 2) & 1) * 2 + ((tg >> 1) & 1)] = n_add[0];
      }
      {
        const int t = wt >> 1, c0 = (wt & 1) * 4;
        float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ch = c0; ch < c0 + 4; ++ch) {
          float f[8];
          kv_tile::Pack<bf16>::unpack(*reinterpret_cast<const uint4*>(qs_p + sm90::swizzle128(t, ch)), f);
          const float4* nn = reinterpret_cast<const float4*>(n_s + e0 + ch * 8);
          const float4 na = nn[0], nb = nn[1];
          a4[0] = fmaf(f[0], na.x, fmaf(f[4], nb.x, a4[0]));
          a4[1] = fmaf(f[1], na.y, fmaf(f[5], nb.y, a4[1]));
          a4[2] = fmaf(f[2], na.z, fmaf(f[6], nb.z, a4[2]));
          a4[3] = fmaf(f[3], na.w, fmaf(f[7], nb.w, a4[3]));
        }
        float x = (a4[0] + a4[1]) + (a4[2] + a4[3]);
        qn += x + __shfl_xor_sync(0xffffffffu, x, 1);
      }
      sm90::wgmma_wait0();
      sm90::fence_regs(qc);
      wg_bar(wg);  // q and k are read: k's tile takes k o w

      scale_rows(ks_p, w, Lc, wt);
      if (wt < 64) {
        const int e = e0 + wt;
        if (fb == 0 && e < D) sc.nst[pc * D + e] = n_s[e];
        n_s[e] = fmaf(decay, n_s[e], n_part[wt]);
      }
      sm90::fence_proxy_async();
      wg_bar(wg);

      // C = decay C + (k o w)^T v (M = e, N = f, K = t; A M-major through
      // the transpose bit)
#pragma unroll
      for (int i = 0; i < 16; ++i) C[j][i] *= decay;
      sm90::fence_regs(C[j]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<32, 1, 0>(C[j], sm90::desc128(ks + kk * 2048, 1024, 1024),
                                 sm90::desc128(vta + kk * 32, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(C[j]);
    }

    // the partial sums of q C and q n to shared memory; warpgroup 0 writes
    // X's share dh . (Q C) over the block's columns, and block 0 Q n
    if (wg > 0)
#pragma unroll
      for (int i = 0; i < 16; ++i) red[(wg - 1) * 64 * kCols + acc_row(i) * kCols + acc_col(i)] = qc[i];
    if ((wt & 1) == 0) qn_s[wg * 64 + (wt >> 1)] = qn;
    __syncthreads();
    if (wg == 0) {
      const bf16* d_s = reinterpret_cast<const bf16*>(sm + Lay::kD + (c & 1) * 64 * kCols * 2);
      float xs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = acc_row(i), f = acc_col(i);
        float x = qc[i];
        for (int p = 1; p < kWg; ++p) x += red[(p - 1) * 64 * kCols + r * kCols + f];
        xs[(i >> 1) & 1] = fmaf(__bfloat162float(d_s[r * kCols + f]), x, xs[(i >> 1) & 1]);
      }
      float* xp = sc.Xp + pc * ncb * L + (size_t)fb * L;
      float* rec = sc.rec + pc * brec_floats(L);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = quad_sum(xs[e]);
        const int r = acc_row(2 * e);
        if ((wt & 3) == 0 && r < Lc) {
          xp[r] = scale * x;
          if (fb == 0) {
            float n = 0.f;
            for (int p = 0; p < kWg; ++p) n += qn_s[p * 64 + r];
            rec[kQn * L + r] = scale * n;
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();  // no copy may outlive the block
}

// Shared memory of rows_tc: byte offsets from a 1024-aligned base (ops.py
// bwd_plan mirrors kBytes).
struct RowsLayout {
  static constexpr int kSlot = 2 * kTile + kHalf;          // v, dh and C_{c-1} tiles
  static constexpr int kRing = 0;                          // [kWg][2 slots]
  static constexpr int kDct = kRing + kWg * 2 * kSlot;     // [kWg] dC [32 e][64 f]
  static constexpr int kGq = kDct + kWg * kHalf;           // (inter / M o Q)^T [32 e][64 s]
  static constexpr int kQt = kGq + kHalf;                  // q^T [32 e][64 s]
  static constexpr int kKt = kQt + kHalf;                  // k^T [32 e][64 t]
  static constexpr int kRed = kKt + kHalf;                 // [kWg - 1][64][32] partials
  static constexpr int kDs = kRed + (kWg - 1) * 64 * kCols * 4;  // dS [64][64] bf16
  static constexpr int kVec = kDs + kMaxL * kMaxL * 2;     // inter, w, 1/M, dden [4][64];
                                                           // n_{c-1}, dn [2][32]; [16] sums
  static constexpr int kBytes = 1024 + kVec + (4 * kMaxL + 2 * kCols + kTc / 32) * 4;
};

// 4. rows_tc: reverse_rows per (b * H + h, 32 rows e of C), the carried dC^T
// (M = f over all dh, N = 32 rows e) in wgmma accumulators, four
// warpgroups of four 64-row f-tiles.  Per f-tile, streamed with v, dh and
// C_{c-1}'s tile through the warpgroup's cp.async ring: U = dC v_t (M = t,
// N = e, K = f) from dC's tile; Y = dh C_{c-1}^T (M = s, N = e, K = f; dq's
// C_{c-1} dnum = Y / M); the share of <dC, C_{c-1}>; then dC^T = decay dC^T
// + dh^T (inter / M o Q) (M = f, N = e, K = s, A M-major).  Per chunk,
// warpgroup 0 sums U's partials, takes dS^T Q (M = t, N = e, K = s) and
// writes dk and dw's share; warpgroup 1 sums Y's, takes dS k (M = s, K =
// t) and writes dq; dS as register A fragments.
__global__ void __launch_bounds__(kTc, 1) rows_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dh, const float* __restrict__ C0, const float* __restrict__ n0,
    const float* __restrict__ C_fin, const float* __restrict__ n_fin,
    const float* __restrict__ dC_fin, const float* __restrict__ dn_fin, bf16* __restrict__ dq,
    bf16* __restrict__ dk, float* __restrict__ dC0, float* __restrict__ dn0, Scratch sc, int S,
    int H, int D, int Dv, int L, float scale) {
  using Lay = RowsLayout;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H, eb = blockIdx.y, e0 = eb * kCols;
  const int ncb = gridDim.y, tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sm_a = sm90::smem_addr(sm);
  uint8_t* dct = sm + Lay::kDct + wg * kHalf;
  uint8_t* gq = sm + Lay::kGq;
  uint8_t* qt = sm + Lay::kQt;
  uint8_t* kt = sm + Lay::kKt;
  float* red = reinterpret_cast<float*>(sm + Lay::kRed);
  bf16* ds = reinterpret_cast<bf16*>(sm + Lay::kDs);
  float* it = reinterpret_cast<float*>(sm + Lay::kVec);
  float* wv = it + kMaxL;
  float* im = wv + kMaxL;
  float* dd = im + kMaxL;
  float* np = dd + kMaxL;
  float* dns = np + kCols;
  float* sums = dns + kCols;
  const bf16* cst = reinterpret_cast<const bf16*>(sc.Cst);

  const int n_ft = (Dv + 63) / 64;
  const int my_tiles = max(0, min(kMt, n_ft - wg * kMt));
  const size_t rs = (size_t)H * D, rsv = (size_t)H * Dv;
  const int nc = (S + L - 1) / L;
  const size_t cbase = (size_t)bh * D * Dv;

  // this warpgroup's rows f of dC^T, columns e (the block's rows e of dC)
  float dC[kMt][16];
  float pf = 0.f;  // this thread's share of <dC_fin, C_fin> + <dn_fin, n_fin>
#pragma unroll
  for (int j = 0; j < kMt; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int f = (wg * kMt + j) * 64 + acc_row(i);
      const size_t o = cbase + (size_t)(e0 + acc_col(i)) * Dv + f;
      const float g = (dC_fin && f < Dv) ? dC_fin[o] : 0.f;
      dC[j][i] = g;
      if (dC_fin && f < Dv) pf = fmaf(g, C_fin[o], pf);
    }
  if (tid < kCols) {
    const float g = dn_fin ? dn_fin[(size_t)bh * D + e0 + tid] : 0.f;
    dns[tid] = g;
    if (dn_fin) pf = fmaf(g, n_fin[(size_t)bh * D + e0 + tid], pf);
  }
  pf = block_sum<kTc>(pf, sums);
  if (tid == 0) sc.pfin[(size_t)bh * ncb + eb] = pf;

  // this warpgroup's stream: u = (nc - 1 - c) * my_tiles + j, 2 ring slots
  const uint32_t ring = sm_a + Lay::kRing + wg * 2 * Lay::kSlot;
  const int n_units = nc * my_tiles;
  auto load = [&](int u) {
    const int c = nc - 1 - u / my_tiles, j = u % my_tiles, ft = wg * kMt + j;
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t vbase = ((size_t)b * S + t0) * rsv + (size_t)hh * Dv + ft * 64;
    const uint32_t slot = ring + (u & 1) * Lay::kSlot;
    load_tile(slot, v, vbase, rsv, Lc, Dv - ft * 64, wt);
    load_tile(slot + kTile, dh, vbase, rsv, Lc, Dv - ft * 64, wt);
    const bf16* ct = cst + ((size_t)bh * nc + c) * (cst_tc_floats(D, Dv) * 2) +
                     ((size_t)eb * n_ft + ft) * 2048;
#pragma unroll
    for (int p = 0; p < 2; ++p)
      sm90::cp_async16(slot + 2 * kTile + (wt + p * 128) * 16, ct + (wt + p * 128) * 8, true);
  };
  if (n_units > 0) load(0);
  sm90::cp_async_commit();
  int u = 0;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t base = ((size_t)b * S + t0) * rs + (size_t)hh * D;
    const size_t pc = (size_t)bh * nc + c;
    const float* rec = sc.rec + pc * brec_floats(L);
    __syncthreads();  // the last chunk is done with the chunk's operands
    for (int t = tid; t < kMaxL; t += kTc) {
      const bool in = t < L;
      it[t] = in ? rec[kIt * L + t] : 0.f;
      wv[t] = in ? rec[kW * L + t] : 0.f;
      im[t] = in ? rec[kInvM * L + t] : 0.f;
      dd[t] = in ? rec[kDden * L + t] : 0.f;
    }
    if (tid < kCols) np[tid] = sc.nst[pc * D + e0 + tid];
    for (int i = tid; i < kMaxL * kMaxL; i += kTc) {  // dS, rounded once
      const int s = i >> 6, t = i & 63;
      ds[i] = __float2bfloat16(s < L && t < L ? rec[kVecs * L + L * L + s * L + t] : 0.f);
    }
    __syncthreads();  // inter and 1 / M for the transposed operands
    for (int i = tid; i < 64 * kCols / 8; i += kTc) {  // q^T, (inter / M o Q)^T and k^T
      const int t = i / (kCols / 8), ch = i % (kCols / 8);
      uint4 xq = make_uint4(0u, 0u, 0u, 0u), xk = xq;
      if (t < Lc) {
        xq = *reinterpret_cast<const uint4*>(q + base + t * rs + e0 + ch * 8);
        xk = *reinterpret_cast<const uint4*>(k + base + t * rs + e0 + ch * 8);
      }
      const bf16* q8 = reinterpret_cast<const bf16*>(&xq);
      const bf16* k8 = reinterpret_cast<const bf16*>(&xk);
      const float g = scale * it[t] * im[t];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int e = ch * 8 + x;
        *tile_at(qt, e, t) = q8[x];
        *tile_at(kt, e, t) = k8[x];
        *tile_at(gq, e, t) = __float2bfloat16(__bfloat162float(q8[x]) * g);
      }
    }
    sm90::fence_proxy_async();
    __syncthreads();
    const float decay = it[Lc - 1];

    float U[16], Y[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) U[i] = Y[i] = 0.f;
    float pd = 0.f;  // this thread's share of <dC, C_{c-1}>
#pragma unroll
    for (int j = 0; j < kMt; ++j) {
      if (j >= my_tiles) continue;  // warpgroup-uniform
      // dC's tile, rows e and columns f (U's B), rounded once
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int f = acc_row(i), e = acc_col(i);
        *tile_at(dct, e, f) = __float2bfloat16(dC[j][i]);
        *tile_at(dct, e + 1, f) = __float2bfloat16(dC[j][i + 1]);
      }
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      wg_bar(wg);  // tile u landed and dC's tile is visible; tile u - 1's products are done
      if (u + 1 < n_units) load(u + 1);
      sm90::cp_async_commit();
      const uint32_t slot = ring + (u & 1) * Lay::kSlot;
      const uint32_t vs = slot, dsl = slot + kTile, cs = slot + 2 * kTile;
      uint8_t* cs_p = sm + (cs - sm_a);
      ++u;
      const uint32_t dcta = sm_a + Lay::kDct + wg * kHalf;
      sm90::fence_regs(U);
      sm90::fence_regs(Y);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_ss<32, 0, 0>(U, sm90::desc128(vs + kk * 32, 16, 1024),
                                 sm90::desc128(dcta + kk * 32, 16, 1024));
        sm90::wgmma_ss<32, 0, 0>(Y, sm90::desc128(dsl + kk * 32, 16, 1024),
                                 sm90::desc128(cs + kk * 32, 16, 1024));
      }
      sm90::wgmma_commit();
      // <dC, C_{c-1}> over the tile, from the stored (bf16) entering state
#pragma unroll
      for (int i = 0; i < 16; ++i)
        pd = fmaf(dC[j][i], __bfloat162float(*tile_at(cs_p, acc_col(i), acc_row(i))), pd);
      // dC^T = decay dC^T + dh^T (inter / M o Q): M = f, N = e, K = s
#pragma unroll
      for (int i = 0; i < 16; ++i) dC[j][i] *= decay;
      sm90::fence_regs(dC[j]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<32, 1, 0>(dC[j], sm90::desc128(dsl + kk * 2048, 1024, 1024),
                                 sm90::desc128(sm_a + Lay::kGq + kk * 32, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(U);
      sm90::fence_regs(Y);
      sm90::fence_regs(dC[j]);
    }

    // U's partials summed on warpgroup 0, which writes dk and dw's share;
    // then Y's on warpgroup 1, which writes dq (each in warpgroup order)
    auto part = [&](int owner, int i) {
      const int slot = (wg < owner ? wg : wg - 1) * 64 * kCols;
      return red + slot + acc_row(i) * kCols + acc_col(i);
    };
    if (wg != 0)
#pragma unroll
      for (int i = 0; i < 16; ++i) *part(0, i) = U[i];
    __syncthreads();
    if (wg == 0)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        for (int p = 1; p < kWg; ++p) U[i] += red[(p - 1) * 64 * kCols + acc_row(i) * kCols + acc_col(i)];
    __syncthreads();
    if (wg != 1)
#pragma unroll
      for (int i = 0; i < 16; ++i) *part(1, i) = Y[i];
    __syncthreads();
    if (wg == 0) {  // dS^T Q (M = t, N = e, K = s), then dk and dw's share
      float dka[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) dka[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t fr[4];
        a_frags(kk, fr, [&](int t, int s) { return ds[s * kMaxL + t]; });
        sm90::fence_regs(dka);
        sm90::wgmma_fence();
        sm90::wgmma_rs<32, 0>(dka, fr, sm90::desc128(sm_a + Lay::kQt + kk * 32, 16, 1024));
        sm90::wgmma_commit();
        sm90::wgmma_wait0();
        sm90::fence_regs(dka);
      }
      float* pdw = sc.pdw + (pc * ncb + eb) * L;
      float pw[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = acc_row(i), e = acc_col(i);
        const float u0 = U[i] + dns[e], u1 = U[i + 1] + dns[e + 1];  // dC v_t + dn
        pw[(i >> 1) & 1] += __bfloat162float(*tile_at(kt, e, r)) * u0 +
                            __bfloat162float(*tile_at(kt, e + 1, r)) * u1;
        if (r < Lc)
          *reinterpret_cast<__nv_bfloat162*>(dk + base + (size_t)r * rs + e0 + e) =
              __floats2bfloat162_rn(fmaf(wv[r], u0, scale * dka[i]),
                                    fmaf(wv[r], u1, scale * dka[i + 1]));
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = quad_sum(pw[e]);
        const int r = acc_row(2 * e);
        if ((wt & 3) == 0 && r < Lc) pdw[r] = x;
      }
    } else if (wg == 1) {  // dS k (M = s, N = e, K = t), then dq
      float dqa[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        for (int p = 0; p < kWg; ++p)
          if (p != 1) Y[i] += *(red + (p < 1 ? p : p - 1) * 64 * kCols + acc_row(i) * kCols + acc_col(i));
        dqa[i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t fr[4];
        a_frags(kk, fr, [&](int s, int t) { return ds[s * kMaxL + t]; });
        sm90::fence_regs(dqa);
        sm90::wgmma_fence();
        sm90::wgmma_rs<32, 0>(dqa, fr, sm90::desc128(sm_a + Lay::kKt + kk * 32, 16, 1024));
        sm90::wgmma_commit();
        sm90::wgmma_wait0();
        sm90::fence_regs(dqa);
      }
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = acc_row(i), e = acc_col(i);
        if (r >= Lc) continue;
        const float y0 = it[r] * fmaf(im[r], Y[i], dd[r] * np[e]) + dqa[i];
        const float y1 = it[r] * fmaf(im[r], Y[i + 1], dd[r] * np[e + 1]) + dqa[i + 1];
        *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)r * rs + e0 + e) =
            __floats2bfloat162_rn(scale * y0, scale * y1);
      }
    }
    if (tid < kCols) pd = fmaf(dns[tid], np[tid], pd);
    pd = block_sum<kTc>(pd, sums);
    if (tid == 0) sc.pdi[pc * ncb + eb] = pd;
    if (tid < kCols) {  // dn_{c-1} = inter_L dn + sum_s inter_s dden_s Q_s
      float a = 0.f;
      for (int s = 0; s < Lc; ++s)
        a = fmaf(it[s] * dd[s], scale * __bfloat162float(*tile_at(qt, tid, s)), a);
      dns[tid] = fmaf(decay, dns[tid], a);
    }
  }
  sm90::cp_async_wait<0>();  // no copy may outlive the block
  __syncthreads();
  float p0 = 0.f;  // this thread's share of <dC0, C0> + <dn0, n0>
#pragma unroll
  for (int j = 0; j < kMt; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int f = (wg * kMt + j) * 64 + acc_row(i);
      if (f >= Dv) continue;
      const size_t o = cbase + (size_t)(e0 + acc_col(i)) * Dv + f;
      if (dC0) dC0[o] = dC[j][i];
      if (C0) p0 = fmaf(dC[j][i], C0[o], p0);
    }
  if (tid < kCols) {
    if (dn0) dn0[(size_t)bh * D + e0 + tid] = dns[tid];
    if (n0) p0 = fmaf(dns[tid], n0[(size_t)bh * D + e0 + tid], p0);
  }
  p0 = block_sum<kTc>(p0, sums);
  if (tid == 0) sc.p0[(size_t)bh * ncb + eb] = p0;
}

// Shared memory of cols_tc: byte offsets from a 1024-aligned base (ops.py
// bwd_plan mirrors kBytes).
struct ColsLayout {
  static constexpr int kRing = 0;                          // [kWg][2 slots][k, q tile]
  static constexpr int kCt = kRing + kWg * 2 * 2 * kTile;  // [kWg][hi, lo] dC^T [32 f][64 e]
  static constexpr int kDt = kCt + kWg * 2 * kHalf;        // dh^T [32 f][64 s]
  static constexpr int kGd = kDt + kHalf;                  // (scale inter / M o dh)^T [32 f][64 s]
  static constexpr int kRed = kGd + kHalf;                 // [kWg - 1][64][32] k dC partials
  static constexpr int kAtt = kRed + (kWg - 1) * 64 * kCols * 4;  // att / M [64 s][64 t] bf16
  static constexpr int kVec = kAtt + kMaxL * kMaxL * 2;    // inter, w, 1/M [3][64]
  static constexpr int kBytes = 1024 + kVec + 3 * kMaxL * 4;
};

// 5. cols_tc: reverse_cols per (b * H + h, 32 columns f of C), the carried
// dC (M = e over all dh, N = f) in wgmma accumulators as the forward's C:
// per e-tile, k dC (M = t, N = f, K = e) from dC^T's tile, then dC = decay
// dC + Q^T (inter / M o dh) (M = e, N = f, K = s, q's tile M-major); per
// chunk, warpgroup 0 sums the partials and writes dv = w (k dC) + (att /
// M)^T dh, att / M as register A fragments.
__global__ void __launch_bounds__(kTc, 1) cols_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ dh,
    const float* __restrict__ dC_fin, bf16* __restrict__ dv, Scratch sc, int S, int H, int D,
    int Dv, int L, float scale) {
  using Lay = ColsLayout;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H, f0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sm_a = sm90::smem_addr(sm);
  uint8_t* ct = sm + Lay::kCt + wg * 2 * kHalf;
  uint8_t* dt = sm + Lay::kDt;
  uint8_t* gd = sm + Lay::kGd;
  float* red = reinterpret_cast<float*>(sm + Lay::kRed);
  bf16* att = reinterpret_cast<bf16*>(sm + Lay::kAtt);
  float* it = reinterpret_cast<float*>(sm + Lay::kVec);
  float* wv = it + kMaxL;
  float* im = wv + kMaxL;

  const int n_et = (D + 63) / 64;
  const int my_tiles = max(0, min(kMt, n_et - wg * kMt));
  const size_t rs = (size_t)H * D, rsv = (size_t)H * Dv;
  const int nc = (S + L - 1) / L;
  const size_t cbase = (size_t)bh * D * Dv;

  float dC[kMt][16];  // rows e, columns f0.. of the carried dC
#pragma unroll
  for (int j = 0; j < kMt; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = (wg * kMt + j) * 64 + acc_row(i);
      dC[j][i] = (dC_fin && e < D) ? dC_fin[cbase + (size_t)e * Dv + f0 + acc_col(i)] : 0.f;
    }

  const uint32_t ring = sm_a + Lay::kRing + wg * 2 * 2 * kTile;
  const int n_units = nc * my_tiles;
  auto load = [&](int u) {
    const int c = nc - 1 - u / my_tiles, j = u % my_tiles, e0 = (wg * kMt + j) * 64;
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t base = ((size_t)b * S + t0) * rs + (size_t)hh * D + e0;
    const uint32_t ks = ring + (u & 1) * 2 * kTile;
    load_tile(ks, k, base, rs, Lc, D - e0, wt);
    load_tile(ks + kTile, q, base, rs, Lc, D - e0, wt);
  };
  if (n_units > 0) load(0);
  sm90::cp_async_commit();
  int u = 0;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t vbase = ((size_t)b * S + t0) * rsv + (size_t)hh * Dv;
    const float* rec = sc.rec + ((size_t)bh * nc + c) * brec_floats(L);
    __syncthreads();  // the last chunk is done with the chunk's operands
    for (int t = tid; t < kMaxL; t += kTc) {
      const bool in = t < L;
      it[t] = in ? rec[kIt * L + t] : 0.f;
      wv[t] = in ? rec[kW * L + t] : 0.f;
      im[t] = in ? rec[kInvM * L + t] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kMaxL * kMaxL; i += kTc) {  // att / M, rounded once
      const int s = i >> 6, t = i & 63;
      att[i] = __float2bfloat16(s < L && t < L ? rec[kVecs * L + s * L + t] * im[s] : 0.f);
    }
    for (int i = tid; i < 64 * kCols / 8; i += kTc) {  // dh^T and (scale inter / M o dh)^T
      const int t = i / (kCols / 8), ch = i % (kCols / 8);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (t < Lc) x = *reinterpret_cast<const uint4*>(dh + vbase + t * rsv + f0 + ch * 8);
      const bf16* x8 = reinterpret_cast<const bf16*>(&x);
      const float g = scale * it[t] * im[t];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        *tile_at(dt, ch * 8 + e, t) = x8[e];
        *tile_at(gd, ch * 8 + e, t) = __float2bfloat16(__bfloat162float(x8[e]) * g);
      }
    }
    sm90::fence_proxy_async();
    __syncthreads();
    const float decay = it[Lc - 1];

    float vk[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) vk[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMt; ++j) {
      if (j >= my_tiles) continue;  // warpgroup-uniform
      // dC's tile transposed (dC^T [32 f][64 e]) as a bf16 pair: k dC's B
#pragma unroll
      for (int i = 0; i < 16; i += 2)
        store_pair_t(ct, ct + kHalf, dC[j][i], dC[j][i + 1], acc_row(i), acc_col(i));
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      wg_bar(wg);  // tile u landed and dC^T is visible; tile u - 1's products are done
      if (u + 1 < n_units) load(u + 1);
      sm90::cp_async_commit();
      const uint32_t ks = ring + (u & 1) * 2 * kTile, qs = ks + kTile;
      ++u;
      const uint32_t cta = sm_a + Lay::kCt + wg * 2 * kHalf;
#pragma unroll
      for (int i = 0; i < 16; ++i) dC[j][i] *= decay;
      sm90::fence_regs(vk);
      sm90::fence_regs(dC[j]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          sm90::wgmma_ss<32, 0, 0>(vk, sm90::desc128(ks + kk * 32, 16, 1024),
                                   sm90::desc128(cta + half * kHalf + kk * 32, 16, 1024));
      // dC = decay dC + Q^T (inter / M o dh): M = e, N = f, K = s
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<32, 1, 0>(dC[j], sm90::desc128(qs + kk * 2048, 1024, 1024),
                                 sm90::desc128(sm_a + Lay::kGd + kk * 32, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(vk);
      sm90::fence_regs(dC[j]);
    }

    if (wg > 0)
#pragma unroll
      for (int i = 0; i < 16; ++i) red[(wg - 1) * 64 * kCols + acc_row(i) * kCols + acc_col(i)] = vk[i];
    __syncthreads();
    if (wg == 0) {
      float a[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        for (int p = 1; p < kWg; ++p) vk[i] += red[(p - 1) * 64 * kCols + acc_row(i) * kCols + acc_col(i)];
        a[i] = 0.f;
      }
      // (att / M)^T dh: M = t, N = f, K = s
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t fr[4];
        a_frags(kk, fr, [&](int t, int s) { return att[s * kMaxL + t]; });
        sm90::fence_regs(a);
        sm90::wgmma_fence();
        sm90::wgmma_rs<32, 0>(a, fr, sm90::desc128(sm_a + Lay::kDt + kk * 32, 16, 1024));
        sm90::wgmma_commit();
        sm90::wgmma_wait0();
        sm90::fence_regs(a);
      }
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int t = acc_row(i), f = acc_col(i);
        if (t < Lc)
          *reinterpret_cast<__nv_bfloat162*>(dv + vbase + (size_t)t * rsv + f0 + f) =
              __floats2bfloat162_rn(fmaf(wv[t], vk[i], a[i]), fmaf(wv[t], vk[i + 1], a[i + 1]));
      }
    }
  }
  sm90::cp_async_wait<0>();  // no copy may outlive the block
}

template <typename Kernel>
cudaError_t prepare(Kernel* kernel, size_t smem, int (&set)[kv_tile::kMaxDevices]) {
  const cudaError_t err = kv_tile::raise_smem_limit(kernel, smem, set);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the next launch must not report it
  return err;
}

struct Args {
  const void *q, *k, *v, *log_i, *log_f, *C0, *n0, *m0, *C_fin, *n_fin, *dh, *dC_fin, *dn_fin,
      *dm_fin;
  void *dq, *dk, *dv, *dlog_i, *dlog_f, *dC0, *dn0, *dm0, *scratch;
};

// One launch of a call: its grid, threads and dynamic shared memory.
struct Launch {
  dim3 grid;
  int threads;
  size_t smem;
};

// The six launches of a call, in order (ops.py bwd_plan mirrors them), and
// the scratch's floats: float32 takes the scalar bodies, bf16 the
// tensor-core ones (prep_tc, states_tc, rows_tc, cols_tc; steps and
// gate_grads are shared).  The states and column sweeps have a block per 32
// columns of C (Dv / 32), the row sweep one per 32 rows (D / 32).
int plan(int B, int S, int H, int D, int Dv, int L, int dtype, Launch (&ls)[6],
         size_t& scratch) {
  const int nc = (S + L - 1) / L, BH = B * H;
  const bool tc = dtype == 1;
  scratch = scratch_floats(BH, nc, D, Dv, L, tc ? cst_tc_floats(D, Dv) : (size_t)D * Dv);
  const dim3 per_chunk(nc, BH), by_cols(BH, Dv / kCols), by_rows(BH, D / kCols);
  ls[2] = {per_chunk, kThreads, 0};  // steps
  ls[5] = {per_chunk, kMaxL, 0};     // gate_grads
  if (tc) {
    ls[0] = {per_chunk, 128, (size_t)kPrepSmem};
    ls[1] = {by_cols, kTc, (size_t)StatesLayout::kBytes};
    ls[3] = {by_rows, kTc, (size_t)RowsLayout::kBytes};
    ls[4] = {by_cols, kTc, (size_t)ColsLayout::kBytes};
  } else {
    ls[0] = {per_chunk, kThreads, 0};
    ls[1] = {by_cols, kThreads, sizeof(float) * states_smem_floats(D, L)};
    ls[3] = {by_rows, kThreads, sizeof(float) * rows_smem_floats(Dv, L)};
    ls[4] = {by_cols, kThreads, sizeof(float) * cols_smem_floats(D, L)};
  }
  return 0;
}

#define LAUNCH(i, kernel, ...)                                                            \
  do {                                                                                    \
    static int set[kv_tile::kMaxDevices] = {};                                            \
    if (ls[i].smem && (err = prepare(kernel, ls[i].smem, set)) != cudaSuccess) return (int)err; \
    kernel<<<ls[i].grid, ls[i].threads, ls[i].smem, stream>>>(__VA_ARGS__);               \
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;                       \
  } while (0)

int launch(const Args& a, int B, int S, int H, int D, int Dv, int L, float scale, int dtype,
           cudaStream_t stream) {
  Launch ls[6];
  size_t n_scratch;
  plan(B, S, H, D, Dv, L, dtype, ls, n_scratch);
  const int nc = (S + L - 1) / L, BH = B * H, nck = D / kCols, ncv = Dv / kCols;
  const Scratch sc = carve(static_cast<float*>(a.scratch), BH, nc, D, Dv, L,
                           dtype == 1 ? cst_tc_floats(D, Dv) : (size_t)D * Dv);
  const float* li = static_cast<const float*>(a.log_i);
  const float* lf = static_cast<const float*>(a.log_f);
  const float* C0 = static_cast<const float*>(a.C0);
  const float* n0 = static_cast<const float*>(a.n0);
  const float* m0 = static_cast<const float*>(a.m0);
  const float* Cf = static_cast<const float*>(a.C_fin);
  const float* nf = static_cast<const float*>(a.n_fin);
  const float* dCf = static_cast<const float*>(a.dC_fin);
  const float* dnf = static_cast<const float*>(a.dn_fin);
  float* dC0 = static_cast<float*>(a.dC0);
  float* dn0 = static_cast<float*>(a.dn0);
  cudaError_t err;
  if (dtype == 1) {
    const bf16* q = static_cast<const bf16*>(a.q);
    const bf16* k = static_cast<const bf16*>(a.k);
    const bf16* v = static_cast<const bf16*>(a.v);
    const bf16* dh = static_cast<const bf16*>(a.dh);
    LAUNCH(0, prep_tc, q, k, v, dh, li, lf, m0, sc.rec, S, H, D, Dv, L, scale);
    LAUNCH(1, states_tc, q, k, v, dh, C0, n0, sc, S, H, D, Dv, L, scale);
    LAUNCH(2, steps, sc, S, L, ncv);
    LAUNCH(3, rows_tc, q, k, v, dh, C0, n0, Cf, nf, dCf, dnf, static_cast<bf16*>(a.dq),
           static_cast<bf16*>(a.dk), dC0, dn0, sc, S, H, D, Dv, L, scale);
    LAUNCH(4, cols_tc, q, k, dh, dCf, static_cast<bf16*>(a.dv), sc, S, H, D, Dv, L, scale);
  } else {
    const float* q = static_cast<const float*>(a.q);
    const float* k = static_cast<const float*>(a.k);
    const float* v = static_cast<const float*>(a.v);
    const float* dh = static_cast<const float*>(a.dh);
    LAUNCH(0, prep<float>, q, k, v, dh, li, lf, m0, sc.rec, S, H, D, Dv, L, scale);
    LAUNCH(1, states<float>, q, k, v, dh, C0, n0, sc, S, H, D, Dv, L, scale);
    LAUNCH(2, steps, sc, S, L, ncv);
    LAUNCH(3, reverse_rows<float>, q, k, v, dh, C0, n0, Cf, nf, dCf, dnf,
           static_cast<float*>(a.dq), static_cast<float*>(a.dk), dC0, dn0, sc, S, H, D, Dv, L,
           scale);
    LAUNCH(4, reverse_cols<float>, q, k, dh, dCf, static_cast<float*>(a.dv), sc, S, H, D, Dv,
           L, scale);
  }
  LAUNCH(5, gate_grads, li, lf, m0, static_cast<const float*>(a.dm_fin),
         static_cast<float*>(a.dlog_i), static_cast<float*>(a.dlog_f),
         static_cast<float*>(a.dm0), sc, S, H, L, nck);
  return 0;
}

#undef LAUNCH

bool valid(int D, int Dv, int L) {
  return L <= kMaxL && D % kCols == 0 && Dv % kCols == 0 && 0 < Dv && Dv <= D &&
         D <= kWg * kMt * 64;
}

}  // namespace

// q, k (B, S, H, D); v, dh (B, S, H, Dv), Dv <= D (a tensor-parallel
// rank's value columns of every head; Dv = D otherwise); log_i, log_f (B,
// S, H) float32; C0 (B, H, D, Dv), n0 (B, H, D), m0 (B, H) float32, all
// null for a new stream; C_fin, n_fin the forward's final state (read
// where dC_fin, dn_fin are given); dC_fin, dn_fin, dm_fin the final state's
// gradient, each null for zeros; outputs dq, dk (B, S, H, D), dv (B, S, H,
// Dv), dlog_i, dlog_f (B, S, H) float32, dC0, dn0, dm0
// float32 or null (not wanted); scratch: float32, as carve() lays it out
// (mlstm_bwd_plan's floats).  L: chunk length (<= 64); scale multiplies q.
// dtype 0 = float32 (the scalar bodies), 1 = bfloat16 (the tensor-core
// ones; q, k, v, dh and dq, dk, dv share it).  The wrapper guarantees
// contiguous 16-byte-aligned tensors, D and Dv multiples of 32 and at most
// 1024,
// and the shared memory within the card's 227 KB.  Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int mlstm_bwd(const void* q, const void* k, const void* v, const void* log_i,
                         const void* log_f, const void* C0, const void* n0, const void* m0,
                         const void* C_fin, const void* n_fin, const void* dh,
                         const void* dC_fin, const void* dn_fin, const void* dm_fin, void* dq,
                         void* dk, void* dv, void* dlog_i, void* dlog_f, void* dC0, void* dn0,
                         void* dm0, void* scratch, int B, int S, int H, int D, int Dv, int L,
                         float scale, int dtype, void* stream) {
  if (!valid(D, Dv, L)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, log_i, log_f, C0, n0, m0, C_fin, n_fin, dh, dC_fin, dn_fin, dm_fin,
               dq, dk, dv, dlog_i, dlog_f, dC0, dn0, dm0, scratch};
  return launch(a, B, S, H, D, Dv, L, scale, dtype, static_cast<cudaStream_t>(stream));
}

// The plan of a call, as mlstm_bwd launches it: out[0] the scratch's
// floats, then for each of the six launches grid x, y, z, threads and
// dynamic shared memory (31 values).  ops.py bwd_plan mirrors it.
extern "C" int mlstm_bwd_plan(int B, int S, int H, int D, int Dv, int L, int dtype,
                              long long* out) {
  if (!valid(D, Dv, L)) return (int)cudaErrorInvalidValue;
  Launch ls[6];
  size_t n;
  plan(B, S, H, D, Dv, L, dtype, ls, n);
  out[0] = (long long)n;
  for (int i = 0; i < 6; ++i) {
    long long* o = out + 1 + 5 * i;
    o[0] = ls[i].grid.x;
    o[1] = ls[i].grid.y;
    o[2] = ls[i].grid.z;
    o[3] = ls[i].threads;
    o[4] = (long long)ls[i].smem;
  }
  return 0;
}
