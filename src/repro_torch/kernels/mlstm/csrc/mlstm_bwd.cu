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
//     n_chunks dh^2 4 bytes (512 MB at xlstm's B = 2, S = 1024) held from
//     the forward to the backward, and both forward bodies (the bf16 one
//     keeps C in wgmma accumulators) would have to write them.  The
//     backward recomputes them in its own states sweep instead: one more
//     L dh^2 product a chunk, no change to the forward, and the 512 MB live
//     only during the backward call (under remat, one layer at a time).
//
// Six launches, every product as scalar float32 FMAs from shared memory
// over q, k, v and dh read in their dtype (bf16 or float32):
//   1. prep, per (chunk, b * H + h): the gates, S = Q k^T and DV = dh v^T
//      over dh, att, rowsum; into the chunk's record (float32 scratch);
//   2. states, per (b * H + h, 32 columns f of C), serial over the chunks:
//      each chunk's entering C (its columns) and n into the scratch, Q n,
//      and X = dh . (Q C) over its columns (X is the part of dh . num that
//      goes through the state), as the forward's scalar recurrent kernel
//      walks it;
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
//   6. gate_grads, per (b * H + h): the shares summed in order, log f's
//      gradient as the reverse cumsum within each chunk of b's, and the m
//      terms.
// Deterministic: no atomics, every sum in a fixed order.
//
// What bounds it on this card: at xlstm-1.3b's training shape (B = 2, S =
// 1024, H = 4, dh = 1024, L = 64) about 91 GFLOP in five L dh^2 products a
// chunk (~0.09 ms at 989 TFLOP/s of bf16 tensor cores; ~1.4 ms at 67
// TFLOP/s of scalar float32), while the recomputed entering states are
// 512 MB written and read (~0.3 ms at 3.35 TB/s).  This first version is
// scalar float32 FMAs (the tensor-core redesign is later work); its sweeps
// run 256 blocks of 256 threads (B H dh / 32), one an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kv_tile.cuh"
#include "mlstm_gates.cuh"

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
// the records (B H, n_chunks); the entering C (B H, n_chunks, dh, dh) and n
// (B H, n_chunks, dh); X's shares (B H, n_chunks, dh / 32, L); dw's (B H,
// n_chunks, dh / 32, L) and d inter_L's (B H, n_chunks, dh / 32); the
// shares of <dC_fin, C_fin> + <dn_fin, n_fin> and <dC0, C0> + <dn0, n0>
// (B H, dh / 32 each).
struct Scratch {
  float *rec, *Cst, *nst, *Xp, *pdw, *pdi, *pfin, *p0;
};

__host__ inline Scratch carve(float* base, int BH, int nc, int dh, int L) {
  const size_t ncb = dh / kCols, n = (size_t)BH * nc;
  Scratch s;
  s.rec = base;
  s.Cst = s.rec + n * brec_floats(L);
  s.nst = s.Cst + n * dh * dh;
  s.Xp = s.nst + n * dh;
  s.pdw = s.Xp + n * ncb * L;
  s.pdi = s.pdw + n * ncb * L;
  s.pfin = s.pdi + n * ncb;
  s.p0 = s.pfin + (size_t)BH * ncb;
  return s;
}

// The block's sum of v, in a fixed order (lanes, then the warps' sums), on
// thread 0.  Every thread calls it.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
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
                                                 int L, float scale) {
  __shared__ float qs[kMaxL][kLd], ks[kMaxL][kLd], ds[kMaxL][kLd], vs[kMaxL][kLd];
  __shared__ GateSmem<kThreads> g;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int nc = gridDim.x, t0 = c * L, Lc = min(L, S - t0);
  const int ty = tid / 16, tx = tid % 16;
  const size_t rs = (size_t)H * D, base = ((size_t)b * S + t0) * rs + (size_t)h * D;
  chunk_gates<kThreads>(log_i, log_f, m0, b, h, H, S, L, c, g);
  float sc[4][4] = {}, dv[4][4] = {};
  for (int e0 = 0; e0 < D; e0 += kCols) {
    __syncthreads();  // the last tile is consumed
    for (int i = tid; i < kMaxL * kCols; i += kThreads) {
      const int t = i / kCols, e = i - t * kCols;
      const bool in = t < Lc;
      const size_t o = base + t * rs + e0 + e;
      qs[t][e] = in ? to_float(q[o]) * scale : 0.f;
      ks[t][e] = in ? to_float(k[o]) : 0.f;
      ds[t][e] = in ? to_float(dh[o]) : 0.f;
      vs[t][e] = in ? to_float(v[o]) : 0.f;
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
                                                   int S, int H, int D, int L, float scale) {
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
  const size_t cbase = (size_t)bh * D * D, rs = (size_t)H * D;
  for (int i = tid; i < D * kCols; i += kThreads) {
    const int e = i / kCols, f = i - e * kCols;
    Cs[i] = C0 ? C0[cbase + (size_t)e * D + f0 + f] : 0.f;
  }
  for (int e = tid; e < D; e += kThreads) ns[e] = n0 ? n0[(size_t)bh * D + e] : 0.f;
  int rows[kRows];  // this warp's chunk rows, clamped into the tiles
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t base = ((size_t)b * S + t0) * rs + (size_t)h * D;
    const size_t pc = (size_t)bh * nc + c;
    float* rec = sc.rec + pc * brec_floats(L);
    float* Cst = sc.Cst + pc * D * D;
    __syncthreads();  // the previous chunk is done with shared memory
    for (int t = tid; t < L; t += kThreads) {
      it[t] = rec[kIt * L + t];
      wv[t] = rec[kW * L + t];
    }
    for (int i = tid; i < L * kCols; i += kThreads) {
      const int t = i / kCols, f = i - t * kCols;
      const bool in = t < Lc;
      const size_t o = base + t * rs + f0 + f;
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
        Cst[(size_t)(e0 + e) * D + f0 + f] = Cs[(e0 + e) * kCols + f];
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
__host__ __device__ inline size_t rows_smem_floats(int D, int L) {
  return (size_t)kCols * (D + 1) + 2 * kCols + 2 * (size_t)L * kCols + (size_t)L * L + 4 * L +
         2 * (size_t)L * kLd + kCols * kLd + kWarps;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) reverse_rows(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dh, const float* __restrict__ C0, const float* __restrict__ n0,
    const float* __restrict__ C_fin, const float* __restrict__ n_fin,
    const float* __restrict__ dC_fin, const float* __restrict__ dn_fin, T* __restrict__ dq,
    T* __restrict__ dk, float* __restrict__ dC0, float* __restrict__ dn0, Scratch sc, int S,
    int H, int D, int L, float scale) {
  extern __shared__ float smem[];
  const int ldc = D + 1;  // padded rows: the 32 lanes read 32 rows at once
  float* dCs = smem;                  // [32][D + 1] rows e0.. of the carried dC
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
  const size_t rbase = (size_t)bh * D * D + (size_t)e0 * D;  // row e0 of (b, h)'s matrices
  const size_t rs = (size_t)H * D;
  float pf = 0.f;  // this thread's share of <dC_fin, C_fin> + <dn_fin, n_fin>
  for (int i = tid; i < kCols * D; i += kThreads) {
    const int e = i / D, f = i - e * D;
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
    const size_t pc = (size_t)bh * nc + c;
    const float* rec = sc.rec + pc * brec_floats(L);
    const float* Cprev = sc.Cst + pc * D * D + (size_t)e0 * D;
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
    for (int f0 = 0; f0 < D; f0 += kCols) {
      for (int i = tid; i < L * kCols; i += kThreads) {
        const int t = i / kCols, f = i - t * kCols;
        const bool in = t < Lc;
        const size_t o = base + t * rs + f0 + f;
        vt[t * kLd + f] = in ? to_float(v[o]) : 0.f;
        dnt[t * kLd + f] = in ? to_float(dh[o]) * im[t] : 0.f;
      }
      for (int i = tid; i < kCols * kCols; i += kThreads) {
        const int e = i / kCols, f = i - e * kCols;
        Ct[e * kLd + f] = Cprev[(size_t)e * D + f0 + f];
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
  for (int i = tid; i < kCols * D; i += kThreads) {
    const int e = i / D, f = i - e * D;
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
    int L, float scale) {
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
  const size_t cbase = (size_t)bh * D * D, rs = (size_t)H * D;
  for (int i = tid; i < D * kCols; i += kThreads) {
    const int e = i / kCols, f = i - e * kCols;
    dCs[i] = dC_fin ? dC_fin[cbase + (size_t)e * D + f0 + f] : 0.f;
  }
  int rows[kRows];
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t base = ((size_t)b * S + t0) * rs + (size_t)h * D;
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
      dnt[i] = t < Lc ? to_float(dh[base + t * rs + f0 + f]) * im[t] : 0.f;
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
      store(dv + base + (size_t)t * rs + f0 + lane, a);
    }
  }
}

// ---------------------------------------------------------------------------
// 6. gate_grads: one block of kMaxL threads per b * H + h, a step a thread.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxL) gate_grads(
    const float* __restrict__ log_i, const float* __restrict__ log_f,
    const float* __restrict__ m0, const float* __restrict__ dm_fin, float* __restrict__ dlog_i,
    float* __restrict__ dlog_f, float* __restrict__ dm0, Scratch sc, int S, int H, int L,
    int ncb) {
  __shared__ float rw[kMaxL], db[kMaxL];
  __shared__ float gm_s;
  __shared__ int win_s;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int nc = (S + L - 1) / L;
  auto at = [&](int s) { return ((size_t)b * S + s) * H + h; };
  if (tid == 0) {
    // m_fin's own gradient g_m, and the step (-1: m0) whose running max
    // m_fin is: the chain m <- b_last + max(m, run_last) of chunk_gates
    float g = dm_fin ? dm_fin[bh] : 0.f;
    for (int fb = 0; fb < ncb; ++fb) g -= sc.pfin[(size_t)bh * ncb + fb];
    float m = m0 ? m0[bh] : kNeg;
    int win = -1;
    for (int c = 0; c < nc; ++c) {
      const int t0 = c * L, Lc = min(L, S - t0);
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
      if (run > m) win = t0 + arg;
      m = cum + fmaxf(m, run);
    }
    gm_s = g;
    win_s = win;
    if (dm0) {
      float p = 0.f;
      for (int fb = 0; fb < ncb; ++fb) p += sc.p0[(size_t)bh * ncb + fb];
      dm0[bh] = p + (win < 0 ? g : 0.f);
    }
  }
  __syncthreads();
  const float g = gm_s;
  const int win = win_s;
  for (int c = 0; c < nc; ++c) {
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
    __syncthreads();
  }
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

template <typename T>
int launch(const Args& a, int B, int S, int H, int D, int L, float scale, cudaStream_t stream) {
  const int nc = (S + L - 1) / L, BH = B * H, ncb = D / kCols;
  const Scratch sc = carve(static_cast<float*>(a.scratch), BH, nc, D, L);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dh = static_cast<const T*>(a.dh);
  const float* li = static_cast<const float*>(a.log_i);
  const float* lf = static_cast<const float*>(a.log_f);
  const float* C0 = static_cast<const float*>(a.C0);
  const float* n0 = static_cast<const float*>(a.n0);
  const float* m0 = static_cast<const float*>(a.m0);
  const float* dCf = static_cast<const float*>(a.dC_fin);
  cudaError_t err;
  prep<T><<<dim3(nc, BH), kThreads, 0, stream>>>(q, k, v, dh, li, lf, m0, sc.rec, S, H, D, L,
                                                  scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  {
    const size_t smem = sizeof(float) * states_smem_floats(D, L);
    static int set[kv_tile::kMaxDevices] = {};
    if ((err = prepare(states<T>, smem, set)) != cudaSuccess) return (int)err;
    states<T><<<dim3(BH, ncb), kThreads, smem, stream>>>(q, k, v, dh, C0, n0, sc, S, H, D, L,
                                                         scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  steps<<<dim3(nc, BH), kThreads, 0, stream>>>(sc, S, L, ncb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  {
    const size_t smem = sizeof(float) * rows_smem_floats(D, L);
    static int set[kv_tile::kMaxDevices] = {};
    if ((err = prepare(reverse_rows<T>, smem, set)) != cudaSuccess) return (int)err;
    reverse_rows<T><<<dim3(BH, ncb), kThreads, smem, stream>>>(
        q, k, v, dh, C0, n0, static_cast<const float*>(a.C_fin),
        static_cast<const float*>(a.n_fin), dCf, static_cast<const float*>(a.dn_fin),
        static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<float*>(a.dC0),
        static_cast<float*>(a.dn0), sc, S, H, D, L, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  {
    const size_t smem = sizeof(float) * cols_smem_floats(D, L);
    static int set[kv_tile::kMaxDevices] = {};
    if ((err = prepare(reverse_cols<T>, smem, set)) != cudaSuccess) return (int)err;
    reverse_cols<T><<<dim3(BH, ncb), kThreads, smem, stream>>>(
        q, k, dh, dCf, static_cast<T*>(a.dv), sc, S, H, D, L, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  gate_grads<<<BH, kMaxL, 0, stream>>>(li, lf, m0, static_cast<const float*>(a.dm_fin),
                                        static_cast<float*>(a.dlog_i),
                                        static_cast<float*>(a.dlog_f),
                                        static_cast<float*>(a.dm0), sc, S, H, L, ncb);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dh (B, S, H, D); log_i, log_f (B, S, H) float32; C0 (B, H, D, D),
// n0 (B, H, D), m0 (B, H) float32, all null for a new stream; C_fin, n_fin
// the forward's final state (read where dC_fin, dn_fin are given); dC_fin,
// dn_fin, dm_fin the final state's gradient, each null for zeros; outputs
// dq, dk, dv (B, S, H, D), dlog_i, dlog_f (B, S, H) float32, dC0, dn0, dm0
// float32 or null (not wanted); scratch: float32, as carve() lays it out
// (ops.py bwd_plan).  L: chunk length (<= 64); scale multiplies q.  dtype
// 0 = float32, 1 = bfloat16 (q, k, v, dh and dq, dk, dv share it).  The
// wrapper guarantees contiguous tensors, D a multiple of 32 and at most
// 1024, and the shared memory within the card's 227 KB.  Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int mlstm_bwd(const void* q, const void* k, const void* v, const void* log_i,
                         const void* log_f, const void* C0, const void* n0, const void* m0,
                         const void* C_fin, const void* n_fin, const void* dh,
                         const void* dC_fin, const void* dn_fin, const void* dm_fin, void* dq,
                         void* dk, void* dv, void* dlog_i, void* dlog_f, void* dC0, void* dn0,
                         void* dm0, void* scratch, int B, int S, int H, int D, int L,
                         float scale, int dtype, void* stream) {
  if (L > kMaxL || D % kCols) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, log_i, log_f, C0, n0, m0, C_fin, n_fin, dh, dC_fin, dn_fin, dm_fin,
               dq, dk, dv, dlog_i, dlog_f, dC0, dn0, dm0, scratch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(a, B, S, H, D, L, scale, s);
  return launch<float>(a, B, S, H, D, L, scale, s);
}
