// Chunkwise mLSTM (xLSTM matrix memory) for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the Pallas TPU kernel mlstm_pallas
// (src/repro/kernels/mlstm/kernel.py, body _mlstm_kernel, launched at
// kernel.py:106).  Per (batch row b, head h), over chunks of L steps, with
// the stabilized state (C (dh, dv), n (dh), m) carried in float32 (dv = dh
// but on a tensor-parallel rank, which holds dv of every head's columns):
//   b      = inclusive cumsum of log f within the chunk
//   m_new  = b + max(m_prev, cummax(log i - b))
//   inter  = exp(b + m_prev - m_new)
//   gate   = tril(exp(b_s - b_t + log i_t - m_new_s))           (L, L)
//   att    = gate o (q k^T)
//   h      = (att v + inter o (q C)) / max(|rowsum(att) + inter o (q n)|, exp(-m_new))
//   C'     = inter_L C + (k o w)^T v,  n' = inter_L n + (k o w)^T 1,  w = gate[L-1]
//
// The TPU kernel walks the chunks as a sequential grid axis with the whole
// (dh, dh) state in VMEM.  At xlstm-1.3b's width (dh = 4096 / 4 = 1024) one
// head's C is 4 MB, far beyond an SM, so the work is cut three ways:
//   * the gates: m_new of a chunk depends on every chunk before it, but
//     only through m, which a chunk moves by m <- b_last + max(m, run_last)
//     (run = cummax(log i - b)).  Each scores block (one per chunk) sums the
//     chunks before its own, one thread each in one serial pass, chains
//     them on one thread (a max and an add per chunk, no exp), then works
//     out its own chunk's gates a step per thread.  The in-chunk cumsum is
//     the serial pass's order (each step's prefix summed from the chunk's
//     start); torch.cumsum is not that order on either device (the CPU
//     accumulates in double, the card scans in parallel), so the gates
//     match the plain version to a few ulp and the tolerances cover it.
//   * scores kernels, one block per (b, h, chunk), all in parallel: the
//     gates, the (L, L) scores q k^T over all dh, gated and masked to att,
//     and rowsum(att), all float32, into a per-chunk record (m_new, inter,
//     w, rowsum, att) that the recurrent kernels read.  None of it
//     depends on the carried C or n, so no column block recomputes it.
//   * recurrent kernels, one block per (b, h, 32 columns of C): the
//     columns of v, C, the numerator and h are independent given the
//     denominator, so they split over blocks (4 heads x 32 = 128 blocks on
//     132 SMs at B = 1).  A block carries its (dh, 32) slice of C and all
//     of n (n redundantly: it is cheap) across the chunks in a loop.
//   * a no-state boot path (one launch): with no start state and one
//     chunk (S <= L, every boot prefill of the serving path) q C = q n = 0,
//     so C' = (k o w)^T v, n' = (k o w)^T 1 and h = att v / max(|rowsum
//     att|, exp(-m_new)).  One block per (b, h, 64 columns of C, 4 e-tiles
//     of 64 rows) writes its tiles of C'; one more per (b, h, 64 columns),
//     beside them, works out h for those columns.  It is bound by writing
//     the float32 state (16.8 MB at B = 1, H = 4, dh = 1024), not by a
//     serial walk.
//
// bfloat16 (the serving dtype): the four products on the tensor cores
// (wgmma, sm90.cuh), bf16 operands and f32 accumulators.
//   * scores q k^T: M = t, N = s, K = e, both operands K-major as loaded,
//     q and k streamed in 64-column tiles through a cp.async ring of 4
//     tile pairs (3 in the boot kernel, whose blocks fit 3 an SM).
//   * the recurrent block has four warpgroups; warpgroup w owns 4 m-tiles
//     (256 rows of e) of the block's C and keeps them in registers as
//     wgmma accumulators (64 floats a thread: the 128 KB slice is half the
//     register file, so the block runs alone on its SM), with n and the
//     rest in 220 KB of shared memory.  Each warpgroup streams its e-tiles
//     of q and k (64 steps x 64 columns, 8 KB each) through its own
//     2-tile cp.async ring, the next tile's copies in flight while they
//     compute.  Per tile: q n and the tile's rows of n's update in f32
//     from the tile as loaded; the tile of C as a transposed (K-major)
//     bf16 pair; q C (M = t, N = f, K = e) by wgmma m64n32k16; k o w as a
//     bf16 pair in place of the tile's k and q; then the state update
//     C = decay C + (k o w)^T v (M = e, N = f, K = t: A = k o w as stored,
//     M-major, read through the transpose bit).  v's 32 columns are stored
//     transposed (K-major) once a chunk and serve both the state update
//     and att v.  Warpgroup 0 adds the others' partial q C, then att v
//     with att as the register A operand, and writes h.  A chunk's att
//     and the next chunk's gates and v load by cp.async behind the tiles.
//   * precision: q, k and v are bf16 already, so q k^T is exact up to the
//     f32 sums.  The other operands, att, k o w and the carried C, are
//     float32 values; each goes into the tensor cores as a pair hi + lo of
//     bf16 (hi = x rounded, lo = x - hi rounded: ~16 significant bits) in
//     two wgmmas.  One bf16 rounding of any of them moves h by up to 35
//     times its 2e-2 tolerance, since h's denominator cancels
//     (tests/test_torch_kernel_plans.py holds the pairs within it at
//     dh = 1024).  rowsum(att) and q n, the denominator, stay float32, and
//     so does the carried state.
// float32: the scalar bodies (scalar FMAs from shared memory), for the
// float32 parity paths only: their gates hold h at 2e-4 and the state at
// 2e-5, which bf16 operands (or TF32) cannot meet.  A block of the scalar
// recurrent kernel keeps its columns of C in shared memory and walks each
// chunk's q and k in tiles of 32 e-columns.
//
// What bounds it on this card: at B = 1, S = 2048, H = 4, dh = 1024, L = 64
// with a start state the function moves ~101 MB and does ~35.5 GFLOP:
// bound by the tensor cores' rate (~36 us at 989 TFLOP/s; the pairs double
// the tensor work of three products, ~71 us for this grid).  What holds the
// recurrent block back is its shared-memory pipe (the tiles' cp.async, the
// f32 sums, the pairs and wgmma's operands: ~120 KB a tile and warpgroup)
// and the chain of barriers a tile; the column split also has every block
// read every tile of q and k, 32 MB a chunk from L2 over the card.
// Built without fast math: exp(-m_new) must overflow to inf when m_new is
// very negative, as in the reference.  It is CUDA rather than Triton
// because its work is matrix products chained through a sequential carry.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kv_tile.cuh"
#include "mlstm_gates.cuh"
#include "sm90.cuh"
#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using kv_tile::Pack;

constexpr int kMaxL = 64;  // longest chunk
constexpr int kCols = 32;  // columns of C per recurrent block
constexpr float kNeg = -1e30f;

// The per-chunk record of (b * H + h, chunk) that a scores kernel writes and
// a recurrent kernel reads: m_new, inter, w and rowsum(att), L floats each
// (zeros past the chunk), then att [L][L] (zero above the diagonal and past
// the chunk), padded to 16 bytes; att starts 16-byte aligned.
__host__ __device__ inline size_t record_floats(int L) {
  return ((size_t)L * L + 4 * (size_t)L + 3) & ~(size_t)3;
}
constexpr int kRecMn = 0, kRecInter = 1, kRecW = 2, kRecRowsum = 3;
__host__ __device__ inline float* rec_att(float* rec, int L) { return rec + 4 * L; }

// ---------------------------------------------------------------------------
// The gates (include/mlstm_gates.cuh)
// ---------------------------------------------------------------------------
using mlstm_gates::chunk_gates;
using mlstm_gates::gate;
using mlstm_gates::GateSmem;

// Writes the chunk's gates into its record: m_new, inter, w for t < L;
// rowsum and att are the caller's.
template <int NT>
__device__ __forceinline__ void write_gates(const GateSmem<NT>& g, float* r, int L, int Lc) {
  for (int t = threadIdx.x; t < L; t += NT) {
    const bool in = t < Lc;
    r[kRecMn * L + t] = in ? g.mn[t] : 0.f;
    r[kRecInter * L + t] = in ? g.it[t] : 0.f;
    r[kRecW * L + t] = g.w[t];
  }
}

// ---------------------------------------------------------------------------
// float32: the scalar bodies
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;          // scalar bodies
constexpr int kWarps = kThreads / 32;
constexpr int kTileE = 32;             // e-columns of q and k per streamed tile
constexpr int kRows = kMaxL / kWarps;  // chunk rows per warp

// 16-byte loads per thread for one (kMaxL, kTileE) tile of q or k.
constexpr int kVec = kMaxL * kTileE / (kThreads * 4);

// Loads rows [0, rows) of a (rows, kTileE) float32 tile whose row t starts
// at x + base + t * row_stride into this thread's registers.
__device__ __forceinline__ void fetch(uint4 (&r)[kVec], const float* __restrict__ x, size_t base,
                                      size_t row_stride, int rows) {
  constexpr int per_row = kTileE / 4;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / per_row, c = i - t * per_row;
    if (t < rows) r[j] = __ldg(reinterpret_cast<const uint4*>(x + base + t * row_stride + c * 4));
  }
}

// Writes the fetched tile into dst (row stride ld), row t times mul[t] (or
// times scale where mul is null); rows [rows, rows_buf) are zeros, rows
// past rows_buf are not written.
__device__ __forceinline__ void stash(const uint4 (&r)[kVec], float* dst, int ld, int rows,
                                      int rows_buf, const float* mul, float scale) {
  constexpr int per_row = kTileE / 4;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / per_row, c = (i - t * per_row) * 4;
    if (t >= rows_buf) continue;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < rows) {
      Pack<float>::unpack(r[j], f);
      const float s = mul ? mul[t] : scale;
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] *= s;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[t * ld + c + e] = f[e];
  }
}

// One block per (chunk, b * H + h): the chunk's gates, its scores (scale
// q_c) k_c^T over all dh (a 4 x 4 register tile per thread), gated into
// att, and rowsum(att), into the chunk's record; the last chunk's block
// also writes the final m.
__global__ void __launch_bounds__(kThreads)
    scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ log_i, const float* __restrict__ log_f,
                  const float* __restrict__ m0, float* __restrict__ rec_out,
                  float* __restrict__ m_out, int S, int H, int dh, int L, float scale) {
  constexpr int ld = kTileE + 1;  // padded rows: 16 lanes read 16 k rows at once
  __shared__ __align__(16) float qs[kMaxL * ld];
  __shared__ __align__(16) float ks[kMaxL * ld];
  __shared__ GateSmem<kThreads> g;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row_stride = (size_t)H * dh;
  const size_t base = ((size_t)b * S + t0) * row_stride + (size_t)h * dh;

  float acc[4][4] = {};
  uint4 rq[kVec], rk[kVec];
  fetch(rq, q, base, row_stride, Lc);
  fetch(rk, k, base, row_stride, Lc);
  chunk_gates<kThreads>(log_i, log_f, m0, b, h, H, S, L, c, g);
  for (int e0 = 0; e0 < dh; e0 += kTileE) {
    __syncthreads();  // the last tile is consumed
    stash(rq, qs, ld, Lc, kMaxL, nullptr, scale);
    stash(rk, ks, ld, Lc, kMaxL, nullptr, 1.f);
    __syncthreads();
    if (e0 + kTileE < dh) {
      fetch(rq, q, base + e0 + kTileE, row_stride, Lc);
      fetch(rk, k, base + e0 + kTileE, row_stride, Lc);
    }
    for (int e = 0; e < kTileE; ++e) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * ld + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
    }
  }
  float* rec = rec_out + ((size_t)bh * gridDim.x + c) * record_floats(L);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = ty + 16 * i;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tx + 16 * j;
      const float a = (t <= s && s < Lc) ? gate(g, s, t) * acc[i][j] : 0.f;
      rs += a;
      if (s < L && t < L) rec_att(rec, L)[s * L + t] = a;
    }
    // the 16 threads of a row are one half-warp
    for (int off = 8; off; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    if (tx == 0 && s < L) rec[kRecRowsum * L + s] = rs;
  }
  write_gates(g, rec, L, Lc);
  if (c == gridDim.x - 1 && threadIdx.x == 0) m_out[bh] = g.mn[Lc - 1];
}

__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }

// Floats of recurrent_kernel's shared memory (ops.py plan agrees).
__host__ __device__ inline size_t recurrent_smem_floats(int L, int dh) {
  return (size_t)dh * kCols + dh + pad4(L * L) + (size_t)L * kCols + 2 * (size_t)L * kTileE +
         4 * (size_t)L;
}

// One block per (b * H + h, 32-column block of C) walks every chunk.
__global__ void __launch_bounds__(kThreads) recurrent_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ C0, const float* __restrict__ n0, const float* __restrict__ recs,
    float* __restrict__ h_out, float* __restrict__ C_out, float* __restrict__ n_out, int S,
    int H, int dh, int dv, int L, float scale) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int f0 = blockIdx.y * kCols;  // this block's columns [f0, f0 + 32) of C, v, h
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                   // [dh][kCols] the carried columns of C
  float* ns = Cs + dh * kCols;        // [dh] the carried n
  float* att = ns + dh;               // [L][L] the chunk's att
  float* vs = att + pad4(L * L);      // [L][kCols] this block's columns of v
  float* qs = vs + L * kCols;         // [L][kTileE] scale q, one e-tile
  float* ks = qs + L * kTileE;        // [L][kTileE] k o w, one e-tile
  float* gv = ks + L * kTileE;        // [4][L] m_new, inter, w, rowsum
  const float* mn = gv + kRecMn * L;
  const float* inter = gv + kRecInter * L;
  const float* w = gv + kRecW * L;
  const float* rowsum = gv + kRecRowsum * L;

  const size_t cbase = (size_t)bh * dh * dv;
  for (int i = tid; i < dh * kCols; i += kThreads) {
    const int e = i / kCols, f = i - e * kCols;
    Cs[i] = C0 ? C0[cbase + (size_t)e * dv + f0 + f] : 0.f;
  }
  for (int e = tid; e < dh; e += kThreads) ns[e] = n0 ? n0[(size_t)bh * dh + e] : 0.f;

  const size_t row_stride = (size_t)H * dh, vrs = (size_t)H * dv;
  const int n_chunks = (S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t base = ((size_t)b * S + t0) * row_stride + (size_t)h * dh;
    const size_t vbase = ((size_t)b * S + t0) * vrs + (size_t)h * dv;
    const float* rec = recs + ((size_t)bh * n_chunks + c) * record_floats(L);
    uint4 rq[kVec], rk[kVec];
    fetch(rq, q, base, row_stride, Lc);
    fetch(rk, k, base, row_stride, Lc);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int i = tid; i < 4 * L; i += kThreads) gv[i] = rec[i];
    for (int i = tid; i < L * L; i += kThreads) att[i] = rec[4 * L + i];
    for (int i = tid; i < Lc * kCols; i += kThreads) {
      const int t = i / kCols, f = i - t * kCols;
      vs[i] = v[vbase + t * vrs + f0 + f];
    }
    __syncthreads();
    const float decay = inter[Lc - 1];

    // stream q and k over e: q C and q n from the state before this chunk,
    // then that tile's rows of C and n move to the state after it
    int rows[kRows];  // this warp's chunk rows, clamped into the chunk
#pragma unroll
    for (int i = 0; i < kRows; ++i) rows[i] = min(warp + kWarps * i, Lc - 1);
    float qc[kRows] = {}, qn[kRows] = {};
    for (int e0 = 0; e0 < dh; e0 += kTileE) {
      stash(rq, qs, kTileE, Lc, L, nullptr, scale);
      stash(rk, ks, kTileE, Lc, L, w, 1.f);
      __syncthreads();
      if (e0 + kTileE < dh) {
        fetch(rq, q, base + e0 + kTileE, row_stride, Lc);
        fetch(rk, k, base + e0 + kTileE, row_stride, Lc);
      }
      for (int e4 = 0; e4 < kTileE / 4; ++e4) {
        const float* cr = Cs + (size_t)(e0 + 4 * e4) * kCols + lane;
        const float c0 = cr[0], c1 = cr[kCols], c2 = cr[2 * kCols], c3 = cr[3 * kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 x = reinterpret_cast<const float4*>(qs + rows[i] * kTileE)[e4];
          float a = fmaf(x.x, c0, qc[i]);
          a = fmaf(x.y, c1, a);
          a = fmaf(x.z, c2, a);
          qc[i] = fmaf(x.w, c3, a);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qn[i] = fmaf(qs[rows[i] * kTileE + lane], ns[e0 + lane], qn[i]);
      __syncthreads();  // every q C and q n read the old state
      {
        const int e = 4 * warp;  // rows e0 + e .. e0 + e + 3 of C, column `lane`
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int t = 0; t < Lc; ++t) {
          const float4 kw = reinterpret_cast<const float4*>(ks + t * kTileE + e)[0];
          const float x = vs[t * kCols + lane];
          a0 = fmaf(kw.x, x, a0);
          a1 = fmaf(kw.y, x, a1);
          a2 = fmaf(kw.z, x, a2);
          a3 = fmaf(kw.w, x, a3);
        }
        float* cr = Cs + (size_t)(e0 + e) * kCols + lane;
        cr[0] = fmaf(decay, cr[0], a0);
        cr[kCols] = fmaf(decay, cr[kCols], a1);
        cr[2 * kCols] = fmaf(decay, cr[2 * kCols], a2);
        cr[3 * kCols] = fmaf(decay, cr[3 * kCols], a3);
        if (lane < 4) {
          float a = 0.f;
          for (int t = 0; t < Lc; ++t) a += ks[t * kTileE + e + lane];
          ns[e0 + e + lane] = fmaf(decay, ns[e0 + e + lane], a);
        }
      }
      __syncthreads();  // the next tile overwrites qs and ks
    }

    // h = (att v + inter q C) / max(|rowsum(att) + inter q n|, exp(-m_new))
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = warp + kWarps * i;  // warp-uniform
      float qni = qn[i];
      for (int off = 16; off; off >>= 1) qni += __shfl_xor_sync(0xffffffffu, qni, off);
      if (s >= Lc) continue;
      const float* ar = att + s * L;
      float num = 0.f;
      for (int t = 0; t <= s; ++t) num = fmaf(ar[t], vs[t * kCols + lane], num);
      const float is = inter[s];
      num = fmaf(is, qc[i], num);
      const float den = fmaf(is, qni, rowsum[s]);
      h_out[vbase + (size_t)s * vrs + f0 + lane] = num / fmaxf(fabsf(den), expf(-mn[s]));
    }
  }

  __syncthreads();
  for (int i = tid; i < dh * kCols; i += kThreads) {
    const int e = i / kCols, f = i - e * kCols;
    C_out[cbase + (size_t)e * dv + f0 + f] = Cs[i];
  }
  if (blockIdx.y == 0)
    for (int e = tid; e < dh; e += kThreads) n_out[(size_t)bh * dh + e] = ns[e];
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core bodies
// ---------------------------------------------------------------------------
// A tile of q or k (tc_tile::kTile): 64 steps x 64 e-columns of bf16 in the
// 128-byte-swizzled layout (sm90.cuh), step t's row at t * 128; rows past
// the chunk and columns past dh zero-filled.
using tc_tile::acc_col;
using tc_tile::acc_row;
using tc_tile::aligned_smem;
using tc_tile::kTile;
using tc_tile::load_tile;
using tc_tile::scores_tc_loop;
using tc_tile::split_bf16;
using tc_tile::tile_at;
using tc_tile::wg_bar;
constexpr int kTcThreads = 128;  // scores and boot kernels: one warpgroup

// Scales the rows of a swizzled tile: row t < rows times w[t] (k -> k o
// w; rows past are zeros), as a bf16 pair, hi in place and lo at the same
// place of tile `lo`, by the kTcThreads threads numbered `tid`.
__device__ __forceinline__ void scale_rows(uint8_t* tile, uint8_t* lo, const float* w, int rows,
                                           int tid) {
#pragma unroll
  for (int p = 0; p < 64 * 8 / kTcThreads; ++p) {
    const int i = tid + p * kTcThreads, t = i >> 3, ch = i & 7;
    uint4* at = reinterpret_cast<uint4*>(tile + sm90::swizzle128(t, ch));
    float f[8];
    Pack<bf16>::unpack(*at, f);
    const float s = t < rows ? w[t] : 0.f;
    uint32_t hi[4], rest[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_bf16(f[2 * e] * s, f[2 * e + 1] * s, hi[e], rest[e]);
    *at = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(lo + sm90::swizzle128(t, ch)) =
        make_uint4(rest[0], rest[1], rest[2], rest[3]);
  }
}

// Writes v's columns [f0, f0 + n_cols) of the chunk's steps [0, Lc),
// transposed, into a swizzled K-major tile (row f, column t; zeros at t >=
// Lc), by `threads` threads.
__device__ __forceinline__ void load_vt(uint8_t* vt, const bf16* __restrict__ v, size_t base,
                                        size_t row_stride, int Lc, int n_cols, int cols,
                                        int threads) {
  for (int i = threadIdx.x; i < 64 * (n_cols / 8); i += threads) {
    const int t = i / (n_cols / 8), ch = i - t * (n_cols / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (t < Lc && ch * 8 < cols)
      x = *reinterpret_cast<const uint4*>(v + base + t * row_stride + ch * 8);
    const bf16* xv = reinterpret_cast<const bf16*>(&x);
#pragma unroll
    for (int e = 0; e < 8; ++e) *tile_at(vt, ch * 8 + e, t) = xv[e];
  }
}

// The gated, masked scores of a 64 x 64 accumulator s (rows s, columns t)
// in place, with rowsum of each of the thread's two rows (e = 0, 1) summed
// over the quad that holds the row.
template <int NT>
__device__ __forceinline__ void gate_scores(float (&s)[32], float (&rs)[2],
                                            const GateSmem<NT>& g, int Lc, float scale) {
  rs[0] = rs[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = acc_row(i), t = acc_col(i);
    s[i] = (t <= r && r < Lc) ? gate(g, r, t) * (s[i] * scale) : 0.f;
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 1);
    rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 2);
  }
}

// wgmma's A fragments for k-step kk (columns 16 kk .. 16 kk + 15) of a
// 64-row matrix given by value(row, col), as a bf16 pair: the m16n8k16 A
// layout on each warp's 16 rows.
template <typename F>
__device__ __forceinline__ void a_frags(int kk, uint32_t (&hi)[4], uint32_t (&lo)[4], F value) {
  const int lane = threadIdx.x & 31, r0 = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = r0 + 8 * (x & 1), c = 16 * kk + 8 * (x >> 1) + 2 * (lane & 3);
    split_bf16(value(r, c), value(r, c + 1), hi[x], lo[x]);
  }
}

constexpr int kScoreStages = 4;  // scores_tc: one block an SM, the ring as deep as fits
constexpr int kScoresTcSmem = 1024 + kScoreStages * 2 * kTile;

// One block (one warpgroup) per (chunk, b * H + h): scores_kernel's record
// with q k^T on the tensor cores.
__global__ void __launch_bounds__(kTcThreads)
    scores_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const float* __restrict__ log_i, const float* __restrict__ log_f,
              const float* __restrict__ m0, float* __restrict__ rec_out,
              float* __restrict__ m_out, int S, int H, int dh, int L, float scale) {
  __shared__ GateSmem<kTcThreads> g;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = sm90::smem_addr(aligned_smem(smem_raw));
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = c * L, Lc = min(L, S - t0);
  const size_t row_stride = (size_t)H * dh;
  const size_t base = ((size_t)b * S + t0) * row_stride + (size_t)h * dh;

  chunk_gates<kTcThreads>(log_i, log_f, m0, b, h, H, S, L, c, g);
  float s[32], rs[2];
  scores_tc_loop<kScoreStages>(s, ring, q, k, base, row_stride, Lc, dh);
  gate_scores(s, rs, g, Lc, scale);
  float* rec = rec_out + ((size_t)bh * gridDim.x + c) * record_floats(L);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = acc_row(i), t = acc_col(i);
    if (r < L && t < L) rec_att(rec, L)[r * L + t] = s[i];
  }
  if ((threadIdx.x & 3) == 0)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = acc_row(2 * e);
      if (r < L) rec[kRecRowsum * L + r] = rs[e];
    }
  write_gates(g, rec, L, Lc);
  if (c == gridDim.x - 1 && threadIdx.x == 0) m_out[bh] = g.mn[Lc - 1];
}

// Shared memory of recurrent_tc: byte offsets from a 1024-aligned base
// (ops.py plan mirrors kBytes).
template <int NWG, int MT>
struct RecLayout {
  static constexpr int kRing = 0;                                // [NWG][2 slots][q, k tile]
  static constexpr int kVt = kRing + NWG * 2 * 2 * kTile;        // v^T [32 f][64 t]
  static constexpr int kV = kVt + kCols * 128;                   // [2] v [64 t][32 f] as loaded
  static constexpr int kCt = kV + 2 * 64 * kCols * 2;            // [NWG][hi, lo] C^T [32 f][64 e]
  static constexpr int kRed = kCt + NWG * 2 * kCols * 128;       // [NWG - 1][64][32] q C
  static constexpr int kQn = kRed + (NWG - 1) * 64 * kCols * 4;  // [NWG][64] q n
  static constexpr int kGates = kQn + NWG * 64 * 4;              // [2][4][64] records' gates
  static constexpr int kAtt = kGates + 2 * 4 * kMaxL * 4;        // [64][64] the record's att
  static constexpr int kN = kAtt + kMaxL * kMaxL * 4;            // [NWG * MT * 64] n
  static constexpr int kBytes = 1024 + kN + NWG * MT * 64 * 4;   // + alignment slack
};

// One block per (b * H + h, 32-column block of C), NWG warpgroups of MT
// e-tiles each, walks every chunk (see the head of the file).
template <int NWG, int MT>
__global__ void __launch_bounds__(128 * NWG, 1) recurrent_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ C0, const float* __restrict__ n0, const float* __restrict__ recs,
    bf16* __restrict__ h_out, float* __restrict__ C_out, float* __restrict__ n_out, int S,
    int H, int dh, int dv, int L, float scale) {
  using Lay = RecLayout<NWG, MT>;
  constexpr int kT = 128 * NWG;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int f0 = blockIdx.y * kCols;  // this block's columns [f0, f0 + 32) of C, v, h
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sm_a = sm90::smem_addr(sm);
  uint8_t* vt = sm + Lay::kVt;
  uint8_t* ct = sm + Lay::kCt + wg * 2 * kCols * 128;  // this warpgroup's C^T pair
  float* red = reinterpret_cast<float*>(sm + Lay::kRed);
  float* qn_s = reinterpret_cast<float*>(sm + Lay::kQn);
  // during the tiles, this warpgroup's slot of qn_s holds its tile's sums
  // for n's update (q n goes there after the last tile)
  float* n_part = qn_s + wg * 64;
  const float* att = reinterpret_cast<const float*>(sm + Lay::kAtt);  // [L][L]
  float* n_s = reinterpret_cast<float*>(sm + Lay::kN);

  const int n_et = (dh + 63) / 64;
  const int my_tiles = max(0, min(MT, n_et - wg * MT));  // this warpgroup's real e-tiles
  const size_t row_stride = (size_t)H * dh, vrs = (size_t)H * dv;
  const int n_chunks = (S + L - 1) / L;
  const size_t cbase = (size_t)bh * dh * dv;

  // this warpgroup's rows of C, columns f0.., in wgmma's accumulator layout
  float C[MT][16];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = (wg * MT + j) * 64 + acc_row(i);
      C[j][i] = (C0 && e < dh) ? C0[cbase + (size_t)e * dv + f0 + acc_col(i)] : 0.f;
    }
  for (int e = tid; e < NWG * MT * 64; e += kT) n_s[e] = (n0 && e < dh) ? n0[(size_t)bh * dh + e] : 0.f;

  // this warpgroup's stream of tiles: u = chunk * my_tiles + j, 2 ring slots
  const uint32_t ring = sm_a + Lay::kRing + wg * 2 * 2 * kTile;
  const int n_units = n_chunks * my_tiles;
  auto load = [&](int u) {
    const int c = u / my_tiles, j = u - c * my_tiles;
    const int e0 = (wg * MT + j) * 64, t0 = c * L;
    const size_t base = ((size_t)b * S + t0) * row_stride + (size_t)hh * dh + e0;
    const uint32_t qs = ring + (u & 1) * 2 * kTile;
    load_tile(qs, q, base, row_stride, min(L, S - t0), dh - e0, wt);
    load_tile(qs + kTile, k, base, row_stride, min(L, S - t0), dh - e0, wt);
  };
  if (n_units > 0) load(0);
  sm90::cp_async_commit();
  int u = 0;
  // chunk c's gates and v's 32 columns (as loaded) into buffer c % 2
  auto load_gates_v = [&](int c) {
    const int Lc = min(L, S - c * L), buf = c & 1;
    const float* rec = recs + ((size_t)bh * n_chunks + c) * record_floats(L);
    for (int i = tid; i < L; i += kT)  // 4 L floats
      sm90::cp_async16(sm_a + Lay::kGates + buf * 4 * kMaxL * 4 + i * 16, rec + i * 4, true);
    const size_t vbase = ((size_t)b * S + c * L) * vrs + (size_t)hh * dv + f0;
    for (int i = tid; i < 64 * kCols / 8; i += kT) {
      const int t = i / (kCols / 8), ch = i % (kCols / 8);
      sm90::cp_async16(sm_a + Lay::kV + buf * 64 * kCols * 2 + i * 16,
                       t < Lc ? v + vbase + t * vrs + ch * 8 : v, t < Lc);
    }
  };
  load_gates_v(0);
  sm90::cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const float* gv = reinterpret_cast<const float*>(sm + Lay::kGates + (c & 1) * 4 * kMaxL * 4);
    const float* mn = gv + kRecMn * L;
    const float* inter = gv + kRecInter * L;
    const float* w = gv + kRecW * L;
    const float* rowsum = gv + kRecRowsum * L;
    sm90::cp_async_wait<0>();
    __syncthreads();  // the last chunk's h is written; this chunk's gates and v landed
    {
      const bf16* v_s = reinterpret_cast<const bf16*>(sm + Lay::kV + (c & 1) * 64 * kCols * 2);
      for (int i = tid; i < 64 * kCols; i += kT) {  // v^T [32 f][64 t], K-major
        const int t = i / kCols, f = i % kCols;
        *tile_at(vt, f, t) = v_s[i];
      }
      // in flight behind the tiles: this chunk's att, the next chunk's gates and v
      const float* rec = recs + ((size_t)bh * n_chunks + c) * record_floats(L);
      for (int i = tid; i < (L * L + 3) / 4; i += kT)
        sm90::cp_async16(sm_a + Lay::kAtt + i * 16, rec + 4 * L + i * 4, true);
      if (c + 1 < n_chunks) load_gates_v(c + 1);
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
    for (int j = 0; j < MT; ++j) {
      if (j >= my_tiles) continue;  // warpgroup-uniform
      const int e0 = (wg * MT + j) * 64;
      // the tile's C, transposed (C^T [32 f][64 e]), as a bf16 pair: q C's
      // B (its last reader, the previous tile's q C, is done)
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        uint32_t hi, lo;
        split_bf16(C[j][i], C[j][i + 1], hi, lo);
        const bf16* h2 = reinterpret_cast<const bf16*>(&hi);
        const bf16* l2 = reinterpret_cast<const bf16*>(&lo);
        const int r = acc_row(i), f = acc_col(i);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          *tile_at(ct, f + x, r) = h2[x];
          *tile_at(ct + kCols * 128, f + x, r) = l2[x];
        }
      }
      if (j == 0)
        sm90::cp_async_wait<1>();  // the chunk's att and the next gates may stay in flight
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

      // q C (M = t, N = f, K = e) from the old C, on the tensor cores while
      // the float32 sums run
      const uint32_t cta = sm_a + Lay::kCt + wg * 2 * kCols * 128, vta = sm_a + Lay::kVt;
      sm90::fence_regs(qc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          sm90::wgmma_ss<32, 0, 0>(qc, sm90::desc128(qs + kk * 32, 16, 1024),
                                   sm90::desc128(cta + half * kCols * 128 + kk * 32, 16, 1024));
      sm90::wgmma_commit();

      // float32 sums from the tile as loaded, while q C runs: the tile's
      // rows of n's update, sum_t k[t][e] w[t] (thread: 8 columns, every
      // 16th step; the 16 steps of a warp's half summed by shuffles) and
      // q n (thread: half a row t of q against n)
      {
        float n_add[8];
        const int ch = wt >> 4, tg = wt & 15;
#pragma unroll
        for (int e = 0; e < 8; ++e) n_add[e] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tg + 16 * i;
          float f[8];
          Pack<bf16>::unpack(*reinterpret_cast<const uint4*>(ks_p + sm90::swizzle128(t, ch)), f);
          const float wv = t < Lc ? w[t] : 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) n_add[e] = fmaf(f[e], wv, n_add[e]);
        }
        // sum the 8 columns over the 16 lanes of this half-warp by halving:
        // at xor 8, 4, 2 a lane keeps half of its values (those its lane bit
        // selects) plus its partner's, so after xor 1 lane l holds column
        // 4 (l & 8) / 8 + 2 (l & 4) / 4 + (l & 2) / 2 (8 shuffles, not 32)
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
          n_part[ch * 8 + ((tg >> 3) & 1) * 4 + ((tg >> 2) & 1) * 2 + ((tg >> 1) & 1)] =
              n_add[0];
      }
      {
        const int t = wt >> 1, c0 = (wt & 1) * 4;
        float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ch = c0; ch < c0 + 4; ++ch) {
          float f[8];
          Pack<bf16>::unpack(*reinterpret_cast<const uint4*>(qs_p + sm90::swizzle128(t, ch)), f);
          const float4* nn = reinterpret_cast<const float4*>(n_s + e0 + ch * 8);
          const float4 n0 = nn[0], n1 = nn[1];
          a4[0] = fmaf(f[0], n0.x, fmaf(f[4], n1.x, a4[0]));
          a4[1] = fmaf(f[1], n0.y, fmaf(f[5], n1.y, a4[1]));
          a4[2] = fmaf(f[2], n0.z, fmaf(f[6], n1.z, a4[2]));
          a4[3] = fmaf(f[3], n0.w, fmaf(f[7], n1.w, a4[3]));
        }
        float x = (a4[0] + a4[1]) + (a4[2] + a4[3]);
        qn += x + __shfl_xor_sync(0xffffffffu, x, 1);
      }
      sm90::wgmma_wait0();
      sm90::fence_regs(qc);
      wg_bar(wg);  // q and k are read: q's tile takes the lo half of k o w

      scale_rows(ks_p, qs_p, w, Lc, wt);
      if (wt < 64) n_s[e0 + wt] = fmaf(decay, n_s[e0 + wt], n_part[wt]);
      sm90::fence_proxy_async();
      wg_bar(wg);

      // C = decay C + (k o w)^T v (M = e, N = f, K = t; A M-major through
      // the transpose bit), over the pair: hi in k's tile, lo in q's
#pragma unroll
      for (int i = 0; i < 16; ++i) C[j][i] *= decay;
      sm90::fence_regs(C[j]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          sm90::wgmma_ss<32, 1, 0>(C[j], sm90::desc128((half ? qs : ks) + kk * 2048, 1024, 1024),
                                   sm90::desc128(vta + kk * 32, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(C[j]);
    }

    // the partial sums of q C and q n to shared memory (warpgroup 0 keeps
    // its q C); warpgroup 0 then writes h
    if (wg > 0)
#pragma unroll
      for (int i = 0; i < 16; ++i) red[(wg - 1) * 64 * kCols + acc_row(i) * kCols + acc_col(i)] = qc[i];
    if ((wt & 1) == 0) qn_s[wg * 64 + (wt >> 1)] = qn;
    sm90::cp_async_wait<0>();  // this chunk's att (warpgroup 0 reads it next)
    __syncthreads();
    if (wg == 0) {
      float num[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = acc_row(i);
        float x = qc[i];
        for (int p = 1; p < NWG; ++p) x += red[(p - 1) * 64 * kCols + r * kCols + acc_col(i)];
        num[i] = inter[r] * (scale * x);
      }
      // + att v: att from the record as a bf16 pair of A fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
        a_frags(kk, hi, lo, [&](int r, int t) { return (r < L && t < L) ? att[r * L + t] : 0.f; });
        sm90::fence_regs(num);
        sm90::wgmma_fence();
        sm90::wgmma_rs<32, 0>(num, hi, sm90::desc128(sm_a + Lay::kVt + kk * 32, 16, 1024));
        sm90::wgmma_rs<32, 0>(num, lo, sm90::desc128(sm_a + Lay::kVt + kk * 32, 16, 1024));
        sm90::wgmma_commit();
        sm90::wgmma_wait0();
        sm90::fence_regs(num);
      }
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = acc_row(i);
        if (r >= Lc) continue;
        float x = 0.f;
        for (int p = 0; p < NWG; ++p) x += qn_s[p * 64 + r];
        const float den = rowsum[r] + inter[r] * (scale * x);
        const float inv = 1.f / fmaxf(fabsf(den), expf(-mn[r]));
        *reinterpret_cast<__nv_bfloat162*>(
            h_out + ((size_t)b * S + t0 + r) * vrs + (size_t)hh * dv + f0 + acc_col(i)) =
            __floats2bfloat162_rn(num[i] * inv, num[i + 1] * inv);
      }
    }
  }
  sm90::cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int j = 0; j < MT; ++j) {
    if (j >= my_tiles) continue;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int e = (wg * MT + j) * 64 + acc_row(i);
      if (e < dh)
        *reinterpret_cast<float2*>(C_out + cbase + (size_t)e * dv + f0 + acc_col(i)) =
            make_float2(C[j][i], C[j][i + 1]);
    }
  }
  __syncthreads();
  if (blockIdx.y == 0)
    for (int e = tid; e < dh; e += kT) n_out[(size_t)bh * dh + e] = n_s[e];
}

// No state, one chunk (S <= L): one block per (b * H + h, 64 columns of C,
// kBootE e-tiles) writes those tiles of C', and one more per (b * H + h,
// 64 columns), beside them, that block's columns of h (blockIdx.z = the
// e-groups' count).
constexpr int kBootF = 64;  // columns of C per block
constexpr int kBootE = 4;   // e-tiles (64 rows of C) per block
constexpr int kBootStages = 3;  // three boot blocks an SM: the grid is one wave
constexpr int kBootSmem = 1024 + kBootStages * 2 * kTile + kBootF * 128;

__global__ void __launch_bounds__(kTcThreads)
    boot_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const float* __restrict__ log_i, const float* __restrict__ log_f,
            bf16* __restrict__ h_out, float* __restrict__ C_out, float* __restrict__ n_out,
            float* __restrict__ m_out, int S, int H, int dh, int dv, float scale) {
  __shared__ GateSmem<kTcThreads> g;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sm_a = sm90::smem_addr(sm);
  uint8_t* vt = sm + kBootStages * 2 * kTile;  // v^T [64 f][64 t]
  const uint32_t vta = sm_a + kBootStages * 2 * kTile;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int f0 = blockIdx.y * kBootF, eg = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t row_stride = (size_t)H * dh, vrs = (size_t)H * dv;
  const size_t base = (size_t)b * S * row_stride + (size_t)hh * dh;
  const size_t vbase = (size_t)b * S * vrs + (size_t)hh * dv;
  const size_t cbase = (size_t)bh * dh * dv;
  const int ksteps = (S + 15) / 16;  // 16-step slices of K = t
  const int n_et = (dh + 63) / 64;
  const int et0 = eg * kBootE, et1 = min(n_et, et0 + kBootE);
  const bool h_block = eg == (int)gridDim.z - 1;

  chunk_gates<kTcThreads>(log_i, log_f, nullptr, b, hh, H, S, S, 0, g);
  load_vt(vt, v, vbase + f0, vrs, S, kBootF, dv - f0, kTcThreads);
  if (h_block) {
    // h of this block's columns: att v / max(|rowsum(att)|, exp(-m_new))
    float s[32], rs[2];
    scores_tc_loop<kBootStages>(s, sm_a, q, k, base, row_stride, S, dh);  // v^T is visible after
    gate_scores(s, rs, g, S, scale);
    // att v, att's A fragments straight from s as a bf16 pair: the
    // accumulator layout of columns 16 kk .. 16 kk + 15 is s[8 kk .. 8 kk + 7]
    // (as the flash kernel's P)
    float num[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) num[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) split_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1], hi[x], lo[x]);
      sm90::fence_regs(num);
      sm90::wgmma_fence();
      sm90::wgmma_rs<64, 0>(num, hi, sm90::desc128(vta + kk * 32, 16, 1024));
      sm90::wgmma_rs<64, 0>(num, lo, sm90::desc128(vta + kk * 32, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(num);
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = acc_row(i), f = f0 + acc_col(i);
      if (r >= S || f >= dv) continue;
      const float inv = 1.f / fmaxf(fabsf(rs[(i >> 1) & 1]), expf(-g.mn[r]));
      *reinterpret_cast<__nv_bfloat162*>(h_out + vbase + (size_t)r * vrs + f) =
          __floats2bfloat162_rn(num[i] * inv, num[i + 1] * inv);
    }
    if (blockIdx.y == 0 && tid == 0) m_out[bh] = g.mn[S - 1];
    return;
  }
  sm90::fence_proxy_async();  // v^T, before the barrier in the loop

  // C' tiles: (k o w)^T v, k tiles double-buffered through the ring's slots
  auto load_k = [&](int et, int slot) {
    load_tile(sm_a + slot * kTile, k, base + et * 64, row_stride, S, dh - et * 64, tid);
  };
  load_k(et0, 0);
  sm90::cp_async_commit();
  for (int et = et0; et < et1; ++et) {
    const int slot = (et - et0) & 1;
    uint8_t* ks_p = sm + slot * kTile;
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile et landed; tile et - 1's products are done
    if (et + 1 < et1) load_k(et + 1, slot ^ 1);
    sm90::cp_async_commit();
    if (blockIdx.y == 0 && tid < 64 && et * 64 + tid < dh) {  // n' = (k o w)^T 1
      float a = 0.f;
      for (int t = 0; t < S; ++t) a = fmaf(__bfloat162float(*tile_at(ks_p, t, tid)), g.w[t], a);
      n_out[(size_t)bh * dh + et * 64 + tid] = a;
    }
    __syncthreads();
    scale_rows(ks_p, ks_p + 2 * kTile, g.w, S, tid);  // lo in ring tiles 2 and 3
    sm90::fence_proxy_async();
    __syncthreads();
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        sm90::wgmma_ss<64, 1, 0>(
            acc, sm90::desc128(sm_a + (slot + 2 * half) * kTile + kk * 2048, 1024, 1024),
            sm90::desc128(vta + kk * 32, 16, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int e = et * 64 + acc_row(i), f = f0 + acc_col(i);
      if (e < dh && f < dv)
        *reinterpret_cast<float2*>(C_out + cbase + (size_t)e * dv + f) =
            make_float2(acc[i], acc[i + 1]);
    }
  }
  sm90::cp_async_wait<0>();  // no copy may outlive the block
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t prepare(Kernel* kernel, size_t smem, int (&set)[kv_tile::kMaxDevices]) {
  const cudaError_t err = kv_tile::raise_smem_limit(kernel, smem, set);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the next launch must not report it
  return err;
}

int launch_f32(const float* q, const float* k, const float* v, const float* log_i,
               const float* log_f, const float* C0, const float* n0, const float* m0, float* rec,
               float* h, float* C, float* n, float* m, int B, int S, int H, int dh, int dv,
               int L, float scale, cudaStream_t stream) {
  const int n_chunks = (S + L - 1) / L;
  scores_kernel<<<dim3(n_chunks, B * H), kThreads, 0, stream>>>(q, k, log_i, log_f, m0, rec, m,
                                                                 S, H, dh, L, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * recurrent_smem_floats(L, dh);
  static int set[kv_tile::kMaxDevices] = {};
  if ((err = prepare(recurrent_kernel, smem, set)) != cudaSuccess) return (int)err;
  recurrent_kernel<<<dim3(B * H, dv / kCols), kThreads, smem, stream>>>(
      q, k, v, C0, n0, rec, h, C, n, S, H, dh, dv, L, scale);
  return (int)cudaGetLastError();
}

template <int NWG, int MT>
int launch_recurrent_tc(const bf16* q, const bf16* k, const bf16* v, const float* C0,
                        const float* n0, const float* rec, bf16* h, float* C, float* n, int B,
                        int S, int H, int dh, int dv, int L, float scale,
                        cudaStream_t stream) {
  constexpr int smem = RecLayout<NWG, MT>::kBytes;
  static int set[kv_tile::kMaxDevices] = {};
  const cudaError_t err = prepare(recurrent_tc<NWG, MT>, smem, set);
  if (err != cudaSuccess) return (int)err;
  recurrent_tc<NWG, MT><<<dim3(B * H, dv / kCols), 128 * NWG, smem, stream>>>(
      q, k, v, C0, n0, rec, h, C, n, S, H, dh, dv, L, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* log_i,
                const float* log_f, const float* C0, const float* n0, const float* m0,
                float* rec, bf16* h, float* C, float* n, float* m, int B, int S, int H, int dh,
                int dv, int L, float scale, cudaStream_t stream) {
  const int n_et = (dh + 63) / 64;
  cudaError_t err;
  if (C0 == nullptr && S <= L) {  // the boot path: one launch
    static int set[kv_tile::kMaxDevices] = {};
    if ((err = prepare(boot_tc, kBootSmem, set)) != cudaSuccess) return (int)err;
    boot_tc<<<dim3(B * H, (dv + kBootF - 1) / kBootF, (n_et + kBootE - 1) / kBootE + 1),
              kTcThreads, kBootSmem, stream>>>(q, k, v, log_i, log_f, h, C, n, m, S, H, dh, dv,
                                               scale);
    return (int)cudaGetLastError();
  }
  const int n_chunks = (S + L - 1) / L;
  static int set[kv_tile::kMaxDevices] = {};
  if ((err = prepare(scores_tc, kScoresTcSmem, set)) != cudaSuccess) return (int)err;
  scores_tc<<<dim3(n_chunks, B * H), kTcThreads, kScoresTcSmem, stream>>>(
      q, k, log_i, log_f, m0, rec, m, S, H, dh, L, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // warpgroups x e-tiles each: ops.py plan mirrors this choice
  if (n_et <= 1) return launch_recurrent_tc<1, 1>(q, k, v, C0, n0, rec, h, C, n, B, S, H, dh, dv, L, scale, stream);
  if (n_et <= 2) return launch_recurrent_tc<2, 1>(q, k, v, C0, n0, rec, h, C, n, B, S, H, dh, dv, L, scale, stream);
  if (n_et <= 4) return launch_recurrent_tc<4, 1>(q, k, v, C0, n0, rec, h, C, n, B, S, H, dh, dv, L, scale, stream);
  if (n_et <= 8) return launch_recurrent_tc<4, 2>(q, k, v, C0, n0, rec, h, C, n, B, S, H, dh, dv, L, scale, stream);
  if (n_et <= 12) return launch_recurrent_tc<4, 3>(q, k, v, C0, n0, rec, h, C, n, B, S, H, dh, dv, L, scale, stream);
  if (n_et <= 16) return launch_recurrent_tc<4, 4>(q, k, v, C0, n0, rec, h, C, n, B, S, H, dh, dv, L, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k (B, S, H, dh); v (B, S, H, dv); log_i, log_f (B, S, H) float32; C0
// (B, H, dh, dv), n0 (B, H, dh), m0 (B, H) float32, all null for a new
// stream (C = n = 0, m = -1e30); rec (B * H, n_chunks, L * L + 4 L) float32
// scratch (unused, and may be null, on the bf16 boot path: bf16, no state,
// S <= L); h (B, S, H, dv); C, n, m the final state, float32.  dv <= dh: a
// tensor-parallel rank's value columns of every head (v, h and C's
// columns), q and k whole; the column blocks just number dv / 32.  L: chunk
// length (<= 64); scale multiplies q.  dtype 0 = float32 (scalar bodies),
// 1 = bfloat16 (tensor cores).  The wrapper guarantees contiguous
// 16-byte-aligned inputs, dh and dv multiples of 32 and at most 1024, and
// the shared memory within the card's 227 KB.  Returns cudaGetLastError() after the
// launches (0 = success).
extern "C" int mlstm(const void* q, const void* k, const void* v, const void* log_i,
                     const void* log_f, const void* C0, const void* n0, const void* m0,
                     void* rec, void* h, void* C, void* n, void* m, int B, int S, int H, int dh,
                     int dv, int L, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(log_i);
  const float* lf = static_cast<const float*>(log_f);
  const float* c0 = static_cast<const float*>(C0);
  const float* nn0 = static_cast<const float*>(n0);
  const float* mm0 = static_cast<const float*>(m0);
  float* r = static_cast<float*>(rec);
  float* Cf = static_cast<float*>(C);
  float* nf = static_cast<float*>(n);
  float* mf = static_cast<float*>(m);
  if (dtype == 1)
    return launch_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), li, lf, c0, nn0, mm0, r,
                       static_cast<bf16*>(h), Cf, nf, mf, B, S, H, dh, dv, L, scale, s);
  return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), li, lf, c0, nn0, mm0, r,
                    static_cast<float*>(h), Cf, nf, mf, B, S, H, dh, dv, L, scale, s);
}
