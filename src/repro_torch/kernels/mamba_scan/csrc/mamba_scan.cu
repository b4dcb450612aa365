// Chunked SSD scan (Mamba) for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel mamba_scan_pallas
// (src/repro/kernels/mamba_scan/kernel.py, body _mamba_kernel, launched at
// kernel.py:63).  Per (batch row b, head h), over chunks of L steps:
//   lcum  = inclusive cumsum of loga within the chunk
//   att   = tril(C B^T o exp(lcum_s - lcum_t))                    (L, L)
//   y     = att xbar + exp(lcum) o (C h)                           (L, P)
//   h'    = exp(lcum_L) h + B^T (xbar o exp(lcum_L - lcum))        (N, P)
// carrying h (N, P) in float32 from h0 across the chunks in order.  B and C
// (L, N) are shared by all heads, as in the model.  Every kernel reads the
// model's layouts directly, xbar (B, S, H, P), loga (B, S, H), B and C
// (B, S, N), so the wrapper neither transposes nor pads: the ragged last
// chunk is masked here (padded steps have loga = 0 and xbar = 0, so the
// state is unaffected, as in the reference's zero padding).
//
// The TPU kernel walks the chunks as a sequential grid axis with the state
// in an output block.  On Hopper the chunks run in parallel, in SSD's
// chunk decomposition, over units of work (b * H + h, chunk, column group
// of P):
//   1. chunk states: a chunk's own state S_c = (B o w)^T xbar, w =
//      exp(lcum_L - lcum), and its decay a_c = exp(lcum_L), into float32
//      scratch;
//   2. state passing (one block per (b * H + h, 1024 floats of the state)):
//      h_c = a_c h_{c-1} + S_c from h0, serial over the chunks but only N P
//      floats a (b, h) (2,048 at jamba's width); it writes each chunk's
//      entering state h_{c-1}, rounded to bf16, and the final state;
//   3. chunk outputs: y = att xbar + (C o exp(lcum)) h_{c-1}.
// Three launches a call.  With no start state and one chunk (S <= L: every
// boot prefill of the serving path) there is no state to pass: one launch
// (the boot path) takes y = att xbar and h' = S_0.  A chunk launch runs at
// most two blocks an SM (launch bounds; two stages of copies in shared
// memory), each walking an equal share of the units with the next unit's
// copies in flight while it computes; a unit is all of P, or one 64-column
// group where there would be fewer than 264 units.  At B = 1, S = 2048,
// H = 64, L = 128: 1,024 units on 256 blocks of 256 threads (two
// warpgroups), 109,056 bytes of shared memory each; the boot at S = 8: 128
// units (64 heads x 2 column groups) on 128 blocks of 128 threads.  Each
// unit recomputes its chunk's C B^T for its head: K = N = 16 makes it one
// wgmma a 64 x 64 tile, cheaper than a pass that writes it and a load
// that reads it back.
//
// bfloat16 (the serving dtype): the products on the tensor cores (wgmma,
// sm90.cuh), bf16 operands and f32 accumulators.  A unit copies its
// chunk's xbar columns (L rows x 64 columns a group, 128-byte swizzled),
// C and B side by side in one swizzled tile (C in columns 0..15, B in
// 16..31: K = N padded to 16 with zeros) and, for the outputs, the bf16
// entering state (rows n, MN-major), by 16-byte cp.async; loga and its row
// of B by plain loads into registers a unit ahead.  The in-chunk cumsum
// runs as warp scans in registers.  Warpgroup w owns rows 64 w .. 64 w +
// 63 of the chunk:
//   * C B^T: M = 64 rows s, N = 64 columns t a wgmma (only t < 64 (w + 1):
//     the rest is above the diagonal), K = 16, both operands K-major;
//   * att = that o exp(lcum_s - lcum_t) (by the SFU's exp2: att is rounded
//     to bf16 next), masked, rounded to bf16 where the plain version rounds
//     it (ref.py, att.to(xb.dtype)), as the register A operand of att xbar
//     (M = s, N = 64 columns p, K = t; xbar the MN-major B operand through
//     the transpose bit);
//   * (C o exp(lcum)) h_{c-1}: A from registers, K = 16, the entering state
//     the MN-major B operand, into the same accumulator; y then goes
//     through the unit's xbar tile (free once every warpgroup's products are
//     done) to 16-byte stores of whole row pieces;
//   * the chunk's state S_c = (B o w)^T xbar: M = 64 rows n (N real), N = 64
//     columns p, K = t; step t's thread writes column t of (B o w)^T into a
//     K-major tile whose rows past 15 are never written (they feed only
//     output rows past N, which are not stored); warpgroup w takes column
//     group w.
// B o w, C o exp(lcum) and the entering state are rounded to bf16 once:
// att's own rounding dominates the error (tests/test_torch_kernel_plans.py
// holds the split with these roundings at jamba's width within the bf16
// tolerance); the state passes in float32.  The cumsum's order (a scan,
// not one running sum) moves the decays by a few ulp of float32, far
// inside the bf16 tolerance; the float32 kernel keeps the serial order.
// float32: the scalar kernel below (one block per (b, h, column block)
// walks the chunks with the state in shared memory, products as scalar
// FMAs), for the float32 parity paths only: their gates hold y and h at
// 2e-5, which bf16 operands (or TF32) cannot meet.
//
// What bounds it on this card: at the full-width prefill shape (S = 2048,
// H = 64, P = 128, N = 16, L = 128) the function moves ~69 MB and does
// ~5.9 GFLOP, ~86 FLOP/byte: bytes bound (~21 us at 3.35 TB/s).  The
// decomposition reads xbar twice (launches 1 and 3) and moves the chunk
// states through device memory (~12 MB), ~100 MB in all; what holds the
// chunk launches below that is each unit's chain of copies, barriers and
// stores (y went out as 4-byte stores of the accumulators at first, which
// cost more than the rest of the outputs launch; it now goes through
// shared memory; scripts/scan_kernels.py times each launch).  It is CUDA
// rather than
// Triton because its work is matrix products chained through a
// sequential carry.  Built without fast math.
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

// ---------------------------------------------------------------------------
// float32: the scalar kernel
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kRows = 4;  // output rows a thread holds in registers

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_kernel(
    const T* __restrict__ xbar, const float* __restrict__ loga, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_out, float* __restrict__ st, float* __restrict__ dec, int S, int H,
    int P, int N, int L, int PB) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int c0 = blockIdx.y * PB;    // this block's columns [c0, c0 + PB) of P
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  const int ldb = N + 1;             // padded B rows: att reads B down a column
  float* la = smem;                  // [L] loga of the chunk, 0 past its end
  float* lc = la + L;                // [L] inclusive cumsum
  float* w = lc + L;                 // [L] exp(lc[L-1] - lc[t])
  float* bs = w + L;                 // [L][N + 1]
  float* cs = bs + L * ldb;          // [L][N]
  float* xs = cs + L * N;            // [L][PB]
  float* att = xs + L * PB;          // [L][L]
  float* hs = att + L * L;           // [N][PB] the carried state

  const size_t hbase = (size_t)blockIdx.x * N * P + c0;
  for (int i = tid; i < N * PB; i += kThreads) {
    const int n = i / PB, p = i - n * PB;
    hs[i] = h0 ? h0[hbase + (size_t)n * P + p] : 0.f;
  }

  const int n_chunks = (S + L - 1) / L;
  const int col = tid % PB;          // this thread's column of y and h
  const int row0 = tid / PB;         // and its first row; rows step by rstep
  const int rstep = kThreads / PB;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int Lc = min(L, S - t0);   // real steps in this chunk
    __syncthreads();                 // the previous chunk is done with smem
    for (int t = tid; t < L; t += kThreads)
      la[t] = t < Lc ? loga[((size_t)b * S + t0 + t) * H + h] : 0.f;
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const size_t g = ((size_t)b * S + t0 + t) * N + n;
      bs[t * ldb + n] = t < Lc ? to_float(Bm[g]) : 0.f;
      cs[i] = t < Lc ? to_float(Cm[g]) : 0.f;
    }
    for (int i = tid; i < L * PB; i += kThreads) {
      const int t = i / PB, p = i - t * PB;
      xs[i] = t < Lc ? to_float(xbar[(((size_t)b * S + t0 + t) * H + h) * P + c0 + p]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                  // lc = cumsum(la): one serial pass, the
      float x = 0.f;                 // order of the plain version's cumsum, so
      for (int t = 0; t < L; ++t) {  // the decays exp(lc_s - lc_t) agree with it
        x += la[t];                  // to the rounding of expf (<= 128 adds)
        lc[t] = x;
      }
    }
    __syncthreads();
    const float l_last = lc[L - 1];
    for (int t = tid; t < L; t += kThreads) w[t] = expf(l_last - lc[t]);
    for (int i = tid; i < L * L; i += kThreads) {  // att = tril(C B^T o decay)
      const int s = i / L, t = i - s * L;
      float a = 0.f;
      if (t <= s && s < Lc) {
        const float* cr = cs + s * N;
        const float* br = bs + t * ldb;
        for (int n = 0; n < N; ++n) a = fmaf(cr[n], br[n], a);
        a *= expf(lc[s] - lc[t]);
      }
      att[i] = a;
    }
    __syncthreads();
    // y = att xbar + exp(lc) o (C h): kRows rows of one column per thread
    for (int s0 = row0; s0 < Lc; s0 += kRows * rstep) {
      float acc[kRows] = {};
      int rows[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) rows[r] = min(s0 + r * rstep, L - 1);
      const int t_end = min(s0 + (kRows - 1) * rstep, Lc - 1);  // att is 0 past the diagonal
      for (int t = 0; t <= t_end; ++t) {
        const float x = xs[t * PB + col];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(att[rows[r] * L + t], x, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int s = s0 + r * rstep;
        if (s >= Lc) break;
        float ch = 0.f;
        for (int n = 0; n < N; ++n) ch = fmaf(cs[s * N + n], hs[n * PB + col], ch);
        store(y + (((size_t)b * S + t0 + s) * H + h) * P + c0 + col, acc[r] + expf(lc[s]) * ch);
      }
    }
    __syncthreads();                 // every y read the old state
    // h' = exp(l_last) h + B^T (xbar o w): each thread owns its (n, col);
    // for the backward (st non-null) the chunk's own state and its decay,
    // in the tensor-core path's scratch layout
    const float decay = expf(l_last);
    for (int n = row0; n < N; n += rstep) {
      float a = 0.f;
      for (int t = 0; t < Lc; ++t) a = fmaf(bs[t * ldb + n], xs[t * PB + col] * w[t], a);
      if (st) st[(((size_t)blockIdx.x * n_chunks + c) * N + n) * P + c0 + col] = a;
      hs[n * PB + col] = fmaf(decay, hs[n * PB + col], a);
    }
    if (st && tid == 0 && blockIdx.y == 0) dec[(size_t)blockIdx.x * n_chunks + c] = decay;
  }
  __syncthreads();
  for (int i = tid; i < N * PB; i += kThreads) {
    const int n = i / PB, p = i - n * PB;
    h_out[hbase + (size_t)n * P + p] = hs[i];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels
// ---------------------------------------------------------------------------
constexpr int kMaxL = 128;        // longest chunk
constexpr int kMaxN = 16;         // widest state: K of C B^T and of C h
constexpr int kSplitBelow = 264;  // chunk units under which a unit is one
                                  // column group of 64, not all of P
constexpr int kBlocksPerSm = 2;   // resident chunk blocks an SM (launch bounds)
constexpr int kPassBatch = 8;     // chunks whose states the pass loads at once
enum Mode { kBoot = 0, kStates = 1, kOutputs = 2 };

// Shared memory of chunk_tc, byte offsets from a 1024-aligned base (ops.py
// plan mirrors kBytes): two stages, each the entering state (kOutputs) or
// (B o w)^T (kStates, kBoot), two 64-column blocks of 16 rows x 128 bytes;
// xbar as two 64-column blocks of kR rows x 128 bytes; the C | B tile (kR
// rows of 128 bytes: C in columns 0..15, B in 16..31); then float32
// lc log2(e), w and exp(lcum), kR each.
template <int NWG>
struct TcLayout {
  static constexpr int kR = 64 * NWG;  // rows (steps) of the tiles
  static constexpr int kH = 0;
  static constexpr int kX = kH + 2 * kMaxN * 128;
  static constexpr int kBC = kX + 2 * kR * 128;
  static constexpr int kStage = kBC + kR * 128;
  static constexpr int kVec = 2 * kStage;
  static constexpr int kBytes = 1024 + kVec + 3 * kR * 4;  // + alignment slack
};

using tc_tile::acc_col;
using tc_tile::acc_row;
using tc_tile::aligned_smem;
using tc_tile::frag_col;
using tc_tile::frag_row;
using tc_tile::kLog2e;
using tc_tile::tile_at;

// A unit of work: chunk c of row bh = b * H + h, columns [p0, p0 + 64 NCB).
struct Unit {
  int c, bh, p0, Lc;
  size_t row0;  // the chunk's first step in (B, S)
};

// One block walks units blockIdx.x, blockIdx.x + gridDim.x, ... (units in
// order of (b * H + h, chunk, column group)), NWG warpgroups of 64 chunk
// rows (see the head of the file), with the next unit's copies in flight
// in the other stage while it computes.  MODE kBoot: y and the state of
// the only chunk (into st = h_out); kStates: the chunk's state into st
// (scratch (B * H, n_chunks, N, P)) and its decay into dec; kOutputs: y
// from the entering state hin (bf16 scratch like st).
template <int NWG, int MODE, int NCB>
__global__ void __launch_bounds__(128 * NWG, kBlocksPerSm) chunk_tc(
    const bf16* __restrict__ xbar, const float* __restrict__ loga, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ hin, bf16* __restrict__ y,
    float* __restrict__ st, float* __restrict__ dec, int S, int H, int P, int N, int L,
    int n_chunks, int groups, int n_units) {
  using Lay = TcLayout<NWG>;
  constexpr int kT = 128 * NWG, kR = Lay::kR;
  constexpr int kPerRow = NCB * 8;          // 16-byte pieces of a row of the group
  constexpr int kRowStep = kT / kPerRow;    // rows between a thread's pieces
  const int tid = threadIdx.x, wg = tid >> 7;
  const int my_ch = tid % kPerRow, my_r = tid / kPerRow;  // this thread's piece
  const size_t HP = (size_t)H * P;          // a step's stride in xbar and y

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sm_a = sm90::smem_addr(sm);
  float* l2 = reinterpret_cast<float*>(sm + Lay::kVec);  // lc log2(e)
  float* w = l2 + kR;   // exp(l_last - lc[t]), 0 past the chunk
  float* e = w + kR;    // exp(lc[t])
  __shared__ float warp_sums[kMaxL / 32];

  // a unit's copies into stage stg: xbar's columns of its group, C | B and
  // (kOutputs) the entering state, zeros past the chunk, P and N.  A thread
  // copies piece my_ch of rows my_r, my_r + kRowStep, ... (same swizzle)
  auto issue = [&](const Unit& t, int stg) {
    const uint32_t base = sm_a + stg * Lay::kStage;
    const int col = t.p0 + my_ch * 8;
    const uint32_t xdst = base + Lay::kX + (my_ch >> 3) * (kR * 128) +
                          sm90::swizzle128(my_r, my_ch & 7);
    const bf16* xsrc = xbar + (t.row0 * H + t.bh % H) * P + col + my_r * HP;
#pragma unroll
    for (int j = 0; j < kR / kRowStep; ++j) {
      const bool ok = my_r + j * kRowStep < t.Lc && col < P;
      sm90::cp_async16(xdst + j * kRowStep * 128, ok ? xsrc + j * kRowStep * HP : xbar, ok);
    }
#pragma unroll
    for (int j = 0; j < kR * 4 / kT; ++j) {
      const int i = tid + j * kT, r = i >> 2, ch = i & 3, half = ch & 1;
      const bf16* src = ch < 2 ? Cm : Bm;
      const bool ok = r < t.Lc && half * 8 < N;
      sm90::cp_async16(base + Lay::kBC + sm90::swizzle128(r, ch),
                       ok ? src + (t.row0 + r) * N + half * 8 : src, ok);
    }
    if constexpr (MODE == kOutputs) {
      const bf16* hs = hin + ((size_t)t.bh * n_chunks + t.c) * N * P + col;
#pragma unroll
      for (int j = 0; j < (kMaxN + kRowStep - 1) / kRowStep; ++j) {
        const int n = my_r + j * kRowStep;
        const bool ok = n < N && col < P;
        if (n < kMaxN)
          sm90::cp_async16(base + Lay::kH + (my_ch >> 3) * (kMaxN * 128) +
                               sm90::swizzle128(n, my_ch & 7),
                           ok ? hs + (size_t)n * P : hin, ok);
      }
    }
    sm90::cp_async_commit();
  };
  auto make_unit = [&](int u) {  // units in order of (bh, chunk, column group)
    Unit t;
    t.p0 = (u % groups) * NCB * 64;
    t.c = (u / groups) % n_chunks;
    t.bh = u / groups / n_chunks;
    t.Lc = min(L, S - t.c * L);
    t.row0 = (size_t)(t.bh / H) * S + (size_t)t.c * L;
    return t;
  };
  auto load_loga = [&](const Unit& t) {
    return tid < t.Lc ? loga[(t.row0 + tid) * H + t.bh % H] : 0.f;
  };
  // step tid's row of B (N <= 16 bf16), for (B o w)^T (kStates, kBoot)
  auto load_b = [&](const Unit& t, uint4 (&bv)[2]) {
    if constexpr (MODE != kOutputs) {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      const uint4* src = reinterpret_cast<const uint4*>(Bm + (t.row0 + tid) * N);
      bv[0] = tid < t.Lc ? src[0] : z;
      bv[1] = tid < t.Lc && N > 8 ? src[1] : z;
    }
  };

  int u = blockIdx.x;
  Unit cur = make_unit(min(u, n_units - 1));
  float la = 0.f;
  uint4 bv[2];
  if (u < n_units) {
    issue(cur, 0);
    la = load_loga(cur);
    load_b(cur, bv);
  }
  for (int it = 0; u < n_units; ++it, u += gridDim.x) {
    const int stg = it & 1;
    const uint32_t base_a = sm_a + stg * Lay::kStage;
    uint8_t* bc = sm + stg * Lay::kStage + Lay::kBC;
    const Unit nxt = make_unit(min(u + (int)gridDim.x, n_units - 1));
    const bool more = u + (int)gridDim.x < n_units;
    if (more) issue(nxt, stg ^ 1);  // the other stage's last reader finished
    else sm90::cp_async_commit();  // an empty group: the wait below stays uniform
    const int c = cur.c, bh = cur.bh, hh = bh % H, p0 = cur.p0, Lc = cur.Lc;
    const size_t row0 = cur.row0;

    // lc = inclusive cumsum of loga over the chunk, in registers: a warp's
    // scan of its 32 steps, then the totals of the warps before it
    const float la_cur = la;
    la = more ? load_loga(nxt) : 0.f;  // in flight during this unit
    uint4 b_cur[2] = {bv[0], bv[1]};
    if (more) load_b(nxt, bv);
    float l_last;  // the chunk's total: zeros past its steps
    const float x = tc_tile::chunk_cumsum<kR>(la_cur, warp_sums, l_last);
    if (tid < kR) {
      const float wt = tid < Lc ? expf(l_last - x) : 0.f;
      w[tid] = wt;
      e[tid] = expf(x);
      l2[tid] = x * kLog2e;  // att's decays by exp2 (att is rounded to bf16)
      if constexpr (MODE != kOutputs) {
        // column t = tid of (B o w)^T, rows n < N, into this stage's state
        // tile (K-major A of the state product; its rows past 15 are never
        // written, and feed only output rows past N)
        uint8_t* bt = sm + stg * Lay::kStage + Lay::kH + (tid >> 6) * (kMaxN * 128);
        const bf16* b16 = reinterpret_cast<const bf16*>(b_cur);
#pragma unroll
        for (int n = 0; n < kMaxN; ++n)
          if (n < N) *tile_at(bt, n, tid & 63) = __float2bfloat16(__bfloat162float(b16[n]) * wt);
      }
    }
    if (MODE == kStates && tid == 0 && p0 == 0) dec[(size_t)bh * n_chunks + c] = expf(l_last);
    sm90::cp_async_wait<1>();  // this unit's copies (the next unit's may fly)
    sm90::fence_proxy_async();
    __syncthreads();

    const int r0 = 64 * wg;  // this warpgroup's first row s (or n) of the chunk
    if constexpr (MODE != kOutputs) {
      // S_c = (B o w)^T xbar: rows n (N real), K = t, A = (B o w)^T K-major
      // from the state tile (k-step kk: block kk / 4, 32 bytes a step);
      // warpgroup wg takes the column blocks cb with cb % NWG == wg
      float* stbase = st + ((MODE == kBoot ? (size_t)bh : (size_t)bh * n_chunks + c) * N) * P;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        if (cb % NWG != wg) continue;  // warpgroup-uniform
        float s2[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s2[i] = 0.f;
        sm90::fence_regs(s2);
        sm90::wgmma_fence();
        const uint32_t xs = base_a + Lay::kX + cb * (kR * 128);
#pragma unroll
        for (int kk = 0; kk < 4 * NWG; ++kk)
          if (16 * kk < Lc)
            sm90::wgmma_ss<64, 0, 1>(
                s2, sm90::desc128(base_a + Lay::kH + (kk >> 2) * (kMaxN * 128) + (kk & 3) * 32, 16,
                                  1024),
                sm90::desc128(xs + kk * 2048, 1024, 1024));
        sm90::wgmma_commit();
        sm90::wgmma_wait0();
        sm90::fence_regs(s2);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int n = acc_row(i), col = p0 + cb * 64 + acc_col(i);
          if (n < N && col < P)
            *reinterpret_cast<float2*>(stbase + (size_t)n * P + col) = make_float2(s2[i], s2[i + 1]);
        }
      }
    }
    if constexpr (MODE != kStates) {
      // C B^T: this warpgroup's 64 rows s against columns t < 64 (wg + 1)
      float sc[NWG][32];
#pragma unroll
      for (int nb = 0; nb < NWG; ++nb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[nb][i] = 0.f;
        sm90::fence_regs(sc[nb]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < NWG; ++nb)
        if (nb <= wg)
          sm90::wgmma_ss<64, 0, 0>(sc[nb], sm90::desc128(base_a + Lay::kBC + r0 * 128, 16, 1024),
                                   sm90::desc128(base_a + Lay::kBC + nb * 64 * 128 + 32, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      // att = C B^T o exp(lc_s - lc_t), masked, as bf16 A fragments: columns
      // 16 kk .. 16 kk + 15 are sc[kk / 4][8 (kk % 4) .. 8 (kk % 4) + 7]
      uint32_t pa[4 * NWG][4];
#pragma unroll
      for (int nb = 0; nb < NWG; ++nb) {
        sm90::fence_regs(sc[nb]);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int s = r0 + acc_row(i), t = nb * 64 + acc_col(i);
          sc[nb][i] = (t <= s && s < Lc) ? sc[nb][i] * sm90::fast_exp2(l2[s] - l2[t]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pa[4 * nb + j][q] = sm90::pack_bf16(sc[nb][8 * j + 2 * q], sc[nb][8 * j + 2 * q + 1]);
      }
      // C o exp(lcum) as A fragments (K = 16: C's columns 0..15)
      uint32_t ca[4];
      if constexpr (MODE == kOutputs) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = r0 + frag_row(q), n = frag_col(0, q);
          ca[q] = sm90::pack_bf16(__bfloat162float(*tile_at(bc, s, n)) * e[s],
                                  __bfloat162float(*tile_at(bc, s, n + 1)) * e[s]);
        }
      }
      float acc[NCB][32];
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
        sm90::fence_regs(acc[cb]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        const uint32_t xs = base_a + Lay::kX + cb * (kR * 128);
        if constexpr (MODE == kOutputs)
          sm90::wgmma_rs<64, 1>(acc[cb], ca,
                                sm90::desc128(base_a + Lay::kH + cb * (kMaxN * 128), 1024, 1024));
        // att xbar over t < 64 (wg + 1): xbar MN-major, 16 steps (2048 bytes) a k-step
#pragma unroll
        for (int kk = 0; kk < 4 * NWG; ++kk)
          if (kk < 4 * (wg + 1) && 16 * kk < Lc)
            sm90::wgmma_rs<64, 1>(acc[cb], pa[kk], sm90::desc128(xs + kk * 2048, 1024, 1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      // y through this stage's xbar tile (every warpgroup is done reading
      // it after the barrier), then 16-byte stores of whole row pieces
      __syncthreads();
      uint8_t* ys = sm + stg * Lay::kStage + Lay::kX;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        sm90::fence_regs(acc[cb]);
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          *reinterpret_cast<uint32_t*>(tile_at(ys + cb * (kR * 128), r0 + acc_row(i), acc_col(i))) =
              sm90::pack_bf16(acc[cb][i], acc[cb][i + 1]);
      }
      __syncthreads();
      const int col = p0 + my_ch * 8;
      bf16* ydst = y + (row0 * H + hh) * P + col + my_r * HP;
      const uint8_t* ysrc = ys + (my_ch >> 3) * (kR * 128) + sm90::swizzle128(my_r, my_ch & 7);
#pragma unroll
      for (int j = 0; j < kR / kRowStep; ++j)
        if (my_r + j * kRowStep < Lc && col < P)
          *reinterpret_cast<uint4*>(ydst + j * kRowStep * HP) =
              *reinterpret_cast<const uint4*>(ysrc + j * kRowStep * 128);
    }

    cur = nxt;
    __syncthreads();  // every warp is done with this stage, warp_sums and the vectors
  }
  sm90::cp_async_wait<0>();  // no copy may outlive the block
}

// State passing: one block per (b * H + h, 1024 floats of its N P state),
// a float4 a thread: h_c = a_c h_{c-1} + S_c from h0 (zeros if null),
// writing each chunk's entering state h_{c-1}, rounded to bf16 (the
// operand the chunk outputs' wgmma reads), into hin and the last, float32,
// into h_out.  The loads of kPassBatch chunks are issued before the chain
// uses them.
__global__ void __launch_bounds__(kThreads) pass_states(
    const float* __restrict__ st, const float* __restrict__ dec, const float* __restrict__ h0,
    bf16* __restrict__ hin, float* __restrict__ h_out, int NP, int n_chunks) {
  const int bh = blockIdx.x, i = 4 * (blockIdx.y * kThreads + threadIdx.x);
  if (i >= NP) return;
  float4 h = h0 ? *reinterpret_cast<const float4*>(h0 + (size_t)bh * NP + i)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t base = (size_t)bh * n_chunks * NP + i;
  for (int c0 = 0; c0 < n_chunks; c0 += kPassBatch) {
    float4 s[kPassBatch];
    float a[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c0 + j < n_chunks) {
        s[j] = *reinterpret_cast<const float4*>(st + base + (size_t)(c0 + j) * NP);
        a[j] = dec[(size_t)bh * n_chunks + c0 + j];
      }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c0 + j < n_chunks) {
        *reinterpret_cast<uint2*>(hin + base + (size_t)(c0 + j) * NP) =
            make_uint2(sm90::pack_bf16(h.x, h.y), sm90::pack_bf16(h.z, h.w));
        h = make_float4(fmaf(a[j], h.x, s[j].x), fmaf(a[j], h.y, s[j].y),
                        fmaf(a[j], h.z, s[j].z), fmaf(a[j], h.w, s[j].w));
      }
  }
  *reinterpret_cast<float4*>(h_out + (size_t)bh * NP + i) = h;
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

template <typename T>
int launch_scalar(const void* xbar, const void* loga, const void* Bm, const void* Cm,
                  const void* h0, void* y, void* h_out, float* scratch, int B, int S, int H,
                  int P, int N, int L, int PB, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)3 * L + (size_t)L * (N + 1) + (size_t)L * N +
                                       (size_t)L * PB + (size_t)L * L + (size_t)N * PB);
  static int set[kv_tile::kMaxDevices] = {};
  const cudaError_t err = prepare(scan_kernel<T>, smem, set);
  if (err != cudaSuccess) return (int)err;
  const size_t n_st = (size_t)B * H * ((S + L - 1) / L) * N * P;
  scan_kernel<T><<<dim3(B * H, P / PB), kThreads, smem, stream>>>(
      static_cast<const T*>(xbar), static_cast<const float*>(loga), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), scratch, scratch ? scratch + n_st + n_st / 2 : nullptr, S, H,
      P, N, L, PB);
  return (int)cudaGetLastError();
}

// Streaming multiprocessors of the current device (cached per device).
int sm_count() {
  static int counts[kv_tile::kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kv_tile::kMaxDevices) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    return 132;
  }
  return counts[dev];
}

template <int NWG, int MODE>
int launch_chunks(const bf16* xbar, const float* loga, const bf16* Bm, const bf16* Cm,
                  const bf16* hin, bf16* y, float* st, float* dec, int B, int S, int H, int P,
                  int N, int L, cudaStream_t stream) {
  // units: (b * H + h, chunk, column group), a group all of P, or one
  // 64-column block where there would be fewer than kSplitBelow units;
  // blocks: at most kBlocksPerSm an SM, each walking an equal share of the
  // units (ops.py plan mirrors both)
  const int n_chunks = (S + L - 1) / L, n_cb = (P + 63) / 64;
  const int ncb = (n_cb > 1 && n_chunks * B * H >= kSplitBelow) ? n_cb : 1;
  const int groups = n_cb / ncb;
  const long long units = (long long)n_chunks * B * H * groups;
  const long long cap = (long long)kBlocksPerSm * sm_count();
  const long long per_block = (units + cap - 1) / cap;
  const int blocks = (int)((units + per_block - 1) / per_block);
  constexpr int smem = TcLayout<NWG>::kBytes;
  if (ncb == 2) {
    static int set[kv_tile::kMaxDevices] = {};
    const cudaError_t err = prepare(chunk_tc<NWG, MODE, 2>, smem, set);
    if (err != cudaSuccess) return (int)err;
    chunk_tc<NWG, MODE, 2><<<blocks, 128 * NWG, smem, stream>>>(
        xbar, loga, Bm, Cm, hin, y, st, dec, S, H, P, N, L, n_chunks, groups, (int)units);
  } else {
    static int set[kv_tile::kMaxDevices] = {};
    const cudaError_t err = prepare(chunk_tc<NWG, MODE, 1>, smem, set);
    if (err != cudaSuccess) return (int)err;
    chunk_tc<NWG, MODE, 1><<<blocks, 128 * NWG, smem, stream>>>(
        xbar, loga, Bm, Cm, hin, y, st, dec, S, H, P, N, L, n_chunks, groups, (int)units);
  }
  return (int)cudaGetLastError();
}

template <int NWG>
int launch_tc(const bf16* xbar, const float* loga, const bf16* Bm, const bf16* Cm,
              const float* h0, bf16* y, float* h_out, float* scratch, int B, int S, int H, int P,
              int N, int L, cudaStream_t stream) {
  if (h0 == nullptr && S <= L)  // the boot path: one launch
    return launch_chunks<NWG, kBoot>(xbar, loga, Bm, Cm, nullptr, y, h_out, nullptr, B, S, H, P,
                                     N, L, stream);
  // scratch: the chunk states (f32), the entering states (bf16), the decays
  const int n_chunks = (S + L - 1) / L;
  const size_t n_st = (size_t)B * H * n_chunks * N * P;
  float* st = scratch;
  bf16* hin = reinterpret_cast<bf16*>(st + n_st);
  float* dec = st + n_st + n_st / 2;
  int err = launch_chunks<NWG, kStates>(xbar, loga, Bm, Cm, nullptr, nullptr, st, dec, B, S, H,
                                        P, N, L, stream);
  if (err) return err;
  pass_states<<<dim3(B * H, (N * P + 4 * kThreads - 1) / (4 * kThreads)), kThreads, 0, stream>>>(
      st, dec, h0, hin, h_out, N * P, n_chunks);
  if ((err = (int)cudaGetLastError())) return err;
  return launch_chunks<NWG, kOutputs>(xbar, loga, Bm, Cm, hin, y, nullptr, nullptr, B, S, H, P, N,
                                      L, stream);
}

}  // namespace

// xbar (B, S, H, P); loga (B, S, H) float32; Bm, Cm (B, S, N); h0 (B, H, N,
// P) float32 or null (zeros); y (B, S, H, P); h_out (B, H, N, P) float32;
// scratch: B H n_chunks (3 N P / 2 + 1) floats on the tensor-core path
// with more than one chunk or a start state (else unused, may be null); the
// float32 path writes its chunk states and decays there, in the same
// layout, for the backward, where it is given (it may be null).
// L: chunk length; PB: columns of P per block of the scalar kernel.  dtype
// 0 = float32 (the scalar kernel), 1 = bfloat16 (the tensor-core kernels;
// xbar, Bm, Cm and y share it).  The wrapper guarantees contiguous inputs,
// the tensor-core kernels' shapes (L <= 128, N in {8, 16}, P <= 128 and
// P % 8 == 0, 16-byte aligned xbar, Bm, Cm and h0), PB dividing both P and
// the scalar block's 256 threads, and the shared memory within the card's
// 227 KB.  Returns cudaGetLastError() after the launches (0 = success).
extern "C" int mamba_scan(const void* xbar, const void* loga, const void* Bm, const void* Cm,
                          const void* h0, void* y, void* h_out, void* scratch, int B, int S,
                          int H, int P, int N, int L, int PB, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bf16* x = static_cast<const bf16*>(xbar);
    const float* la = static_cast<const float*>(loga);
    const bf16* bm = static_cast<const bf16*>(Bm);
    const bf16* cm = static_cast<const bf16*>(Cm);
    const float* hh = static_cast<const float*>(h0);
    bf16* yy = static_cast<bf16*>(y);
    float* ho = static_cast<float*>(h_out);
    float* sc = static_cast<float*>(scratch);
    if (L > kMaxL || N > kMaxN) return (int)cudaErrorInvalidValue;
    if (L > 64) return launch_tc<2>(x, la, bm, cm, hh, yy, ho, sc, B, S, H, P, N, L, s);
    return launch_tc<1>(x, la, bm, cm, hh, yy, ho, sc, B, S, H, P, N, L, s);
  }
  return launch_scalar<float>(xbar, loga, Bm, Cm, h0, y, h_out, static_cast<float*>(scratch), B,
                              S, H, P, N, L, PB, s);
}
