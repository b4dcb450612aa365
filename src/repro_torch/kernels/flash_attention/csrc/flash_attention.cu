// Blockwise online-softmax attention for Hopper (sm_90a), bound to Python
// with ctypes.  Two entries share each kernel body:
//   flash_attention        dense q (B, H, S, D) x k, v (B, Hkv, Skv, D), any
//                          strides with unit stride along D (the slot
//                          pool's prefill passes (B, S, H, D) tensors
//                          viewed as (B, H, S, D), with no copy)
//   paged_flash_attention  q (B, Sq, H, D) at positions pos0[b] + i, K/V read
//                          from the arena (P, BLOCK, Hkv, D) through the
//                          page table, with a per-row `active` mask
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, body _attn_kernel, launched
// at kernel.py:83): causal masking that skips key blocks past the query
// block, a sliding window, a logit softcap and GQA.  In the port the paged
// entry carries the serving path's prefill chunks (Sq = 32) and speculative
// verify windows (Sq = spec_k + 1), which the reference computes as a page
// gather plus jnp attention (models/attention.py paged_prefill_attention).
//
// What bounds it on this card: bytes at the serving shapes, operations at
// a long prompt.  A 32-token prefill chunk does 4 * 32 * G = 512 FLOPs per
// K/V element for G = 4 query heads per KV head, a 5-token verify window
// 80: both below the ~295 FLOP/byte where an H100's bf16 tensor cores, not
// HBM, become the limit; a 1024-token causal prompt is above it.  Both
// bodies read each needed K/V tile once per GQA group: one block per (row,
// KV head, query tile) holds all H/Hkv query heads of the group for its
// query tile; the key loop stops at the tile holding the block's last
// query position (causal) and starts at the first tile its window can see;
// a dead row (active == 0) writes zeros and reads nothing.
//
// bfloat16 (the serving dtype), tc_kernel: the products on the tensor
// cores, with wgmma.
//   * A row is one (query head of the group, query index) pair; one
//     warpgroup (128 threads) owns 64 rows, a block one or two warpgroups
//     (a 32-token chunk with G = 4 is 128 rows; at D = 256 one warpgroup,
//     so a thread's registers stay under 255).  Pad rows are masked and
//     never written.
//   * Q goes once into shared memory, K/V tiles of 64 keys (two pages on
//     the paged entry, each page found through the page table) stream
//     through a ring of kStages tiles by 16-byte cp.async, in bf16, in the
//     128-byte-swizzled layout wgmma reads (sm90.cuh), so the next tiles
//     are in flight while one computes.  D is padded with zero columns to
//     64, 128 or 256: zeros add nothing to Q.K^T, and the pad columns of O
//     are never written.
//   * S = Q.K^T by wgmma m64n64k16 (both from shared memory, K-major),
//     f32 in registers; the softmax scale and softcap are applied to S in
//     f32 (scaling Q in bf16 would add a rounding), the causal, window and
//     ragged Sq / Skv masks in registers, each element's (row, key) from
//     the accumulator layout.
//   * The online softmax stays in registers: a row's 64 scores live in 4
//     lanes of a warp, so two shuffles give its max; the running sum stays
//     per thread until the epilogue.
//   * O += P.V by wgmma with P as the register A operand (the accumulator
//     layout of S is the A-fragment layout, cast to bf16) and V from
//     shared memory through the transpose bit, its rows being
//     D-contiguous; O stays in f32 registers, rescaled per row, and the
//     epilogue divides by l and stores bf16.
//   * One barrier per tile: the ring's slot for tile j + kStages - 1 is
//     the one tile j - 1 used.
//
// float32, scalar_kernel: today's scalar body, kept for the float32 parity
// paths only.  Their gates hold a kernel within 2e-5 of its plain version,
// which TF32 tensor cores (about three decimal digits) cannot meet.  Tiles
// of 32 keys move as 16-byte loads, the next one fetched into registers
// while the current one is computed (kv_tile.cuh); Q.K^T and P.V run as
// fp32 FMAs from shared memory in 4x2 and 4x8 register tiles; scores,
// probabilities and the running (m, l, acc) stay in shared memory.
#include "kv_tile.cuh"
#include "sm90.cuh"

namespace {

using kv_tile::kNegInf;
using kv_tile::store;
using kv_tile::to_float;

constexpr int kThreads = 256;  // scalar body
constexpr int kMaxVec = 8;     // a tile of K (or V) for one head: <= 32 KB
constexpr int kBk = 32;        // keys per tile of the scalar body

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* page_table;  // paged: (B, n_pg)
  const int* pos0;        // paged: (B,) position of query 0
  const int* active;      // paged: (B,) or null (all rows live)
  float* lse;             // dense: (B, H, Sq) float32 or null (not written)
  int H, Hkv, D, Sq;
  int Skv;                // dense: key count; paged: n_pg * 32
  int n_pg, P;            // paged: table width, arena pages
  int tq;                 // query indices per block (rows = G * tq)
  int causal, window;     // window <= 0: none
  float softcap, scale;
  long long q_sb, q_ss, q_sh;     // q strides (elements) for batch, query, head
  long long o_sb, o_ss, o_sh;     // o strides
  long long kv_sb, kv_ss, kv_sh;  // dense k / v strides for batch, key, head
};

// row (b, head h, query i) of the dense entry's lse, (B, H, Sq) contiguous
__device__ __forceinline__ long long lse_off(const Args& a, int b, int h, int i) {
  return ((long long)b * a.H + h) * a.Sq + i;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, s))));
}

// ---------------------------------------------------------------------------
// float32: the scalar body
// ---------------------------------------------------------------------------
template <bool PAGED>
__global__ void __launch_bounds__(kThreads) scalar_kernel(Args a) {
  using T = float;
  const int b = blockIdx.x / a.Hkv;
  const int g = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int R = G * a.tq;                             // query rows of the block
  const int R4 = (R + 3) & ~3;                        // padded to the 4-row tiles
  const int D = a.D;
  const int q_lo = blockIdx.y * a.tq;                 // first query index of the tile
  const int q_n = min(a.tq, a.Sq - q_lo);             // real query indices in the tile
  const int tid = threadIdx.x;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  // row r: query head g*G + r / tq, query index q_lo + r % tq
  auto q_off = [&](int r) -> long long {
    return (long long)b * a.q_sb + (long long)(q_lo + r % a.tq) * a.q_ss +
           (long long)(g * G + r / a.tq) * a.q_sh;
  };
  auto o_off = [&](int r) -> long long {
    return (long long)b * a.o_sb + (long long)(q_lo + r % a.tq) * a.o_ss +
           (long long)(g * G + r / a.tq) * a.o_sh;
  };

  if (PAGED && a.active != nullptr && a.active[b] == 0) {
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D;
      if (r % a.tq < q_n) store(o + o_off(r) + (i - r * D), 0.f);
    }
    return;
  }

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = D + 4;              // 16-byte rows, shifted 4 banks per row
  float* q_s = smem;                  // [R4][D] scaled queries (pad rows 0)
  float* k_s = q_s + R4 * D;          // [kBk][D + 4]
  float* v_s = k_s + kBk * ldk;       // [kBk][D]
  float* p_s = v_s + kBk * D;         // [R4][kBk]
  float* acc_s = p_s + R4 * kBk;      // [R4][D]
  float* m_s = acc_s + R4 * D;        // [R]
  float* l_s = m_s + R;               // [R]
  float* a_s = l_s + R;               // [R]

  const int base_pos = PAGED ? a.pos0[b] : 0;
  const int lo_pos = base_pos + q_lo;                 // smallest query position here
  const int hi_pos = base_pos + q_lo + q_n - 1;       // largest
  int t_end = (a.Skv + kBk - 1) / kBk;
  if (a.causal) t_end = min(t_end, hi_pos / kBk + 1);
  const int t_begin = a.window > 0 ? max(0, lo_pos - a.window + 1) / kBk : 0;

  // K/V tile j: rows [j*kBk, j*kBk + rows) of this (row, KV head)
  const long long row_stride = PAGED ? (long long)a.Hkv * D : a.kv_ss;
  auto tile_base = [&](int j) -> long long {
    if (PAGED) {  // a page id past the arena is clamped, as the reference's gather
      const int phys = min(max(a.page_table[(long long)b * a.n_pg + j], 0), a.P - 1);
      return ((long long)phys * kBk * a.Hkv + g) * D;
    }
    return (long long)b * a.kv_sb + (long long)g * a.kv_sh + (long long)j * kBk * a.kv_ss;
  };
  auto tile_rows = [&](int j) { return PAGED ? kBk : min(kBk, a.Skv - j * kBk); };
  kv_tile::TileRegs<kMaxVec> regs;
  if (t_begin < t_end)
    kv_tile::fetch_tile<kMaxVec, kThreads>(regs, kp, vp, tile_base(t_begin), row_stride,
                                           tile_rows(t_begin), D);

  for (int i = tid; i < R4 * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = (r < R && r % a.tq < q_n)
                 ? to_float(q[q_off(r) + (i - r * D)]) * a.scale : 0.f;
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < R; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  const int lane = tid & 31, warp = tid >> 5;
  const int n_dq = D / 8;             // 8-dim column groups of the PV tiles

  for (int j = t_begin; j < t_end; ++j) {
    kv_tile::stash_tile<kMaxVec, kThreads, T>(regs, k_s, ldk, v_s, D, tile_rows(j), kBk, D);
    __syncthreads();
    if (j + 1 < t_end)  // in flight while this tile is computed
      kv_tile::fetch_tile<kMaxVec, kThreads>(regs, kp, vp, tile_base(j + 1), row_stride,
                                             tile_rows(j + 1), D);

    // S = Q K^T: a thread owns rows 4*rb..4*rb+3 and keys kb, kb + 16
    for (int w = tid; w < (R4 / 4) * 16; w += kThreads) {
      const int rb = w >> 4, kb = w & 15;
      float s[4][2] = {};
      for (int d = 0; d < D; d += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(k_s + kb * ldk + d);
        const float4 k1 = *reinterpret_cast<const float4*>(k_s + (kb + 16) * ldk + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + (rb * 4 + i) * D + d);
          s[i][0] = dot4(qv, k0, s[i][0]);
          s[i][1] = dot4(qv, k1, s[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb * 4 + i;
        const int qpos = base_pos + q_lo + r % a.tq;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = kb + 16 * c;
          const int kpos = j * kBk + t;
          float x = s[i][c];
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          bool ok = r < R && r % a.tq < q_n && kpos < a.Skv;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && qpos - kpos < a.window;
          p_s[r * kBk + t] = ok ? x : kNegInf;
        }
      }
    }
    __syncthreads();
    // online softmax: one warp per row, one lane per key
    for (int r = warp; r < R; r += kThreads / 32) {
      const float x = p_s[r * kBk + lane];
      float mx = x;
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(x - m_new);
      p_s[r * kBk + lane] = p;
      float sum = p;
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // O = alpha * O + P V: a thread owns rows 4*rb..4*rb+3 and the dims
    // 4*dq..4*dq+3 and D/2 + 4*dq..D/2 + 4*dq+3
    for (int w = tid; w < (R4 / 4) * n_dq; w += kThreads) {
      const int rb = w / n_dq, dq = w - rb * n_dq;
      const int d0 = 4 * dq, d1 = D / 2 + 4 * dq;
      float4 acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb * 4 + i;
        const float al = r < R ? a_s[r] : 0.f;
        float4 x0 = *reinterpret_cast<const float4*>(acc_s + r * D + d0);
        float4 x1 = *reinterpret_cast<const float4*>(acc_s + r * D + d1);
        acc[i][0] = make_float4(x0.x * al, x0.y * al, x0.z * al, x0.w * al);
        acc[i][1] = make_float4(x1.x * al, x1.y * al, x1.z * al, x1.w * al);
      }
      for (int t = 0; t < kBk; ++t) {
        const float4 v0 = *reinterpret_cast<const float4*>(v_s + t * D + d0);
        const float4 v1 = *reinterpret_cast<const float4*>(v_s + t * D + d1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = p_s[(rb * 4 + i) * kBk + t];
          acc[i][0].x = fmaf(p, v0.x, acc[i][0].x);
          acc[i][0].y = fmaf(p, v0.y, acc[i][0].y);
          acc[i][0].z = fmaf(p, v0.z, acc[i][0].z);
          acc[i][0].w = fmaf(p, v0.w, acc[i][0].w);
          acc[i][1].x = fmaf(p, v1.x, acc[i][1].x);
          acc[i][1].y = fmaf(p, v1.y, acc[i][1].y);
          acc[i][1].z = fmaf(p, v1.z, acc[i][1].z);
          acc[i][1].w = fmaf(p, v1.w, acc[i][1].w);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb * 4 + i;
        *reinterpret_cast<float4*>(acc_s + r * D + d0) = acc[i][0];
        *reinterpret_cast<float4*>(acc_s + r * D + d1) = acc[i][1];
      }
    }
    __syncthreads();  // k_s / v_s / p_s are rewritten by the next tile
  }
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D;
    if (r % a.tq < q_n) store(o + o_off(r) + (i - r * D), acc_s[i] / fmaxf(l_s[r], 1e-20f));
  }
  if (!PAGED && a.lse != nullptr)  // the backward's log-sum-exp of each row
    for (int r = tid; r < R; r += kThreads)
      if (r % a.tq < q_n)
        a.lse[lse_off(a, b, g * G + r / a.tq, q_lo + r % a.tq)] =
            l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : __int_as_float(0x7f800000);  // +inf: no key seen
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body
// ---------------------------------------------------------------------------
constexpr int kKeys = 64;    // keys per K/V tile: two pages on the paged entry
constexpr int kPage = 32;    // the arena's page size
constexpr int kStages = 3;   // K/V tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of tc_kernel, from a 1024-byte aligned base: Q, rows x DP
// bf16 as DP / 64 column blocks, then kStages x (K tile, V tile), each
// 64 keys x DP as DP / 64 column blocks.  ops.py smem_bytes mirrors kBytes.
template <int DP, int NWG>
struct TcLayout {
  static constexpr int kRows = 64 * NWG;
  static constexpr int kQBytes = kRows * DP * 2;
  static constexpr int kTileBytes = kKeys * DP * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBytes = 1024 + kQBytes + kStages * kStageBytes;  // + alignment slack
};

template <bool PAGED, int DP, int NWG>
__global__ void __launch_bounds__(128 * NWG) tc_kernel(Args a) {
  using L = TcLayout<DP, NWG>;
  constexpr int kT = 128 * NWG;
  constexpr int kCB = DP / 64;       // 64-column blocks
  constexpr int kChunks = DP / 8;    // 16-byte chunks of a padded row
  const int b = blockIdx.x / a.Hkv;
  const int g = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int R = G * a.tq;                             // query rows of the block
  const int D = a.D;
  const int q_lo = blockIdx.y * a.tq;                 // first query index of the tile
  const int q_n = min(a.tq, a.Sq - q_lo);             // real query indices in the tile
  const int tid = threadIdx.x;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);

  // row r: query head g*G + r / tq, query index q_lo + r % tq
  auto q_off = [&](int r) -> long long {
    return (long long)b * a.q_sb + (long long)(q_lo + r % a.tq) * a.q_ss +
           (long long)(g * G + r / a.tq) * a.q_sh;
  };
  auto o_off = [&](int r) -> long long {
    return (long long)b * a.o_sb + (long long)(q_lo + r % a.tq) * a.o_ss +
           (long long)(g * G + r / a.tq) * a.o_sh;
  };

  if (PAGED && a.active != nullptr && a.active[b] == 0) {
    for (int i = tid; i < R * D; i += kT) {
      const int r = i / D;
      if (r % a.tq < q_n) store(o + o_off(r) + (i - r * D), 0.f);
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + L::kQBytes;

  const int base_pos = PAGED ? a.pos0[b] : 0;
  const int lo_pos = base_pos + q_lo;                 // smallest query position here
  const int hi_pos = base_pos + q_lo + q_n - 1;       // largest
  int t_end = (a.Skv + kKeys - 1) / kKeys;
  if (a.causal) t_end = min(t_end, hi_pos / kKeys + 1);
  const int t_begin = a.window > 0 ? max(0, lo_pos - a.window + 1) / kKeys : 0;
  const int n_tiles = max(0, t_end - t_begin);
  const int cpr = D / 8;                              // real chunks of a row

  // Q: zero-filled past the block's rows, past its query indices and past D
  for (int i = tid; i < L::kRows * kChunks; i += kT) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < R && r % a.tq < q_n && c < cpr;
    sm90::cp_async16(q_s + (c >> 3) * (L::kRows * 128) + sm90::swizzle128(r, c & 7),
                     ok ? q + q_off(r) + c * 8 : q, ok);
  }
  // K/V tile j into ring slot `stage`: keys past Skv (past the table, on the
  // paged entry) and columns past D are zero-filled, never read; a page id
  // past the arena is clamped, as the reference's gather clamps it
  // (a thread always moves chunk c_ld of rows t_ld, t_ld + kT / kChunks, ...)
  const int c_ld = tid % kChunks, t_ld = tid / kChunks;
  const bool c_real = c_ld < cpr;
  constexpr int kPasses = kKeys * kChunks / kT;
  auto load_tile = [&](int j, int stage) {
    const uint32_t ks = kv_s + stage * L::kStageBytes, vs = ks + L::kTileBytes;
    // the page ids first, all loads in flight at once: a cp.async (a memory
    // clobber) would otherwise wait out each id's latency in turn
    int phys[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int key = j * kKeys + t_ld + p * (kT / kChunks);
      phys[p] = PAGED && key < a.Skv ? a.page_table[(long long)b * a.n_pg + key / kPage] : 0;
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int t = t_ld + p * (kT / kChunks);
      const int key = j * kKeys + t;
      const bool ok = c_real && key < a.Skv;
      long long off = 0;
      if (ok) {
        if (PAGED) {
          const int page = min(max(phys[p], 0), a.P - 1);
          off = (((long long)page * kPage + key % kPage) * a.Hkv + g) * D + c_ld * 8;
        } else {
          off = (long long)b * a.kv_sb + (long long)g * a.kv_sh + (long long)key * a.kv_ss +
                c_ld * 8;
        }
      }
      const uint32_t dst = (c_ld >> 3) * (kKeys * 128) + sm90::swizzle128(t, c_ld & 7);
      sm90::cp_async16(ks + dst, kp + off, ok);
      sm90::cp_async16(vs + dst, vp + off, ok);
    }
  };
  // group s holds tile t_begin + s (group 0 also Q); empty groups keep the
  // count uniform, so wait_group<kStages - 2> always means "tile it landed"
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(t_begin + s, s);
    sm90::cp_async_commit();
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // this thread's two rows of its warpgroup's accumulators: e = 0 and e = 1
  int row[2], qpos[2];
  bool live[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    row[e] = wg * 64 + warp * 16 + (lane >> 2) + 8 * e;
    live[e] = row[e] < R && row[e] % a.tq < q_n;
    qpos[e] = base_pos + q_lo + row[e] % a.tq;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // running max (log2 units), sum
  const float scale_log2 = a.scale * kLog2e;
  const float scale_cap = a.softcap > 0.f ? a.scale / a.softcap : 0.f;
  const float cap_log2 = a.softcap * kLog2e;
  float acc[kCB][32];
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j = t_begin + it;
    sm90::cp_async_wait<kStages - 2>();
    sm90::fence_proxy_async();
    __syncthreads();  // tile j visible to all; every warpgroup is done with tile j - 1
    if (it + kStages - 1 < n_tiles) load_tile(j + kStages - 1, (it + kStages - 1) % kStages);
    sm90::cp_async_commit();
    const uint32_t ks = kv_s + (it % kStages) * L::kStageBytes, vs = ks + L::kTileBytes;

    // S = Q K^T over D / 16 steps: step kk is chunk pair kk % 4 of column
    // block kk / 4; both K-major, 8-row groups 1024 bytes apart (the leading
    // offset is unused in a swizzled K-major layout)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    sm90::fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      sm90::wgmma_ss<64, 0, 0>(
          s, sm90::desc128(q_s + (kk >> 2) * (L::kRows * 128) + wg * 64 * 128 + col, 16, 1024),
          sm90::desc128(ks + (kk >> 2) * (kKeys * 128) + col, 16, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(s);

    // scale and softcap in f32, in log2 units for exp2
    if (a.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = cap_log2 * tanhf(s[i] * scale_cap);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    }
    // masks, only on a tile some (row, key) of the block cannot see: the
    // block's rows share [lo_pos, hi_pos], and its pad rows hold zero
    // queries (finite scores, never written)
    const int k_lo = j * kKeys, k_hi = k_lo + kKeys - 1;
    if (k_hi >= a.Skv || (a.causal && k_hi > lo_pos) ||
        (a.window > 0 && hi_pos - k_lo >= a.window)) {
      const int key0 = k_lo + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i >> 1) & 1;
        const int kpos = key0 + 8 * (i >> 2) + (i & 1);
        const bool ok = live[e] && kpos < a.Skv && (!a.causal || kpos <= qpos[e]) &&
                        (a.window <= 0 || qpos[e] - kpos < a.window);
        s[i] = ok ? s[i] : kNegInf;
      }
    }
    // online softmax: a row's 64 scores sit in the 4 lanes of a quad
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 2 * e; i < 32; i += 4) mx = fmaxf(mx, fmaxf(s[i], s[i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[e], mx);
      alpha[e] = sm90::fast_exp2(m[e] - m_new);
      m[e] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      s[i] = sm90::fast_exp2(s[i] - m[e]);
      sum[e] += s[i];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] *= alpha[(i >> 1) & 1];
    // P as wgmma's A fragments: keys 16 kk .. 16 kk + 15 are s[8 kk .. 8 kk + 7]
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = sm90::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V: column block cb of V, keys 16 kk .. 16 kk + 15 (2048 bytes a
    // step).  V is MN-major: its 8-key groups are 1024 bytes apart; an
    // instruction spans one 64-column block, so the offset between blocks is
    // never used and both descriptor offsets are 1024.
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) sm90::fence_regs(acc[cb]);
    sm90::wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<64, 1>(acc[cb], pa[kk],
                          sm90::desc128(vs + cb * (kKeys * 128) + kk * 2048, 1024, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) sm90::fence_regs(acc[cb]);
  }
  sm90::cp_async_wait<0>();  // no copy may outlive the block

  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float t = l[e] + __shfl_xor_sync(0xffffffffu, l[e], 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[e] = t > 0.f ? 1.f / t : 0.f;
    // the backward's log-sum-exp of the row, natural log (m is in log2 units)
    if (!PAGED && a.lse != nullptr && live[e] && (lane & 3) == 0)
      a.lse[lse_off(a, b, g * G + row[e] / a.tq, q_lo + row[e] % a.tq)] =
          t > 0.f ? (m[e] + log2f(t)) * kLn2 : __int_as_float(0x7f800000);  // +inf: no key seen
  }
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int e = (i >> 1) & 1;
      const int d = cb * 64 + 8 * (i >> 2) + 2 * (lane & 3);
      if (live[e] && d < D)
        *reinterpret_cast<__nv_bfloat162*>(o + o_off(row[e]) + d) =
            __floats2bfloat162_rn(acc[cb][i] * inv[e], acc[cb][i + 1] * inv[e]);
    }
}

template <bool PAGED, int DP, int NWG>
int launch_tc(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = TcLayout<DP, NWG>::kBytes;
  static int smem_set[kv_tile::kMaxDevices] = {};
  const cudaError_t err = kv_tile::raise_smem_limit(tc_kernel<PAGED, DP, NWG>, smem, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  const dim3 grid(B * a.Hkv, (a.Sq + a.tq - 1) / a.tq);
  tc_kernel<PAGED, DP, NWG><<<grid, 128 * NWG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int launch_scalar(const Args& a, int B, cudaStream_t stream) {
  const int R = (a.H / a.Hkv) * a.tq;
  const int R4 = (R + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)2 * R4 * a.D + (size_t)kBk * (a.D + 4) +
                                       (size_t)kBk * a.D + (size_t)R4 * kBk + 3 * (size_t)R);
  static int smem_set[kv_tile::kMaxDevices] = {};
  const cudaError_t err = kv_tile::raise_smem_limit(scalar_kernel<PAGED>, smem, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  const dim3 grid(B * a.Hkv, (a.Sq + a.tq - 1) / a.tq);
  scalar_kernel<PAGED><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16: padded width DP (64, 128 or 256) and one or two warpgroups from the
// block's rows (ops.py plan); float32: the scalar body.
template <bool PAGED>
int dispatch(const Args& a, int B, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return launch_scalar<PAGED>(a, B, s);
  const int rows = (a.H / a.Hkv) * a.tq;
  if (rows > 128 || (a.D > 128 && rows > 64)) return (int)cudaErrorInvalidValue;
  const bool two = rows > 64;
  if (a.D <= 64)
    return two ? launch_tc<PAGED, 64, 2>(a, B, s) : launch_tc<PAGED, 64, 1>(a, B, s);
  if (a.D <= 128)
    return two ? launch_tc<PAGED, 128, 2>(a, B, s) : launch_tc<PAGED, 128, 1>(a, B, s);
  return launch_tc<PAGED, 256, 1>(a, B, s);
}

}  // namespace

// q, o (B, H, S, D); k, v (B, Hkv, Skv, D), with the strides (elements)
// for batch, position and head given as q_st, o_st and kv_st (k and v share
// theirs; each tensor's D elements are contiguous).  Query i sits at
// position i and key t at position t.  window <= 0: none; softcap <= 0:
// none; dtype 0 = float32 (scalar body), 1 = bfloat16 (tensor cores).  tq:
// query indices per block (ops.py plan: G * tq rows, at most 128 in bf16,
// 64 at D > 128, and 64 in float32).  The wrapper guarantees D a multiple
// of 8 and at most 256, and 16-byte aligned q, K and V rows.  lse: null,
// or (B, H, S) float32 contiguous, which receives each query row's
// log-sum-exp of its scaled, soft-capped and masked scores (the backward's
// input, flash_attention_bwd.cu).  Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Hkv, int S, int Skv, int D, int tq, int causal,
                               int window, float softcap, float scale,
                               const long long* q_st, const long long* o_st,
                               const long long* kv_st, int dtype, void* stream, float* lse) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.H = H; a.Hkv = Hkv; a.D = D; a.Sq = S; a.Skv = Skv; a.n_pg = 0; a.tq = tq;
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
  a.q_sb = q_st[0]; a.q_ss = q_st[1]; a.q_sh = q_st[2];
  a.o_sb = o_st[0]; a.o_ss = o_st[1]; a.o_sh = o_st[2];
  a.kv_sb = kv_st[0]; a.kv_ss = kv_st[1]; a.kv_sh = kv_st[2];
  return dispatch<false>(a, B, dtype, stream);
}

// q, o (B, Sq, H, D), query i of row b at position pos0[b] + i; k, v arenas
// (P, 32, Hkv, D); page_table (B, n_pg) int32; pos0 (B,) int32; active (B,)
// int32 or null.  Causal over the row's pages.  Other arguments as above.
extern "C" int paged_flash_attention(const void* q, const void* k, const void* v,
                                     const void* page_table, const void* pos0,
                                     const void* active, void* o, int B, int Sq, int H,
                                     int Hkv, int D, int P, int n_pg, int tq, int window,
                                     float softcap, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.page_table = static_cast<const int*>(page_table);
  a.pos0 = static_cast<const int*>(pos0);
  a.active = static_cast<const int*>(active);
  a.H = H; a.Hkv = Hkv; a.D = D; a.Sq = Sq; a.Skv = n_pg * kPage; a.n_pg = n_pg; a.P = P;
  a.tq = tq; a.causal = 1; a.window = window; a.softcap = softcap; a.scale = scale;
  a.q_sb = (long long)Sq * H * D; a.q_ss = (long long)H * D; a.q_sh = D;
  a.o_sb = a.q_sb; a.o_ss = a.q_ss; a.o_sh = a.q_sh;
  return dispatch<true>(a, B, dtype, stream);
}
