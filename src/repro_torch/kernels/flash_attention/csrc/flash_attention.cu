// Blockwise online-softmax attention for Hopper (sm_90a), bound to Python
// with ctypes.  Two entries share one kernel body:
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
// What bounds it on this card: bytes at the serving shapes.  A 32-token
// prefill chunk does 4 * 32 * G = 512 FLOPs per K/V element for G = 4 query
// heads per KV head, a 5-token verify window 80; both sit near or below the
// ~295 FLOP/byte an H100 needs in bf16 before its tensor cores bound, but
// this kernel computes in fp32 on the CUDA cores (67 TFLOP/s), where the
// arithmetic of a prefill chunk is the larger term.  The design keeps what
// it can on chip and reads each needed K/V tile once per GQA group:
//   * one block per (row, KV head, query tile) holds all H/Hkv query heads of
//     the group for its query tile, so a K/V tile is read once per group;
//   * the key loop stops at the tile holding the block's last query
//     position (causal) and starts at the first tile its window can see, so
//     key pages past the row's position are never read;
//   * tiles of 32 keys move as 16-byte loads, the next one fetched into
//     registers while the current one is computed (kv_tile.cuh);
//   * Q.K^T and P.V run from shared memory in 4x2 and 4x8 register tiles
//     with 16-byte shared loads, so a shared load feeds 4-8 FMAs;
//   * scores, probabilities and the running (m, l, acc) stay in shared
//     memory; nothing but the output goes to device memory;
//   * ragged query tiles (Sq not a multiple of the tile) are masked inside
//     the kernel, and a dead row (active == 0) writes zeros, reading nothing.
// Still simple: fp32 FMAs, no tensor cores (wgmma / mma) yet.
#include "kv_tile.cuh"

namespace {

using kv_tile::kNegInf;
using kv_tile::store;
using kv_tile::to_float;

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;   // a tile of K (or V) for one head: <= 32 KB
constexpr int kBk = 32;      // keys per tile (the page size on the paged entry)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* page_table;  // paged: (B, n_pg)
  const int* pos0;        // paged: (B,) position of query 0
  const int* active;      // paged: (B,) or null (all rows live)
  int H, Hkv, D, Sq;
  int Skv;                // dense: key count; paged: n_pg * kBk
  int n_pg, P;            // paged: table width, arena pages
  int tq;                 // query indices per block (rows = G * tq)
  int causal, window;     // window <= 0: none
  float softcap, scale;
  long long q_sb, q_ss, q_sh;     // q strides (elements) for batch, query, head
  long long o_sb, o_ss, o_sh;     // o strides
  long long kv_sb, kv_ss, kv_sh;  // dense k / v strides for batch, key, head
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, s))));
}

template <bool PAGED, typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
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
}

template <bool PAGED, typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int R = (a.H / a.Hkv) * a.tq;
  const int R4 = (R + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)2 * R4 * a.D + (size_t)kBk * (a.D + 4) +
                                       (size_t)kBk * a.D + (size_t)R4 * kBk + 3 * (size_t)R);
  static int smem_set[kv_tile::kMaxDevices] = {};
  const cudaError_t err = kv_tile::raise_smem_limit(flash_kernel<PAGED, T>, smem, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  const dim3 grid(B * a.Hkv, (a.Sq + a.tq - 1) / a.tq);
  flash_kernel<PAGED, T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int dispatch(const Args& a, int B, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<PAGED, __nv_bfloat16>(a, B, s) : launch<PAGED, float>(a, B, s);
}

}  // namespace

// q, o (B, H, S, D); k, v (B, Hkv, Skv, D), with the strides (elements)
// for batch, position and head given as q_st, o_st and kv_st (k and v share
// theirs; each tensor's D elements are contiguous).  Query i sits at
// position i and key t at position t.  window <= 0: none; softcap <= 0:
// none; dtype 0 = float32, 1 = bfloat16.  tq: query indices per block.  The
// wrapper guarantees D a multiple of 8 and at most 256, and 16-byte aligned
// K/V rows.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Hkv, int S, int Skv, int D, int tq, int causal,
                               int window, float softcap, float scale,
                               const long long* q_st, const long long* o_st,
                               const long long* kv_st, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o;
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
  a.H = H; a.Hkv = Hkv; a.D = D; a.Sq = Sq; a.Skv = n_pg * kBk; a.n_pg = n_pg; a.P = P;
  a.tq = tq; a.causal = 1; a.window = window; a.softcap = softcap; a.scale = scale;
  a.q_sb = (long long)Sq * H * D; a.q_ss = (long long)H * D; a.q_sh = D;
  a.o_sb = a.q_sb; a.o_ss = a.q_ss; a.o_sh = a.q_sh;
  return dispatch<true>(a, B, dtype, stream);
}
