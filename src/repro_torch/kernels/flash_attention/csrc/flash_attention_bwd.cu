// Backward of the flash kernel's dense entry (flash_attention.cu) for
// Hopper (sm_90a), bound to Python with ctypes: dQ, dK and dV of
// softmax(softcap(scale * Q K^T) + mask) V from q, k, v, the forward's
// output o, its gradient dout and the forward's per-row log-sum-exp lse.
//
// It replaces no Pallas kernel: the reference trains through
// jax.value_and_grad of its jnp full_attention (models/attention.py), and
// none of its six Pallas kernels has a custom_vjp.  The port's forward is a
// ctypes launch that autograd cannot see through, so training needs this
// kernel to reach the weights below every attention layer.
//
// It takes everything the dense entry takes: causal or not, a sliding
// window, a logit softcap (dS carries its 1 - tanh^2 factor), GQA (dK and
// dV sum over the G = H / Hkv query heads of their KV head), Sq != Skv,
// D a multiple of 8 up to 256, float32 and bfloat16, and the same strided
// (B, H, S, D) views of (B, S, H, D) tensors.  No atomics: the same inputs
// give the same bits.
//
// What bounds it: operations.  The FlashAttention-2 split does five S x S x
// D products (Q K^T and dO V^T recomputed, then dV, dK and dQ); at S = 2048
// and D = 128 that is far above the bytes.  This design does seven: the dQ
// kernel recomputes Q K^T and dO V^T.  That is the price of determinism:
// the dK/dV walk could add dS K into dQ only with float32 atomics across
// blocks, in an order that changes from run to run; a kernel of its own
// per query tile sums dQ in registers, in a fixed order.
//   * delta_kernel: Delta = rowsum(dO o O), one warp a row, in float32
//     (a pass of its own: both kernels below read Delta from the start).
//
// bfloat16 (the training dtype): the products on the tensor cores, with
// wgmma, as the forward's tc_kernel (sm90.cuh: cp.async, the 128-byte
// swizzle, wgmma from shared memory or with A from registers).
//   * dkdv_tc_kernel: a block (one warpgroup) per (row, KV head, 64-key
//     tile) holds the K and V tiles in shared memory, bf16, swizzled, D
//     padded with zero columns to 64, 128 or 256, and walks the group's
//     query heads and the 64-query tiles that can see its keys (the causal
//     mask and the window bound the walk), Q and dO tiles (and their lse
//     and Delta) streaming through a two-stage cp.async ring.  Keys are
//     wgmma's M: S^T = K Q^T and dP^T = V dO^T from shared memory, both
//     K-major; P^T = exp(scale S^T (softcapped) - lse[q]) and dS^T = P^T o
//     (dP^T - Delta[q]) (o (1 - tanh^2)) * scale in f32 registers; then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T as the register A
//     operand (the accumulator layout is the A-fragment layout, rounded to
//     bf16) and dO and Q read through the transpose bit, as the forward's
//     O += P V.  dK and dV stay in f32 registers and are rounded once.
//     Blocks of the first key tiles (the longest walks under the causal
//     mask) are issued first.  At D = 256 dK + dV would need 256 registers
//     a thread, so the walk runs twice, dV alone then dK alone (one more
//     product: eight in all).
//   * Where rows x KV heads x key tiles leave most of the 132 SMs idle
//     (granite's one KV head), the group's query heads are split over
//     blocks; each split writes f32 partials after Delta in the scratch, and
//     dkdv_sum_kernel adds them in split order and rounds once.  The rule
//     lives in plan_bf16 alone; flash_attention_bwd_plan exports it, and
//     the wrapper sizes the scratch by it.
//   * dq_tc_kernel: the forward's row mapping, a block per (row, KV head,
//     tq query indices) holding all G query heads of the group (one or two
//     64-row warpgroups), so each K/V tile is read once per group; K/V
//     tiles stream through a cp.async ring.  S = Q K^T and dP = dO V^T from
//     shared memory, P and dS in registers (each row's lse and Delta in
//     registers), dQ += dS K with K through the transpose bit; dQ stays in
//     f32 registers and is rounded once.  The longest walks (the last query
//     tiles, causal) are issued first.
//
// float32 (the parity paths only: their 2e-5 gate rules out TF32), the
// scalar body, a first, simple design:
//   * dkdv_kernel: a block per (row, KV head, 32-key tile) holds K, V and
//     the f32 dK, dV sums of its tile in shared memory, and walks every
//     query head of the group and every 32-query tile that can see a key
//     of the tile;
//   * dq_kernel: a block per (row, query head, 32-query tile) holds Q, dO
//     and the f32 dQ sum, and walks the key tiles its rows can see.
// Every product is scalar float32 FMAs from shared memory, in 2x2 (scores)
// and 4x4 (gradients) register tiles.
#include <algorithm>

#include "kv_tile.cuh"
#include "sm90.cuh"

namespace {

using kv_tile::store;
using kv_tile::to_float;

constexpr int kThreads = 256;  // Delta, the split sum and the float32 body
constexpr int kBq = 32;        // float32 body: query rows of a tile
constexpr int kBk = 32;        // float32 body: keys of a tile

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  float* delta;        // (B, H, Sq)
  float* part;         // bf16 split walk: (splits, 2, B, Hkv, Skv, D) f32 dK, dV partials
  void* dq;            // q's strides
  void* dk;            // k's strides
  void* dv;
  int B, H, Hkv, Sq, Skv, D, causal, window;  // window <= 0: none
  float softcap, scale;                       // softcap <= 0: none
  int tq;              // bf16 dQ: query indices a block (G * tq rows)
  int splits, hps;     // bf16 dK/dV: splits of the group's query heads, heads a split
  long long q_sb, q_ss, q_sh;     // q and dq strides (elements): batch, position, head
  long long o_sb, o_ss, o_sh;     // o
  long long do_sb, do_ss, do_sh;  // dout
  long long kv_sb, kv_ss, kv_sh;  // k, v, dk and dv
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, s))));
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ float get(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

// rows [0, rows) of a tile into shared memory as float32, row r from
// src[base + r * stride + (0 .. D-1)]; rows at or past `valid` are zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long base,
                                          long long stride, int valid, int rows, int D) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * ld + c] = r < valid ? to_float(src[base + (long long)r * stride + c]) : 0.f;
  }
}

// Delta[row] = sum_d dO[row, d] * O[row, d], one warp a (b, h, i) row
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(BwdArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + warp;
  if (row >= (long long)a.B * a.H * a.Sq) return;
  const int i = (int)(row % a.Sq);
  const int h = (int)((row / a.Sq) % a.H);
  const int b = (int)(row / ((long long)a.Sq * a.H));
  const T* o = static_cast<const T*>(a.o) + (long long)b * a.o_sb + (long long)i * a.o_ss +
               (long long)h * a.o_sh;
  const T* d = static_cast<const T*>(a.dout) + (long long)b * a.do_sb +
               (long long)i * a.do_ss + (long long)h * a.do_sh;
  float s = 0.f;
  for (int c = lane; c < a.D; c += 32) s = fmaf(to_float(o[c]), to_float(d[c]), s);
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[row] = s;
}

// P and scale * dS of one (query tile, key tile) pair from the tiles in
// shared memory (q_s, do_s: kBq rows; k_s, v_s: kBk rows; row stride ld):
// a thread owns rows 2 rb, 2 rb + 1 and keys kb, kb + 16.  p_s (if not
// null) gets P as [row][key]; ds_s gets scale * dS as [row][key], or
// [key][row] when `ds_by_key`.  Masked or ragged pairs get zeros.
__device__ __forceinline__ void tile_scores(const BwdArgs& a, const float* q_s,
                                            const float* do_s, const float* k_s,
                                            const float* v_s, int ld, const float* lse_s,
                                            const float* dl_s, int q_lo, int q_n, int k_lo,
                                            int k_n, float* p_s, float* ds_s, bool ds_by_key) {
  const int rb = threadIdx.x >> 4, kb = threadIdx.x & 15;
  float s[2][2] = {}, dp[2][2] = {};
  for (int d = 0; d < a.D; d += 4) {
    const float4 k0 = *reinterpret_cast<const float4*>(k_s + kb * ld + d);
    const float4 k1 = *reinterpret_cast<const float4*>(k_s + (kb + 16) * ld + d);
    const float4 v0 = *reinterpret_cast<const float4*>(v_s + kb * ld + d);
    const float4 v1 = *reinterpret_cast<const float4*>(v_s + (kb + 16) * ld + d);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + (2 * rb + i) * ld + d);
      const float4 ov = *reinterpret_cast<const float4*>(do_s + (2 * rb + i) * ld + d);
      s[i][0] = dot4(qv, k0, s[i][0]);
      s[i][1] = dot4(qv, k1, s[i][1]);
      dp[i][0] = dot4(ov, v0, dp[i][0]);
      dp[i][1] = dot4(ov, v1, dp[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * rb + i;
    const int qpos = q_lo + r;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = kb + 16 * c;
      const int kpos = k_lo + t;
      bool ok = r < q_n && t < k_n;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.window > 0) ok = ok && qpos - kpos < a.window;
      float x = s[i][c] * a.scale, th = 0.f;
      if (a.softcap > 0.f) {
        th = tanhf(x / a.softcap);
        x = a.softcap * th;
      }
      const float p = ok ? expf(x - lse_s[r]) : 0.f;
      float ds = p * (dp[i][c] - dl_s[r]);
      if (a.softcap > 0.f) ds *= 1.f - th * th;
      if (p_s != nullptr) p_s[r * kBk + t] = p;
      ds_s[ds_by_key ? t * kBq + r : r * kBk + t] = ds * a.scale;
    }
  }
}

// dK and dV of one (row, KV head, key tile)
template <typename T>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(BwdArgs a) {
  const int b = blockIdx.x / a.Hkv, g = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int D = a.D, ld = D + 4;  // 16-byte rows, shifted 4 banks per row
  const int k_lo = blockIdx.y * kBk, k_n = min(kBk, a.Skv - k_lo);
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBk][ld]
  float* v_s = k_s + kBk * ld;                    // [kBk][ld]
  float* q_s = v_s + kBk * ld;                    // [kBq][ld]
  float* do_s = q_s + kBq * ld;                   // [kBq][ld]
  float* dk_s = do_s + kBq * ld;                  // [kBk][D]
  float* dv_s = dk_s + kBk * D;                   // [kBk][D]
  float* p_s = dv_s + kBk * D;                    // [kBq][kBk]
  float* ds_s = p_s + kBq * kBk;                  // [kBq][kBk]
  float* lse_s = ds_s + kBq * kBk;                // [kBq]
  float* dl_s = lse_s + kBq;                      // [kBq]
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const long long kv_base = (long long)b * a.kv_sb + (long long)g * a.kv_sh +
                            (long long)k_lo * a.kv_ss;
  load_rows(k_s, ld, static_cast<const T*>(a.k), kv_base, a.kv_ss, k_n, kBk, D);
  load_rows(v_s, ld, static_cast<const T*>(a.v), kv_base, a.kv_ss, k_n, kBk, D);
  for (int i = threadIdx.x; i < kBk * D; i += kThreads) dk_s[i] = dv_s[i] = 0.f;

  // the query tiles with a row that sees a key of this tile: none before
  // k_lo (causal), none at or past the last key + window
  const int qt_begin = a.causal ? k_lo / kBq : 0;
  const int q_end = a.window > 0 ? min(a.Sq, k_lo + k_n - 1 + a.window) : a.Sq;
  const int qt_end = (q_end + kBq - 1) / kBq;
  const int n_dq = D / 4;  // 4-dim column groups of the gradient tiles
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const long long row0 = ((long long)b * a.H + h) * a.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_lo = qt * kBq, q_n = min(kBq, a.Sq - q_lo);
      __syncthreads();  // the previous pair's readers are done
      load_rows(q_s, ld, q, (long long)b * a.q_sb + (long long)h * a.q_sh +
                (long long)q_lo * a.q_ss, a.q_ss, q_n, kBq, D);
      load_rows(do_s, ld, dout, (long long)b * a.do_sb + (long long)h * a.do_sh +
                (long long)q_lo * a.do_ss, a.do_ss, q_n, kBq, D);
      for (int r = threadIdx.x; r < kBq; r += kThreads) {
        lse_s[r] = r < q_n ? a.lse[row0 + q_lo + r] : 0.f;
        dl_s[r] = r < q_n ? a.delta[row0 + q_lo + r] : 0.f;
      }
      __syncthreads();
      tile_scores(a, q_s, do_s, k_s, v_s, ld, lse_s, dl_s, q_lo, q_n, k_lo, k_n, p_s, ds_s,
                  false);
      __syncthreads();
      // dV += P^T dO, dK += (scale dS)^T Q: a thread owns keys 4 tb .. 4 tb + 3
      // and dims 4 dc .. 4 dc + 3
      for (int w = threadIdx.x; w < (kBk / 4) * n_dq; w += kThreads) {
        const int tb = w / n_dq, dc = w - tb * n_dq;
        float4 dv[4] = {}, dk[4] = {};
        for (int r = 0; r < kBq; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * kBk + 4 * tb);
          const float4 s4 = *reinterpret_cast<const float4*>(ds_s + r * kBk + 4 * tb);
          const float4 o4 = *reinterpret_cast<const float4*>(do_s + r * ld + 4 * dc);
          const float4 q4 = *reinterpret_cast<const float4*>(q_s + r * ld + 4 * dc);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            fma4(dv[j], get(p4, j), o4);
            fma4(dk[j], get(s4, j), q4);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4* pv = reinterpret_cast<float4*>(dv_s + (4 * tb + j) * D + 4 * dc);
          float4* pk = reinterpret_cast<float4*>(dk_s + (4 * tb + j) * D + 4 * dc);
          const float4 x = *pv, y = *pk;
          *pv = make_float4(x.x + dv[j].x, x.y + dv[j].y, x.z + dv[j].z, x.w + dv[j].w);
          *pk = make_float4(y.x + dk[j].x, y.y + dk[j].y, y.z + dk[j].z, y.w + dk[j].w);
        }
      }
    }
  }
  __syncthreads();
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  for (int i = threadIdx.x; i < k_n * D; i += kThreads) {
    const int t = i / D, c = i - t * D;
    const long long off = kv_base + (long long)t * a.kv_ss + c;
    store(dk + off, dk_s[i]);
    store(dv + off, dv_s[i]);
  }
}

// dQ of one (row, query head, query tile)
template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int g = h / (a.H / a.Hkv);
  const int D = a.D, ld = D + 4;
  const int q_lo = blockIdx.y * kBq, q_n = min(kBq, a.Sq - q_lo);
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBq][ld]
  float* do_s = q_s + kBq * ld;                   // [kBq][ld]
  float* k_s = do_s + kBq * ld;                   // [kBk][ld]
  float* v_s = k_s + kBk * ld;                    // [kBk][ld]
  float* dq_s = v_s + kBk * ld;                   // [kBq][D]
  float* ds_s = dq_s + kBq * D;                   // [kBk][kBq]
  float* lse_s = ds_s + kBq * kBk;                // [kBq]
  float* dl_s = lse_s + kBq;                      // [kBq]
  const long long q_base = (long long)b * a.q_sb + (long long)h * a.q_sh +
                           (long long)q_lo * a.q_ss;
  const long long row0 = ((long long)b * a.H + h) * a.Sq + q_lo;
  load_rows(q_s, ld, static_cast<const T*>(a.q), q_base, a.q_ss, q_n, kBq, D);
  load_rows(do_s, ld, static_cast<const T*>(a.dout), (long long)b * a.do_sb +
            (long long)h * a.do_sh + (long long)q_lo * a.do_ss, a.do_ss, q_n, kBq, D);
  for (int r = threadIdx.x; r < kBq; r += kThreads) {
    lse_s[r] = r < q_n ? a.lse[row0 + r] : 0.f;
    dl_s[r] = r < q_n ? a.delta[row0 + r] : 0.f;
  }
  for (int i = threadIdx.x; i < kBq * D; i += kThreads) dq_s[i] = 0.f;

  // the key tiles these rows can see (as the forward's walk)
  int t_end = (a.Skv + kBk - 1) / kBk;
  if (a.causal) t_end = min(t_end, (q_lo + q_n - 1) / kBk + 1);
  const int t_begin = a.window > 0 ? max(0, q_lo - a.window + 1) / kBk : 0;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const int n_dq = D / 4;
  for (int j = t_begin; j < t_end; ++j) {
    const int k_lo = j * kBk, k_n = min(kBk, a.Skv - k_lo);
    const long long kv_base = (long long)b * a.kv_sb + (long long)g * a.kv_sh +
                              (long long)k_lo * a.kv_ss;
    __syncthreads();  // the previous tile's readers are done
    load_rows(k_s, ld, kp, kv_base, a.kv_ss, k_n, kBk, D);
    load_rows(v_s, ld, vp, kv_base, a.kv_ss, k_n, kBk, D);
    __syncthreads();
    tile_scores(a, q_s, do_s, k_s, v_s, ld, lse_s, dl_s, q_lo, q_n, k_lo, k_n, nullptr, ds_s,
                true);
    __syncthreads();
    // dQ += (scale dS) K: a thread owns rows 4 rb .. 4 rb + 3, dims 4 dc .. 4 dc + 3
    for (int w = threadIdx.x; w < (kBq / 4) * n_dq; w += kThreads) {
      const int rb = w / n_dq, dc = w - rb * n_dq;
      float4 acc[4] = {};
      for (int t = 0; t < kBk; ++t) {
        const float4 s4 = *reinterpret_cast<const float4*>(ds_s + t * kBq + 4 * rb);
        const float4 k4 = *reinterpret_cast<const float4*>(k_s + t * ld + 4 * dc);
#pragma unroll
        for (int j = 0; j < 4; ++j) fma4(acc[j], get(s4, j), k4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4* pq = reinterpret_cast<float4*>(dq_s + (4 * rb + j) * D + 4 * dc);
        const float4 x = *pq;
        *pq = make_float4(x.x + acc[j].x, x.y + acc[j].y, x.z + acc[j].z, x.w + acc[j].w);
      }
    }
  }
  __syncthreads();
  T* dq = static_cast<T*>(a.dq);
  for (int i = threadIdx.x; i < q_n * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    store(dq + q_base + (long long)r * a.q_ss + c, dq_s[i]);
  }
}


// ---------------------------------------------------------------------------
// bfloat16: the tensor-core bodies
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // keys of a dK/dV block, queries of a walk step, keys of a dQ step
constexpr int kSMs = 132;          // an H100's SMs: the split rule's target (plan_bf16)
constexpr int kMaxSplits = 16;
constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes from global to shared memory, asynchronously; valid = false
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// A tile of 64 bf16 rows into shared memory at dst (1024-byte aligned), in
// the 128-byte-swizzled layout of DP / 64 column blocks of 64 rows x 128
// bytes: row r from src + r * stride, its D columns; rows at or past
// `valid` and columns past D are zero-filled.  kT threads share the copy.
template <int DP, int kT>
__device__ __forceinline__ void load_tile64(uint32_t dst, const bf16* src, long long stride,
                                            int valid, int D) {
  constexpr int kChunks = DP / 8;
  const int cpr = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kTile * kChunks; i += kT) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < valid && c < cpr;
    sm90::cp_async16(dst + (c >> 3) * (kTile * 128) + sm90::swizzle128(r, c & 7),
                     ok ? src + (long long)r * stride + c * 8 : src, ok);
  }
}

// Shared memory of dkdv_tc_kernel from a 1024-byte aligned base: the K and
// V tiles, kStages x (Q tile, dO tile), then kStages x (lse, Delta) of the
// tiles' 64 queries.  ops.py bwd_smem_bytes mirrors kBytes.
template <int DP>
struct DkdvLayout {
  static constexpr int kStages = 2;
  static constexpr int kTileBytes = kTile * DP * 2;
  static constexpr int kBytes = 1024 + 2 * kTileBytes + kStages * 2 * kTileBytes +
                                kStages * 2 * kTile * 4;
};

// dK and dV (DV, DK: which of the two this pass computes) of one (row, KV
// head, 64-key tile), over query heads [split * hps, split * hps + hps) of
// the group
template <int DP, bool DV, bool DK>
__global__ void __launch_bounds__(128) dkdv_tc_kernel(BwdArgs a) {
  using L = DkdvLayout<DP>;
  constexpr int kCB = DP / 64;   // 64-column blocks
  const int b = blockIdx.x / a.Hkv, g = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int h_begin = blockIdx.z * a.hps, h_end = min(G, h_begin + a.hps);
  const int D = a.D;
  const int k_lo = blockIdx.y * kTile, k_n = min(kTile, a.Skv - k_lo);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + L::kTileBytes;
  const uint32_t ring = v_s + L::kTileBytes;                      // stage s at ring + s * 2 * kTileBytes
  const uint32_t stats = ring + L::kStages * 2 * L::kTileBytes;   // stage s at stats + s * 512
  const float* stats_p = reinterpret_cast<const float*>(smem_raw + (stats - raw));

  const long long kv_base = (long long)b * a.kv_sb + (long long)g * a.kv_sh +
                            (long long)k_lo * a.kv_ss;
  load_tile64<DP, 128>(k_s, static_cast<const bf16*>(a.k) + kv_base, a.kv_ss, k_n, D);
  if constexpr (DK)
    load_tile64<DP, 128>(v_s, static_cast<const bf16*>(a.v) + kv_base, a.kv_ss, k_n, D);

  // the query tiles with a row that sees a key of this tile: none before
  // k_lo (causal), none at or past the last key + window
  const int qt_begin = a.causal ? k_lo / kTile : 0;
  const int q_end = a.window > 0 ? min(a.Sq, k_lo + k_n - 1 + a.window) : a.Sq;
  const int nq = max(0, (q_end + kTile - 1) / kTile - qt_begin);
  const int n_items = max(0, h_end - h_begin) * nq;   // (head, query tile) steps
  auto item_head = [&](int it) { return g * G + h_begin + it / nq; };
  auto item_q_lo = [&](int it) { return (qt_begin + it % nq) * kTile; };
  // item it into ring stage `stage`: its Q and dO tiles (zero past Sq and
  // past D), its queries' lse and Delta (zero past Sq), one float a thread
  auto load_item = [&](int it, int stage) {
    const int h = item_head(it), q_lo = item_q_lo(it), q_n = min(kTile, a.Sq - q_lo);
    const uint32_t qs = ring + stage * 2 * L::kTileBytes;
    load_tile64<DP, 128>(qs, q + (long long)b * a.q_sb + (long long)h * a.q_sh +
                         (long long)q_lo * a.q_ss, a.q_ss, q_n, D);
    load_tile64<DP, 128>(qs + L::kTileBytes, dout + (long long)b * a.do_sb +
                         (long long)h * a.do_sh + (long long)q_lo * a.do_ss, a.do_ss, q_n, D);
    const int r = tid & (kTile - 1);
    const float* src = (tid < kTile ? a.lse : a.delta) + ((long long)b * a.H + h) * a.Sq + q_lo;
    cp_async4(stats + stage * 2 * kTile * 4 + tid * 4, src + (r < q_n ? r : 0), r < q_n);
  };
  // group s holds item s (group 0 also K and V); empty groups keep the
  // count uniform, so wait_group<kStages - 2> always means "item it landed"
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_items) load_item(s, s);
    sm90::cp_async_commit();
  }

  const bool capped = a.softcap > 0.f;
  const float scale_log2 = a.scale * kLog2e;
  const float scale_cap = capped ? a.scale / a.softcap : 0.f;
  const float cap_log2 = a.softcap * kLog2e;
  const int key_row = warp * 16 + (lane >> 2);   // + 8 (i / 2 % 2): this thread's keys
  float dv[kCB][32], dk[kCB][32];
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[cb][i] = dk[cb][i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    sm90::cp_async_wait<L::kStages - 2>();
    sm90::fence_proxy_async();
    __syncthreads();  // item it visible to all; all are done with item it - 1
    if (it + L::kStages - 1 < n_items)
      load_item(it + L::kStages - 1, (it + L::kStages - 1) % L::kStages);
    sm90::cp_async_commit();
    const int stage = it % L::kStages;
    const uint32_t qs = ring + stage * 2 * L::kTileBytes, dos = qs + L::kTileBytes;
    const float* lse_s = stats_p + stage * 2 * kTile;
    const float* dl_s = lse_s + kTile;
    const int q_lo = item_q_lo(it), q_n = min(kTile, a.Sq - q_lo);

    // S^T = K Q^T and dP^T = V dO^T (keys x queries) over D / 16 steps:
    // step kk is chunk pair kk % 4 of column block kk / 4, both operands
    // K-major, 8-row groups 1024 bytes apart
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    sm90::fence_regs(s);
    if constexpr (DK) sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk >> 2) * (kTile * 128) + (kk & 3) * 32;
      sm90::wgmma_ss<64, 0, 0>(s, sm90::desc128(k_s + col, 16, 1024),
                               sm90::desc128(qs + col, 16, 1024));
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk >> 2) * (kTile * 128) + (kk & 3) * 32;
        sm90::wgmma_ss<64, 0, 0>(dp, sm90::desc128(v_s + col, 16, 1024),
                                 sm90::desc128(dos + col, 16, 1024));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(s);
    if constexpr (DK) sm90::fence_regs(dp);

    // P^T and scale * dS^T in f32: element i is key key_row + 8 (i / 2 % 2),
    // query column 8 (i / 4) + 2 (lane % 4) + i % 2; masks only on a pair of
    // tiles some (key, query) of which is hidden or ragged
    const bool edge = k_lo + kTile > a.Skv || q_lo + kTile > a.Sq ||
                      (a.causal && q_lo < k_lo + kTile - 1) ||
                      (a.window > 0 && q_lo + kTile - 1 - k_lo >= a.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int t = key_row + 8 * ((i >> 1) & 1);
      float lg, th = 0.f;
      if (capped) {
        th = tanhf(s[i] * scale_cap);
        lg = cap_log2 * th;
      } else {
        lg = s[i] * scale_log2;
      }
      float p = sm90::fast_exp2(lg - lse_s[c] * kLog2e);
      if (edge) {
        const int kpos = k_lo + t, qpos = q_lo + c;
        const bool ok = t < k_n && c < q_n && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || qpos - kpos < a.window);
        p = ok ? p : 0.f;
      }
      s[i] = p;
      if constexpr (DK) {
        float ds = p * (dp[i] - dl_s[c]);
        if (capped) ds *= 1.f - th * th;
        dp[i] = ds * a.scale;
      }
    }
    // as wgmma's A fragments: queries 16 kk .. 16 kk + 15 are elements 8 kk .. 8 kk + 7
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = sm90::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        da[kk][r] = sm90::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }

    // dV += P^T dO, dK += dS^T Q: column block cb, queries 16 kk .. 16 kk +
    // 15 (2048 bytes a step); dO and Q are MN-major (D-contiguous rows), so
    // both descriptor offsets are 1024, as the forward's V
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) {
      if constexpr (DV) sm90::fence_regs(dv[cb]);
      if constexpr (DK) sm90::fence_regs(dk[cb]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (DV)
          sm90::wgmma_rs<64, 1>(dv[cb], pa[kk],
                                sm90::desc128(dos + cb * (kTile * 128) + kk * 2048, 1024, 1024));
        if constexpr (DK)
          sm90::wgmma_rs<64, 1>(dk[cb], da[kk],
                                sm90::desc128(qs + cb * (kTile * 128) + kk * 2048, 1024, 1024));
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) {
      if constexpr (DV) sm90::fence_regs(dv[cb]);
      if constexpr (DK) sm90::fence_regs(dk[cb]);
    }
  }
  sm90::cp_async_wait<0>();  // no copy may outlive the block

  // rounded once into dk / dv, or the split's f32 partials
  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
  const long long n_grad = (long long)a.B * a.Hkv * a.Skv * D;
  float* pk = a.part + 2 * blockIdx.z * n_grad +
              (((long long)b * a.Hkv + g) * a.Skv + k_lo) * D;
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = key_row + 8 * ((i >> 1) & 1);
      const int d = cb * 64 + 8 * (i >> 2) + 2 * (lane & 3);
      if (t >= k_n || d >= D) continue;
      if (a.splits == 1) {
        const long long off = kv_base + (long long)t * a.kv_ss + d;
        if constexpr (DK)
          *reinterpret_cast<__nv_bfloat162*>(dkp + off) =
              __floats2bfloat162_rn(dk[cb][i], dk[cb][i + 1]);
        if constexpr (DV)
          *reinterpret_cast<__nv_bfloat162*>(dvp + off) =
              __floats2bfloat162_rn(dv[cb][i], dv[cb][i + 1]);
      } else {
        const long long off = (long long)t * D + d;
        if constexpr (DK)
          *reinterpret_cast<float2*>(pk + off) = make_float2(dk[cb][i], dk[cb][i + 1]);
        if constexpr (DV)
          *reinterpret_cast<float2*>(pk + n_grad + off) = make_float2(dv[cb][i], dv[cb][i + 1]);
      }
    }
}

// dK and dV from the splits' partials, added in split order, rounded once
__global__ void __launch_bounds__(kThreads) dkdv_sum_kernel(BwdArgs a) {
  const long long n_grad = (long long)a.B * a.Hkv * a.Skv * a.D;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_grad) return;
  float sk = 0.f, sv = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    sk += a.part[2 * s * n_grad + i];
    sv += a.part[(2 * s + 1) * n_grad + i];
  }
  const int d = (int)(i % a.D);
  long long r = i / a.D;
  const int t = (int)(r % a.Skv);
  r /= a.Skv;
  const int g = (int)(r % a.Hkv), b = (int)(r / a.Hkv);
  const long long off = (long long)b * a.kv_sb + (long long)g * a.kv_sh + (long long)t * a.kv_ss + d;
  store(static_cast<bf16*>(a.dk) + off, sk);
  store(static_cast<bf16*>(a.dv) + off, sv);
}

// Shared memory of dq_tc_kernel from a 1024-byte aligned base: Q and dO,
// rows x DP each as DP / 64 column blocks, then kStages x (K tile, V tile).
// ops.py bwd_smem_bytes mirrors kBytes.
template <int DP, int NWG>
struct DqLayout {
  static constexpr int kStages = DP > 128 ? 2 : 3;
  static constexpr int kRows = 64 * NWG;
  static constexpr int kRowBytes = kRows * DP * 2;
  static constexpr int kTileBytes = kTile * DP * 2;
  static constexpr int kBytes = 1024 + 2 * kRowBytes + kStages * 2 * kTileBytes;
};

// dQ of one (row, KV head, tq query indices): G * tq rows, row r being
// query head g * G + r / tq at query index q_lo + r % tq
template <int DP, int NWG>
__global__ void __launch_bounds__(128 * NWG) dq_tc_kernel(BwdArgs a) {
  using L = DqLayout<DP, NWG>;
  constexpr int kT = 128 * NWG;
  constexpr int kCB = DP / 64;
  constexpr int kChunks = DP / 8;
  const int b = blockIdx.x / a.Hkv, g = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int R = G * a.tq, D = a.D;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * a.tq;   // the longest walks first
  const int q_n = min(a.tq, a.Sq - q_lo);
  const int tid = threadIdx.x;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const bf16* kp = static_cast<const bf16*>(a.k);
  const bf16* vp = static_cast<const bf16*>(a.v);
  auto q_off = [&](int r) -> long long {
    return (long long)b * a.q_sb + (long long)(q_lo + r % a.tq) * a.q_ss +
           (long long)(g * G + r / a.tq) * a.q_sh;
  };
  auto do_off = [&](int r) -> long long {
    return (long long)b * a.do_sb + (long long)(q_lo + r % a.tq) * a.do_ss +
           (long long)(g * G + r / a.tq) * a.do_sh;
  };

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + L::kRowBytes;
  const uint32_t kv_s = do_s + L::kRowBytes;      // stage s: K at kv_s + s * 2 * kTileBytes, V after

  int t_end = (a.Skv + kTile - 1) / kTile;
  if (a.causal) t_end = min(t_end, (q_lo + q_n - 1) / kTile + 1);
  const int t_begin = a.window > 0 ? max(0, q_lo - a.window + 1) / kTile : 0;
  const int n_tiles = max(0, t_end - t_begin);
  const int cpr = D / 8;

  // Q and dO: zero-filled past the block's rows, past its query indices and past D
#pragma unroll
  for (int i = tid; i < L::kRows * kChunks; i += kT) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < R && r % a.tq < q_n && c < cpr;
    const uint32_t dst = (c >> 3) * (L::kRows * 128) + sm90::swizzle128(r, c & 7);
    sm90::cp_async16(q_s + dst, ok ? q + q_off(r) + c * 8 : q, ok);
    sm90::cp_async16(do_s + dst, ok ? dout + do_off(r) + c * 8 : dout, ok);
  }
  auto load_tile = [&](int j, int stage) {
    const uint32_t ks = kv_s + stage * 2 * L::kTileBytes;
    const long long base = (long long)b * a.kv_sb + (long long)g * a.kv_sh +
                           (long long)j * kTile * a.kv_ss;
    const int valid = min(kTile, a.Skv - j * kTile);
    load_tile64<DP, kT>(ks, kp + base, a.kv_ss, valid, D);
    load_tile64<DP, kT>(ks + L::kTileBytes, vp + base, a.kv_ss, valid, D);
  };
  // group s holds tile t_begin + s (group 0 also Q and dO)
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_tiles) load_tile(t_begin + s, s);
    sm90::cp_async_commit();
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // this thread's two rows of its warpgroup's accumulators, their lse (log2
  // units; +inf for a pad row: P = 0) and Delta
  int row[2], qpos[2];
  bool live[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    row[e] = wg * 64 + warp * 16 + (lane >> 2) + 8 * e;
    live[e] = row[e] < R && row[e] % a.tq < q_n;
    qpos[e] = q_lo + row[e] % a.tq;
    const long long at = ((long long)b * a.H + g * G + row[e] / a.tq) * a.Sq + qpos[e];
    lse2[e] = live[e] ? a.lse[at] * kLog2e : __int_as_float(0x7f800000);
    dl[e] = live[e] ? a.delta[at] : 0.f;
  }
  const bool capped = a.softcap > 0.f;
  const float scale_log2 = a.scale * kLog2e;
  const float scale_cap = capped ? a.scale / a.softcap : 0.f;
  const float cap_log2 = a.softcap * kLog2e;
  const int lo_pos = q_lo, hi_pos = q_lo + q_n - 1;
  float acc[kCB][32];
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j = t_begin + it;
    sm90::cp_async_wait<L::kStages - 2>();
    sm90::fence_proxy_async();
    __syncthreads();  // tile j visible to all; every warpgroup is done with tile j - 1
    if (it + L::kStages - 1 < n_tiles) load_tile(j + L::kStages - 1, (it + L::kStages - 1) % L::kStages);
    sm90::cp_async_commit();
    const uint32_t ks = kv_s + (it % L::kStages) * 2 * L::kTileBytes, vs = ks + L::kTileBytes;

    // S = Q K^T and dP = dO V^T (rows x keys), both operands K-major
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      const uint32_t rows = (kk >> 2) * (L::kRows * 128) + wg * 64 * 128 + col;
      const uint32_t keys = (kk >> 2) * (kTile * 128) + col;
      sm90::wgmma_ss<64, 0, 0>(s, sm90::desc128(q_s + rows, 16, 1024),
                               sm90::desc128(ks + keys, 16, 1024));
      sm90::wgmma_ss<64, 0, 0>(dp, sm90::desc128(do_s + rows, 16, 1024),
                               sm90::desc128(vs + keys, 16, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // scale * dS in f32, into s: element i is row e = i / 2 % 2, key
    // k_lo + 8 (i / 4) + 2 (lane % 4) + i % 2; masks only on a tile some
    // (row, key) of the block cannot see
    const int k_lo = j * kTile, k_hi = k_lo + kTile - 1;
    const bool edge = k_hi >= a.Skv || (a.causal && k_hi > lo_pos) ||
                      (a.window > 0 && hi_pos - k_lo >= a.window);
    const int key0 = k_lo + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      float lg, th = 0.f;
      if (capped) {
        th = tanhf(s[i] * scale_cap);
        lg = cap_log2 * th;
      } else {
        lg = s[i] * scale_log2;
      }
      float p = sm90::fast_exp2(lg - lse2[e]);
      if (edge) {
        const int kpos = key0 + 8 * (i >> 2) + (i & 1);
        const bool ok = live[e] && kpos < a.Skv && (!a.causal || kpos <= qpos[e]) &&
                        (a.window <= 0 || qpos[e] - kpos < a.window);
        p = ok ? p : 0.f;
      }
      float ds = p * (dp[i] - dl[e]);
      if (capped) ds *= 1.f - th * th;
      s[i] = ds * a.scale;
    }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) da[kk][r] = sm90::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // dQ += dS K: column block cb of K, keys 16 kk .. 16 kk + 15; K is
    // MN-major here (D-contiguous rows), as the forward's V
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) sm90::fence_regs(acc[cb]);
    sm90::wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<64, 1>(acc[cb], da[kk],
                              sm90::desc128(ks + cb * (kTile * 128) + kk * 2048, 1024, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) sm90::fence_regs(acc[cb]);
  }
  sm90::cp_async_wait<0>();  // no copy may outlive the block

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int e = (i >> 1) & 1;
      const int d = cb * 64 + 8 * (i >> 2) + 2 * (lane & 3);
      if (live[e] && d < D)
        *reinterpret_cast<__nv_bfloat162*>(dq + q_off(row[e]) + d) =
            __floats2bfloat162_rn(acc[cb][i], acc[cb][i + 1]);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t launch_kernel(Kernel* kernel, dim3 grid, int threads, size_t smem,
                          int (&set)[kv_tile::kMaxDevices], const BwdArgs& a,
                          cudaStream_t stream) {
  cudaError_t err = kv_tile::raise_smem_limit(kernel, smem, set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_delta(const BwdArgs& a, void (*kernel)(BwdArgs), cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.Sq;
  kernel<<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// float32: the scalar body
int launch_f32(const BwdArgs& a, cudaStream_t stream) {
  // ops.py bwd_smem_bytes mirrors these two sizes
  const size_t ld = a.D + 4;
  const size_t dkdv_smem =
      sizeof(float) * (2 * kBk * ld + 2 * kBq * ld + 2 * (size_t)kBk * a.D + 2 * kBq * kBk + 2 * kBq);
  const size_t dq_smem =
      sizeof(float) * (2 * kBq * ld + 2 * kBk * ld + (size_t)kBq * a.D + kBq * kBk + 2 * kBq);
  static int dkdv_set[kv_tile::kMaxDevices] = {};
  static int dq_set[kv_tile::kMaxDevices] = {};
  cudaError_t err = launch_delta(a, delta_kernel<float>, stream);
  if (err == cudaSuccess)
    err = launch_kernel(dkdv_kernel<float>, dim3(a.B * a.Hkv, (a.Skv + kBk - 1) / kBk), kThreads,
                        dkdv_smem, dkdv_set, a, stream);
  if (err == cudaSuccess)
    err = launch_kernel(dq_kernel<float>, dim3(a.B * a.H, (a.Sq + kBq - 1) / kBq), kThreads,
                        dq_smem, dq_set, a, stream);
  return (int)err;
}

template <int DP, bool DV, bool DK>
cudaError_t launch_dkdv(const BwdArgs& a, cudaStream_t stream) {
  static int set[kv_tile::kMaxDevices] = {};
  return launch_kernel(dkdv_tc_kernel<DP, DV, DK>,
                       dim3(a.B * a.Hkv, (a.Skv + kTile - 1) / kTile, a.splits), 128,
                       DkdvLayout<DP>::kBytes, set, a, stream);
}

template <int DP, int NWG>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  static int set[kv_tile::kMaxDevices] = {};
  return launch_kernel(dq_tc_kernel<DP, NWG>, dim3(a.B * a.Hkv, (a.Sq + a.tq - 1) / a.tq),
                       128 * NWG, DqLayout<DP, NWG>::kBytes, set, a, stream);
}

// The bf16 plan (ops.py bwd_plan mirrors it): dQ rows as the forward's
// plan (G * tq <= 128, 64 at D > 128); the dK/dV walk split over the
// group's heads where B * Hkv * key tiles is under one block an SM, to
// about four blocks an SM, at most kMaxSplits.  Sets tq, hps and splits;
// returns the scratch floats: Delta, then the splits' partials from the
// next 16-byte boundary (-1 where G exceeds a dQ block's rows).
long long plan_bf16(BwdArgs& a) {
  const int G = a.H / a.Hkv;
  const int max_rows = a.D > 128 ? 64 : 128;
  if (G > max_rows) return -1;
  a.tq = std::max(1, std::min(a.Sq, max_rows / G));
  const long long blocks = (long long)a.B * a.Hkv * ((a.Skv + kTile - 1) / kTile);
  a.hps = G;
  if (blocks < kSMs) {
    const int want = (int)std::min<long long>(std::min(G, kMaxSplits),
                                              (4 * kSMs + blocks - 1) / blocks);
    a.hps = (G + want - 1) / want;
  }
  a.splits = (G + a.hps - 1) / a.hps;
  const long long delta = ((long long)a.B * a.H * a.Sq + 3) & ~3LL;
  return delta + (a.splits > 1 ? 2LL * a.splits * a.B * a.Hkv * a.Skv * a.D : 0);
}

// bfloat16: the tensor-core bodies, as plan_bf16 plans them
int launch_bf16(BwdArgs a, cudaStream_t stream) {
  if (plan_bf16(a) < 0) return (int)cudaErrorInvalidValue;
  const int G = a.H / a.Hkv;
  a.part = a.delta + (((long long)a.B * a.H * a.Sq + 3) & ~3LL);

  cudaError_t err = launch_delta(a, delta_kernel<bf16>, stream);
  if (err == cudaSuccess) {
    if (a.D <= 64) {
      err = launch_dkdv<64, true, true>(a, stream);
    } else if (a.D <= 128) {
      err = launch_dkdv<128, true, true>(a, stream);
    } else {
      err = launch_dkdv<256, true, false>(a, stream);
      if (err == cudaSuccess) err = launch_dkdv<256, false, true>(a, stream);
    }
  }
  if (err == cudaSuccess && a.splits > 1) {
    const long long n_grad = (long long)a.B * a.Hkv * a.Skv * a.D;
    dkdv_sum_kernel<<<(unsigned)((n_grad + kThreads - 1) / kThreads), kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    const bool two = G * a.tq > 64;
    if (a.D <= 64)
      err = two ? launch_dq<64, 2>(a, stream) : launch_dq<64, 1>(a, stream);
    else if (a.D <= 128)
      err = two ? launch_dq<128, 2>(a, stream) : launch_dq<128, 1>(a, stream);
    else
      err = launch_dq<256, 1>(a, stream);
  }
  return (int)err;
}

}  // namespace

// The launch plan of flash_attention_bwd at one shape and dtype (0 =
// float32, 1 = bfloat16): *scratch gets the floats of scratch it needs,
// *splits the splits of the dK/dV walk (1 in float32).  Returns 0, or
// cudaErrorInvalidValue where the bf16 body does not take the heads.
// ops.py sizes the scratch by it.
extern "C" int flash_attention_bwd_plan(int B, int H, int Hkv, int Sq, int Skv, int D,
                                        int dtype, long long* scratch, int* splits) {
  BwdArgs a{};
  a.B = B; a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Skv = Skv; a.D = D;
  if (dtype != 1) {
    *scratch = (long long)B * H * Sq;
    *splits = 1;
    return 0;
  }
  *scratch = plan_bf16(a);
  *splits = a.splits;
  return *scratch < 0 ? (int)cudaErrorInvalidValue : 0;
}

// q, o, dout, dq (B, H, Sq, D); k, v, dk, dv (B, Hkv, Skv, D); lse (B, H,
// Sq) float32, contiguous.  delta: float32 scratch of the floats
// flash_attention_bwd_plan gives: Delta (B, H, Sq), then, where the bf16 dK/dV walk is
// split over the group's heads, the splits' partials from the next 16-byte
// boundary.  Strides (elements) for batch, position and head: q_st (q and
// dq), o_st, do_st, kv_st (k, v, dk and dv); each tensor's D elements are
// contiguous.  Query i sits at position i and key t at position t; window
// <= 0: none; softcap <= 0: none; dtype 0 = float32 (scalar body), 1 =
// bfloat16 (tensor cores).  The launches (Delta, dK/dV (twice at D > 128),
// the split sum where split, dQ) go on `stream`; returns cudaGetLastError()
// after them (0 = success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int Hkv, int Sq, int Skv,
                                   int D, int causal, int window, float softcap, float scale,
                                   const long long* q_st, const long long* o_st,
                                   const long long* do_st, const long long* kv_st, int dtype,
                                   void* stream) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Skv = Skv; a.D = D;
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
  a.q_sb = q_st[0]; a.q_ss = q_st[1]; a.q_sh = q_st[2];
  a.o_sb = o_st[0]; a.o_ss = o_st[1]; a.o_sh = o_st[2];
  a.do_sb = do_st[0]; a.do_ss = do_st[1]; a.do_sh = do_st[2];
  a.kv_sb = kv_st[0]; a.kv_ss = kv_st[1]; a.kv_sh = kv_st[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_bf16(a, s) : launch_f32(a, s);
}
