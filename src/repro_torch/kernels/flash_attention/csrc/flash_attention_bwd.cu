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
// (B, H, S, D) views of (B, S, H, D) tensors.
//
// What bounds it: operations.  The FlashAttention-2 split does five S x S x
// D products (Q K^T and dO V^T recomputed, then dV, dK and dQ), of which
// this design does seven, Q K^T and dO V^T once more for dQ; at S = 2048
// and D = 128 that is far above the bytes.  It is a first, simple and
// deterministic design, with no atomics:
//   * delta_kernel: Delta = rowsum(dO o O), one warp a row, in float32;
//   * dkdv_kernel: a block per (row, KV head, 32-key tile) holds K, V and
//     the f32 dK, dV sums of its tile in shared memory, and walks every
//     query head of the group and every 32-query tile that can see a key
//     of the tile (the causal mask and the window bound the walk);
//   * dq_kernel: a block per (row, query head, 32-query tile) holds Q, dO
//     and the f32 dQ sum, and walks the key tiles its rows can see.
// Every product is scalar float32 FMAs from shared memory (inputs converted
// on load), in 2x2 (scores) and 4x4 (gradients) register tiles; dK, dV and
// dQ are rounded to the input dtype once, at the end.  The tensor cores
// (wgmma, as the forward's bf16 body) are later work.
#include "kv_tile.cuh"

namespace {

using kv_tile::store;
using kv_tile::to_float;

constexpr int kThreads = 256;
constexpr int kBq = 32;  // query rows of a tile
constexpr int kBk = 32;  // keys of a tile

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  float* delta;        // (B, H, Sq)
  void* dq;            // q's strides
  void* dk;            // k's strides
  void* dv;
  int B, H, Hkv, Sq, Skv, D, causal, window;  // window <= 0: none
  float softcap, scale;                       // softcap <= 0: none
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

template <typename T>
int launch(const BwdArgs& a, cudaStream_t stream) {
  // ops.py bwd_smem_bytes mirrors these two sizes
  const size_t ld = a.D + 4;
  const size_t dkdv_smem =
      sizeof(float) * (2 * kBk * ld + 2 * kBq * ld + 2 * (size_t)kBk * a.D + 2 * kBq * kBk + 2 * kBq);
  const size_t dq_smem =
      sizeof(float) * (2 * kBq * ld + 2 * kBk * ld + (size_t)kBq * a.D + kBq * kBk + 2 * kBq);
  static int dkdv_set[kv_tile::kMaxDevices] = {};
  static int dq_set[kv_tile::kMaxDevices] = {};
  cudaError_t err = kv_tile::raise_smem_limit(dkdv_kernel<T>, dkdv_smem, dkdv_set);
  if (err == cudaSuccess) err = kv_tile::raise_smem_limit(dq_kernel<T>, dq_smem, dq_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  const long long rows = (long long)a.B * a.H * a.Sq;
  delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                    stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkdv_kernel<T><<<dim3(a.B * a.Hkv, (a.Skv + kBk - 1) / kBk), kThreads, dkdv_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dq_kernel<T><<<dim3(a.B * a.H, (a.Sq + kBq - 1) / kBq), kThreads, dq_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, H, Sq, D); k, v, dk, dv (B, Hkv, Skv, D); lse, delta
// (B, H, Sq) float32, contiguous (delta is scratch).  Strides (elements)
// for batch, position and head: q_st (q and dq), o_st, do_st, kv_st (k, v,
// dk and dv); each tensor's D elements are contiguous.  Query i sits at
// position i and key t at position t; window <= 0: none; softcap <= 0:
// none; dtype 0 = float32, 1 = bfloat16.  Three launches on `stream`
// (delta, dK/dV, dQ); returns cudaGetLastError() after them (0 = success).
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
  return dtype == 1 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
