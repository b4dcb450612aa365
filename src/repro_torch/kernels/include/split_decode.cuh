// Split-K one-token decode attention for Hopper (sm_90a), one launch a
// call, shared by the paged decode (paged_decode.cu: K/V read from the
// node-wide arena (P, BLOCK, Hkv, D) through the row's page table) and the
// dense decode (decode_attention.cu: K/V read from the slot pool's cache
// (B, S, Hkv, D)).  One query token per row, with GQA, a sliding window
// (pos >= len - window), a logit softcap and a per-row valid length
// (0 = dead slot-pool row).
//
// What bounds it on this card: bytes.  A decode query does 4 FLOPs per K/V
// element it reads, two orders of magnitude below the ~295 FLOP/byte where
// an H100's tensor cores, not HBM, become the limit.  So the design is about
// reading each needed byte once, from as many SMs as possible, with many
// loads in flight (flash-decoding):
//   * one block per (row, KV head, split) serves all H/Hkv query heads of
//     the GQA group, so a tile of K/V is read from device memory once per
//     group, not once per query head;
//   * a row's visible tiles (a tile is a page, or 32 positions of the dense
//     cache) [first / blk, ceil(len / blk)) are cut into n_splits spans of
//     ceil(visible / n_splits) tiles (the wrapper picks n_splits from B,
//     Hkv and the row's width, so a batch of 4 rows x 8 KV heads fills the
//     card instead of 32 of its 132 SMs); each block computes its span on
//     the device from the row's length and window, so the host never reads
//     the lengths; tiles past the length, or wholly before the window, are
//     never read;
//   * the non-empty spans are the first n_live = ceil(visible / per) of
//     them, so a block whose span is empty (most of them at one short row)
//     returns at once: it reads nothing, writes nothing and takes no
//     ticket.  A dead row's split 0 writes its zeros;
//   * a block streams its tiles through a ring of 3 (float32) or 2 (bf16)
//     tiles in shared memory by 16-byte cp.async, in the cache's dtype and
//     serving layout, so the next tiles are in flight while one is computed
//     (a dense tile's rows past the cache are zero-filled, never read);
//   * scores: a warp takes a group of keys, its lanes split D into 16-byte
//     chunks, accumulate in f32 and shuffle-reduce;
//   * P.V: a thread owns (query head, 16 bytes of D) of acc, in registers
//     across the whole span, for every key of its key group; the groups
//     are summed once, at the end of the span;
//   * one launch per call: each live split writes a float32 partial (acc,
//     m, l) to scratch, and the last of the n_live blocks of a (row, KV
//     group) to finish, found by an atomic ticket after a __threadfence(),
//     combines them (split_combine.cuh) and writes the output, then resets
//     the ticket for the next call (with one live split, its block combines
//     its own record).
// Its arithmetic is float32 throughout, in both dtypes.
#pragma once

#include "kv_tile.cuh"
#include "sm90.cuh"
#include "split_combine.cuh"

namespace split_decode {
// internal to the library that includes it: its statics (the shared-memory
// limit already set) must not be shared with another kernel library's
namespace {

using kv_tile::kNegInf;
using kv_tile::Pack;
using kv_tile::to_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// tiles in the cp.async ring: 2 in bf16 (one in flight while one is
// computed: against 3 and 4 on an H100 it was the fastest at 4 rows of
// 8 KV heads, where the smaller block lets the 288 blocks run as one wave,
// and tied at one row), 3 in float32
template <typename T>
constexpr int kStages = sizeof(T) == 2 ? 2 : 3;
constexpr int kAccFloats = 32;  // a thread's acc registers: G * D <= kAccFloats * kThreads

struct Args {
  const void* q;           // (B, H, D)
  const void* k;           // paged: arena (P, blk, Hkv, D); dense: cache (B, S, Hkv, D)
  const void* v;
  const int* page_table;   // paged: (B, n_tiles); dense: null
  const int* lengths;      // (B,)
  void* out;               // (B, H, D)
  float* part;             // (B, H, n_splits, D + 2) scratch
  int* tickets;            // >= B * Hkv, zero between calls
  int H, Hkv, D;
  int P;                   // paged: arena pages
  int blk;                 // positions per tile: the page size, or 32
  int n_tiles;             // tiles of a row: the table width, or ceil(S / 32)
  int S;                   // positions of a row: n_tiles * blk (paged), the cache's S (dense)
  int n_splits, window;    // window <= 0: none
  float softcap, scale;    // softcap <= 0: none
};

// Dynamic shared memory: the ring (kStages x (K tile, V tile) in T), then
// float32 q [G][D], scores [G][blk], the key groups' sums [kThreads][N + 1]
// and the combine's weights [G][n_splits + 1].  A block past the card's
// shared memory is refused at launch (raise_smem_limit); the CPU test
// tests/test_torch_kernel_plans.py mirrors this sum for every config.
template <typename T>
size_t smem_bytes(int G, int D, int blk, int n_splits) {
  return (size_t)kStages<T> * 2 * blk * D * sizeof(T) +
         sizeof(float) * ((size_t)G * D + (size_t)G * blk + (size_t)kThreads * (Pack<T>::N + 1) +
                          (size_t)G * (n_splits + 1));
}

template <typename T, bool PAGED>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  constexpr int N = Pack<T>::N;           // elements in 16 bytes
  constexpr int kItems = kAccFloats / N;  // (head, chunk) items a thread may own
  const T* q = static_cast<const T*>(a.q);
  const T* k_src = static_cast<const T*>(a.k);
  const T* v_src = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  const int H = a.H, D = a.D, blk = a.blk, n_splits = a.n_splits;
  const int b = blockIdx.x / a.Hkv;
  const int g = blockIdx.x % a.Hkv;
  const int sp = blockIdx.y;
  const int G = H / a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cpr = D / N;                  // 16-byte chunks of a row
  const int n_items = G * cpr;
  const size_t qrow = ((size_t)b * H + (size_t)g * G) * D;  // first query head of the group

  // this split's tiles [j_begin, j_begin + n) of the visible range (ops.py
  // split_spans mirrors these lines): the window counts from the row's
  // length, and a length past the row is clamped to it (as the plain
  // versions' mask and gather do)
  const int first = a.window > 0 ? max(0, a.lengths[b] - a.window) : 0;
  const int len = min(a.lengths[b], a.S);
  const int vis_lo = first / blk;
  const int vis_hi = len > first ? (len + blk - 1) / blk : vis_lo;
  const int per = (vis_hi - vis_lo + n_splits - 1) / n_splits;
  const int n_live = per > 0 ? (vis_hi - vis_lo + per - 1) / per : 0;  // splits 0 .. n_live - 1
  const int j_begin = vis_lo + sp * per;
  const int n = max(0, min(j_begin + per, vis_hi) - j_begin);
  if (n == 0) {  // nothing visible here: a dead row's split 0 writes its zeros
    if (n_live == 0 && sp == 0)
      for (int i = tid; i < G * D; i += kThreads) kv_tile::store(out + qrow + i, 0.f);
    return;
  }

  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int tile_bytes = blk * D * (int)sizeof(T);
  float* q_s = reinterpret_cast<float*>(smem + kStages<T> * 2 * tile_bytes);
  float* p_s = q_s + G * D;
  float* red = p_s + G * blk;
  float* w_s = red + kThreads * (N + 1);
  __shared__ int last;

  const long long tok_stride = (long long)a.Hkv * D;
  auto load_tile = [&](int j, int stage) {
    long long base;
    int rows = blk;
    if (PAGED) {  // a page id past the arena is clamped, as the plain version's gather
      const int phys = min(max(a.page_table[(size_t)b * a.n_tiles + j], 0), a.P - 1);
      base = (long long)phys * blk * tok_stride + (long long)g * D;
    } else {      // the last tile of the cache may be ragged
      base = ((long long)b * a.S + (long long)j * blk) * tok_stride + (long long)g * D;
      rows = min(blk, a.S - j * blk);
    }
    const uint32_t ks = sm90::smem_addr(smem + stage * 2 * tile_bytes), vs = ks + tile_bytes;
    for (int i = tid; i < blk * cpr; i += kThreads) {
      const int t = i / cpr, c = i - t * cpr;
      const bool ok = t < rows;
      const long long off = ok ? base + t * tok_stride + (long long)c * N : 0;
      sm90::cp_async16(ks + i * 16, k_src + off, ok);
      sm90::cp_async16(vs + i * 16, v_src + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages<T> - 1; ++s) {
    if (s < n) load_tile(j_begin + s, s);
    sm90::cp_async_commit();
  }
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_float(q[qrow + i]) * a.scale;

  // scores: L lanes a key (the chunks of its row), 32 / L keys a warp pass
  int L = 1;
  while (L < cpr && L < 32) L <<= 1;
  const int kpw = 32 / L, sub = lane / L, c0 = lane % L;
  // P.V: n_items (head, chunk) items; with few items, kg_n key groups of
  // n_items threads each take every kg_n-th key; with many, a thread owns
  // items tid, tid + kThreads, ... over all keys
  const int kg_n = n_items <= kThreads ? kThreads / n_items : 1;
  const int kg = kg_n > 1 ? tid / n_items : 0;
  auto item_of = [&](int s) {
    if (kg_n > 1) return (s == 0 && kg < kg_n) ? tid - kg * n_items : n_items;
    return tid + s * kThreads;
  };
  float acc[kItems][N], m_r[kItems], l_r[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    m_r[s] = kNegInf;
    l_r[s] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[s][e] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int j = j_begin + it;
    sm90::cp_async_wait<kStages<T> - 2>();
    __syncthreads();  // tile j visible to all; tile j - 1 and its scores are done with
    if (it + kStages<T> - 1 < n)
      load_tile(j + kStages<T> - 1, (it + kStages<T> - 1) % kStages<T>);
    sm90::cp_async_commit();
    const T* kt = reinterpret_cast<const T*>(smem + (it % kStages<T>) * 2 * tile_bytes);
    const T* vt = kt + blk * D;

    for (int t0 = warp * kpw; t0 < blk; t0 += kWarps * kpw) {
      const int t = t0 + sub;
      for (int h = 0; h < G; ++h) {
        float x = 0.f;
        if (t < blk)
          for (int c = c0; c < cpr; c += L) {
            float kf[N];
            Pack<T>::unpack(*reinterpret_cast<const uint4*>(kt + t * D + c * N), kf);
            const float* qh = q_s + h * D + c * N;
#pragma unroll
            for (int e = 0; e < N; ++e) x = fmaf(qh[e], kf[e], x);
          }
        for (int off = L >> 1; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        if (t < blk && c0 == 0) {
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          const int pos = j * blk + t;
          p_s[h * blk + t] = (pos < len && pos >= first) ? x : kNegInf;
        }
      }
    }
    __syncthreads();
    // every tile of a span holds a visible position, so m is finite after it
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      const int item = item_of(s);
      if (item >= n_items) continue;
      const int h = item / cpr, c = item - h * cpr;
      const float* ph = p_s + h * blk;
      float mx = kNegInf;
      for (int t = 0; t < blk; ++t) mx = fmaxf(mx, ph[t]);
      const float m_new = fmaxf(m_r[s], mx);
      const float alpha = expf(m_r[s] - m_new);
      m_r[s] = m_new;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[s][e] *= alpha;
      float sum = 0.f;
      for (int t = kg; t < blk; t += kg_n) {
        const float p = expf(ph[t] - m_new);
        sum += p;
        float vf[N];
        Pack<T>::unpack(*reinterpret_cast<const uint4*>(vt + t * D + c * N), vf);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[s][e] = fmaf(p, vf[e], acc[s][e]);
      }
      l_r[s] = l_r[s] * alpha + sum;
    }
  }
  sm90::cp_async_wait<0>();

  if (kg_n > 1) {  // sum the key groups (they share m)
    if (kg < kg_n) {
#pragma unroll
      for (int e = 0; e < N; ++e) red[tid * (N + 1) + e] = acc[0][e];
      red[tid * (N + 1) + N] = l_r[0];
    }
    __syncthreads();
    if (tid < n_items)
      for (int kk = 1; kk < kg_n; ++kk) {
        const float* r = red + (tid + kk * n_items) * (N + 1);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[0][e] += r[e];
        l_r[0] += r[N];
      }
  }
  // the owner of an item: key group 0 (kg_n > 1), else every thread
  auto owns = [&](int s) { return item_of(s) < n_items && kg == 0; };

#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    if (!owns(s)) continue;
    const int item = item_of(s), h = item / cpr, c = item - h * cpr;
    float* rec = a.part + split_combine::record(b, H, g * G + h, n_splits, sp, D);
#pragma unroll
    for (int e = 0; e < N; ++e) rec[c * N + e] = acc[s][e];
    if (c == 0) {
      rec[D] = m_r[s];
      rec[D + 1] = l_r[s];
    }
  }
  __threadfence();  // this split's partial is visible before its ticket is taken
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + blockIdx.x, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  split_combine::combine(a.part + split_combine::record(b, H, g * G, n_splits, 0, D),
                         out + qrow, G, D, n_splits, n_live, w_s);
  if (tid == 0) a.tickets[blockIdx.x] = 0;  // every live split of this group has taken its ticket
}

// Raises the block's shared-memory limit where needed and launches the
// (B * Hkv, n_splits) grid on `stream`.  Returns the error of raising the
// limit, else cudaGetLastError() after the launch (0 = success).
template <typename T, bool PAGED>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.H / a.Hkv, a.D, a.blk, a.n_splits);
  static int smem_set[kv_tile::kMaxDevices] = {};
  const cudaError_t err = kv_tile::raise_smem_limit(decode_kernel<T, PAGED>, smem, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  decode_kernel<T, PAGED><<<dim3(B * a.Hkv, a.n_splits), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace split_decode
