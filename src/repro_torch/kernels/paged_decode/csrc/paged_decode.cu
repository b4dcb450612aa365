// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel paged_decode_attention_pallas
// (src/repro/kernels/decode_attention/paged.py, body _paged_kernel, launched
// at paged.py:94): one query token per row against that row's KV, read from
// the node-wide arena (P, BLOCK, Hkv, D) through the row's page table, with
// GQA, a sliding window (pos >= len - window), a logit softcap and a
// per-row valid length (0 = dead slot-pool row).
//
// What bounds it on this card: bytes.  A decode query does 4 FLOPs per K/V
// element it reads, two orders of magnitude below the ~295 FLOP/byte where
// an H100's tensor cores, not HBM, become the limit.  So the design is about
// reading each needed byte once, from as many SMs as possible, with many
// loads in flight (flash-decoding, split over pages):
//   * one block per (row, KV head, split) serves all H/Hkv query heads of
//     the GQA group, so a K/V page is read from device memory once per
//     group, not once per query head;
//   * a row's visible pages [first / BLOCK, ceil(len / BLOCK)) are cut into
//     n_splits spans (the wrapper picks n_splits from B, Hkv and the table
//     width, so a batch of 4 rows x 8 KV heads fills the card instead of
//     32 of its 132 SMs); each block computes its span on the device from
//     the row's length and window, so the host never reads the lengths;
//     pages past the length, or wholly before the window, are never read,
//     and a span past the length records an empty partial;
//   * a block streams its pages through a ring of 3 (float32) or 4 (bf16)
//     pages in shared memory by 16-byte cp.async, in the arena's dtype and
//     serving layout, so the next pages are in flight while one is computed;
//   * scores: a warp takes a group of keys, its lanes split D into 16-byte
//     chunks, accumulate in f32 and shuffle-reduce;
//   * P.V: a thread owns (query head, 16 bytes of D) of acc, in registers
//     across the whole span, for every key of its key group; the groups
//     are summed once, at the end of the span;
//   * one launch per call: each split writes a float32 partial (acc, m, l)
//     to scratch, and the last block of a (row, KV group) to finish, found
//     by an atomic ticket after a __threadfence(), combines them
//     (split_combine.cuh, shared with the dense decode) and writes the
//     output, then resets the ticket for the next call (with one split, a
//     block combines its own record).
// Its arithmetic is float32 throughout, in both dtypes.
#include "kv_tile.cuh"
#include "sm90.cuh"
#include "split_combine.cuh"

namespace {

using kv_tile::kNegInf;
using kv_tile::Pack;
using kv_tile::to_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// pages in the cp.async ring: a block's span is a few pages at the serving
// shapes, so bf16 keeps them all in flight; a float32 page is twice the bytes
template <typename T>
constexpr int kStages = sizeof(T) == 2 ? 4 : 3;
constexpr int kAccFloats = 32;  // a thread's acc registers: G * D <= kAccFloats * kThreads

// Dynamic shared memory: the ring (kStages x (K page, V page) in T), then
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

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_arena, const T* __restrict__ v_arena,
    const int* __restrict__ page_table, const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int H, int Hkv, int D, int P, int blk,
    int n_pg, int n_splits, int window, float softcap, float scale) {
  constexpr int N = Pack<T>::N;           // elements in 16 bytes
  constexpr int kItems = kAccFloats / N;  // (head, chunk) items a thread may own
  const int b = blockIdx.x / Hkv;
  const int g = blockIdx.x % Hkv;
  const int sp = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cpr = D / N;                  // 16-byte chunks of a row
  const int n_items = G * cpr;

  // this split's pages [j_begin, j_end) of the visible range (ops.py
  // split_spans mirrors these lines): the window counts from the row's
  // length, and a length past the table is clamped to it (as the plain
  // version's gather clamps)
  const int first = window > 0 ? max(0, lengths[b] - window) : 0;
  const int len = min(lengths[b], n_pg * blk);
  const int vis_lo = first / blk;
  const int vis_hi = len > first ? (len + blk - 1) / blk : vis_lo;
  const int per = (vis_hi - vis_lo + n_splits - 1) / n_splits;
  const int j_begin = vis_lo + sp * per;
  const int n = max(0, min(j_begin + per, vis_hi) - j_begin);

  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int page_bytes = blk * D * (int)sizeof(T);
  float* q_s = reinterpret_cast<float*>(smem + kStages<T> * 2 * page_bytes);
  float* p_s = q_s + G * D;
  float* red = p_s + G * blk;
  float* w_s = red + kThreads * (N + 1);
  __shared__ int last;

  const long long tok_stride = (long long)Hkv * D;
  auto load_page = [&](int j, int stage) {
    const int phys = min(max(page_table[(size_t)b * n_pg + j], 0), P - 1);  // clamped
    const long long base = (long long)phys * blk * tok_stride + (long long)g * D;
    const uint32_t ks = sm90::smem_addr(smem + stage * 2 * page_bytes), vs = ks + page_bytes;
    for (int i = tid; i < blk * cpr; i += kThreads) {
      const int t = i / cpr, c = i - t * cpr;
      const long long off = base + t * tok_stride + (long long)c * N;
      sm90::cp_async16(ks + i * 16, k_arena + off, true);
      sm90::cp_async16(vs + i * 16, v_arena + off, true);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages<T> - 1; ++s) {
    if (s < n) load_page(j_begin + s, s);
    sm90::cp_async_commit();
  }
  const size_t qrow = ((size_t)b * H + (size_t)g * G) * D;  // first query head of the group
  if (n > 0)
    for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_float(q[qrow + i]) * scale;

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
    __syncthreads();  // page j visible to all; page j - 1 and its scores are done with
    if (it + kStages<T> - 1 < n)
      load_page(j + kStages<T> - 1, (it + kStages<T> - 1) % kStages<T>);
    sm90::cp_async_commit();
    const T* kt = reinterpret_cast<const T*>(smem + (it % kStages<T>) * 2 * page_bytes);
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
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const int pos = j * blk + t;
          p_s[h * blk + t] = (pos < len && pos >= first) ? x : kNegInf;
        }
      }
    }
    __syncthreads();
    // every page of a span holds a visible position, so m is finite after it
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
      for (int k = 1; k < kg_n; ++k) {
        const float* r = red + (tid + k * n_items) * (N + 1);
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
    float* rec = part + split_combine::record(b, H, g * G + h, n_splits, sp, D);
#pragma unroll
    for (int e = 0; e < N; ++e) rec[c * N + e] = acc[s][e];
    if (c == 0) {
      rec[D] = m_r[s];
      rec[D + 1] = l_r[s];
    }
  }
  __threadfence();  // this split's partial is visible before its ticket is taken
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  split_combine::combine(part + split_combine::record(b, H, g * G, n_splits, 0, D), out + qrow,
                         G, D, n_splits, w_s);
  if (tid == 0) tickets[blockIdx.x] = 0;  // every split of this group has taken its ticket
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* page_table,
           const void* lengths, void* out, void* part, void* tickets, int B, int H, int Hkv,
           int D, int P, int blk, int n_pg, int n_splits, int window, float softcap,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(H / Hkv, D, blk, n_splits);
  static int smem_set[kv_tile::kMaxDevices] = {};
  const cudaError_t err = kv_tile::raise_smem_limit(paged_decode_kernel<T>, smem, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  paged_decode_kernel<T><<<dim3(B * Hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<T*>(out), static_cast<float*>(part), static_cast<int*>(tickets), H, Hkv, D,
      P, blk, n_pg, n_splits, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D); k, v (P, blk, Hkv, D); page_table (B, n_pg) int32;
// lengths (B,) int32; out (B, H, D); part (B, H, n_splits, D + 2) float32
// scratch; tickets (>= B * Hkv) int32, zero between calls (each call
// leaves them zero) and used by one launch at a time (the wrapper keeps a
// buffer per stream).  window <= 0: none; softcap <= 0: none.  dtype 0 =
// float32, 1 = bfloat16 (q, arenas and out share it).  The wrapper
// guarantees 16-byte aligned rows (D a multiple of 8) and
// G * D <= kAccFloats * kThreads.  Returns the error of raising the
// block's shared-memory limit, else cudaGetLastError() after the launch
// (0 = success).
extern "C" int paged_decode_attention(const void* q, const void* k, const void* v,
                                      const void* page_table, const void* lengths, void* out,
                                      void* part, void* tickets, int B, int H, int Hkv, int D,
                                      int P, int blk, int n_pg, int n_splits, int window,
                                      float softcap, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, page_table, lengths, out, part, tickets, B, H, Hkv,
                                 D, P, blk, n_pg, n_splits, window, softcap, scale, s);
  return launch<float>(q, k, v, page_table, lengths, out, part, tickets, B, H, Hkv, D, P, blk,
                       n_pg, n_splits, window, softcap, scale, s);
}
