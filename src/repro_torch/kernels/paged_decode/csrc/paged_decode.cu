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
// reading each needed byte once, and about keeping loads in flight:
//   * one block per (row, KV head) serves all H/Hkv query heads of the GQA
//     group, so a K/V page is read from device memory once per group, not
//     once per query head;
//   * the block walks the row's pages itself with an online softmax, so
//     there are no per-page partials in device memory and no combine pass
//     (the TPU kernel wrote (m, l, acc) per page and combined at XLA level);
//   * pages are taken from page_table[b, j] for j in [first/BLOCK,
//     ceil(len/BLOCK)) only: pages past the row's length, and pages wholly
//     before its window, are never read; a dead row writes zeros and reads
//     nothing;
//   * a page moves as 16-byte loads, all of a thread's loads issued at
//     once, and the next page is fetched into registers while the current
//     one is computed (kv_tile.cuh), so a page costs about one latency;
//   * the arena is read in its serving layout, no transpose.
// Still simple: scalar FMAs, one page in flight at a time.  With few rows
// most SMs idle; keeping more of a row's pages in flight per block is the
// next step (PERF.md).
#include "kv_tile.cuh"

namespace {

using kv_tile::store;
using kv_tile::to_float;

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;  // a page of K (or V) for one head: <= 32 KB

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_arena, const T* __restrict__ v_arena,
    const int* __restrict__ page_table, const int* __restrict__ lengths, T* __restrict__ out,
    int H, int Hkv, int D, int P, int blk, int n_pg, int window, float softcap, float scale) {
  const int b = blockIdx.x / Hkv;
  const int g = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int len = lengths[b];
  const size_t row = ((size_t)b * H + (size_t)g * G) * D;  // first query head of the group
  T* o = out + row;
  if (len <= 0) {  // dead row: zeros, nothing read
    for (int i = tid; i < G * D; i += kThreads) store(o + i, 0.f);
    return;
  }

  extern __shared__ float smem[];
  const kv_tile::DecodeSmem sm = kv_tile::decode_smem(smem, G, D, blk);

  const int first = window > 0 ? max(0, len - window) : 0;  // first visible position
  if (first / blk >= n_pg) {  // nothing of the row inside its table
    for (int i = tid; i < G * D; i += kThreads) store(o + i, 0.f);
    return;
  }
  // a length past the table, or a page id past the arena, is clamped (as
  // the reference's gather clamps) instead of read out of bounds
  const int j_begin = first / blk, j_end = min((len + blk - 1) / blk, n_pg);
  const long long tok_stride = (long long)Hkv * D;
  auto page_base = [&](int j) -> long long {
    const int phys = min(max(page_table[(size_t)b * n_pg + j], 0), P - 1);
    return (long long)phys * blk * tok_stride + (long long)g * D;
  };
  kv_tile::TileRegs<kMaxVec> regs;
  kv_tile::fetch_tile<kMaxVec, kThreads>(regs, k_arena, v_arena, page_base(j_begin), tok_stride,
                                         blk, D);
  for (int i = tid; i < G * D; i += kThreads) sm.q[i] = to_float(q[row + i]) * scale;
  kv_tile::decode_state_init<kThreads>(sm, G, D);

  for (int j = j_begin; j < j_end; ++j) {
    kv_tile::stash_tile<kMaxVec, kThreads, T>(regs, sm.k, sm.ldk, sm.v, D, blk, blk, D);
    __syncthreads();
    if (j + 1 < j_end)  // in flight while this page is computed
      kv_tile::fetch_tile<kMaxVec, kThreads>(regs, k_arena, v_arena, page_base(j + 1),
                                             tok_stride, blk, D);
    kv_tile::decode_tile_step<kThreads>(sm, G, D, blk, blk, j * blk, first, len, softcap);
  }
  for (int i = tid; i < G * D; i += kThreads) store(o + i, sm.acc[i] / sm.l[i / D]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* page_table,
           const void* lengths, void* out, int B, int H, int Hkv, int D, int P, int blk,
           int n_pg, int window, float softcap, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * kv_tile::decode_smem_floats(G, D, blk);
  static int smem_set[kv_tile::kMaxDevices] = {};
  const cudaError_t err = kv_tile::raise_smem_limit(paged_decode_kernel<T>, smem, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  paged_decode_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, Hkv, D, P, blk, n_pg, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D); k, v (P, blk, Hkv, D); page_table (B, n_pg) int32;
// lengths (B,) int32; out (B, H, D).  window <= 0: none; softcap <= 0: none.
// dtype 0 = float32, 1 = bfloat16 (q, arenas and out share it).  The
// wrapper guarantees 16-byte aligned rows (D a multiple of 8) and a page of
// one head's K within kMaxVec * kThreads 16-byte loads.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int paged_decode_attention(const void* q, const void* k, const void* v,
                                      const void* page_table, const void* lengths, void* out,
                                      int B, int H, int Hkv, int D, int P, int blk,
                                      int n_pg, int window, float softcap, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, page_table, lengths, out, B, H, Hkv, D, P, blk,
                                 n_pg, window, softcap, scale, s);
  return launch<float>(q, k, v, page_table, lengths, out, B, H, Hkv, D, P, blk, n_pg, window,
                       softcap, scale, s);
}
