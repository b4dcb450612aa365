// Dense split-K decode attention for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces the Pallas TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/kernel.py, body _decode_kernel,
// launched at kernel.py:64): one query token per row against that row's
// dense KV cache, with GQA, a sliding window (pos >= len - window), a logit
// softcap and a per-row valid length (0 = dead slot-pool row).  In the port
// it serves the dense slot pool's decode (models/attention.py
// decode_attention), reading the pool in its serving layout (B, S, Hkv, D)
// with no transpose; the TPU kernel took (B, Hkv, S, D).
//
// What bounds it on this card: bytes.  A decode query does 4 FLOPs per K/V
// element it reads, far below the ~295 FLOP/byte where an H100's tensor
// cores, not HBM, become the limit.  The design reads each needed byte
// once and spreads the reads over the SMs:
//   * one block per (row, KV group, split) serves all H/Hkv query heads of
//     the group, so a K/V tile is read once per group, not per query head;
//   * a row's visible positions [max(0, len - window), len) are cut into
//     n_splits spans of whole 32-position tiles, one span per block, so a
//     batch of 4 rows x 8 KV heads fills the card instead of 32 of its 132
//     SMs (the TPU kernel's own split-K design); positions outside the
//     visible range are never read, and a dead row reads nothing;
//   * each block walks its span with an online softmax and writes one
//     float32 partial (acc, m, l) per query head; a second small kernel
//     combines the partials of a (row, head), as the TPU kernel's XLA
//     combine did (the record layout and the combine are shared with the
//     paged decode, split_combine.cuh);
//   * tiles move as 16-byte loads, all of a thread's loads in flight at
//     once, the next tile fetched while the current one is computed
//     (kv_tile.cuh).
// Still simple: scalar fp32 FMAs from shared memory.
#include "kv_tile.cuh"
#include "split_combine.cuh"

namespace {

using kv_tile::to_float;

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;  // a tile of K (or V) for one head: <= 32 KB
constexpr int kTile = 32;   // positions per tile

// part: (B, H, n_splits, D + 2) float32: acc[0..D), m, l of one split.
template <typename T>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ part, int H, int Hkv, int S, int D,
    int n_splits, int window, float softcap, float scale) {
  const int b = blockIdx.x / Hkv;
  const int g = blockIdx.x % Hkv;
  const int sp = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  // visible positions [first, len): the window counts from the row's
  // length, and a length past the cache is clamped to it (as the plain
  // version's mask does)
  const int first = window > 0 ? max(0, lengths[b] - window) : 0;
  const int len = min(lengths[b], S);
  // this block's tiles: an even share of the row's visible tiles
  const int vis_lo = first / kTile;
  const int vis_hi = len > first ? (len + kTile - 1) / kTile : vis_lo;
  const int per = (vis_hi - vis_lo + n_splits - 1) / n_splits;
  const int j_begin = vis_lo + sp * per;
  const int j_end = min(j_begin + per, vis_hi);

  extern __shared__ float smem[];
  const kv_tile::DecodeSmem sm = kv_tile::decode_smem(smem, G, D, kTile);
  kv_tile::decode_state_init<kThreads>(sm, G, D);
  const long long tok_stride = (long long)Hkv * D;
  const long long row_base = (long long)b * S * tok_stride + (long long)g * D;
  auto rows_of = [&](int j) { return min(kTile, S - j * kTile); };
  kv_tile::TileRegs<kMaxVec> regs;
  if (j_begin < j_end) {
    kv_tile::fetch_tile<kMaxVec, kThreads>(regs, k, v, row_base + j_begin * kTile * tok_stride,
                                           tok_stride, rows_of(j_begin), D);
    const size_t qrow = ((size_t)b * H + (size_t)g * G) * D;
    for (int i = tid; i < G * D; i += kThreads) sm.q[i] = to_float(q[qrow + i]) * scale;
  }
  __syncthreads();  // the state above is read by other threads, also with no tile

  for (int j = j_begin; j < j_end; ++j) {
    const int rows = rows_of(j);
    kv_tile::stash_tile<kMaxVec, kThreads, T>(regs, sm.k, sm.ldk, sm.v, D, rows, kTile, D);
    __syncthreads();
    if (j + 1 < j_end)  // in flight while this tile is computed
      kv_tile::fetch_tile<kMaxVec, kThreads>(regs, k, v, row_base + (j + 1) * kTile * tok_stride,
                                             tok_stride, rows_of(j + 1), D);
    kv_tile::decode_tile_step<kThreads>(sm, G, D, kTile, rows, j * kTile, first, len, softcap);
  }
  // partials of the group's G heads; an empty span leaves (0, -inf, 0)
  for (int i = tid; i < G * (D + 2); i += kThreads) {
    const int h = i / (D + 2), c = i - h * (D + 2);
    const float val = c < D ? sm.acc[h * D + c] : (c == D ? sm.m[h] : sm.l[h]);
    part[split_combine::record(b, H, g * G + h, n_splits, sp, D) + c] = val;
  }
}

// One block per (row, head): the shared combine (split_combine.cuh) of its
// n_splits partials.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part, T* __restrict__ out, int D,
                               int n_splits) {
  extern __shared__ float w_s[];  // [n_splits] weights, then 1 / L
  split_combine::combine(part + (size_t)blockIdx.x * n_splits * (D + 2),
                         out + (size_t)blockIdx.x * D, 1, D, n_splits, w_s);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* part,
           void* out, int B, int H, int Hkv, int S, int D, int n_splits, int window,
           float softcap, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * kv_tile::decode_smem_floats(G, D, kTile);
  static int smem_set[kv_tile::kMaxDevices] = {};
  cudaError_t err = kv_tile::raise_smem_limit(split_kernel<T>, smem, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  split_kernel<T><<<dim3(B * Hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(part), H, Hkv, S, D, n_splits,
      window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<B * H, 128, sizeof(float) * (n_splits + 1), stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), D, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D); k, v (B, S, Hkv, D); lengths (B,) int32; part (B, H,
// n_splits, D + 2) float32 scratch; out (B, H, D).  window <= 0: none;
// softcap <= 0: none.  dtype 0 = float32, 1 = bfloat16 (q, k, v and out
// share it).  The wrapper guarantees contiguous, 16-byte aligned rows (D a
// multiple of 8, D <= 256).  Returns cudaGetLastError() after the launches
// (0 = success).
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                                void* part, void* out, int B, int H, int Hkv, int S, int D,
                                int n_splits, int window, float softcap, float scale, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, part, out, B, H, Hkv, S, D, n_splits, window,
                                 softcap, scale, s);
  return launch<float>(q, k, v, lengths, part, out, B, H, Hkv, S, D, n_splits, window, softcap,
                       scale, s);
}
