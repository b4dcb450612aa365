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
// The kernel body is the paged decode's (include/split_decode.cuh, where
// its design and what bounds it are set out): bytes bound; one block per
// (row, KV group, split) over spans of 32-position tiles, loaded by a
// cp.async ring; the partials combined by the last live split in the same
// launch, so a call is one launch; a split with nothing visible returns at
// once, which at one row (the teacher-forced prompt tokens, most of the
// dense pool's calls) is most of them.  A tile is 32 positions of the
// row's cache; the last one may be ragged, its rows past the cache
// zero-filled and never read.
#include "split_decode.cuh"

namespace {
constexpr int kTile = 32;  // positions per tile (ops.py TILE)
}  // namespace

// q (B, H, D); k, v (B, S, Hkv, D); lengths (B,) int32; part (B, H,
// n_splits, D + 2) float32 scratch; out (B, H, D); tickets (>= B * Hkv)
// int32, zero between calls (each call leaves them zero) and used by one
// launch at a time (the wrapper keeps a buffer per stream).  window <= 0:
// none; softcap <= 0: none.  dtype 0 = float32, 1 = bfloat16 (q, k, v and
// out share it).  The wrapper guarantees contiguous, 16-byte aligned rows
// (D a multiple of 8, D <= 256) and G * D <= kAccFloats * kThreads.
// Returns the error of raising the block's shared-memory limit, else
// cudaGetLastError() after the launch (0 = success).
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                                void* part, void* out, void* tickets, int B, int H, int Hkv,
                                int S, int D, int n_splits, int window, float softcap,
                                float scale, int dtype, void* stream) {
  split_decode::Args a{};
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.page_table = nullptr;
  a.lengths = static_cast<const int*>(lengths);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.H = H; a.Hkv = Hkv; a.D = D; a.P = 0; a.blk = kTile; a.n_tiles = (S + kTile - 1) / kTile;
  a.S = S; a.n_splits = n_splits; a.window = window; a.softcap = softcap; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return split_decode::launch<__nv_bfloat16, false>(a, B, s);
  return split_decode::launch<float, false>(a, B, s);
}
