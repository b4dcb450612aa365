// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel paged_decode_attention_pallas
// (src/repro/kernels/decode_attention/paged.py, body _paged_kernel, launched
// at paged.py:94): one query token per row against that row's KV, read from
// the node-wide arena (P, BLOCK, Hkv, D) through the row's page table, with
// GQA, a sliding window (pos >= len - window), a logit softcap and a
// per-row valid length (0 = dead slot-pool row).
//
// The kernel body, split over pages and combined in the same launch, is
// the one the dense decode shares (include/split_decode.cuh, where its
// design and what bounds it are set out); a tile is one page, found through
// the row's page table (a page id past the arena is clamped).
#include "split_decode.cuh"

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
  split_decode::Args a{};
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.page_table = static_cast<const int*>(page_table);
  a.lengths = static_cast<const int*>(lengths);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.H = H; a.Hkv = Hkv; a.D = D; a.P = P; a.blk = blk; a.n_tiles = n_pg; a.S = n_pg * blk;
  a.n_splits = n_splits; a.window = window; a.softcap = softcap; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return split_decode::launch<__nv_bfloat16, true>(a, B, s);
  return split_decode::launch<float, true>(a, B, s);
}
