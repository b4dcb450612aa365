// Split-K decode partials and their combine, shared by the dense decode
// (decode_attention.cu, a combine kernel after the split kernel) and the
// paged decode (paged_decode.cu, combined by the last block of a row's
// splits, in the same launch).
//
// A partial is one split's float32 record of one (row, query head):
// acc[0..D), then m (the running max of its scores) and l (the sum of
// exp(score - m)).  An empty split, one that saw no visible position,
// records (0, kNegInf, 0).  The records of a (row, head) are consecutive,
// split-major: part + ((row * H + head) * n_splits + split) * (D + 2).
#pragma once

#include "kv_tile.cuh"

namespace split_combine {

__host__ __device__ inline size_t record(int row, int H, int head, int n_splits, int split,
                                         int D) {
  return (((size_t)row * H + head) * n_splits + split) * (size_t)(D + 2);
}

// out[h * D + d] = sum_s acc_s[d] e^(m_s - M) / sum_s l_s e^(m_s - M) for
// `heads` consecutive heads whose records start at `part`; zeros where no
// split saw a visible position (a dead row).  Called by every thread of
// the block.  Warp w weighs heads w, w + warps, ...: it reads every
// split's (m, l) once and leaves the weights e^(m_s - M) in w_s (0 for an
// empty split, whose acc is then never read) and 1 / L after them; each
// thread then sums its dims over the non-empty splits.  Reads go around L1 (__ldcg): other blocks may
// have written the records in this launch.
// w_s: heads * (n_splits + 1) floats of shared memory.
template <typename T>
__device__ __forceinline__ void combine(const float* __restrict__ part, T* __restrict__ out,
                                        int heads, int D, int n_splits, float* w_s) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int h = threadIdx.x >> 5; h < heads; h += warps) {
    const float* p = part + (size_t)h * n_splits * (D + 2);
    float* w = w_s + h * (n_splits + 1);
    float M = kv_tile::kNegInf;
    for (int s = lane; s < n_splits; s += 32) M = fmaxf(M, __ldcg(p + s * (D + 2) + D));
    for (int off = 16; off; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float l = __ldcg(p + s * (D + 2) + D + 1);
      const float ws = l > 0.f ? expf(__ldcg(p + s * (D + 2) + D) - M) : 0.f;
      w[s] = ws;
      L = fmaf(l, ws, L);
    }
    for (int off = 16; off; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) w[n_splits] = L > 0.f ? 1.f / L : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < heads * D; i += blockDim.x) {
    const int h = i / D, d = i - h * D;
    const float* p = part + (size_t)h * n_splits * (D + 2);
    const float* w = w_s + h * (n_splits + 1);
    float acc = 0.f;
    for (int s = 0; s < n_splits; ++s)
      if (w[s] != 0.f) acc = fmaf(__ldcg(p + s * (D + 2) + d), w[s], acc);
    kv_tile::store(out + i, acc * w[n_splits]);
  }
}

}  // namespace split_combine
