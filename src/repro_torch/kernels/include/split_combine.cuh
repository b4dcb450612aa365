// Split-K decode partials and their combine, used by the split decode
// kernel (split_decode.cuh) of both the dense and the paged decode: the
// last block of a row's splits combines them, in the same launch.
//
// A partial is one split's float32 record of one (row, query head):
// acc[0..D), then m (the running max of its scores) and l (the sum of
// exp(score - m)).  Only the live splits, those that saw a visible
// position, write one; they are the first `count` of the n_splits.  The
// records of a (row, head) are consecutive, split-major: part + ((row * H
// + head) * n_splits + split) * (D + 2).
#pragma once

#include "kv_tile.cuh"

namespace split_combine {

__host__ __device__ inline size_t record(int row, int H, int head, int n_splits, int split,
                                         int D) {
  return (((size_t)row * H + head) * n_splits + split) * (size_t)(D + 2);
}

// out[h * D + d] = sum_s acc_s[d] e^(m_s - M) / sum_s l_s e^(m_s - M) over
// the first `count` records of `heads` consecutive heads whose records
// start at `part`.  Called by every thread of the block.  Warp w weighs
// heads w, w + warps, ...: it reads every split's (m, l) once and leaves
// the weights e^(m_s - M) in w_s and 1 / L after them; each thread then
// sums its dims over the splits.  Reads go around L1 (__ldcg): other
// blocks wrote the records in this launch.
// w_s: heads * (n_splits + 1) floats of shared memory.
template <typename T>
__device__ __forceinline__ void combine(const float* __restrict__ part, T* __restrict__ out,
                                        int heads, int D, int n_splits, int count, float* w_s) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int h = threadIdx.x >> 5; h < heads; h += warps) {
    const float* p = part + (size_t)h * n_splits * (D + 2);
    float* w = w_s + h * (n_splits + 1);
    float M = kv_tile::kNegInf;
    for (int s = lane; s < count; s += 32) M = fmaxf(M, __ldcg(p + s * (D + 2) + D));
    for (int off = 16; off; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int s = lane; s < count; s += 32) {
      const float ws = expf(__ldcg(p + s * (D + 2) + D) - M);
      w[s] = ws;
      L = fmaf(__ldcg(p + s * (D + 2) + D + 1), ws, L);
    }
    for (int off = 16; off; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) w[count] = 1.f / L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < heads * D; i += blockDim.x) {
    const int h = i / D, d = i - h * D;
    const float* p = part + (size_t)h * n_splits * (D + 2);
    const float* w = w_s + h * (n_splits + 1);
    float acc = 0.f;
    for (int s = 0; s < count; ++s) acc = fmaf(__ldcg(p + s * (D + 2) + d), w[s], acc);
    kv_tile::store(out + i, acc * w[count]);
  }
}

}  // namespace split_combine
