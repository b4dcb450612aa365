// The chunkwise mLSTM's gates, shared by its forward (csrc/mlstm.cu) and
// backward (csrc/mlstm_bwd.cu) kernels, so that both work out the same
// m_new, inter and w from log i, log f and the start m.
#pragma once

#include <cuda_runtime.h>

namespace mlstm_gates {

constexpr int kMaxL = 64;  // longest chunk
constexpr float kNeg = -1e30f;

// Shared memory of chunk_gates for a block of NT threads.
template <int NT>
struct GateSmem {
  float gb[kMaxL];   // in-chunk cumsum of log f
  float gi[kMaxL];   // log i
  float mn[kMaxL];   // m_new
  float it[kMaxL];   // inter
  float w[kMaxL];    // gate[Lc - 1]: step t's weight in the state update
  float sb[NT];      // b_last of the chunks before, NT at a time
  float sr[NT];      // run_last of those chunks
  float m_prev;      // the carried m at the chunk's start
};

// The gates of chunk c of row b, head h, from log i / log f (B, S, H) and
// the start m (m0 (B, H), or null for a new stream), into g, by a block of
// NT >= kMaxL threads; entries past the chunk's Lc steps: w = 0.  Ends with
// the block synchronised.
template <int NT>
__device__ void chunk_gates(const float* __restrict__ log_i, const float* __restrict__ log_f,
                            const float* __restrict__ m0, int b, int h, int H, int S, int L,
                            int c, GateSmem<NT>& g) {
  const int tid = threadIdx.x;
  auto at = [&](const float* x, int s) { return x[((size_t)b * S + s) * H + h]; };
  if (tid == 0) g.m_prev = m0 ? m0[(size_t)b * H + h] : kNeg;
  // the chunks before c (all full), NT at a time: one serial pass each,
  // then chained in order on one thread
  for (int c0 = 0; c0 < c; c0 += NT) {
    if (c0 + tid < c) {
      float cum = 0.f, run = kNeg;
      for (int s = (c0 + tid) * L; s < (c0 + tid + 1) * L; ++s) {
        cum += at(log_f, s);
        run = fmaxf(run, at(log_i, s) - cum);
      }
      g.sb[tid] = cum;
      g.sr[tid] = run;
    }
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < min(NT, c - c0); ++i) g.m_prev = g.sb[i] + fmaxf(g.m_prev, g.sr[i]);
    __syncthreads();
  }
  const int t0 = c * L, Lc = min(L, S - t0);
  if (tid < Lc) {  // step t's prefix, summed from the chunk's start in order
    float cum = 0.f;
    for (int s = 0; s <= tid; ++s) cum += at(log_f, t0 + s);
    g.gb[tid] = cum;
    g.gi[tid] = at(log_i, t0 + tid);
  }
  __syncthreads();
  const float m_prev = g.m_prev;
  if (tid < Lc) {
    float run = kNeg;
    for (int s = 0; s <= tid; ++s) run = fmaxf(run, g.gi[s] - g.gb[s]);
    const float mn = g.gb[tid] + fmaxf(m_prev, run);
    g.mn[tid] = mn;
    g.it[tid] = expf(g.gb[tid] + m_prev - mn);
  }
  __syncthreads();
  if (tid < kMaxL)
    g.w[tid] = tid < Lc ? expf(g.gb[Lc - 1] - g.gb[tid] + g.gi[tid] - g.mn[Lc - 1]) : 0.f;
  __syncthreads();
}

// The gate factor of att[s][t] (t <= s < Lc).
template <int NT>
__device__ __forceinline__ float gate(const GateSmem<NT>& g, int s, int t) {
  return expf(g.gb[s] - g.gb[t] + g.gi[t] - g.mn[s]);
}

}  // namespace mlstm_gates
