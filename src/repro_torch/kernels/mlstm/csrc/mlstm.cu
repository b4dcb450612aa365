// Chunkwise mLSTM (xLSTM matrix memory) for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the Pallas TPU kernel mlstm_pallas
// (src/repro/kernels/mlstm/kernel.py, body _mlstm_kernel, launched at
// kernel.py:106).  Per (batch row b, head h), over chunks of L steps, with
// the stabilized state (C (dh, dh), n (dh), m) carried in float32:
//   b      = inclusive cumsum of log f within the chunk
//   m_new  = b + max(m_prev, cummax(log i - b))
//   inter  = exp(b + m_prev - m_new)
//   gate   = tril(exp(b_s - b_t + log i_t - m_new_s))           (L, L)
//   att    = gate o (q k^T)
//   h      = (att v + inter o (q C)) / max(|rowsum(att) + inter o (q n)|, exp(-m_new))
//   C'     = inter_L C + (k o gate[L-1])^T v,  n' = inter_L n + (k o gate[L-1])^T 1
//
// The TPU kernel walks the chunks as a sequential grid axis with the whole
// (dh, dh) state in VMEM.  At xlstm-1.3b's width (dh = 4096 / 4 = 1024) one
// head's C is 4 MB, far beyond a block's 227 KB of shared memory, so the
// work is cut in two kernels:
//   * scores_kernel, one block per (b, h, chunk), all in parallel: the raw
//     (L, L) scores q k^T of its chunk over all dh into a float32 scratch
//     buffer (2 MB at S = 2048).  They depend on neither the carried state
//     nor the gates, so no column block has to recompute them (they are
//     as many FMAs a chunk as q C and the state update together).
//   * recurrent_kernel, one block per (b, h, 32 columns of C): the columns
//     of v, C, the numerator and h are independent given the denominator,
//     so they split over blocks (4 heads x 32 = 128 blocks on 132 SMs at
//     B = 1).  A block keeps its (dh, 32) slice of C (128 KB) and all of n
//     (carried redundantly, it is cheap) in shared memory and walks the
//     chunks in a loop, streaming q and k in tiles of 32 e-columns, each
//     tile's 16-byte loads in flight while the last one computes.
// Both read the model's layouts, q/k/v (B, S, H, dh) and gates (B, S, H),
// so the wrapper neither transposes nor pads: the ragged last chunk runs at
// its own length, which leaves m, C and n as the reference's padding
// (log i = -60, log f = 0, zero q/k/v) does.  The in-chunk cumsum is one
// serial pass, the order of the plain version's torch.cumsum, so the gates
// match it to the rounding of expf.  Built without fast math: exp(-m_new)
// must overflow to inf when m_new is very negative, as in the reference.
//
// What bounds it on this card: at B = 1, S = 2048, H = 4, dh = 1024, L = 64
// with a start state the function moves ~101 MB and does ~36.5 GFLOP:
// bound by the tensor cores' rate (~37 us at 989 TFLOP/s).  This first
// kernel runs every product as scalar fp32 FMAs from shared memory (no
// wgmma or TMA), so its floor is ~0.54 ms at 67 TFLOP/s; tensor cores for
// the four products are later work.  It is CUDA rather than Triton because
// its work is matrix products chained through a sequential carry.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kv_tile.cuh"

namespace {

using kv_tile::Pack;
using kv_tile::store;
using kv_tile::to_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;              // longest chunk
constexpr int kCols = 32;              // columns of C per block, one per lane
constexpr int kTileE = 32;             // e-columns of q and k per streamed tile
constexpr int kRows = kMaxL / kWarps;  // chunk rows per warp
constexpr float kNeg = -1e30f;

// 16-byte loads per thread for one (kMaxL, kTileE) tile of q or k.
template <typename T>
constexpr int kVec = kMaxL * kTileE / (kThreads * Pack<T>::N);

// Loads rows [0, rows) of a (rows, kTileE) tile whose row t starts at
// x + base + t * row_stride into this thread's registers.
template <typename T>
__device__ __forceinline__ void fetch(uint4 (&r)[kVec<T>], const T* __restrict__ x, size_t base,
                                      size_t row_stride, int rows) {
  constexpr int per_row = kTileE / Pack<T>::N;
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / per_row, c = i - t * per_row;
    if (t < rows)
      r[j] = __ldg(reinterpret_cast<const uint4*>(x + base + t * row_stride + c * Pack<T>::N));
  }
}

// Writes the fetched tile into dst (row stride ld) as float32, row t times
// mul[t] (or times scale where mul is null); rows [rows, rows_buf) are
// zeros, rows past rows_buf are not written.
template <typename T>
__device__ __forceinline__ void stash(const uint4 (&r)[kVec<T>], float* dst, int ld, int rows,
                                      int rows_buf, const float* mul, float scale) {
  constexpr int N = Pack<T>::N;
  constexpr int per_row = kTileE / N;
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / per_row, c = (i - t * per_row) * N;
    if (t >= rows_buf) continue;
    float f[N];
    if (t < rows) {
      Pack<T>::unpack(r[j], f);
      const float s = mul ? mul[t] : scale;
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] *= s;
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[t * ld + c + e] = f[e];
  }
}

// scores[bh, c] = (scale q_c) k_c^T over all dh for t <= s < Lc, 0 elsewhere:
// one block per (chunk, b * H + h), a 4 x 4 register tile per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scores_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ scores,
                  int S, int H, int dh, int L, float scale) {
  constexpr int ld = kTileE + 1;  // padded rows: 16 lanes read 16 k rows at once
  __shared__ __align__(16) float qs[kMaxL * ld];
  __shared__ __align__(16) float ks[kMaxL * ld];
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row_stride = (size_t)H * dh;
  const size_t base = ((size_t)b * S + t0) * row_stride + (size_t)h * dh;

  float acc[4][4] = {};
  uint4 rq[kVec<T>], rk[kVec<T>];
  fetch<T>(rq, q, base, row_stride, Lc);
  fetch<T>(rk, k, base, row_stride, Lc);
  for (int e0 = 0; e0 < dh; e0 += kTileE) {
    __syncthreads();  // the last tile is consumed
    stash<T>(rq, qs, ld, Lc, kMaxL, nullptr, scale);
    stash<T>(rk, ks, ld, Lc, kMaxL, nullptr, 1.f);
    __syncthreads();
    if (e0 + kTileE < dh) {
      fetch<T>(rq, q, base + e0 + kTileE, row_stride, Lc);
      fetch<T>(rk, k, base + e0 + kTileE, row_stride, Lc);
    }
    for (int e = 0; e < kTileE; ++e) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * ld + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
    }
  }
  float* out = scores + ((size_t)bh * gridDim.x + c) * L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = ty + 16 * i, t = tx + 16 * j;
      if (s < L && t < L) out[s * L + t] = (s < Lc && t <= s) ? acc[i][j] : 0.f;
    }
}

__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }

// Floats of recurrent_kernel's shared memory (ops.py smem_bytes agrees).
__host__ __device__ inline size_t recurrent_smem_floats(int L, int dh) {
  return (size_t)dh * kCols + dh + pad4(L * L) + (size_t)L * kCols + 2 * (size_t)L * kTileE +
         5 * (size_t)L;
}

// One block per (b * H + h, 32-column block of C) walks every chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) recurrent_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ log_i, const float* __restrict__ log_f,
    const float* __restrict__ C0, const float* __restrict__ n0, const float* __restrict__ m0,
    const float* __restrict__ scores, T* __restrict__ h_out, float* __restrict__ C_out,
    float* __restrict__ n_out, float* __restrict__ m_out, int S, int H, int dh, int L,
    float scale) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int f0 = blockIdx.y * kCols;  // this block's columns [f0, f0 + 32) of C, v, h
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                   // [dh][kCols] the carried columns of C
  float* ns = Cs + dh * kCols;        // [dh] the carried n
  float* att = ns + dh;               // [L][L] gate o scores
  float* vs = att + pad4(L * L);      // [L][kCols] this block's columns of v
  float* qs = vs + L * kCols;         // [L][kTileE] scale q, one e-tile
  float* ks = qs + L * kTileE;        // [L][kTileE] k o gate[Lc-1], one e-tile
  float* gb = ks + L * kTileE;        // [L] log f, then its inclusive cumsum
  float* gi = gb + L;                 // [L] log i
  float* mn = gi + L;                 // [L] m_new
  float* inter = mn + L;              // [L] exp(b + m_prev - m_new)
  float* w = inter + L;               // [L] gate[Lc-1]

  const size_t cbase = (size_t)bh * dh * dh;
  for (int i = tid; i < dh * kCols; i += kThreads) {
    const int e = i / kCols, f = i - e * kCols;
    Cs[i] = C0 ? C0[cbase + (size_t)e * dh + f0 + f] : 0.f;
  }
  for (int e = tid; e < dh; e += kThreads) ns[e] = n0 ? n0[(size_t)bh * dh + e] : 0.f;
  float m_prev = m0 ? m0[bh] : kNeg;

  const size_t row_stride = (size_t)H * dh;
  const int n_chunks = (S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t base = ((size_t)b * S + t0) * row_stride + (size_t)h * dh;
    uint4 rq[kVec<T>], rk[kVec<T>];
    fetch<T>(rq, q, base, row_stride, Lc);
    fetch<T>(rk, k, base, row_stride, Lc);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int t = tid; t < Lc; t += kThreads) {
      const size_t g = ((size_t)b * S + t0 + t) * H + h;
      gi[t] = log_i[g];
      gb[t] = log_f[g];
    }
    for (int i = tid; i < Lc * kCols; i += kThreads) {
      const int t = i / kCols, f = i - t * kCols;
      vs[i] = to_float(v[base + t * row_stride + f0 + f]);
    }
    __syncthreads();
    if (tid == 0) {  // cumsum and cummax: one serial pass, torch.cumsum's order
      float cum = 0.f, run = kNeg;
      for (int t = 0; t < Lc; ++t) {
        cum += gb[t];
        gb[t] = cum;
        run = fmaxf(run, gi[t] - cum);
        mn[t] = cum + fmaxf(m_prev, run);
        inter[t] = expf(cum + m_prev - mn[t]);
      }
    }
    __syncthreads();
    const float b_last = gb[Lc - 1], m_last = mn[Lc - 1], decay = inter[Lc - 1];
    const float* sc = scores + ((size_t)bh * n_chunks + c) * L * L;
    for (int i = tid; i < L * L; i += kThreads) {
      const int s = i / L, t = i - s * L;
      att[i] = (t <= s && s < Lc) ? expf(gb[s] - gb[t] + gi[t] - mn[s]) * sc[i] : 0.f;
    }
    for (int t = tid; t < Lc; t += kThreads) w[t] = expf(b_last - gb[t] + gi[t] - m_last);
    __syncthreads();

    // stream q and k over e: q C and q n from the state before this chunk,
    // then that tile's rows of C and n move to the state after it
    int rows[kRows];  // this warp's chunk rows, clamped into the chunk
#pragma unroll
    for (int i = 0; i < kRows; ++i) rows[i] = min(warp + kWarps * i, Lc - 1);
    float qc[kRows] = {}, qn[kRows] = {};
    for (int e0 = 0; e0 < dh; e0 += kTileE) {
      stash<T>(rq, qs, kTileE, Lc, L, nullptr, scale);
      stash<T>(rk, ks, kTileE, Lc, L, w, 1.f);
      __syncthreads();
      if (e0 + kTileE < dh) {
        fetch<T>(rq, q, base + e0 + kTileE, row_stride, Lc);
        fetch<T>(rk, k, base + e0 + kTileE, row_stride, Lc);
      }
      for (int e4 = 0; e4 < kTileE / 4; ++e4) {
        const float* cr = Cs + (size_t)(e0 + 4 * e4) * kCols + lane;
        const float c0 = cr[0], c1 = cr[kCols], c2 = cr[2 * kCols], c3 = cr[3 * kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 x = reinterpret_cast<const float4*>(qs + rows[i] * kTileE)[e4];
          float a = fmaf(x.x, c0, qc[i]);
          a = fmaf(x.y, c1, a);
          a = fmaf(x.z, c2, a);
          qc[i] = fmaf(x.w, c3, a);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qn[i] = fmaf(qs[rows[i] * kTileE + lane], ns[e0 + lane], qn[i]);
      __syncthreads();  // every q C and q n read the old state
      {
        const int e = 4 * warp;  // rows e0 + e .. e0 + e + 3 of C, column `lane`
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int t = 0; t < Lc; ++t) {
          const float4 kw = reinterpret_cast<const float4*>(ks + t * kTileE + e)[0];
          const float x = vs[t * kCols + lane];
          a0 = fmaf(kw.x, x, a0);
          a1 = fmaf(kw.y, x, a1);
          a2 = fmaf(kw.z, x, a2);
          a3 = fmaf(kw.w, x, a3);
        }
        float* cr = Cs + (size_t)(e0 + e) * kCols + lane;
        cr[0] = fmaf(decay, cr[0], a0);
        cr[kCols] = fmaf(decay, cr[kCols], a1);
        cr[2 * kCols] = fmaf(decay, cr[2 * kCols], a2);
        cr[3 * kCols] = fmaf(decay, cr[3 * kCols], a3);
        if (lane < 4) {
          float a = 0.f;
          for (int t = 0; t < Lc; ++t) a += ks[t * kTileE + e + lane];
          ns[e0 + e + lane] = fmaf(decay, ns[e0 + e + lane], a);
        }
      }
      __syncthreads();  // the next tile overwrites qs and ks
    }

    // h = (att v + inter q C) / max(|rowsum(att) + inter q n|, exp(-m_new))
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = warp + kWarps * i;  // warp-uniform
      float qni = qn[i];
      for (int off = 16; off; off >>= 1) qni += __shfl_xor_sync(0xffffffffu, qni, off);
      if (s >= Lc) continue;
      const float* ar = att + s * L;
      float rs = 0.f;
      for (int t = lane; t <= s; t += 32) rs += ar[t];
      for (int off = 16; off; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      float num = 0.f;
      for (int t = 0; t <= s; ++t) num = fmaf(ar[t], vs[t * kCols + lane], num);
      const float is = inter[s];
      num = fmaf(is, qc[i], num);
      const float den = fmaf(is, qni, rs);
      store(h_out + base + (size_t)s * row_stride + f0 + lane,
            num / fmaxf(fabsf(den), expf(-mn[s])));
    }
    m_prev = m_last;
  }

  __syncthreads();
  for (int i = tid; i < dh * kCols; i += kThreads) {
    const int e = i / kCols, f = i - e * kCols;
    C_out[cbase + (size_t)e * dh + f0 + f] = Cs[i];
  }
  if (blockIdx.y == 0) {
    for (int e = tid; e < dh; e += kThreads) n_out[(size_t)bh * dh + e] = ns[e];
    if (tid == 0) m_out[bh] = m_prev;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* log_i, const void* log_f,
           const void* C0, const void* n0, const void* m0, void* scores, void* h, void* C,
           void* n, void* m, int B, int S, int H, int dh, int L, float scale,
           cudaStream_t stream) {
  const int n_chunks = (S + L - 1) / L;
  scores_kernel<T><<<dim3(n_chunks, B * H), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<float*>(scores), S, H, dh,
      L, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * recurrent_smem_floats(L, dh);
  static int smem_set[kv_tile::kMaxDevices] = {};
  err = kv_tile::raise_smem_limit(recurrent_kernel<T>, smem, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  recurrent_kernel<T><<<dim3(B * H, dh / kCols), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(log_i), static_cast<const float*>(log_f),
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<const float*>(scores), static_cast<T*>(h),
      static_cast<float*>(C), static_cast<float*>(n), static_cast<float*>(m), S, H, dh, L,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v (B, S, H, dh); log_i, log_f (B, S, H) float32; C0 (B, H, dh, dh),
// n0 (B, H, dh), m0 (B, H) float32, all null for a new stream (C = n = 0,
// m = -1e30); scores (B * H, n_chunks, L, L) float32 scratch; h (B, S, H,
// dh); C, n, m the final state, float32.  L: chunk length (<= 64); scale
// multiplies q.  dtype 0 = float32, 1 = bfloat16 (q, k, v and h share it).
// The wrapper guarantees contiguous 16-byte-aligned inputs, dh a multiple of
// 32 and the shared memory within the card's 227 KB.  Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int mlstm(const void* q, const void* k, const void* v, const void* log_i,
                     const void* log_f, const void* C0, const void* n0, const void* m0,
                     void* scores, void* h, void* C, void* n, void* m, int B, int S, int H,
                     int dh, int L, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, log_i, log_f, C0, n0, m0, scores, h, C, n, m, B, S, H,
                                 dh, L, scale, s);
  return launch<float>(q, k, v, log_i, log_f, C0, n0, m0, scores, h, C, n, m, B, S, H, dh, L,
                       scale, s);
}
