// Chunked SSD scan (Mamba) for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel mamba_scan_pallas
// (src/repro/kernels/mamba_scan/kernel.py, body _mamba_kernel, launched at
// kernel.py:63).  Per (batch row b, head h), over chunks of L steps:
//   lcum  = inclusive cumsum of loga within the chunk
//   att   = tril(C B^T o exp(lcum_s - lcum_t))                    (L, L)
//   y     = att xbar + exp(lcum) o (C h)                           (L, P)
//   h'    = exp(lcum_L) h + B^T (xbar o exp(lcum_L - lcum))        (N, P)
// carrying h (N, P) in float32 from h0 across the chunks in order.  B and C
// (L, N) are shared by all heads, as in the model.
//
// The TPU kernel walks the chunks as a sequential grid axis with the state
// in an output block; on Hopper blocks run in any order, so one block per
// (b, h, column block) walks its chunks in a loop and keeps its columns of
// h in shared memory: nothing but y and the final state reaches device
// memory.  The columns of y and h are independent given att, so a (b, h)'s
// P columns are split over blocks of at most 64 (each recomputing the
// small C.B^T form): at B = 1, H = 64 that is 128 blocks on 132 SMs
// instead of 64.  It reads the model's
// layouts directly, xbar (B, S, H, P), loga (B, S, H), B and C (B, S, N),
// so the wrapper neither transposes nor pads: the ragged last chunk is
// masked here (padded steps have loga = 0 and xbar = 0, so the state is
// unaffected, as in the reference's zero padding).
//
// What bounds it on this card: at the full-width prefill shape (S = 2048,
// H = 64, P = 128, N = 16, L = 128) the function moves ~69 MB and does
// ~5.9 GFLOP, ~86 FLOP/byte: bytes bound on the tensor cores' rate, but
// this first kernel runs its products as scalar fp32 FMAs from shared
// memory, so the arithmetic is its real limit.  It is CUDA rather than
// Triton because its work is matrix products chained through a sequential
// carry, not a fused elementwise pass.  Tensor cores (mma/wgmma) for the
// three products, and a parallel pass over chunk states, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kv_tile.cuh"

namespace {

using kv_tile::store;
using kv_tile::to_float;

constexpr int kThreads = 256;
constexpr int kRows = 4;  // output rows a thread holds in registers

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_kernel(
    const T* __restrict__ xbar, const float* __restrict__ loga, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_out, int S, int H, int P, int N, int L, int PB) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int c0 = blockIdx.y * PB;    // this block's columns [c0, c0 + PB) of P
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  const int ldb = N + 1;             // padded B rows: att reads B down a column
  float* la = smem;                  // [L] loga of the chunk, 0 past its end
  float* lc = la + L;                // [L] inclusive cumsum
  float* w = lc + L;                 // [L] exp(lc[L-1] - lc[t])
  float* bs = w + L;                 // [L][N + 1]
  float* cs = bs + L * ldb;          // [L][N]
  float* xs = cs + L * N;            // [L][PB]
  float* att = xs + L * PB;          // [L][L]
  float* hs = att + L * L;           // [N][PB] the carried state

  const size_t hbase = (size_t)blockIdx.x * N * P + c0;
  for (int i = tid; i < N * PB; i += kThreads) {
    const int n = i / PB, p = i - n * PB;
    hs[i] = h0 ? h0[hbase + (size_t)n * P + p] : 0.f;
  }

  const int n_chunks = (S + L - 1) / L;
  const int col = tid % PB;          // this thread's column of y and h
  const int row0 = tid / PB;         // and its first row; rows step by rstep
  const int rstep = kThreads / PB;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int Lc = min(L, S - t0);   // real steps in this chunk
    __syncthreads();                 // the previous chunk is done with smem
    for (int t = tid; t < L; t += kThreads)
      la[t] = t < Lc ? loga[((size_t)b * S + t0 + t) * H + h] : 0.f;
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const size_t g = ((size_t)b * S + t0 + t) * N + n;
      bs[t * ldb + n] = t < Lc ? to_float(Bm[g]) : 0.f;
      cs[i] = t < Lc ? to_float(Cm[g]) : 0.f;
    }
    for (int i = tid; i < L * PB; i += kThreads) {
      const int t = i / PB, p = i - t * PB;
      xs[i] = t < Lc ? to_float(xbar[(((size_t)b * S + t0 + t) * H + h) * P + c0 + p]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                  // lc = cumsum(la): one serial pass, the
      float x = 0.f;                 // order of the plain version's cumsum, so
      for (int t = 0; t < L; ++t) {  // the decays exp(lc_s - lc_t) agree with it
        x += la[t];                  // to the rounding of expf (<= 128 adds)
        lc[t] = x;
      }
    }
    __syncthreads();
    const float l_last = lc[L - 1];
    for (int t = tid; t < L; t += kThreads) w[t] = expf(l_last - lc[t]);
    for (int i = tid; i < L * L; i += kThreads) {  // att = tril(C B^T o decay)
      const int s = i / L, t = i - s * L;
      float a = 0.f;
      if (t <= s && s < Lc) {
        const float* cr = cs + s * N;
        const float* br = bs + t * ldb;
        for (int n = 0; n < N; ++n) a = fmaf(cr[n], br[n], a);
        a *= expf(lc[s] - lc[t]);
      }
      att[i] = a;
    }
    __syncthreads();
    // y = att xbar + exp(lc) o (C h): kRows rows of one column per thread
    for (int s0 = row0; s0 < Lc; s0 += kRows * rstep) {
      float acc[kRows] = {};
      int rows[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) rows[r] = min(s0 + r * rstep, L - 1);
      const int t_end = min(s0 + (kRows - 1) * rstep, Lc - 1);  // att is 0 past the diagonal
      for (int t = 0; t <= t_end; ++t) {
        const float x = xs[t * PB + col];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(att[rows[r] * L + t], x, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int s = s0 + r * rstep;
        if (s >= Lc) break;
        float ch = 0.f;
        for (int n = 0; n < N; ++n) ch = fmaf(cs[s * N + n], hs[n * PB + col], ch);
        store(y + (((size_t)b * S + t0 + s) * H + h) * P + c0 + col, acc[r] + expf(lc[s]) * ch);
      }
    }
    __syncthreads();                 // every y read the old state
    // h' = exp(l_last) h + B^T (xbar o w): each thread owns its (n, col)
    const float decay = expf(l_last);
    for (int n = row0; n < N; n += rstep) {
      float a = 0.f;
      for (int t = 0; t < Lc; ++t) a = fmaf(bs[t * ldb + n], xs[t * PB + col] * w[t], a);
      hs[n * PB + col] = fmaf(decay, hs[n * PB + col], a);
    }
  }
  __syncthreads();
  for (int i = tid; i < N * PB; i += kThreads) {
    const int n = i / PB, p = i - n * PB;
    h_out[hbase + (size_t)n * P + p] = hs[i];
  }
}

template <typename T>
int launch(const void* xbar, const void* loga, const void* Bm, const void* Cm, const void* h0,
           void* y, void* h_out, int B, int S, int H, int P, int N, int L, int PB,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)3 * L + (size_t)L * (N + 1) + (size_t)L * N +
                                       (size_t)L * PB + (size_t)L * L + (size_t)N * PB);
  static int smem_set[kv_tile::kMaxDevices] = {};
  const cudaError_t err = kv_tile::raise_smem_limit(scan_kernel<T>, smem, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it again
    return (int)err;
  }
  scan_kernel<T><<<dim3(B * H, P / PB), kThreads, smem, stream>>>(
      static_cast<const T*>(xbar), static_cast<const float*>(loga), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), S, H, P, N, L, PB);
  return (int)cudaGetLastError();
}

}  // namespace

// xbar (B, S, H, P); loga (B, S, H) float32; Bm, Cm (B, S, N); h0 (B, H, N,
// P) float32 or null (zeros); y (B, S, H, P); h_out (B, H, N, P) float32.
// L: chunk length; PB: columns of P per block.  dtype 0 = float32, 1 =
// bfloat16 (xbar, Bm, Cm and y share it).  The wrapper guarantees
// contiguous inputs, PB dividing both P and the block's 256 threads, and
// the shared memory within the card's 227 KB.  Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int mamba_scan(const void* xbar, const void* loga, const void* Bm, const void* Cm,
                          const void* h0, void* y, void* h_out, int B, int S, int H, int P,
                          int N, int L, int PB, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xbar, loga, Bm, Cm, h0, y, h_out, B, S, H, P, N, L, PB, s);
  return launch<float>(xbar, loga, Bm, Cm, h0, y, h_out, B, S, H, P, N, L, PB, s);
}
