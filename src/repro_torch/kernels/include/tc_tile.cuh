// Shared memory tiles and wgmma register layouts of the port's tensor-core
// kernels for the mLSTM (csrc/mlstm.cu, csrc/mlstm_bwd.cu) and the SSD scan
// (csrc/mamba_scan.cu, csrc/mamba_scan_bwd.cu): the 128-byte-swizzled tiles
// of sm90.cuh, where accumulator element i and A-fragment register x of a
// thread sit, the hi + lo bf16 pair, and the loops the forwards and the
// backwards share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace tc_tile {

using bf16 = __nv_bfloat16;

// A tile of 64 rows x 64 bf16 columns in the 128-byte-swizzled layout.
constexpr int kTile = 64 * 64 * 2;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

// The named barrier of warpgroup wg (128 threads; id 0 is __syncthreads).
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// The 1024-byte-aligned start of dynamic shared memory (the swizzle needs it).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (sm90::smem_addr(raw) & 1023u)) & 1023u);
}

// Element (r, c) of a swizzled tile of bf16 with 64-element rows.
__device__ __forceinline__ bf16* tile_at(uint8_t* tile, int r, int c) {
  return reinterpret_cast<bf16*>(tile + sm90::swizzle128(r, c >> 3) + (c & 7) * 2);
}

// Row and column of accumulator element i (sm90.cuh's layout) within a
// warpgroup's 64-row tile; the A-fragment register x of k-step kk holds
// (frag_row(x), frag_col(kk, x)) and the column after it.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}
__device__ __forceinline__ int frag_row(int x) { return acc_row(2 * x); }
__device__ __forceinline__ int frag_col(int kk, int x) {
  return 16 * kk + 8 * (x >> 1) + 2 * (threadIdx.x & 3);
}

// Sum over the quad of lanes that holds an accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// (x, y) as a pair of bf16x2 registers: hi = (x, y) rounded, lo = the rest
// rounded; a product over hi and one over lo carry ~16 significant bits of
// x and y.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = sm90::pack_bf16(x, y);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = sm90::pack_bf16(x - __low2float(h), y - __high2float(h));
}

// Copies rows [0, 64) of the (steps, 64 columns) tile of x (B, S, H, dh)
// that starts at element `base` (step t at base + t * row_stride) into a
// swizzled tile at `dst`, by the 128 threads numbered `tid`: rows past
// `rows` and columns past `cols` are zero-filled (read nothing).
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ x, size_t base,
                                          size_t row_stride, int rows, int cols, int tid) {
#pragma unroll
  for (int p = 0; p < 64 * 8 / 128; ++p) {
    const int i = tid + p * 128, t = i >> 3, ch = i & 7;
    const bool ok = t < rows && ch * 8 < cols;
    sm90::cp_async16(dst + sm90::swizzle128(t, ch), ok ? x + base + t * row_stride + ch * 8 : x,
                     ok);
  }
}

// The (steps s, steps t) product x y^T of a 64-step chunk over dh (the
// mLSTM's scores q k^T, and its backward's dh v^T): both K-major as loaded,
// streamed in 64-column tiles through a ring of STAGES slots at `ring`
// (2 kTile a slot); one warpgroup.  Ends with the block synchronised and the
// ring free.
template <int STAGES>
__device__ __forceinline__ void scores_tc_loop(float (&s)[32], uint32_t ring,
                                               const bf16* __restrict__ x,
                                               const bf16* __restrict__ y, size_t base,
                                               size_t row_stride, int Lc, int dh) {
  const int n_et = (dh + 63) / 64;
  auto load = [&](int et, int slot) {
    const uint32_t xs = ring + slot * 2 * kTile;
    load_tile(xs, x, base + et * 64, row_stride, Lc, dh - et * 64, threadIdx.x);
    load_tile(xs + kTile, y, base + et * 64, row_stride, Lc, dh - et * 64, threadIdx.x);
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_et) load(p, p);
    sm90::cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  for (int et = 0; et < n_et; ++et) {
    sm90::cp_async_wait<STAGES - 2>();
    sm90::fence_proxy_async();
    __syncthreads();  // tile et visible to all; the slot of tile et - 1 is free
    if (et + STAGES - 1 < n_et)
      load(et + STAGES - 1, (et + STAGES - 1) % STAGES);
    sm90::cp_async_commit();
    const uint32_t xs = ring + (et % STAGES) * 2 * kTile, ys = xs + kTile;
    sm90::fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss<64, 0, 0>(s, sm90::desc128(xs + kk * 32, 16, 1024),
                               sm90::desc128(ys + kk * 32, 16, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(s);
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
}

// The SSD scan's inclusive cumsum of loga over a chunk of KR steps (<= 128),
// step threadIdx.x's (< KR; la = 0 past the chunk): warp scans, then the
// totals of the warps before, in order (warp_sums: KR / 32 floats of shared
// memory; a __syncthreads inside).  Returns it; l_last gets the chunk's
// total.
template <int KR>
__device__ __forceinline__ float chunk_cumsum(float la, float* warp_sums, float& l_last) {
  const int tid = threadIdx.x;
  float x = la;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, x, o);
    if ((tid & 31) >= o) x += up;
  }
  if ((tid & 31) == 31 && tid < KR) warp_sums[tid >> 5] = x;
  __syncthreads();
  l_last = 0.f;
#pragma unroll
  for (int wp = 0; wp < KR / 32; ++wp) {
    if (wp < (tid >> 5)) x += warp_sums[wp];
    l_last += warp_sums[wp];
  }
  return x;
}

}  // namespace tc_tile
