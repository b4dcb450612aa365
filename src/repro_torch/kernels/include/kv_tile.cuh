// Shared by the port's scalar attention bodies (the dense decode, the flash
// kernel's float32 body): moving one tile of K/V rows from device memory
// into shared memory as float32, and the one-token decode step over such a
// tile; also the dtype helpers and the shared-memory limit every kernel uses.
//
// A tile is `rows` rows of D elements; row t starts at element
// base + t * row_stride of the tensor.  Each thread moves its share as
// 16-byte loads (8 bf16 or 4 float32), and fetch_tile issues all of them
// before any is used, so one tile costs about one memory latency; a kernel
// can fetch the next tile into registers while it computes on the current
// one, then stash_tile it into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kv_tile {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Elements of T in one 16-byte load, and their conversion to float32.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// One thread's share of a K tile and a V tile, held in registers.
// kMaxVec 16-byte loads per tensor per thread: with kThreads threads a tile
// holds at most kMaxVec * kThreads * 16 bytes per tensor (the wrappers
// check this).
template <int kMaxVec>
struct TileRegs {
  uint4 k[kMaxVec];
  uint4 v[kMaxVec];
};

template <int kMaxVec, int kThreads, typename T>
__device__ __forceinline__ void fetch_tile(TileRegs<kMaxVec>& regs, const T* __restrict__ k,
                                           const T* __restrict__ v, long long base,
                                           long long row_stride, int rows, int D) {
  const int per_row = D / Pack<T>::N;
  const int total = rows * per_row;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < total) {
      const int t = i / per_row, c = i - t * per_row;
      const long long off = base + t * row_stride + (long long)c * Pack<T>::N;
      regs.k[j] = __ldg(reinterpret_cast<const uint4*>(k + off));
      regs.v[j] = __ldg(reinterpret_cast<const uint4*>(v + off));
    }
  }
}

// Writes the fetched tile to k_s (row stride ldk) and v_s (row stride ldv)
// as float32; rows in [rows, rows_pad) are zero-filled.
template <int kMaxVec, int kThreads, typename T>
__device__ __forceinline__ void stash_tile(const TileRegs<kMaxVec>& regs, float* k_s, int ldk,
                                           float* v_s, int ldv, int rows, int rows_pad, int D) {
  constexpr int N = Pack<T>::N;
  const int per_row = D / N;
  const int total = rows * per_row;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < total) {
      const int t = i / per_row, c = (i - t * per_row) * N;
      float f[N];
      Pack<T>::unpack(regs.k[j], f);
#pragma unroll
      for (int e = 0; e < N; ++e) k_s[t * ldk + c + e] = f[e];
      Pack<T>::unpack(regs.v[j], f);
#pragma unroll
      for (int e = 0; e < N; ++e) v_s[t * ldv + c + e] = f[e];
    }
  }
  for (int i = rows * D + threadIdx.x; i < rows_pad * D; i += kThreads) {
    const int t = i / D, d = i - t * D;
    k_s[t * ldk + d] = 0.f;
    v_s[t * ldv + d] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// One-token decode over K/V tiles: the per-tile step of the dense split-K
// decode (a tile is 32 positions of a row).  A block serves the G query
// heads of one KV group.
// ---------------------------------------------------------------------------

// The block's shared memory, in float32, for G heads of D dims and tiles of
// `tile` positions.
struct DecodeSmem {
  float* q;    // [G][D] scaled queries
  float* k;    // [tile][D + 1] padded K rows: the score loop reads k down
               // a column without bank conflicts
  float* v;    // [tile][D]
  float* p;    // [G][tile] scores, then probabilities
  float* acc;  // [G][D]
  float* m;    // [G] running max
  float* l;    // [G] running sum
  float* a;    // [G] rescale of this tile
  int ldk;
};

__host__ __device__ inline size_t decode_smem_floats(int G, int D, int tile) {
  return (size_t)2 * G * D + (size_t)tile * (D + 1) + (size_t)tile * D + (size_t)G * tile +
         3 * (size_t)G;
}

__device__ __forceinline__ DecodeSmem decode_smem(float* smem, int G, int D, int tile) {
  DecodeSmem s;
  s.ldk = D + 1;
  s.q = smem;
  s.k = s.q + G * D;
  s.v = s.k + tile * s.ldk;
  s.p = s.v + tile * D;
  s.acc = s.p + G * tile;
  s.m = s.acc + G * D;
  s.l = s.m + G;
  s.a = s.l + G;
  return s;
}

// Empty running state: acc = 0, m = -inf, l = 0.
template <int kThreads>
__device__ __forceinline__ void decode_state_init(const DecodeSmem& s, int G, int D) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) s.acc[i] = 0.f;
  for (int i = threadIdx.x; i < G; i += kThreads) {
    s.m[i] = kNegInf;
    s.l[i] = 0.f;
  }
}

// Folds the tile in s.k / s.v (its first `rows` rows real, at positions
// pos0 + t) into the running state: scores of the G heads with the logit
// softcap (softcap <= 0: none), positions outside [first, len) masked, the
// online-softmax update of (m, l) and acc = acc * rescale + P V.  Every
// tile the caller visits holds at least one visible position, so the
// running max is finite after it.  The caller has synchronised the block
// after writing the tile; on return the block is synchronised and the
// tile's shared memory may be rewritten.
template <int kThreads>
__device__ __forceinline__ void decode_tile_step(const DecodeSmem& s, int G, int D, int tile,
                                                 int rows, int pos0, int first, int len,
                                                 float softcap) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < G * tile; i += kThreads) {
    const int h = i / tile, t = i - h * tile;
    const float* qh = s.q + h * D;
    const float* kt = s.k + t * s.ldk;
    float x = 0.f;
    for (int d = 0; d < D; ++d) x = fmaf(qh[d], kt[d], x);
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    const int pos = pos0 + t;
    s.p[i] = (t < rows && pos < len && pos >= first) ? x : kNegInf;
  }
  __syncthreads();
  for (int h = warp; h < G; h += kThreads / 32) {  // one warp per query head
    float* ph = s.p + h * tile;
    float mx = kNegInf;
    for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, ph[t]);
    for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = s.m[h];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int t = lane; t < tile; t += 32) {
      const float p = expf(ph[t] - m_new);
      ph[t] = p;
      sum += p;
    }
    for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      s.a[h] = alpha;
      s.l[h] = s.l[h] * alpha + sum;
      s.m[h] = m_new;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    const float* ph = s.p + h * tile;
    float a = s.acc[i] * s.a[h];
    for (int t = 0; t < rows; ++t) a = fmaf(ph[t], s.v[t * D + d], a);
    s.acc[i] = a;
  }
  __syncthreads();
}

// Raises `kernel`'s dynamic shared-memory limit to `smem` bytes on the
// current device, only when `smem` exceeds what this process already set
// there (`set_bytes`, one static array per kernel instantiation), so the
// host does not pay a driver call before every launch.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t raise_smem_limit(Kernel* kernel, size_t smem,
                                    int (&set_bytes)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if ((int)smem <= set_bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) set_bytes[dev] = (int)smem;
  return err;
}

}  // namespace kv_tile
