// Shared by the port's kernels: the dtype helpers and the shared-memory
// limit every kernel uses, and, for the flash kernel's float32 body, moving
// one tile of K/V rows from device memory into shared memory as float32.
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
