// Inline-PTX helpers for Hopper (sm_90a) shared by the port's kernels:
// 16-byte cp.async copies into shared memory, the proxy fence that makes
// them visible to wgmma, wgmma's shared-memory descriptors for the
// 128-byte-swizzled layout, and the m64nNk16 bf16 wgmma (N = 16, 32 or 64)
// in its two forms (A from shared memory, A from registers), with the
// transpose bits that read an operand stored MN-major.
//
// The 128-byte-swizzled layout (what the descriptors below describe): a
// tile of rows x 64 bf16 columns is stored as rows of 128 bytes, row r at
// r * 128, its 16-byte chunk c at chunk c ^ (r % 8); 8 rows make a
// 1024-byte atom, and the tile must start 1024-byte aligned, since the
// hardware swizzles on the address bits.  A wider tile is a sequence of
// such 64-column blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled block.
__device__ __forceinline__ uint32_t swizzle128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes 16 zero bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (stores and
// completed cp.async copies) visible to the async proxy that wgmma reads
// through; a barrier must follow before another thread's wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins a warpgroup's accumulator registers: keeps the compiler from moving
// their reads or writes across an asynchronous wgmma (issued, not waited).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_D8(d)                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define SM90_D16(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15])
#define SM90_D32(d)                                                                            \
  SM90_D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),            \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define SM90_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SM90_REGS32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D(64xN, f32) += A(64x16) B(16xN), bf16, N = 16, 32 or 64 (d holds N / 2
// floats a thread), A and B from shared memory.  TA = 0: A K-major (K
// contiguous), 1: M-major (the transpose bit); TB = 0: B K-major, 1:
// N-major.  Accumulator layout: thread t of the warpgroup, lane = t % 32,
// holds d[4j + e] at row 16 (t / 32) + lane / 4 + 8 (e / 2), column
// 8 j + 2 (lane % 4) + e % 2.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64, "m64n16k16, m64n32k16 or m64n64k16");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : SM90_D32(d)
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " SM90_REGS8
        ", %8, %9, p, 1, 1, %11, %12;\n}\n"
        : SM90_D8(d)
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SM90_REGS16
        ", %16, %17, p, 1, 1, %19, %20;\n}\n"
        : SM90_D16(d)
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
}

// The same with A from registers: four 32-bit registers a thread, the
// m16n8k16 A-fragment layout on each warp's 16 rows (the accumulator
// layout of a 16-column slice, rounded to bf16 pairs).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64, "m64n16k16, m64n32k16 or m64n64k16");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " SM90_REGS8
        ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : SM90_D8(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SM90_REGS16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : SM90_D16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
}

#undef SM90_D8
#undef SM90_D16
#undef SM90_D32
#undef SM90_REGS8
#undef SM90_REGS16
#undef SM90_REGS32

// 2^x by the SFU (ex2.approx, flushing denormals): about 2 ulp, enough for
// probabilities rounded to bf16.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace sm90
