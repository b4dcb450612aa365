// HR-tree chunk hashing for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel chunk_hash_pallas
// (src/repro/kernels/chunk_hash/kernel.py, body _hash_kernel, launched at
// kernel.py:59).  Each chunk of token ids gets the polynomial rolling hash
// of core/hrtree.chunk_hash,
//   h = SEED;  for t in chunk: h = h * 1000003 + t + 1   (mod 2^32)
// xor-folded from 32 bits down to `bits` bits.  Two entries share the
// kernel: fixed-width chunks of a (B, S) token array (the TPU kernel's
// contract), and ranged chunks given by (start, length) tables over one
// flat token array, so that one launch hashes every chunk of every prompt
// of a state broadcast: the variable-width chunks of the Sentry's L array
// and the 64-token tail alike.
//
// The TPU kernel reduces a fixed power-of-two width W in log2(W) pairwise
// steps with static powers M^(2^j).  Chunks here have any length, so the
// same associativity is carried by pairs (p, M^n): the hash polynomial of
// n tokens and the power that shifts it past them, combined as
//   (p_a, P_a) . (p_b, P_b) = (p_a * P_b + p_b, P_a * P_b)      (mod 2^32)
// One warp hashes one chunk: each lane folds a contiguous segment of
// ceil(len / 32) tokens into its pair, five shuffle steps combine the lanes
// in order, and lane 0 adds the seed, SEED * M^len + p, and folds.  All
// arithmetic is uint32_t wraparound; the fold runs in 64 bits so that
// bits = 32 never shifts a 32-bit value by 32 (undefined in C++).
//
// What bounds it on this card: bytes.  A chunk reads 4 bytes a token and
// does two multiply-adds a token; the card's integer rate is far above the
// 3.35 TB/s at which the tokens arrive.  Still simple: a lane walks its
// segment with 4-byte loads, so in a long chunk the 32 lanes read 32
// separate stretches, and a chunk shorter than 32 tokens leaves lanes
// idle.  A chunk whose range falls outside the tokens is written as -1 (no
// hash has that value) instead of reading out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMult = 1000003u;
constexpr uint32_t kSeed = 0x9E3779B9u;
constexpr int kWarps = 8;  // chunks a block

__global__ void __launch_bounds__(kWarps * 32) chunk_hash_kernel(
    const int* __restrict__ tokens, long long n_tokens, const int* __restrict__ starts,
    const int* __restrict__ lens, int width, int n_chunks, int bits,
    long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;  // c is the same for the whole warp
  long long start, len;
  if (starts != nullptr) {
    start = starts[c];
    len = lens[c];
  } else {
    start = (long long)c * width;
    len = width;
  }
  if (start < 0 || len < 0 || start + len > n_tokens) {
    if (lane == 0) out[c] = -1;
    return;
  }
  const long long seg = (len + 31) / 32;
  const long long lo = start + lane * seg;
  const long long end = start + len;
  const long long hi = lo + seg < end ? lo + seg : end;
  uint32_t p = 0u, pw = 1u;  // (hash polynomial, M^count) of the lane's tokens
  for (long long i = lo; i < hi; ++i) {
    p = p * kMult + (uint32_t)tokens[i] + 1u;
    pw *= kMult;
  }
  // combine the 32 segments in order: after the step of offset o, lane
  // l (l % 2o == 0) holds the pair of lanes l .. l + 2o - 1
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t pr = __shfl_down_sync(0xffffffffu, p, o);
    const uint32_t wr = __shfl_down_sync(0xffffffffu, pw, o);
    if ((lane & (2 * o - 1)) == 0) {
      p = p * wr + pr;
      pw *= wr;
    }
  }
  if (lane == 0) {
    uint64_t x = (uint32_t)(kSeed * pw + p);
    const uint64_t mask = (1ull << bits) - 1ull;
    uint64_t folded = 0;
    while (x) {
      folded ^= x & mask;
      x >>= bits;
    }
    out[c] = (long long)folded;
  }
}

}  // namespace

// tokens: n_tokens int32; starts/lens: n_chunks int32 each, or both null
// for fixed chunks of `width` tokens laid end to end; out: n_chunks int64.
// bits in 1..32 (checked by the wrapper).  Returns the launch's cudaError_t.
extern "C" int chunk_hash(const void* tokens, long long n_tokens, const void* starts,
                          const void* lens, int width, int n_chunks, int bits, void* out,
                          void* stream) {
  const int blocks = (n_chunks + kWarps - 1) / kWarps;
  chunk_hash_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), n_tokens, static_cast<const int*>(starts),
      static_cast<const int*>(lens), width, n_chunks, bits, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
