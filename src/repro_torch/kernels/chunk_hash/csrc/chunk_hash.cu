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
// steps with static powers M^(2^j).  Chunks here have any length and any
// start, so the same associativity is carried by pairs (p, M^n): the hash
// polynomial of n tokens and the power that shifts it past them, combined
// in order as
//   (p_a, P_a) . (p_b, P_b) = (p_a * P_b + p_b, P_a * P_b)      (mod 2^32)
// A group of G lanes hashes one chunk (G = 16 at the fixed entry's width
// 64, so a warp hashes two chunks; a warp on the ranged entry, whose
// lengths the host does not know).  The chunk's tokens, from start's
// 16-byte boundary, split into R = ceil(span / 4 G) 16-byte pieces a lane:
// lane l takes pieces l R .. l R + R - 1, one int4 load each, so at the
// fixed entry's width (R = 1) neighbouring lanes read neighbouring 16
// bytes and a warp's loads are whole 128-byte lines, and a chunk of any
// length and start is one segment a lane.  A lane folds the tokens of its
// pieces that lie in the chunk into its pair (loads issued 8 pieces at a
// time, before it folds any), log2 G shuffle steps combine the group's
// pairs in lane order, and the group's first lane adds the seed,
// SEED * M^len + p, and folds.  All arithmetic is uint32_t wraparound;
// the fold runs in 64 bits so that bits = 32 never shifts a 32-bit value
// by 32 (undefined in C++).  A chunk whose range falls outside the tokens
// is written as -1 (no hash has that value) and reads nothing.
//
// What bounds it on this card: bytes.  A chunk reads 4 bytes a token and
// does two multiplies a token; the card's integer rate is far above the
// 3.35 TB/s at which the tokens arrive.  The ranged entry at the overlay's
// shape (tens of chunks, one or two blocks) sits at a launch's own cost,
// which chunk_hash_floor measures: an empty kernel with its launch shape.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMult = 1000003u;
constexpr uint32_t kSeed = 0x9E3779B9u;
constexpr int kThreads = 256;
constexpr int kRangedGroup = 32;  // lanes a ranged chunk: ops.py RANGED_GROUP
constexpr int kBatch = 8;         // pieces whose loads a lane issues at once

template <int G>
__global__ void __launch_bounds__(kThreads) chunk_hash_kernel(
    const int* __restrict__ tokens, long long n_tokens, const int* __restrict__ starts,
    const int* __restrict__ lens, int width, int n_chunks, int bits,
    long long* __restrict__ out) {
  const int l = threadIdx.x % G;  // lane in the group
  const int c = (blockIdx.x * kThreads + threadIdx.x) / G;
  // the group's lanes: the groups of a warp may take different paths
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  // tokens[0]'s 4-byte slot within its 16 bytes (a view may start anywhere)
  const int mis = (int)((reinterpret_cast<uintptr_t>(tokens) >> 2) & 3);
  long long start = 0, len = 0;
  bool ok = false;
  if (c < n_chunks) {
    if (starts != nullptr) {
      start = starts[c];
      len = lens[c];
    } else {
      start = (long long)c * width;
      len = width;
    }
    ok = start >= 0 && len >= 0 && start + len <= n_tokens;
  }
  const long long end = start + len;
  // this lane's segment: pieces [l R, l R + R) of 4 tokens from start's
  // 16-byte boundary
  const long long first = start - ((start + mis) & 3);
  const long long R = ok ? (end - first + 4 * G - 1) / (4 * G) : 0;
  const long long seg = first + 4 * R * l;
  uint32_t p = 0u, pn = 1u;  // this lane's pair: its tokens in the chunk
  for (long long k0 = 0; k0 < R; k0 += kBatch) {
    int4 v[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const long long q = seg + 4 * (k0 + r);
      v[r] = k0 + r < R && q < end ? *reinterpret_cast<const int4*>(tokens + q)
                                   : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      if (k0 + r >= R) break;
      const long long q = seg + 4 * (k0 + r);
      const int t[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q + j >= start && q + j < end) {
          p = p * kMult + (uint32_t)t[j] + 1u;
          pn *= kMult;
        }
    }
  }
  // the group's pairs in lane order: after the step of offset o, lane l
  // (l % 2o == 0) holds the pair of lanes l .. l + 2o - 1
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const uint32_t rp = __shfl_down_sync(gmask, p, o, G);
    const uint32_t rn = __shfl_down_sync(gmask, pn, o, G);
    if ((l & (2 * o - 1)) == 0) {
      p = p * rn + rp;
      pn *= rn;
    }
  }
  if (l != 0 || c >= n_chunks) return;
  if (!ok) {
    out[c] = -1;
    return;
  }
  uint64_t x = (uint32_t)(kSeed * pn + p);
  const uint64_t mask = (1ull << bits) - 1ull;
  uint64_t folded = 0;
  while (x) {
    folded ^= x & mask;
    x >>= bits;
  }
  out[c] = (long long)folded;
}

__global__ void floor_kernel() {}

// Lanes a chunk of the fixed entry: enough for one int4 a lane in a round
// that covers the width, at most a warp (ops.py group_size mirrors it).
int group_size(int width) {
  int g = 1;
  while (g < 32 && 4 * g < width) g *= 2;
  return g;
}

int blocks(int n_chunks, int G) {
  return (int)(((long long)n_chunks * G + kThreads - 1) / kThreads);
}

template <int G>
int launch(const int* tokens, long long n_tokens, const int* starts, const int* lens, int width,
           int n_chunks, int bits, long long* out, cudaStream_t stream) {
  chunk_hash_kernel<G><<<blocks(n_chunks, G), kThreads, 0, stream>>>(
      tokens, n_tokens, starts, lens, width, n_chunks, bits, out);
  return (int)cudaGetLastError();
}

}  // namespace

// tokens: n_tokens int32 (4-byte aligned, any 16-byte offset); starts/lens:
// n_chunks int32 each, or both null for fixed chunks of `width` tokens laid
// end to end; out: n_chunks int64.  bits in 1..32 (checked by the
// wrapper).  Returns the launch's cudaError_t.
extern "C" int chunk_hash(const void* tokens, long long n_tokens, const void* starts,
                          const void* lens, int width, int n_chunks, int bits, void* out,
                          void* stream) {
  const int* t = static_cast<const int*>(tokens);
  const int* st = static_cast<const int*>(starts);
  const int* ln = static_cast<const int*>(lens);
  long long* o = static_cast<long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (starts != nullptr ? kRangedGroup : group_size(width)) {
    case 1: return launch<1>(t, n_tokens, st, ln, width, n_chunks, bits, o, s);
    case 2: return launch<2>(t, n_tokens, st, ln, width, n_chunks, bits, o, s);
    case 4: return launch<4>(t, n_tokens, st, ln, width, n_chunks, bits, o, s);
    case 8: return launch<8>(t, n_tokens, st, ln, width, n_chunks, bits, o, s);
    case 16: return launch<16>(t, n_tokens, st, ln, width, n_chunks, bits, o, s);
    default: return launch<32>(t, n_tokens, st, ln, width, n_chunks, bits, o, s);
  }
}

// An empty kernel with the ranged entry's launch shape for n_chunks chunks:
// the device time of a launch that does nothing, the floor under the
// ranged entry's time.  Returns the launch's cudaError_t.
extern "C" int chunk_hash_floor(int n_chunks, void* stream) {
  floor_kernel<<<blocks(n_chunks, kRangedGroup), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
