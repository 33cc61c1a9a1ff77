// Ordering keys and the block-wide top-k selection shared by the top-k
// kernels (fused_topk.cu's merge, topk_v4.cu's select).
//
// A key is 64 bits: the score's order-preserving bits above, 0x7fffffff - id
// below, so a larger key is a better entry (higher score, then lower id) and
// every comparison is one integer compare.  A real key is never 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hc {

constexpr int KMAX = 128;  // the largest k of every selection but the streaming top-k's

// order-preserving map of a float to uint32 (-0 folded onto +0)
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t b = __float_as_uint(f + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float unordered_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
// id in [-1, 2^31)
__device__ __forceinline__ uint64_t make_key(float s, int id) {
  return ((uint64_t)ordered_bits(s) << 32) | (uint32_t)(0x7fffffffu - (uint32_t)id);
}
__device__ __forceinline__ float key_score(uint64_t key) {
  return unordered_bits((uint32_t)(key >> 32));
}
__device__ __forceinline__ int key_id(uint64_t key) {
  return (int)(0x7fffffffu - (uint32_t)key);
}

template <int KCAP>
struct SelectScratchT {  // shared memory of top_keys, for k <= KCAP
  unsigned int hist[256];
  uint64_t sel[KCAP];
  uint64_t prefix;
  int krem;
  int n_sel;
};
using SelectScratch = SelectScratchT<KMAX>;

// The k (<= KCAP) largest of the keys key_at(0 .. total-1), descending, in
// s.sel[0 .. k); fewer than k keys leave the rest 0.  Every thread of a
// block of NT (>= KCAP) threads calls it.  An 8-bit radix select finds the
// k-th largest key; the keys above it are gathered, copies of the k-th
// complete the k (equal keys are the same entry), and a bitonic sort
// orders them.
template <int NT, typename KeyAt, int KCAP>
__device__ void top_keys(KeyAt key_at, int total, int k, SelectScratchT<KCAP>& s) {
  static_assert(NT >= KCAP, "the bitonic sort takes one thread per slot");
  const int tid = threadIdx.x;
  uint64_t prefix = 0, mask = 0;
  int krem = k;  // rank of the wanted key among keys matching the prefix
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += NT) s.hist[i] = 0;
    __syncthreads();
    for (int e = tid; e < total; e += NT) {
      const uint64_t key = key_at(e);
      if ((key & mask) == prefix) atomicAdd(&s.hist[(key >> shift) & 255], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      int cum = 0, b = 255;
      for (; b > 0; --b) {
        if (cum + (int)s.hist[b] >= krem) break;
        cum += s.hist[b];
      }
      s.krem = krem - cum;
      s.prefix = prefix | ((uint64_t)b << shift);
      s.n_sel = 0;
    }
    __syncthreads();
    prefix = s.prefix;
    krem = s.krem;
    mask |= 0xffull << shift;
  }
  const uint64_t kth = prefix;  // krem copies of kth complete the top k
  for (int e = tid; e < total; e += NT) {
    const uint64_t key = key_at(e);
    if (key > kth) s.sel[atomicAdd(&s.n_sel, 1)] = key;
  }
  __syncthreads();
  for (int j = k - krem + tid; j < KCAP; j += NT) s.sel[j] = j < k ? kth : 0ull;
  __syncthreads();
  for (int size = 2; size <= KCAP; size <<= 1) {  // bitonic sort, descending
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (tid < KCAP) {
        const int j = tid ^ stride;
        if (j > tid) {
          const uint64_t a = s.sel[tid], b = s.sel[j];
          const bool desc = (tid & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            s.sel[tid] = b;
            s.sel[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace hc
