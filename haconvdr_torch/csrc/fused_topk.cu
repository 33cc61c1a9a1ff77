// Exact inner-product top-k with the score matmul fused into the selection.
//
// Replaces: haconvdr_tpu/ops/pallas_topk.py:63 _topk_kernel (Pallas v3,
// reached through pallas_topk_block).  Contract (pallas_topk.py:178-199,
// 325-331): scores = q . p in f32 accumulation (bf16 operands when the
// passages are bf16; int8 passages with bf16 queries in the int8 mode,
// pallas_topk.py:126-131,203-207); rows at or past n_valid never surface; an optional
// per-query seed acts as a strict threshold and its values come back with
// id -1 where they survive; empty slots are (-inf, -1).
//
// What bounds it on the H100: the passage matrix streams from device
// memory once per query tile (7.7 GB in f32 at 2.5M x 768: 2.3 ms at the
// data sheet's 3.35 TB/s), and the score matmul is 2 * Q * N * D FLOP
// (246 GFLOP at Q = 64), so at serving batch sizes this first version is
// bound by the f32 FMA rate of the CUDA cores, not by memory.  Scores never reach
// device memory: a [Q, N] f32 score matrix would be 640 MB at Q = 64.
//
// Design.  The TPU kernel walks the passage tiles in order and carries one
// running top-k in VMEM; on Hopper the blocks run in parallel and in no
// order, so the passage axis is cut into S splits:
//  1. topk_split_kernel, one block per (64-query tile, split): a 64 x 64
//     score tile per step in registers (4 x 4 per thread), then one warp
//     per query offers the tile's scores to that query's k-slot buffer in
//     shared memory.  A score enters only if it beats the seed threshold
//     strictly and beats the buffer's worst entry; it replaces the worst.
//     Entries are 64-bit keys (order-preserving score bits, then
//     0x7fffffff - id), so "worst" and every comparison is one integer
//     compare and ties always resolve to the lower id.  The seed is NOT
//     copied into the split buffers: S copies of it would crowd real rows
//     out of the merged top-k.
//     Every score is one fmaf chain over d = 0, 1, ..., D-1 (zero-padded
//     to a multiple of DK) from 0.0f: the v4 window and rescore kernels
//     (topk_v4.cu) use the same chain, so all three give the same float
//     for the same row.  In the int8 mode each int8 passage value and
//     each bf16 query value converts to float exactly; with int8 codes
//     as queries (v4's fallback) every product and partial sum is an
//     integer below 2^24, so the scores are exact.
//  2. topk_merge_kernel, one block per query: radix-selects the k-th
//     largest key among the S * k split keys plus the seed entries (id -1),
//     keeps the k keys at or above it and bitonic-sorts them, so the
//     output is ordered (score desc, id asc) with no further sort.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_keys.cuh"

namespace {

using hc::KMAX;
using hc::key_id;
using hc::key_score;
using hc::make_key;

constexpr int QT = 64;   // queries per block
constexpr int PT = 64;   // passage rows per tile
constexpr int DK = 32;   // depth per shared-memory stage
constexpr int NT = 256;  // threads per split block (16 x 16)
constexpr int MERGE_NT = 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename TQ, typename TP>
__global__ void __launch_bounds__(NT) topk_split_kernel(
    const TQ* __restrict__ q, const TP* __restrict__ p, int Q, int D, int row_end, int k,
    const float* __restrict__ thr, int rows_per_split, uint64_t* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem_raw);  // [QT][k] keys
  float* sc = reinterpret_cast<float*>(buf + QT * k);      // [QT][PT+1] score tile
  float* qs = sc + QT * (PT + 1);                          // [DK][QT+1]
  float* ps = qs + DK * (QT + 1);                          // [DK][PT+1]
  __shared__ uint64_t min_key[QT];
  __shared__ int min_slot[QT];
  __shared__ float q_thr[QT];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(row_end, r0 + rows_per_split);
  const uint64_t empty = make_key(-INFINITY, -1);

  for (int e = tid; e < QT * k; e += NT) buf[e] = empty;
  for (int r = tid; r < QT; r += NT) {
    min_key[r] = empty;
    min_slot[r] = 0;
    q_thr[r] = (thr != nullptr && q0 + r < Q) ? thr[q0 + r] : -INFINITY;
  }

  for (int p0 = r0; p0 < r1; p0 += PT) {
    float acc[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();  // previous stage consumed (and buffers initialised)
      for (int e = tid; e < QT * DK; e += NT) {
        const int r = e / DK, dd = e % DK;
        const int qr = q0 + r, d = d0 + dd;
        qs[dd * (QT + 1) + r] = (qr < Q && d < D) ? to_f(q[(size_t)qr * D + d]) : 0.0f;
      }
      for (int e = tid; e < PT * DK; e += NT) {
        const int r = e / DK, dd = e % DK;
        const int pr = p0 + r, d = d0 + dd;
        ps[dd * (PT + 1) + r] = (pr < r1 && d < D) ? to_f(p[(size_t)pr * D + d]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DK; ++dd) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[dd * (QT + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ps[dd * (PT + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // scores at or below the seed threshold, and rows past the split end,
    // can never enter: mark them -inf (-inf never enters a buffer)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = ty + 16 * i, pj = tx + 16 * j;
        const float s = acc[i][j];
        sc[qi * (PT + 1) + pj] = (p0 + pj < r1 && s > q_thr[qi]) ? s : -INFINITY;
      }
    __syncthreads();

    // one warp per query: offer this tile's scores to the query's buffer
    for (int qi = warp; qi < QT; qi += NT / 32) {
      if (q0 + qi >= Q) break;
      uint64_t cur = min_key[qi];
      int slot = min_slot[qi];
      uint64_t* qb = buf + qi * k;
#pragma unroll
      for (int half = 0; half < PT / 32; ++half) {
        const int pj = half * 32 + lane;
        const float s = sc[qi * (PT + 1) + pj];
        const uint64_t key = make_key(s, p0 + pj);
        unsigned want = __ballot_sync(0xffffffffu, s != -INFINITY && key > cur);
        while (want) {
          const int src = __ffs(want) - 1;
          want &= want - 1;
          const uint64_t kk = __shfl_sync(0xffffffffu, key, src);
          if (kk <= cur) continue;  // warp-uniform
          if (lane == 0) qb[slot] = kk;
          __syncwarp();
          // new worst entry: (min key, lowest slot among equal keys)
          uint64_t m = ~0ull;
          int ms = 0x7fffffff;
          for (int j = lane; j < k; j += 32) {
            const uint64_t v = qb[j];
            if (v < m) { m = v; ms = j; }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const uint64_t om = __shfl_xor_sync(0xffffffffu, m, o);
            const int os = __shfl_xor_sync(0xffffffffu, ms, o);
            if (om < m || (om == m && os < ms)) { m = om; ms = os; }
          }
          cur = m;
          slot = ms;
        }
      }
      if (lane == 0) {
        min_key[qi] = cur;
        min_slot[qi] = slot;
      }
    }
    // the next tile's first __syncthreads orders these buffer updates
  }
  __syncthreads();
  for (int e = tid; e < QT * k; e += NT) {
    const int r = e / k, j = e % k;
    if (q0 + r < Q) cand[((size_t)split * Q + q0 + r) * k + j] = buf[e];
  }
}

__global__ void __launch_bounds__(MERGE_NT) topk_merge_kernel(
    const uint64_t* __restrict__ cand, int S, int Q, int k, const float* __restrict__ seed,
    int ks, float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ hc::SelectScratch scratch;
  const int q = blockIdx.x;
  const int C = S * k;
  const int total = C + (seed != nullptr ? ks : 0);
  auto key_at = [&](int e) -> uint64_t {
    if (e < C) {
      const int s = e / k, j = e % k;
      return cand[((size_t)s * Q + q) * k + j];
    }
    return make_key(seed[(size_t)q * ks + (e - C)], -1);
  };
  hc::top_keys<MERGE_NT>(key_at, total, k, scratch);
  for (int j = threadIdx.x; j < k; j += MERGE_NT) {
    out_s[(size_t)q * k + j] = key_score(scratch.sel[j]);
    out_i[(size_t)q * k + j] = key_id(scratch.sel[j]);
  }
}

size_t split_smem_bytes(int k) {
  return sizeof(uint64_t) * (size_t)QT * k +
         sizeof(float) * ((size_t)QT * (PT + 1) + DK * (QT + 1) + DK * (PT + 1));
}

template <typename TQ, typename TP>
cudaError_t launch_split(const void* q, const void* p, int Q, int D, int row_end, int k,
                         const float* thr, int rows_per_split, int n_splits, void* cand,
                         cudaStream_t stream) {
  const size_t smem = split_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_split_kernel<TQ, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + QT - 1) / QT, n_splits);
  topk_split_kernel<TQ, TP><<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(p), Q, D, row_end, k, thr,
      rows_per_split, static_cast<uint64_t*>(cand));
  return cudaGetLastError();
}

}  // namespace

// Pass 1.  q [Q, D], p [N, D], both float32 (dtype 0) or bfloat16 (1), or
// bfloat16 q with int8 p (2);
// rows >= min(n_valid, N) are skipped; thr is float [Q] or NULL; cand is
// uint64 [n_splits, Q, k] with n_splits * rows_per_split >= min(n_valid, N).
extern "C" int hc_topk_split(const void* q, const void* p, int Q, int N, int D, int n_valid,
                             int k, const void* thr, int rows_per_split, int n_splits,
                             void* cand, int dtype, void* stream) {
  if (Q <= 0 || N < 0 || D <= 0 || k <= 0 || k > KMAX || rows_per_split <= 0 ||
      n_splits <= 0 || n_splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int row_end = n_valid < N ? (n_valid < 0 ? 0 : n_valid) : N;
  if ((long long)n_splits * rows_per_split < row_end) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(thr);
  if (dtype == 0)
    return (int)launch_split<float, float>(q, p, Q, D, row_end, k, t, rows_per_split, n_splits,
                                    cand, s);
  if (dtype == 1)
    return (int)launch_split<__nv_bfloat16, __nv_bfloat16>(q, p, Q, D, row_end, k, t,
                                                           rows_per_split, n_splits, cand, s);
  if (dtype == 2)
    return (int)launch_split<__nv_bfloat16, int8_t>(q, p, Q, D, row_end, k, t,
                                                    rows_per_split, n_splits, cand, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 2.  cand uint64 [n_splits, Q, k]; seed float [Q, ks] or NULL (its
// entries join the merge with id -1); out_s float [Q, k], out_i int32 [Q, k]
// ordered (score desc, id asc).
extern "C" int hc_topk_merge(const void* cand, int n_splits, int Q, int k, const void* seed,
                             int ks, void* out_s, void* out_i, void* stream) {
  if (Q <= 0 || k <= 0 || k > KMAX || n_splits <= 0 || (seed != nullptr && ks <= 0))
    return (int)cudaErrorInvalidValue;
  topk_merge_kernel<<<Q, MERGE_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(cand), n_splits, Q, k, static_cast<const float*>(seed),
      ks, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
