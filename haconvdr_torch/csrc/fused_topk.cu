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
// What bounds it on the H100: the products, 2 Q N D fmaf on the CUDA cores
// (f32 at 67 TFLOP/s: 14.67 ms at Q 256 over 2.5M x 768, in every mode,
// since bf16 and int8 operands are widened to floats and run the same
// chain); the passage matrix read once (7.68 GB in f32: 2.29 ms at 3.35
// TB/s) bounds only small batches.  Scores never reach device memory: a
// [Q, N] f32 score matrix would be 2.6 GB at Q 256.
//
// Design.  The TPU kernel walks the passage tiles in order and carries one
// running top-k in VMEM; on Hopper the blocks run in parallel and in no
// order, so the passage axis is cut into S splits:
//  1. topk_split_kernel, one block per (tile of QB queries, split), the
//     query tiles of a split neighbours in the grid (their passage rows are
//     read from device memory once and from L2 after), one block an SM,
//     the splits chosen by the caller to fill the SMs' waves, at most two
//     waves unseeded and eight seeded (ops/fused_topk.split_geometry).
//     Its body is topk_split.cuh's, with the k-buffers in shared memory
//     (QB 128, or 64 at Q <= 64 and where 128 queries' buffers do not
//     fit): tile_fmaf.cuh's register-tiled fmaf product, which the v4
//     window kernel's route B also runs, a threshold filter, per-query
//     lists and sorted buffers merged by rank.  The streaming top-k
//     (topk_stream.cu) runs the same body unseeded.  The seed's threshold
//     filters; the seed is NOT copied into the split buffers: S copies of
//     it would crowd real rows out of the merged top-k.
//  2. topk_merge_kernel, one block per query: radix-selects the k-th
//     largest key among the S * k split keys plus the seed entries (id -1),
//     keeps the k keys at or above it and bitonic-sorts them, so the
//     output is ordered (score desc, id asc) with no further sort.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_keys.cuh"
#include "topk_split.cuh"

namespace {

using hc::KMAX;
using hc::key_id;
using hc::key_score;
using hc::make_key;
using hc::split::SMEM_MAX;
using hc::split::Split;
using hc::tile::THREADS;

constexpr int MERGE_NT = 1024;

template <int MODE, int QB>
__global__ void __launch_bounds__(THREADS, 1) topk_split_kernel(
    const void* __restrict__ q_, const void* __restrict__ p_, int Q, int D, int row_end, int k,
    const float* __restrict__ thr, int rows_per_split, int n_qt, bool vec,
    uint64_t* __restrict__ cand) {
  hc::split::split_topk<MODE, QB, false>(q_, p_, Q, D, row_end, k, thr, rows_per_split, n_qt,
                                         vec, cand, nullptr);
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

// QB of the split kernel at Q queries and k: 128 past Q 64 where its
// shared memory fits, else 64
template <int MODE>
int split_qb(int Q, int k) {
  return Q > 64 && Split<MODE, 128, false>::smem(k) <= (size_t)SMEM_MAX ? 128 : 64;
}

template <int MODE, int QB>
cudaError_t launch_split_qb(const void* q, const void* p, int Q, int D, int row_end, int k,
                            const float* thr, int rows_per_split, int n_splits, bool vec,
                            void* cand, cudaStream_t stream) {
  const size_t smem = Split<MODE, QB, false>::smem(k);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(topk_split_kernel<MODE, QB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Q + QB - 1) / QB;
  const long long blocks = (long long)n_qt * n_splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  topk_split_kernel<MODE, QB><<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, p, Q, D, row_end, k, thr, rows_per_split, n_qt, vec, static_cast<uint64_t*>(cand));
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_split(const void* q, const void* p, int Q, int D, int row_end, int k,
                         const float* thr, int rows_per_split, int n_splits, void* cand,
                         cudaStream_t stream) {
  using K = Split<MODE, 64, false>;
  // 16-byte copies need 16-byte rows and bases; else the narrower loads
  const bool vec = (D * (int)sizeof(typename K::PT)) % 16 == 0 &&
                   (D * (int)sizeof(typename K::QT)) % 16 == 0 && ((uintptr_t)q & 15) == 0 &&
                   ((uintptr_t)p & 15) == 0;
  if (split_qb<MODE>(Q, k) == 128)
    return launch_split_qb<MODE, 128>(q, p, Q, D, row_end, k, thr, rows_per_split, n_splits,
                                      vec, cand, stream);
  return launch_split_qb<MODE, 64>(q, p, Q, D, row_end, k, thr, rows_per_split, n_splits, vec,
                                   cand, stream);
}

}  // namespace

// Pass 1.  q [Q, D], p [N, D], both float32 (dtype 0) or bfloat16 (1), or
// bfloat16 q with int8 p (2);
// rows >= min(n_valid, N) are skipped; thr is float [Q] or NULL; cand is
// uint64 [n_splits, Q, k] with n_splits * rows_per_split >= min(n_valid, N).
// The grid is ceil(Q / hc_topk_split_qb(Q, k, dtype)) x n_splits blocks,
// one an SM.
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
    return (int)launch_split<0>(q, p, Q, D, row_end, k, t, rows_per_split, n_splits, cand, s);
  if (dtype == 1)
    return (int)launch_split<1>(q, p, Q, D, row_end, k, t, rows_per_split, n_splits, cand, s);
  if (dtype == 2)
    return (int)launch_split<2>(q, p, Q, D, row_end, k, t, rows_per_split, n_splits, cand, s);
  return (int)cudaErrorInvalidValue;
}

// Queries a block of hc_topk_split takes at Q queries, k and dtype (the
// caller's split geometry depends on it); 0 for a dtype or k it refuses.
extern "C" int hc_topk_split_qb(int Q, int k, int dtype) {
  if (k <= 0 || k > KMAX) return 0;
  if (dtype == 0) return split_qb<0>(Q, k);
  if (dtype == 1) return split_qb<1>(Q, k);
  if (dtype == 2) return split_qb<2>(Q, k);
  return 0;
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
