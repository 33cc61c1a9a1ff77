// Streaming exact inner-product top-k: the split pass of the v3 fused top-k
// (topk_split.cuh) run unseeded, for k up to 1,024.
//
// Replaces: haconvdr_tpu/ops/pallas_topk_v2.py:38 _topk_stream_kernel
// (reached through pallas_topk_block_v2 :136).  Contract: the exact top-k
// of q . p (float32 or bfloat16 operands, products accumulated in float32)
// over rows < n_valid, as 64-bit keys; empty slots are (-inf, -1).  No
// seed: the TPU kernel takes none.
//
// What bounds it on the H100: at Q = 256 over 2.5M x 768 rows the score
// product is 2 Q N D = 983 GFLOP, formed on the CUDA cores in float32 (67
// TFLOP/s: 14.7 ms), far above the bytes (7.7 GB of float32 passages, read
// once from device memory by the query tiles of a split: 2.3 ms at 3.35
// TB/s).  Scores never reach device memory.
//
// What carries over from the TPU kernel, and what does not:
//  * The TPU runs one program per 256-query tile and walks every passage
//    chunk in order with its DMA double-buffered (pallas_topk_v2.py:60-87);
//    that would be 1 block at Q = 256 on 132 SMs.  Here the passage axis is
//    cut into splits, one block per (tile of QB queries, split), each block
//    one an SM streaming its rows through three cp.async stages, and a
//    merge kernel ranks the splits' keys (the wrapper counts split and
//    merge as one launch).  The grid is row 2's unseeded grid
//    (ops/fused_topk.split_geometry, at most two waves) at every k: fewer,
//    longer splits past k 128 measured slower (probes/probe_torch_stream.py
//    --geometries).
//  * Grouped selection (:89-116: `group` chunks share one threshold-gated
//    round) becomes topk_split.cuh's threshold filter, per-query lists and
//    sorted buffers merged by rank, the body of the v3 kernel's split pass
//    (fused_topk.cu): the same product, the same fmaf chain, so this
//    kernel's answer equals the unseeded v3 kernel's bit for bit on the
//    same rows.  The TPU's chunk (p_chunk rows x D, 3 MiB of float32 VMEM
//    at 1024 x 768) does not fit a block's 227 KB: the wrapper's p_chunk
//    and group keep their meaning only in its contract (N a multiple of
//    p_chunk * group).
//  * k up to STREAM_KMAX = 1024, as the JAX kernel takes any k (it rounds
//    its buffer up to 128 lanes, pallas_topk_v2.py:160).  k <= 128 keeps the
//    buffers in shared memory (row 2's kernel, at row 2's QB) and
//    fused_topk.cu's merge; above, the buffers of 64 or 128
//    queries (QB 128 past Q 64) do not fit a block's shared memory (128 x
//    1,024 x 8 bytes = 1 MB), so each block keeps them in its own slices
//    of cand and of a spare array in device memory (WIDE), and the split
//    merge is wide_merge_kernel below: top_keys with 1,024 key slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_keys.cuh"
#include "topk_split.cuh"

namespace {

using hc::KMAX;
using hc::split::SMEM_MAX;
using hc::split::Split;
using hc::tile::THREADS;

constexpr int STREAM_KMAX = 1024;  // the largest k of this kernel
constexpr int MERGE_NT = 1024;     // threads of the wide merge: one a key slot

template <int MODE, int QB, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1) topk_stream_kernel(
    const void* __restrict__ q_, const void* __restrict__ p_, int Q, int D, int row_end, int k,
    int rows_per_split, int n_qt, bool vec, uint64_t* __restrict__ cand,
    uint64_t* __restrict__ spare) {
  hc::split::split_topk<MODE, QB, WIDE>(q_, p_, Q, D, row_end, k, nullptr, rows_per_split, n_qt,
                                        vec, cand, spare);
}

template <int MODE, int QB, bool WIDE>
cudaError_t launch_qb(const void* q, const void* p, int Q, int D, int row_end, int k,
                      int rows_per_split, int n_splits, bool vec, void* cand, void* spare,
                      cudaStream_t stream) {
  const size_t smem = Split<MODE, QB, WIDE>::smem(k);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(topk_stream_kernel<MODE, QB, WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Q + QB - 1) / QB;
  const long long blocks = (long long)n_qt * n_splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  topk_stream_kernel<MODE, QB, WIDE><<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, p, Q, D, row_end, k, rows_per_split, n_qt, vec, static_cast<uint64_t*>(cand),
      static_cast<uint64_t*>(spare));
  return cudaGetLastError();
}

template <int MODE, bool WIDE>
cudaError_t launch_wide(const void* q, const void* p, int Q, int D, int row_end, int k, int qb,
                        int rows_per_split, int n_splits, bool vec, void* cand, void* spare,
                        cudaStream_t stream) {
  if (qb == 128)
    return launch_qb<MODE, 128, WIDE>(q, p, Q, D, row_end, k, rows_per_split, n_splits, vec,
                                      cand, spare, stream);
  return launch_qb<MODE, 64, WIDE>(q, p, Q, D, row_end, k, rows_per_split, n_splits, vec, cand,
                                   spare, stream);
}

template <int MODE>
cudaError_t launch(const void* q, const void* p, int Q, int D, int row_end, int k, int qb,
                   int rows_per_split, int n_splits, void* cand, void* spare,
                   cudaStream_t stream) {
  using K = Split<MODE, 64, false>;
  // 16-byte copies need 16-byte rows and bases; else the narrower loads
  const bool vec = (D * (int)sizeof(typename K::PT)) % 16 == 0 && ((uintptr_t)q & 15) == 0 &&
                   ((uintptr_t)p & 15) == 0;
  if (k <= KMAX)
    return launch_wide<MODE, false>(q, p, Q, D, row_end, k, qb, rows_per_split, n_splits, vec,
                                    cand, spare, stream);
  if (spare == nullptr) return cudaErrorInvalidValue;
  return launch_wide<MODE, true>(q, p, Q, D, row_end, k, qb, rows_per_split, n_splits, vec,
                                 cand, spare, stream);
}

// Pass 2 for k > KMAX: one block per query, top_keys over the splits' keys
// with STREAM_KMAX slots (fused_topk.cu's merge, wider).
__global__ void __launch_bounds__(MERGE_NT) wide_merge_kernel(
    const uint64_t* __restrict__ cand, int S, int Q, int k, float* __restrict__ out_s,
    int* __restrict__ out_i) {
  __shared__ hc::SelectScratchT<STREAM_KMAX> scratch;
  const int q = blockIdx.x;
  auto key_at = [&](int e) -> uint64_t {
    const int s = e / k, j = e % k;
    return cand[((size_t)s * Q + q) * k + j];
  };
  hc::top_keys<MERGE_NT>(key_at, S * k, k, scratch);
  for (int j = threadIdx.x; j < k; j += MERGE_NT) {
    out_s[(size_t)q * k + j] = hc::key_score(scratch.sel[j]);
    out_i[(size_t)q * k + j] = hc::key_id(scratch.sel[j]);
  }
}

}  // namespace

// Pass 1 of the streaming top-k.  q [Q, D], p [N, D], both float32 (dtype
// 0) or both bfloat16 (1); rows >= min(n_valid, N) are skipped; qb (64 or
// 128) queries a block, refused where the block's shared memory would not
// hold them (ops/topk_stream.stream_plan picks it); cand is uint64
// [n_splits, Q, k] with n_splits * rows_per_split >= min(n_valid, N); k <=
// STREAM_KMAX; spare, uint64 [n_splits, Q, k], holds half of the buffers
// past k 128 (NULL at k <= 128).  The grid takes ceil(Q / qb) query tiles
// x n_splits blocks, one an SM.  Pass 2 is hc_topk_merge (fused_topk.cu)
// with no seed for k <= 128, hc_topk_stream_merge above.
extern "C" int hc_topk_stream(const void* q, const void* p, int Q, int N, int D, int n_valid,
                              int k, int qb, int rows_per_split, int n_splits, void* cand,
                              void* spare, int dtype, void* stream) {
  if (Q <= 0 || N < 0 || D <= 0 || k <= 0 || k > STREAM_KMAX || (qb != 64 && qb != 128) ||
      rows_per_split <= 0 || n_splits <= 0 || n_splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int row_end = n_valid < N ? (n_valid < 0 ? 0 : n_valid) : N;
  if ((long long)n_splits * rows_per_split < row_end) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<0>(q, p, Q, D, row_end, k, qb, rows_per_split, n_splits, cand, spare, s);
  if (dtype == 1)
    return (int)launch<1>(q, p, Q, D, row_end, k, qb, rows_per_split, n_splits, cand, spare, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 2 for KMAX < k <= STREAM_KMAX.  cand uint64 [n_splits, Q, k]; out_s
// float [Q, k], out_i int32 [Q, k] ordered (score desc, id asc).
extern "C" int hc_topk_stream_merge(const void* cand, int n_splits, int Q, int k, void* out_s,
                                    void* out_i, void* stream) {
  if (Q <= 0 || k <= KMAX || k > STREAM_KMAX || n_splits <= 0 ||
      (long long)n_splits * k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  wide_merge_kernel<<<Q, MERGE_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(cand), n_splits, Q, k, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
