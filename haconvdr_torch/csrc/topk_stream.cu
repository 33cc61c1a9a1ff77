// Streaming exact inner-product top-k: the passages stream through shared
// memory in cp.async double-buffered stages, and each query's running top-k
// is offered whole groups of score tiles at a time.
//
// Replaces: haconvdr_tpu/ops/pallas_topk_v2.py:38 _topk_stream_kernel
// (reached through pallas_topk_block_v2 :136).  Contract: the exact top-k
// of q . p (float32 or bfloat16 operands, products accumulated in float32)
// over rows < n_valid, as 64-bit keys; empty slots are (-inf, -1).  No
// seed: the TPU kernel takes none.
//
// What bounds it on the H100: at Q = 256 over 2.5M x 768 rows the score
// product is 2 Q N D = 983 GFLOP; this first version forms it on the CUDA
// cores in float32 (67 TFLOP/s: 14.7 ms), far above the bytes (7.7 GB of
// float32 passages, each read once per 64-query tile: 2.3 ms at 3.35 TB/s).
// Scores never reach device memory.
//
// What carries over from the TPU kernel, and what does not:
//  * The TPU runs one program per 256-query tile and walks every passage
//    chunk in order; that would be 1 block at Q = 256 on 132 SMs.  Here
//    the passage axis is cut into splits as in fused_topk.cu: one block per
//    (64-query tile, row range), each range a multiple of the 64-row
//    staging tile, and fused_topk.cu's hc_topk_merge merges the splits'
//    keys (the wrapper counts split and merge as one launch).
//  * Double buffering (pallas_topk_v2.py:60-87: chunk c+1's DMA is started
//    before chunk c is waited on).  A stage is a 64-row passage tile and
//    the block's 64 queries, DK elements deep, copied with 16-byte
//    cp.async.cg.shared.global into one of two shared-memory slots; stage
//    s+1's copies are committed before cp.async.wait_group 1 waits for
//    stage s, so they overlap stage s's FMAs and the selection after it.
//  * Grouped selection (:89-116: `group` chunks share one threshold-gated
//    round).  GT consecutive 64 x 64 score tiles collect in shared memory,
//    [64, GT * 64] float32; then one warp per query makes one check, the
//    group's best key against the worst key of the query's buffer, and
//    only a group that beats it runs an insertion round (a ballot over the
//    entries above the worst key, each replacing the worst, as in
//    fused_topk.cu).  Keys are topk_keys.cuh's: (score desc, id asc).
//  * Shared memory.  The TPU's chunk (p_chunk rows x D, 3 MiB of float32
//    VMEM at 1024 x 768) does not fit a block's 227 KB.  The staging tile
//    (64 rows x DK = 32 deep x 2 slots, plus 64 queries) and GT are this
//    kernel's own; the wrapper's p_chunk and group keep their meaning only
//    in its contract (N a multiple of p_chunk * group).
//  * Numerics.  Every score is one fmaf chain over d = 0, 1, ..., D-1
//    (zero-padded to a multiple of DK) from 0.0f, the chain of fused_topk.cu
//    and topk_v4.cu, so this kernel's answer equals the unseeded v3
//    kernel's bit for bit on the same rows.
//  * k up to STREAM_KMAX = 1024, as the JAX kernel takes any k (it rounds
//    its buffer up to 128 lanes, pallas_topk_v2.py:160).  The key buffer
//    is [QT, k] in shared memory, so the block takes fewer queries as k
//    grows: QT = 64 for k <= 128 (the kernel as it was), 32 for k <= 256,
//    16 above (at most 128 KB of keys).  The split merge for k > 128 is
//    wide_merge_kernel below: top_keys with 1,024 key slots; k <= 128
//    keeps fused_topk.cu's merge.
//  * No tensor cores and no TMA in this first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_keys.cuh"

namespace {

using hc::KMAX;
using hc::make_key;

constexpr int STREAM_KMAX = 1024;  // the largest k of this kernel
constexpr int PT = 64;       // passage rows per staging tile
constexpr int DK = 32;       // elements of depth per stage
constexpr int GT = 2;        // staging tiles per selection group
constexpr int GW = GT * PT;  // selection width
constexpr int NT = 256;      // threads (16 x 16, each a QT / 16 x 4 score block)
constexpr int MERGE_NT = 1024;  // threads of the wide merge: one a key slot

// queries per block: the [QT, k] key buffer stays within 128 KB
constexpr int qt_for(int k) { return k <= KMAX ? 64 : (k <= 2 * KMAX ? 32 : 16); }

// One stage's shared-memory rows: QT query rows then PT passage rows, each
// DK elements plus 16 bytes of padding (144 B in float32, 80 B in bfloat16),
// so the 16-byte loads of 8 neighbouring rows hit distinct banks.
template <typename T, int QT>
struct Stage {
  static constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte copy
  static constexpr int CHUNKS = DK / VEC;          // copies per row and stage
  static constexpr int ROW = DK * sizeof(T) + 16;  // bytes per row
  static constexpr int SLOT = (QT + PT) * ROW;     // bytes per slot
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  // src-size 0 zero-fills the 16 bytes (rows past the range, depth past D)
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ uint64_t key_max(uint64_t a, uint64_t b) { return a > b ? a : b; }

__device__ __forceinline__ void load_vec(const unsigned char* src, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load_vec(const unsigned char* src, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: the lower half is the earlier element
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copy stage (p0, d0) into ``slot``: the block's query rows and one passage tile.
template <typename T, int QT>
__device__ __forceinline__ void copy_stage(unsigned char* slot, const T* __restrict__ q,
                                           const T* __restrict__ p, int Q, int D, int q0,
                                           int p0, int r1, int d0) {
  using S = Stage<T, QT>;
  for (int e = threadIdx.x; e < (QT + PT) * S::CHUNKS; e += NT) {
    const int r = e / S::CHUNKS, c = e % S::CHUNKS;
    const int d = d0 + c * S::VEC;
    const T* src;
    bool full;
    if (r < QT) {
      full = q0 + r < Q && d < D;
      src = full ? q + (size_t)(q0 + r) * D + d : q;
    } else {
      full = p0 + r - QT < r1 && d < D;
      src = full ? p + (size_t)(p0 + r - QT) * D + d : p;
    }
    cp_async16(slot + r * S::ROW + c * 16, src, full);
  }
}

template <typename T, int QT>
__global__ void __launch_bounds__(NT) topk_stream_kernel(
    const T* __restrict__ q, const T* __restrict__ p, int Q, int D, int row_end, int k,
    int rows_per_split, uint64_t* __restrict__ cand) {
  using S = Stage<T, QT>;
  constexpr int RI = QT / 16;  // query rows a thread scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* slots = smem_raw;                                      // [2][SLOT]
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem_raw + 2 * S::SLOT);  // [QT][k] keys
  float* sc = reinterpret_cast<float*>(buf + QT * k);                   // [QT][GW + 1]
  __shared__ uint64_t min_key[QT];
  __shared__ int min_slot[QT];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(row_end, r0 + rows_per_split);
  const uint64_t empty = make_key(-INFINITY, -1);

  for (int e = tid; e < QT * k; e += NT) buf[e] = empty;
  for (int r = tid; r < QT; r += NT) {
    min_key[r] = empty;
    min_slot[r] = 0;
  }

  const int n_tiles = r1 > r0 ? (r1 - r0 + PT - 1) / PT : 0;
  const int n_depth = (D + DK - 1) / DK;
  const int n_stages = n_tiles * n_depth;
  if (n_stages > 0) copy_stage<T, QT>(slots, q, p, Q, D, q0, r0, r1, 0);
  cp_async_commit();

  float acc[RI][4] = {};
  for (int st = 0; st < n_stages; ++st) {
    // stage st + 1 in flight while stage st is consumed (an empty group
    // at the end keeps the wait count uniform)
    if (st + 1 < n_stages) {
      const int t = (st + 1) / n_depth, ds = (st + 1) % n_depth;
      copy_stage<T, QT>(slots + ((st + 1) & 1) * S::SLOT, q, p, Q, D, q0, r0 + t * PT, r1,
                        ds * DK);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();  // stage st's bytes from every thread are visible

    const unsigned char* slot = slots + (st & 1) * S::SLOT;
#pragma unroll
    for (int c = 0; c < S::CHUNKS; ++c) {
      float a[RI][S::VEC], b[4][S::VEC];
#pragma unroll
      for (int i = 0; i < RI; ++i) load_vec(slot + (ty + 16 * i) * S::ROW + c * 16, a[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_vec(slot + (QT + tx + 16 * j) * S::ROW + c * 16, b[j]);
#pragma unroll
      for (int v = 0; v < S::VEC; ++v)
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][v], b[j][v], acc[i][j]);
    }

    const int t = st / n_depth;
    if (st % n_depth == n_depth - 1) {  // tile t is scored: into the group's tile
      const int p0 = r0 + t * PT;
      const int col0 = (t % GT) * PT;
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pj = tx + 16 * j;
          sc[(ty + 16 * i) * (GW + 1) + col0 + pj] = p0 + pj < r1 ? acc[i][j] : -INFINITY;
          acc[i][j] = 0.0f;
        }
      if (t % GT == GT - 1 || t == n_tiles - 1) {  // the group is full (or the last)
        const int g0 = r0 + (t - t % GT) * PT;     // the group's first row
        const int width = (t % GT + 1) * PT;
        __syncthreads();
        for (int qi = warp; qi < QT; qi += NT / 32) {
          if (q0 + qi >= Q) break;
          const float* row = sc + qi * (GW + 1);
          uint64_t cur = min_key[qi];
          // the one check of the group: its best key against the worst
          // buffered key (-inf never enters: key 0)
          uint64_t best = 0;
          for (int c = lane; c < width; c += 32) {
            const float s = row[c];
            if (s != -INFINITY) best = key_max(best, make_key(s, g0 + c));
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) best = key_max(best, __shfl_xor_sync(0xffffffffu, best, o));
          if (best <= cur) continue;  // warp-uniform
          int slot_i = min_slot[qi];
          uint64_t* qb = buf + qi * k;
          for (int c0 = 0; c0 < width; c0 += 32) {
            const float s = row[c0 + lane];
            const uint64_t key = s != -INFINITY ? make_key(s, g0 + c0 + lane) : 0ull;
            unsigned want = __ballot_sync(0xffffffffu, key > cur);
            while (want) {
              const int src = __ffs(want) - 1;
              want &= want - 1;
              const uint64_t kk = __shfl_sync(0xffffffffu, key, src);
              if (kk <= cur) continue;  // warp-uniform
              if (lane == 0) qb[slot_i] = kk;
              __syncwarp();
              // new worst entry: (min key, lowest slot among equal keys)
              uint64_t m = ~0ull;
              int ms = 0x7fffffff;
              for (int j = lane; j < k; j += 32) {
                const uint64_t v = qb[j];
                if (v < m) {
                  m = v;
                  ms = j;
                }
              }
#pragma unroll
              for (int o = 16; o > 0; o >>= 1) {
                const uint64_t om = __shfl_xor_sync(0xffffffffu, m, o);
                const int os = __shfl_xor_sync(0xffffffffu, ms, o);
                if (om < m || (om == m && os < ms)) {
                  m = om;
                  ms = os;
                }
              }
              cur = m;
              slot_i = ms;
            }
          }
          if (lane == 0) {
            min_key[qi] = cur;
            min_slot[qi] = slot_i;
          }
        }
      }
    }
    __syncthreads();  // slot st & 1 consumed (stage st + 2 refills it); sc read
  }
  for (int e = tid; e < QT * k; e += NT) {
    const int r = e / k, j = e % k;
    if (q0 + r < Q) cand[((size_t)blockIdx.y * Q + q0 + r) * k + j] = buf[e];
  }
}

template <typename T, int QT>
size_t smem_bytes(int k) {
  return 2 * (size_t)Stage<T, QT>::SLOT + sizeof(uint64_t) * (size_t)QT * k +
         sizeof(float) * (size_t)QT * (GW + 1);
}

template <typename T, int QT>
cudaError_t launch_qt(const void* q, const void* p, int Q, int D, int row_end, int k,
                      int rows_per_split, int n_splits, void* cand, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, QT>(k);
  cudaError_t err = cudaFuncSetAttribute(topk_stream_kernel<T, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + QT - 1) / QT, n_splits);
  topk_stream_kernel<T, QT><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(p), Q, D, row_end, k, rows_per_split,
      static_cast<uint64_t*>(cand));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* p, int Q, int D, int row_end, int k,
                   int rows_per_split, int n_splits, void* cand, cudaStream_t stream) {
  switch (qt_for(k)) {
    case 64:
      return launch_qt<T, 64>(q, p, Q, D, row_end, k, rows_per_split, n_splits, cand, stream);
    case 32:
      return launch_qt<T, 32>(q, p, Q, D, row_end, k, rows_per_split, n_splits, cand, stream);
    default:
      return launch_qt<T, 16>(q, p, Q, D, row_end, k, rows_per_split, n_splits, cand, stream);
  }
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

// Pass 1 of the streaming top-k.  q [Q, D], p [N, D], both float32
// (dtype 0) or both bfloat16 (1), 16-byte aligned rows (D a multiple of 4
// in float32, 8 in bfloat16); rows >= min(n_valid, N) are skipped;
// rows_per_split a multiple of 64; cand is uint64 [n_splits, Q, k] with
// n_splits * rows_per_split >= min(n_valid, N); k <= STREAM_KMAX.  The
// grid takes ceil(Q / QT) query tiles (QT of qt_for(k), hc_topk_stream_qt).
// Pass 2 is hc_topk_merge (fused_topk.cu) with no seed for k <= 128,
// hc_topk_stream_merge above.
extern "C" int hc_topk_stream(const void* q, const void* p, int Q, int N, int D, int n_valid,
                              int k, int rows_per_split, int n_splits, void* cand, int dtype,
                              void* stream) {
  if (Q <= 0 || N < 0 || D <= 0 || k <= 0 || k > STREAM_KMAX || rows_per_split <= 0 ||
      rows_per_split % PT != 0 || n_splits <= 0 || n_splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int row_end = n_valid < N ? (n_valid < 0 ? 0 : n_valid) : N;
  if ((long long)n_splits * rows_per_split < row_end) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D % Stage<float, 64>::VEC != 0) return (int)cudaErrorInvalidValue;
    return (int)launch<float>(q, p, Q, D, row_end, k, rows_per_split, n_splits, cand, s);
  }
  if (dtype == 1) {
    if (D % Stage<__nv_bfloat16, 64>::VEC != 0) return (int)cudaErrorInvalidValue;
    return (int)launch<__nv_bfloat16>(q, p, Q, D, row_end, k, rows_per_split, n_splits, cand,
                                      s);
  }
  return (int)cudaErrorInvalidValue;
}

// queries per block of hc_topk_stream at this k (0 if k is out of range)
extern "C" int hc_topk_stream_qt(int k) { return k > 0 && k <= STREAM_KMAX ? qt_for(k) : 0; }

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
