// The v4 window-top-2 exact top-k: three kernels.
//
// Replaces haconvdr_tpu/ops/pallas_topk_v4.py: _window_top2_kernel (:98),
// _rescore_kernel (:522) and _select_t_kernel (:612) / _select_kernel
// (:386), glued together by haconvdr_torch/ops/topk_v4.py as _v4_search
// glues them with XLA.  The search: per sw-row window the (max, its row,
// second max) triple; v_k = the k-th largest window max; windows whose
// second max reaches v_k are "flagged" and rescored row by row; one final
// selection over [unflagged window maxima | rescored rows] is the exact
// top-k.
//
// Score arithmetic (shared with fused_topk.cu, so that a row scores the
// same float in every kernel): float modes convert each operand to float
// and run one fmaf chain over d = 0 .. D-1, zero-padded to a multiple of
// DK, from 0.0f; the int8 x int8 mode sums __dp4a products in int32,
// which is exact (|s| <= 768 * 127^2 < 2^24), and converts to float once.
//
// Modes: 0 = f32 x f32, 1 = bf16 x bf16, 2 = int8 x int8 (queries are the
// per-query int8 codes of pallas_topk_v4.py:855-861).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "topk_keys.cuh"

namespace {

using hc::make_key;

constexpr int QT = 64;   // queries per window block
constexpr int PT = 64;   // passage rows per score tile
constexpr int DK = 32;   // depth per shared-memory stage (floats, or int8x4 words)
constexpr int NT = 256;  // threads per window block (16 x 16)
constexpr int RS_NT = 256;      // threads (= rows per pass) of a rescore block
constexpr int SEL_NT = 512;     // threads of a select block
constexpr int SEL_CAP = 8192;   // candidate keys a select block keeps in shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// 1. window_top2_kernel (replaces _window_top2_kernel, pallas_topk_v4.py:98)
//
// Bound on the H100: the score work of v3 (2 Q N D FLOP; the passage
// matrix streams once per 64-query tile), on the CUDA cores: f32/bf16 FMA,
// int8 as __dp4a at four products per instruction.  What it writes is
// small: three [W, Q] panels, 1/sw of the score area (30 MB at Q = 256,
// N = 2.5M, sw = 256).
//
// Design: one block per (64-query tile, run of whole windows).  The block
// walks its windows in row order, one 64 x 64 score tile at a time (the
// tile loop of fused_topk.cu's split kernel); after each tile one warp per
// query reduces the tile's 64 scores to (max, its lowest row, second max)
// with shuffles and folds them into the window's running triple in shared
// memory.  Tiles arrive in row order, so a later tile takes the window max
// only when strictly larger: ties keep the lowest row, and the second max
// then equals the max, as in the TPU kernel.  At a window's end the 64
// queries' triples are stored as one coalesced row of each [W, Q] panel.
// Rows at or past n_valid score -inf; a window with no valid row keeps
// (-inf, its first row, -inf).  The TPU's transposed-panel alignment
// rules do not apply; [W, Q] is kept because it makes the stores
// coalesced.
// ---------------------------------------------------------------------------
template <int MODE>
__global__ void __launch_bounds__(NT) window_top2_kernel(
    const void* __restrict__ q_, const void* __restrict__ p_, int Q, int D, int row_end,
    int sw, int W, int win_per_split, float* __restrict__ v1, int* __restrict__ a1,
    float* __restrict__ v2) {
  __shared__ float qs[DK * (QT + 1)];  // float operands, or int8x4 words (MODE 2)
  __shared__ float ps[DK * (PT + 1)];
  __shared__ float sc[QT * (PT + 1)];
  __shared__ float run_v1[QT], run_v2[QT];
  __shared__ int run_a1[QT];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int w0 = blockIdx.y * win_per_split;
  const int w1 = min(W, w0 + win_per_split);

  for (int w = w0; w < w1; ++w) {
    const int wr0 = w * sw;
    if (tid < QT) {
      run_v1[tid] = -INFINITY;
      run_v2[tid] = -INFINITY;
      run_a1[tid] = wr0;
    }
    // (the first stage's __syncthreads orders this before any update)
    for (int t0 = wr0; t0 < wr0 + sw && t0 < row_end; t0 += PT) {
      float s_tile[4][4];
      if constexpr (MODE == 2) {
        const int D4 = D / 4;
        const int* q4 = static_cast<const int*>(q_);
        const int* p4 = static_cast<const int*>(p_);
        int* qsi = reinterpret_cast<int*>(qs);
        int* psi = reinterpret_cast<int*>(ps);
        int acc[4][4] = {};
        for (int d0 = 0; d0 < D4; d0 += DK) {
          __syncthreads();
          for (int e = tid; e < QT * DK; e += NT) {
            const int r = e / DK, dd = e % DK;
            const int qr = q0 + r, d = d0 + dd;
            qsi[dd * (QT + 1) + r] = (qr < Q && d < D4) ? q4[(size_t)qr * D4 + d] : 0;
          }
          for (int e = tid; e < PT * DK; e += NT) {
            const int r = e / DK, dd = e % DK;
            const int pr = t0 + r, d = d0 + dd;
            psi[dd * (PT + 1) + r] =
                (pr < row_end && d < D4) ? p4[(size_t)pr * D4 + d] : 0;
          }
          __syncthreads();
#pragma unroll 8
          for (int dd = 0; dd < DK; ++dd) {
            int a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qsi[dd * (QT + 1) + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = psi[dd * (PT + 1) + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s_tile[i][j] = (float)acc[i][j];
      } else {
        using T = typename std::conditional<MODE == 0, float, __nv_bfloat16>::type;
        const T* q = static_cast<const T*>(q_);
        const T* p = static_cast<const T*>(p_);
        float acc[4][4] = {};
        for (int d0 = 0; d0 < D; d0 += DK) {
          __syncthreads();
          for (int e = tid; e < QT * DK; e += NT) {
            const int r = e / DK, dd = e % DK;
            const int qr = q0 + r, d = d0 + dd;
            qs[dd * (QT + 1) + r] = (qr < Q && d < D) ? to_f(q[(size_t)qr * D + d]) : 0.0f;
          }
          for (int e = tid; e < PT * DK; e += NT) {
            const int r = e / DK, dd = e % DK;
            const int pr = t0 + r, d = d0 + dd;
            ps[dd * (PT + 1) + r] =
                (pr < row_end && d < D) ? to_f(p[(size_t)pr * D + d]) : 0.0f;
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
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s_tile[i][j] = acc[i][j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pj = tx + 16 * j;
          sc[(ty + 16 * i) * (PT + 1) + pj] =
              t0 + pj < row_end ? s_tile[i][j] : -INFINITY;
        }
      __syncthreads();
      // one warp per query: the tile's (max, lowest row, second max)
      for (int qi = warp; qi < QT; qi += NT / 32) {
        if (q0 + qi >= Q) break;  // warp-uniform
        const float s0 = sc[qi * (PT + 1) + lane];
        const float s1 = sc[qi * (PT + 1) + lane + 32];
        float bv = s0;
        int bi = lane;
        if (s1 > s0) {
          bv = s1;
          bi = lane + 32;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
        float sv = fmaxf(bi == lane ? -INFINITY : s0, bi == lane + 32 ? -INFINITY : s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sv = fmaxf(sv, __shfl_xor_sync(0xffffffffu, sv, o));
        if (lane == 0) {
          if (bv > run_v1[qi]) {
            run_v2[qi] = fmaxf(run_v1[qi], sv);
            run_v1[qi] = bv;
            run_a1[qi] = t0 + bi;
          } else {
            run_v2[qi] = fmaxf(run_v2[qi], bv);
          }
        }
      }
      // the next tile's first __syncthreads orders these updates
    }
    __syncthreads();
    if (tid < QT && q0 + tid < Q) {
      const size_t o = (size_t)w * Q + q0 + tid;
      v1[o] = run_v1[tid];
      a1[o] = run_a1[tid];
      v2[o] = run_v2[tid];
    }
    __syncthreads();  // stored before the next window resets the triples
  }
}

// ---------------------------------------------------------------------------
// 2. rescore_kernel (replaces _rescore_kernel, pallas_topk_v4.py:522)
//
// Bound on the H100: memory.  Each (query, slot) reads one whole [sw, D]
// window (786 KB in f32 at sw = 256): Q * budget windows per search, 1.6
// GB at Q = 256, budget 8, against 0.4 GFLOP.
//
// Design: one block per (query, budget slot); the TPU's 8-row query groups
// are a block-shape rule of Mosaic and are dropped.  The block stages the
// window through shared memory DK columns at a time with coalesced row
// reads, and each thread runs its row's score chain exactly as the window
// kernel does (same conversions, same fmaf order, same zero padding), so a
// rescored row equals the window kernel's value for it bit for bit.  A
// slot whose window id is negative (no flagged window) and rows at or past
// n_valid come out -inf; the TPU gathers window 0 for such slots and masks
// afterwards.
// ---------------------------------------------------------------------------
template <int MODE>
__global__ void __launch_bounds__(RS_NT) rescore_kernel(
    const void* __restrict__ q_, const void* __restrict__ p_, int D, int row_end, int sw,
    int B, const int* __restrict__ win_ids, float* __restrict__ out) {
  __shared__ float qs[DK];
  __shared__ float ps[RS_NT * (DK + 1)];
  const int tid = threadIdx.x;
  const int qb = blockIdx.x;  // query * B + slot
  const int q = qb / B;
  const int win = win_ids[qb];
  float* o = out + (size_t)qb * sw;
  if (win < 0) {
    for (int r = tid; r < sw; r += RS_NT) o[r] = -INFINITY;
    return;
  }
  const int row0 = win * sw;
  for (int rb = 0; rb < sw; rb += RS_NT) {
    float score;
    if constexpr (MODE == 2) {
      const int D4 = D / 4;
      const int* q4 = static_cast<const int*>(q_) + (size_t)q * D4;
      const int* p4 = static_cast<const int*>(p_);
      int* qsi = reinterpret_cast<int*>(qs);
      int* psi = reinterpret_cast<int*>(ps);
      int acc = 0;
      for (int d0 = 0; d0 < D4; d0 += DK) {
        __syncthreads();
        if (tid < DK) qsi[tid] = d0 + tid < D4 ? q4[d0 + tid] : 0;
        for (int e = tid; e < RS_NT * DK; e += RS_NT) {
          const int rr = e / DK, dd = e % DK;
          const int r = rb + rr, row = row0 + r, d = d0 + dd;
          psi[rr * (DK + 1) + dd] =
              (r < sw && row < row_end && d < D4) ? p4[(size_t)row * D4 + d] : 0;
        }
        __syncthreads();
#pragma unroll 8
        for (int dd = 0; dd < DK; ++dd) acc = __dp4a(qsi[dd], psi[tid * (DK + 1) + dd], acc);
      }
      score = (float)acc;
    } else {
      using T = typename std::conditional<MODE == 0, float, __nv_bfloat16>::type;
      const T* qrow = static_cast<const T*>(q_) + (size_t)q * D;
      const T* p = static_cast<const T*>(p_);
      float acc = 0.0f;
      for (int d0 = 0; d0 < D; d0 += DK) {
        __syncthreads();
        if (tid < DK) qs[tid] = d0 + tid < D ? to_f(qrow[d0 + tid]) : 0.0f;
        for (int e = tid; e < RS_NT * DK; e += RS_NT) {
          const int rr = e / DK, dd = e % DK;
          const int r = rb + rr, row = row0 + r, d = d0 + dd;
          ps[rr * (DK + 1) + dd] =
              (r < sw && row < row_end && d < D) ? to_f(p[(size_t)row * D + d]) : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int dd = 0; dd < DK; ++dd) acc = fmaf(qs[dd], ps[tid * (DK + 1) + dd], acc);
      }
      score = acc;
    }
    const int r = rb + tid;
    if (r < sw) o[r] = row0 + r < row_end ? score : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// 3. select_kernel (replaces _select_t_kernel, pallas_topk_v4.py:612, and
//    _select_kernel, :386: one kernel, the layout is a pair of strides)
//
// Bound on the H100: neither bytes nor FLOP.  The panels are small (10 MB
// at [9766, 256], L2-resident after the window kernel wrote them); the
// cost is the selection's passes and barriers per query.
//
// Design: one block per query, exact top-k by 64-bit keys (score bits,
// then 0x7fffffff - id), so ties go to the lower id and no later sort is
// needed; the id is the row index, or ids[] where the caller passes a
// tie-break id per entry (the v4 pool passes passage ids).  The TPU's
// insert machinery with exactness rounds (seg = 256, c_tile) is replaced
// by the radix select the merge kernel of fused_topk.cu also runs
// (topk_keys.cuh, top_keys): one pass keeps the
// entries above the per-query floor (-inf when cold) as keys in shared
// memory; if more than SEL_CAP pass, the selection reads the scores again
// from device memory instead.  Then an 8-bit radix select finds the k-th
// largest key, the keys above it are gathered and bitonic-sorted.  The
// warm floor is the optional lower bound of warm_floor (pallas_topk_v4.py
// :706): any floor below the k-th value gives the same answer, it only
// shrinks the candidate set.  -inf never enters; empty slots are (-inf, -1).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SEL_NT) select_kernel(
    const float* __restrict__ s, const int* __restrict__ ids, const float* __restrict__ floor_,
    int C, long long sq, long long sc, int k, float* __restrict__ out_s,
    int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* cand = reinterpret_cast<uint64_t*>(smem_raw);  // [SEL_CAP]
  __shared__ hc::SelectScratch scratch;
  __shared__ int n_cand;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const float thr = floor_ != nullptr ? floor_[q] : -INFINITY;
  const float* sq_ = s + (long long)q * sq;
  const int* iq = ids != nullptr ? ids + (long long)q * sq : nullptr;
  auto key_of = [&](int c) -> uint64_t {  // 0: below the floor
    const float v = sq_[(long long)c * sc];
    if (!(v > thr)) return 0ull;
    return make_key(v, iq != nullptr ? iq[(long long)c * sc] : c);
  };

  if (tid == 0) n_cand = 0;
  __syncthreads();
  for (int c = tid; c < C; c += SEL_NT) {
    const uint64_t key = key_of(c);
    if (key != 0ull) {
      const int pos = atomicAdd(&n_cand, 1);
      if (pos < SEL_CAP) cand[pos] = key;
    }
  }
  __syncthreads();
  const bool in_smem = n_cand <= SEL_CAP;  // block-uniform
  auto key_at = [&](int e) -> uint64_t { return in_smem ? cand[e] : key_of(e); };
  hc::top_keys<SEL_NT>(key_at, in_smem ? n_cand : C, k, scratch);
  for (int j = tid; j < k; j += SEL_NT) {
    const uint64_t key = scratch.sel[j];
    const bool hit = key != 0ull;
    out_s[(size_t)q * k + j] = hit ? hc::key_score(key) : -INFINITY;
    out_i[(size_t)q * k + j] = hit ? hc::key_id(key) : -1;
  }
}

template <int MODE>
cudaError_t launch_window(const void* q, const void* p, int Q, int D, int row_end, int sw,
                          int W, int win_per_split, int n_splits, float* v1, int* a1,
                          float* v2, cudaStream_t stream) {
  dim3 grid((Q + QT - 1) / QT, n_splits);
  window_top2_kernel<MODE><<<grid, NT, 0, stream>>>(q, p, Q, D, row_end, sw, W,
                                                     win_per_split, v1, a1, v2);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_rescore(const void* q, const void* p, int Q, int D, int row_end, int sw,
                           int B, const int* win_ids, float* out, cudaStream_t stream) {
  rescore_kernel<MODE><<<(unsigned)Q * B, RS_NT, 0, stream>>>(q, p, D, row_end, sw, B,
                                                              win_ids, out);
  return cudaGetLastError();
}

bool bad_mode_shape(int mode, int D, const void* q, const void* p) {
  if (mode < 0 || mode > 2) return true;
  // int8 x int8 reads 4-byte words: rows of D % 4 == 0 bytes, aligned bases
  return mode == 2 && (D % 4 != 0 || ((uintptr_t)q & 3) || ((uintptr_t)p & 3));
}

}  // namespace

// Kernel 1.  q [Q, D], p [N, D] of one mode (0 f32, 1 bf16, 2 int8 x int8);
// rows >= min(n_valid, N) score -inf; W = ceil(min(n_valid, N) / sw) windows
// or more; block y covers windows [y * win_per_split, ...).  Outputs
// v1 float [W, Q], a1 int32 [W, Q], v2 float [W, Q].
extern "C" int hc_window_top2(const void* q, const void* p, int Q, int N, int D, int n_valid,
                              int sw, int W, int win_per_split, int n_splits, void* v1,
                              void* a1, void* v2, int mode, void* stream) {
  if (Q <= 0 || N < 0 || D <= 0 || sw <= 0 || sw % PT != 0 || W <= 0 ||
      win_per_split <= 0 || n_splits <= 0 || n_splits > 65535 ||
      (long long)win_per_split * n_splits < W || bad_mode_shape(mode, D, q, p))
    return (int)cudaErrorInvalidValue;
  const int row_end = n_valid < N ? (n_valid < 0 ? 0 : n_valid) : N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o1 = static_cast<float*>(v1);
  int* oa = static_cast<int*>(a1);
  float* o2 = static_cast<float*>(v2);
  if (mode == 0)
    return (int)launch_window<0>(q, p, Q, D, row_end, sw, W, win_per_split, n_splits, o1,
                                 oa, o2, s);
  if (mode == 1)
    return (int)launch_window<1>(q, p, Q, D, row_end, sw, W, win_per_split, n_splits, o1,
                                 oa, o2, s);
  return (int)launch_window<2>(q, p, Q, D, row_end, sw, W, win_per_split, n_splits, o1, oa,
                               o2, s);
}

// Kernel 2.  win_ids int32 [Q, B] (negative = empty slot); out float
// [Q, B * sw]: out[q, b * sw + r] = score of row win_ids[q, b] * sw + r.
extern "C" int hc_rescore_windows(const void* q, const void* p, int Q, int N, int D,
                                  int n_valid, int sw, int B, const void* win_ids, void* out,
                                  int mode, void* stream) {
  if (Q <= 0 || N < 0 || D <= 0 || sw <= 0 || B <= 0 || bad_mode_shape(mode, D, q, p))
    return (int)cudaErrorInvalidValue;
  const int row_end = n_valid < N ? (n_valid < 0 ? 0 : n_valid) : N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* w = static_cast<const int*>(win_ids);
  float* o = static_cast<float*>(out);
  if (mode == 0) return (int)launch_rescore<0>(q, p, Q, D, row_end, sw, B, w, o, s);
  if (mode == 1) return (int)launch_rescore<1>(q, p, Q, D, row_end, sw, B, w, o, s);
  return (int)launch_rescore<2>(q, p, Q, D, row_end, sw, B, w, o, s);
}

// Kernel 3.  Entry (q, c) of scores (and of ids, when not NULL) lies at
// q * stride_q + c * stride_c; floor float [Q] or NULL.  out_s float
// [Q, k], out_i int32 [Q, k] (the entry's id, else its index c), ordered
// (score desc, id asc); k <= 128.
extern "C" int hc_select_topk(const void* scores, const void* ids, const void* floor_, int Q,
                              int C, long long stride_q, long long stride_c, int k,
                              void* out_s, void* out_i, void* stream) {
  if (Q <= 0 || C <= 0 || k <= 0 || k > hc::KMAX) return (int)cudaErrorInvalidValue;
  const int smem = SEL_CAP * (int)sizeof(uint64_t);
  cudaError_t err =
      cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  select_kernel<<<Q, SEL_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(ids),
      static_cast<const float*>(floor_), C, stride_q, stride_c, k,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
