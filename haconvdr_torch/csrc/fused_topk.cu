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
//     The product is tile_fmaf.cuh's, which the v4 window kernel's route B
//     also runs: 128 passage rows x QB queries (QB 128, or 64 at Q <= 64
//     and where 128 queries' k-buffers do not fit), 8 x QB/16 outputs a thread,
//     three cp.async stages.  Stage depth KC = 32 values: f32 rows 128 bytes
//     deep (route B's); bf16 rows 64 bytes and the int8 mode's 32 passage
//     bytes with 64 query bytes, widened to floats once a stage.  Route B's
//     bf16 stages are 128 bytes deep; here they are halved so that the
//     k-buffers fit beside them (f32 at QB 128 and k 100: 110.6 KB of
//     stages, 102.4 KB of buffers, 10.2 KB of lists and state).
//     Every score is one fmaf chain over d = 0, 1, ..., D-1 (zeros past D
//     add nothing) from 0.0f: the v4 window and rescore kernels
//     (topk_v4.cu) use the same chain, so all three give the same float
//     for the same row.  In the int8 mode each int8 passage value and
//     each bf16 query value converts to float exactly; with int8 codes
//     as queries (v4's fallback) every product and partial sum is an
//     integer below 2^24, so the scores are exact.
//     The selection filters, then merges.  Each query of the block keeps
//     a k-slot buffer of 64-bit keys (order-preserving score bits, then
//     0x7fffffff - id: one integer compare orders (score desc, id asc)) in
//     shared memory, in ascending order, and a threshold tau: the seed's
//     threshold, raised to the score of the buffer's worst key B[0] once
//     it holds k.  A split's rows ascend across its tiles, so a later row
//     that ties the worst key's score has the larger id and loses: the
//     test s > tau is exact.  After each tile every thread tests its
//     outputs against tau in registers; survivors go to their query's list
//     of LIST keys in shared memory (one atomicAdd a thread and query).
//     The lists are offered to the buffers only when one of them
//     overflows, and after the last tile: a warp takes a query's list and
//     merges it into the sorted buffer in one step (each key's new place
//     is its rank in the union, less the keys that drop out), then raises
//     tau (a tau that lags only lets more survivors in).  Survivors that
//     found their list full stay in registers; after the offer they are
//     compared by key with the worst (within a tile, rows are in no
//     order), so no survivor is dropped: the first tile of an unseeded
//     split, where every score passes, takes about 128 / LIST offers, a
//     late tile usually none, and a tile whose survivors all fit costs one
//     barrier.  The seed is NOT copied into the split buffers: S copies of
//     it would crowd real rows out of the merged top-k.
//     The buffers stay in shared memory: at QB 128 they leave room for k <=
//     101 in f32, 113 in bf16 and 125 in the int8 mode, and a larger k
//     takes QB 64.  Measured at Q 256, k 100 (probes/probe_torch_v3.py
//     --variants, device ms, NVIDIA H100 80GB HBM3 at 700 W): f32 29.29-29.40
//     unseeded, 26.97-26.99 seeded; the buffers in the block's own slice of
//     cand in device memory (L2) 29.95-30.28 and 26.89; QB 64 at every Q
//     29.76-29.78 and 28.91-28.92 (bf16: 28.34-28.38 and 26.77, in L2
//     28.65-28.71 and 26.77-26.78, QB 64 31.23 and 30.37-30.38).
//  2. topk_merge_kernel, one block per query: radix-selects the k-th
//     largest key among the S * k split keys plus the seed entries (id -1),
//     keeps the k keys at or above it and bitonic-sorts them, so the
//     output is ordered (score desc, id asc) with no further sort.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tile_fmaf.cuh"
#include "topk_keys.cuh"

namespace {

using hc::KMAX;
using hc::key_id;
using hc::key_score;
using hc::make_key;
using hc::tile::ROWS;
using hc::tile::THREADS;

constexpr int STAGES = 3;
constexpr int KC = 32;    // depth of a stage, values
constexpr int LIST = 16;  // keys a query's list holds between offers
static_assert(LIST <= 32, "offer holds one listed key a lane");
constexpr int MERGE_NT = 1024;
constexpr int SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;

// Mode 0: f32 x f32; 1: bf16 x bf16; 2: bf16 queries x int8 passages.
// Dynamic shared memory: STAGES stages, the widened floats (modes 1, 2),
// lists [QB][LIST] keys, tau [QB] floats, cnt and fill [QB] ints, then
// the buffers [QB][k] keys.
template <int MODE, int QB>
struct Split {
  using PT = typename std::conditional<
      MODE == 0, float,
      typename std::conditional<MODE == 1, __nv_bfloat16, int8_t>::type>::type;
  using QT = typename std::conditional<MODE == 0, float, __nv_bfloat16>::type;
  static constexpr int PCH = KC * (int)sizeof(PT), QCH = KC * (int)sizeof(QT);
  using S = hc::tile::Stage<PCH, QCH, QB>;
  static constexpr bool WIDEN = MODE != 0;
  static constexpr int FP = KC + 4;  // floats between widened rows
  static constexpr int WIDE_OFF = STAGES * S::BYTES;
  static constexpr int LIST_OFF = WIDE_OFF + (WIDEN ? (ROWS + QB) * FP * 4 : 0);
  static constexpr int BUF_OFF = LIST_OFF + 8 * QB * LIST + 12 * QB;
  static size_t smem(int k) { return (size_t)BUF_OFF + 8 * (size_t)QB * k; }
};

// A whole warp offers one query's list L[0 .. n) (n <= LIST <= 32) to its
// buffer B, which holds f keys in ascending order (B[0] the worst): the k
// largest of B[0 .. f) and L come out ascending in B[0 .. min(k, f + n)).
// A key's place is its rank in the union (keys are distinct: distinct rows)
// less the number that drop out: a listed key's rank is a binary search
// in B plus a count over the list, a buffered key's its index plus a count
// over the list.  Every lane reads before any writes.  Returns with f
// updated.
__device__ __forceinline__ void offer(uint64_t* B, const uint64_t* L, int n, int k, int lane,
                                      int& f) {
  const uint64_t e = lane < n ? L[lane] : 0ull;
  if (f == k && !__any_sync(FULL, lane < n && e > B[0])) return;  // nothing enters
  int re = 0;  // e's rank
  if (lane < n) {
    int lo = 0, hi = f;  // the keys of B below e
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (B[mid] < e) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    re = lo;
  }
  uint64_t bv[KMAX / 32];  // B[lane + 32 s] and its rank
  int rb[KMAX / 32];
#pragma unroll
  for (int s = 0; s < KMAX / 32; ++s) {
    bv[s] = lane + 32 * s < f ? B[lane + 32 * s] : 0ull;
    rb[s] = lane + 32 * s;
  }
  for (int j = 0; j < n; ++j) {
    const uint64_t x = L[j];
    re += x < e;
#pragma unroll
    for (int s = 0; s < KMAX / 32; ++s) rb[s] += x < bv[s];
  }
  const int drop = max(0, f + n - k);
  __syncwarp();
#pragma unroll
  for (int s = 0; s < KMAX / 32; ++s)
    if (lane + 32 * s < f && rb[s] >= drop) B[rb[s] - drop] = bv[s];
  if (lane < n && re >= drop) B[re - drop] = e;
  f = min(k, f + n);
}

template <int MODE, int QB>
__global__ void __launch_bounds__(THREADS, 1) topk_split_kernel(
    const void* __restrict__ q_, const void* __restrict__ p_, int Q, int D, int row_end, int k,
    const float* __restrict__ thr, int rows_per_split, int n_qt, bool vec,
    uint64_t* __restrict__ cand) {
  using K = Split<MODE, QB>;
  using S = typename K::S;
  constexpr int NB = QB / 16;  // queries of a thread
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + K::LIST_OFF);
  float* tau = reinterpret_cast<float*>(lists + QB * LIST);
  int* cnt = reinterpret_cast<int*>(tau + QB);
  int* fill = cnt + QB;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - split * n_qt) * QB;
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem + K::BUF_OFF);  // [QB][k]
  const long long r_first = (long long)split * rows_per_split;
  const int r_begin = r_first < row_end ? (int)r_first : row_end;
  const int r_stop = (int)min((long long)row_end, r_first + rows_per_split);
  const int n_tiles = r_stop > r_begin ? (r_stop - r_begin + ROWS - 1) / ROWS : 0;
  const int KT = (D + KC - 1) / KC;
  const int steps = n_tiles * KT;
  const int p_row_bytes = D * (int)sizeof(typename K::PT);
  const int q_row_bytes = D * (int)sizeof(typename K::QT);

  for (int e = tid; e < QB; e += THREADS) {
    const int qg = q0 + e;
    // queries past Q never pass (their scores, against zero rows, are 0)
    tau[e] = qg < Q ? (thr != nullptr ? thr[qg] : -INFINITY) : INFINITY;
    cnt[e] = 0;
    fill[e] = 0;
  }
  // (the main loop's first barrier orders these before any tile's selection)

  const hc::tile::Stager<S, MODE == 2 ? 1 : 2> stager(
      static_cast<const unsigned char*>(p_), p_row_bytes,
      static_cast<const unsigned char*>(q_), q_row_bytes, r_begin, q0);
  auto fill_stage = [&](int st) {
    const int t = st / KT, kt = st - t * KT;
    stager.fill(smem + (st % STAGES) * S::BYTES, t, kt, r_stop - (r_begin + t * ROWS),
                Q - q0, p_row_bytes, q_row_bytes, vec, p_);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) fill_stage(s);
    hc::tile::cp_async_commit();
  }

  // warp w offers the lists of queries w, w + 8, ... and raises their tau
  auto offer_lists = [&]() {
    for (int ql = warp; ql < QB; ql += THREADS / 32) {
      const int c = cnt[ql];
      if (c == 0) continue;
      uint64_t* B = buf + (size_t)ql * k;
      int f = fill[ql];
      offer(B, lists + ql * LIST, min(c, LIST), k, lane, f);
      __syncwarp();
      if (lane == 0) {
        cnt[ql] = 0;
        fill[ql] = f;
        if (f == k) tau[ql] = key_score(B[0]);
      }
    }
  };

  float acc[8][NB];
  for (int st = 0; st < steps; ++st) {
    hc::tile::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step st is in; every warp is done with step st - 1's slot
    if (st + STAGES - 1 < steps) fill_stage(st + STAGES - 1);
    hc::tile::cp_async_commit();
    const int t = st / KT, kt = st - t * KT;
    const unsigned char* slot = smem + (st % STAGES) * S::BYTES;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[i][j] = 0.0f;
    }
    if constexpr (K::WIDEN) {  // widen the stage once: [ROWS + QB][FP] floats
      float* fb = reinterpret_cast<float*>(smem + K::WIDE_OFF);
      hc::tile::widen<S, typename K::PT, typename K::QT, K::FP>(slot, fb);
      __syncthreads();
      hc::tile::product<QB, KC, K::FP, K::FP>(fb, fb + ROWS * K::FP, acc);
    } else {
      hc::tile::product<QB, KC, S::PTP / 4, S::QTP / 4>(
          reinterpret_cast<const float*>(slot), reinterpret_cast<const float*>(slot + S::QOFF),
          acc);
    }
    if (kt != KT - 1) continue;

    // ---- the tile is scored: select.  acc[i][j] is row rb + 8 i, query
    // qj(j); survivors are bit 8 j + i of m
    const int rb = r_begin + t * ROWS + wm * 64 + g;
    const int nv = r_stop - rb;  // acc[i][*] is a row of the split while 8 i < nv
    auto qj = [&](int j) { return wn * (QB / 4) + t4 + 4 * j; };
    uint64_t m = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float th = tau[qj(j)];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (8 * i < nv && acc[i][j] > th) m |= 1ull << (8 * j + i);
    }
    for (;;) {
      // push: each query's survivors into its list, as far as it has room
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const uint32_t mj = (uint32_t)(m >> (8 * j)) & 0xffu;
        if (mj == 0) continue;
        int at = atomicAdd(&cnt[qj(j)], __popc(mj));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!((mj >> i) & 1u)) continue;
          if (at < LIST) {
            lists[qj(j) * LIST + at] = make_key(acc[i][j], rb + 8 * i);
            m &= ~(1ull << (8 * j + i));
          }
          ++at;
        }
      }
      // every survivor is in a list: the lists wait for a later tile
      if (!__syncthreads_or(m != 0)) break;
      offer_lists();
      __syncthreads();
      // a survivor that found its list full enters only if its key beats the
      // worst key of a full buffer (within a tile rows are in no order)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (((m >> (8 * j)) & 0xffu) == 0 || fill[qj(j)] < k) continue;
        const uint64_t w = buf[(size_t)qj(j) * k];  // the worst key
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (make_key(acc[i][j], rb + 8 * i) <= w) m &= ~(1ull << (8 * j + i));
      }
    }
  }
  hc::tile::cp_async_wait<0>();
  __syncthreads();
  offer_lists();  // what the last tiles left in the lists
  __syncthreads();
  const uint64_t empty = make_key(-INFINITY, -1);
  for (int e = tid; e < QB * k; e += THREADS) {
    const int ql = e / k, j = e - ql * k;
    if (q0 + ql < Q) cand[((size_t)split * Q + q0 + ql) * k + j] = j < fill[ql] ? buf[e] : empty;
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

// QB of the split kernel at Q queries and k: 128 past Q 64 where its
// shared memory fits, else 64
template <int MODE>
int split_qb(int Q, int k) {
  return Q > 64 && Split<MODE, 128>::smem(k) <= (size_t)SMEM_MAX ? 128 : 64;
}

template <int MODE, int QB>
cudaError_t launch_split_qb(const void* q, const void* p, int Q, int D, int row_end, int k,
                            const float* thr, int rows_per_split, int n_splits, bool vec,
                            void* cand, cudaStream_t stream) {
  const size_t smem = Split<MODE, QB>::smem(k);
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
  using K = Split<MODE, 64>;
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
