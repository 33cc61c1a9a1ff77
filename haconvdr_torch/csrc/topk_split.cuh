// The body of the split pass of the exact inner-product top-k that the v3
// fused top-k (fused_topk.cu, topk_split_kernel) and the streaming top-k
// (topk_stream.cu, topk_stream_kernel) share.  One block per (tile of QB
// query rows, split of the passage rows): the block's exact top k of its
// rows for each of its queries, as 64-bit keys (topk_keys.cuh: (score desc,
// id asc) is one integer order), into cand [S, Q, k]; a merge kernel of
// the including source ranks the S * k keys of a query.
//
// The product is tile_fmaf.cuh's: 128 passage rows x QB queries (QB 64 or
// 128), 8 x QB/16 outputs a thread, three cp.async stages.  Stage depth
// KC = 32 values: f32 rows 128 bytes deep; bf16 rows 64 bytes and the int8
// mode's (MODE 2: int8 passages, bf16 queries) 32 passage bytes with 64
// query bytes, widened to floats once a stage.  Every score is one fmaf
// chain over d = 0, 1, ..., D-1 (zeros past D add nothing) from 0.0f: the
// v4 window and rescore kernels (topk_v4.cu) run the same chain, so all of
// them give the same float for the same row.
//
// The selection filters, then merges.  Each query of the block keeps a
// k-slot buffer of keys in ascending order and a threshold tau: the seed's
// threshold (row 2), raised to the score of the buffer's worst key B[0]
// once it holds k.  A split's rows ascend across its tiles, so a later row
// that ties the worst key's score has the larger id and loses: the test
// s > tau is exact.  After each tile every thread tests its outputs
// against tau in registers; survivors go to their query's list of LIST
// keys in shared memory (one atomicAdd a thread and query).  The lists are
// offered to the buffers only when one of them overflows, and after the
// last tile: a warp takes a query's list and merges it into the sorted
// buffer (each key's new place is its rank in the union, less the keys
// that drop out), then raises tau (a tau that lags only lets more
// survivors in).  Survivors that found their list full stay in registers;
// after the offer they are compared by key with the worst (within a tile,
// rows are in no order), so no survivor is dropped: the first tile of an
// unseeded split, where every score passes, takes about 128 / LIST offers,
// a late tile usually none, and a tile whose survivors all fit costs one
// barrier.  A seed is not copied into the split buffers (S copies of it
// would crowd real rows out of the merged top-k).
//
// Two placements of the buffers (template WIDE):
// - shared memory (k <= 128; rows 2 and 7): lists of 16 keys, each merged
//   in one warp step with the buffer in registers.  At QB 128 the buffers
//   leave room for k <= 101 in f32, 113 in bf16 and 125 in the int8 mode; a
//   larger k takes QB 64.  Measured at Q 256, k 100
//   (probes/probe_torch_v3.py --variants, device ms, NVIDIA H100 80GB HBM3
//   at 700 W): f32 29.29-29.40 unseeded, 26.97-26.99 seeded; the buffers in
//   device memory (L2) 29.95-30.28 and 26.89; QB 64 at every Q 29.76-29.78
//   and 28.91-28.92.
// - device memory (128 < k <= 1,024; row 7): two buffers a query, the
//   block's own slices of cand and of a spare [S, Q, k] array, merged one
//   into the other (offer_wide), lists of 64 keys, so each pass over a
//   buffer takes up to 64 keys.  The lists, tau, the counters and which
//   buffer holds a query's keys stay in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tile_fmaf.cuh"
#include "topk_keys.cuh"

namespace hc {
namespace split {

using hc::tile::ROWS;
using hc::tile::THREADS;

constexpr int STAGES = 3;
constexpr int KC = 32;  // depth of a stage, values
constexpr int SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;
constexpr int LIST_SHARED = 16;  // keys a query's list holds between offers: shared buffers
constexpr int LIST_WIDE = 64;    // and buffers in device memory
static_assert(LIST_SHARED <= 32, "offer holds one listed key a lane");
static_assert(LIST_WIDE % 32 == 0 && (LIST_WIDE & (LIST_WIDE - 1)) == 0,
              "offer_wide holds LIST_WIDE / 32 keys a lane and searches by halves");

// Mode 0: f32 x f32; 1: bf16 x bf16; 2: bf16 queries x int8 passages.
// Dynamic shared memory: STAGES stages, the widened floats (modes 1, 2),
// lists [QB][LIST] keys, tau [QB] floats, cnt and fill [QB] ints (WIDE:
// and side [QB] ints), then (shared buffers) the buffers [QB][k] keys.
template <int MODE, int QB, bool WIDE>
struct Split {
  using PT = typename std::conditional<
      MODE == 0, float,
      typename std::conditional<MODE == 1, __nv_bfloat16, int8_t>::type>::type;
  using QT = typename std::conditional<MODE == 0, float, __nv_bfloat16>::type;
  static constexpr int PCH = KC * (int)sizeof(PT), QCH = KC * (int)sizeof(QT);
  using S = hc::tile::Stage<PCH, QCH, QB>;
  static constexpr bool WIDEN = MODE != 0;
  static constexpr int LIST = WIDE ? LIST_WIDE : LIST_SHARED;
  static constexpr int FP = KC + 4;  // floats between widened rows
  static constexpr int WIDE_OFF = STAGES * S::BYTES;
  static constexpr int LIST_OFF = WIDE_OFF + (WIDEN ? (ROWS + QB) * FP * 4 : 0);
  static constexpr int BUF_OFF = LIST_OFF + 8 * QB * LIST + (WIDE ? 16 : 12) * QB;
  static size_t smem(int k) { return (size_t)BUF_OFF + (WIDE ? 0 : 8 * (size_t)QB * k); }
};

// A whole warp offers one query's list L[0 .. n) (n <= LIST_SHARED) to its
// buffer B in shared memory, which holds f keys in ascending order (B[0]
// the worst): the k largest of B[0 .. f) and L come out ascending in
// B[0 .. min(k, f + n)).  A key's place is its rank in the union (keys are
// distinct: distinct rows) less the number that drop out: a listed key's
// rank is a binary search in B plus a count over the list, a buffered
// key's its index plus a count over the list.  Every lane reads before any
// writes.  Returns with f updated.
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

// A whole warp offers one query's list L[0 .. n) (n <= LIST_WIDE, in
// shared memory) to its buffer in device memory: src holds f keys in
// ascending order; the k largest of them and L come out ascending in
// dst[0 .. min(k, f + n)).  The list is sorted in place (each key's rank
// among the n), the slots past n set to ~0 (above every key).  Then the
// warp walks src 32 keys a step, OFFER_BATCH steps' loads in flight: the
// key at i goes to i + c_i - drop, c_i = #{L < src[i]} by a search of the
// sorted list by halves; the listed keys L[j] with c_{i-1} <= j < c_i lie
// between src[i - 1] and src[i], so they go to j + i - drop (i = f stands
// for a key above every key).  Returns false, writing nothing, when no
// listed key enters a full buffer; else true, with f updated.  The block
// rewrites the buffers it reads, so every read of them goes to L2
// (__ldcg), never through a cache the writes may leave stale.
constexpr int OFFER_BATCH = 8;

__device__ __forceinline__ bool offer_wide(const uint64_t* src, uint64_t* dst, uint64_t* L,
                                           int n, int k, int lane, int& f) {
  constexpr int PER = LIST_WIDE / 32;
  uint64_t e[PER];
  bool enters = false;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    e[u] = lane + 32 * u < n ? L[lane + 32 * u] : ~0ull;
    enters |= lane + 32 * u < n;
  }
  if (f == k) {
    const uint64_t worst = __ldcg(src);
    enters = false;
#pragma unroll
    for (int u = 0; u < PER; ++u) enters |= lane + 32 * u < n && e[u] > worst;
  }
  if (!__any_sync(FULL, enters)) return false;
  int r[PER] = {};  // ranks among the n listed keys (distinct: distinct rows)
  for (int j = 0; j < n; ++j) {
    const uint64_t x = L[j];
#pragma unroll
    for (int u = 0; u < PER; ++u) r[u] += x < e[u];
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < PER; ++u) L[lane + 32 * u < n ? r[u] : lane + 32 * u] = e[u];
  __syncwarp();
  const int drop = max(0, f + n - k);
  int carry = 0;  // c of the key before lane 0's
  for (int i0 = 0; i0 <= f; i0 += 32 * OFFER_BATCH) {
    uint64_t b[OFFER_BATCH];
#pragma unroll
    for (int t = 0; t < OFFER_BATCH; ++t) {
      const int i = i0 + 32 * t + lane;
      b[t] = i < f ? __ldcg(src + i) : ~0ull;
    }
#pragma unroll
    for (int t = 0; t < OFFER_BATCH; ++t) {
      if (i0 + 32 * t > f) break;  // warp-uniform: past the stand-in
      const int i = i0 + 32 * t + lane;
      int c = 0;  // #{L < b}: n for the stand-in above every key
#pragma unroll
      for (int half = LIST_WIDE / 2; half > 0; half >>= 1) c += L[c + half - 1] < b[t] ? half : 0;
      c += L[c] < b[t] ? 1 : 0;  // the halves reach LIST_WIDE - 1
      if (i >= f) c = n;
      if (i < f && i + c >= drop) dst[i + c - drop] = b[t];
      int prev = __shfl_up_sync(FULL, c, 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(FULL, c, 31);
      if (i <= f)
        for (int j = prev; j < c; ++j)
          if (j + i >= drop) dst[j + i - drop] = L[j];
    }
  }
  f = min(k, f + n);
  return true;
}

// The split pass (see the top of the file): block blockIdx.x = split *
// n_qt + query tile; cand (and, WIDE, spare) uint64 [S, Q, k]; thr float
// [Q] (a strict threshold a query's scores must pass) or NULL.
template <int MODE, int QB, bool WIDE>
__device__ __forceinline__ void split_topk(const void* __restrict__ q_,
                                           const void* __restrict__ p_, int Q, int D,
                                           int row_end, int k, const float* __restrict__ thr,
                                           int rows_per_split, int n_qt, bool vec,
                                           uint64_t* __restrict__ cand,
                                           uint64_t* __restrict__ spare) {
  using K = Split<MODE, QB, WIDE>;
  using S = typename K::S;
  constexpr int NB = QB / 16;  // queries of a thread
  constexpr int LIST = K::LIST;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + K::LIST_OFF);
  float* tau = reinterpret_cast<float*>(lists + QB * LIST);
  int* cnt = reinterpret_cast<int*>(tau + QB);
  int* fill = cnt + QB;
  int* side = fill + QB;  // WIDE: 1 where a query's keys are in spare

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - split * n_qt) * QB;
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem + K::BUF_OFF);  // [QB][k], shared buffers
  // WIDE: query ql's buffers, the one holding its keys (h = side) and the other
  auto wide_buf = [&](int ql, int h) {
    return (h ? spare : cand) + ((size_t)split * Q + q0 + ql) * k;
  };
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
    if constexpr (WIDE) side[e] = 0;
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
      int f = fill[ql];
      if constexpr (WIDE) {
        const int h = side[ql];
        uint64_t* to = wide_buf(ql, h ^ 1);
        const bool moved = offer_wide(wide_buf(ql, h), to, lists + ql * LIST, min(c, LIST), k,
                                      lane, f);
        __syncwarp();
        if (lane == 0) {
          cnt[ql] = 0;
          if (moved) {
            side[ql] = h ^ 1;
            fill[ql] = f;
            if (f == k) tau[ql] = key_score(__ldcg(to));
          }
        }
      } else {
        uint64_t* B = buf + (size_t)ql * k;
        offer(B, lists + ql * LIST, min(c, LIST), k, lane, f);
        __syncwarp();
        if (lane == 0) {
          cnt[ql] = 0;
          fill[ql] = f;
          if (f == k) tau[ql] = key_score(B[0]);
        }
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
        uint64_t w;  // the worst key
        if constexpr (WIDE) {
          w = __ldcg(wide_buf(qj(j), side[qj(j)]));
        } else {
          w = buf[(size_t)qj(j) * k];
        }
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
    if constexpr (WIDE) {  // the keys into cand, where spare holds them
      if (q0 + ql >= Q) continue;
      const size_t o = ((size_t)split * Q + q0 + ql) * k + j;
      if (j >= fill[ql]) {
        cand[o] = empty;
      } else if (side[ql]) {
        cand[o] = __ldcg(spare + o);
      }
    } else {
      if (q0 + ql < Q) cand[((size_t)split * Q + q0 + ql) * k + j] = j < fill[ql] ? buf[e] : empty;
    }
  }
}

}  // namespace split
}  // namespace hc
