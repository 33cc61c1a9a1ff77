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

constexpr int QT = 64;   // queries per window block
constexpr int PT = 64;   // passage rows per score tile
constexpr int DK = 32;   // depth per shared-memory stage (floats, or int8x4 words)
constexpr int NT = 256;  // threads per window block (16 x 16)
constexpr int RS_NT = 256;      // threads (= rows per pass) of a rescore block

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
// Bound on the H100: the bytes of the panel, read once (10 MB at
// [9,766, 256]: 3.0 us at 3.35 TB/s; L2-resident after the window kernel
// wrote it).  What bounds it in fact is the latency of a warp's selection
// steps: one query's steps run in order, and one step of a warp is some
// 6,000 cycles (clock64 per phase in a variant build: staging 0.3-1.3K,
// issuing the next tile's loads ~1K, radix passes ~2.3K, gather ~1.5K).
//
// Geometry: a block takes SEL_QT = 8 consecutive queries when the queries
// are the panel's fast axis ([C, Q] strides: each row read is 8 floats, one
// 32-byte sector), else one query ([Q, C]: each warp reads its own
// contiguous row); blockIdx.y is the split, a run of ceil(C / splits)
// entries.  A block walks its run SEL_ROWS = 512 entries a step: the block
// stages the tile (score bits, ids) into shared memory, then each warp
// selects its query's top k of [its running top k | the tile] and keeps it
// as the new running top k; the next tile's loads are in flight meanwhile
// (registers).  So every score is read from global memory once, at any C:
// no capacity limit, no re-read.  Resources (ptxas, sm_90a): 173
// registers a thread, no spill; 7,212 bytes of shared memory a warp.  So
// an SM holds one 8-warp block (registers: 44,288 of 65,536) or eleven
// one-warp blocks.  hc_select_topk_split runs `splits` blocks along each
// query (one query spreads over `splits` SMs; ops/topk_v4.select_splits
// takes about eight warps an SM and at most two tiles a split: 4 at
// [11,814, 256], 12 at Q 1) into a [Q, splits, k] candidate
// panel, then the same kernel with one split over that panel (rows
// layout, the candidates' ids), which ranks: exact, because each member
// of the top k is in the top k of its split.  hc_select_topk is one launch
// with one split.
//
// Selection (one warp per query; select_v4::warp_topk): a key is
// ordered_bits(score) (32 bits), held 20 a lane in registers; entries at
// or below the floor, -inf and NaN are staged as key 0 and never enter.
// A count / AND / OR reduction gives the admitted count and the bits every
// admitted key shares; with no more than k admitted every one is taken,
// so the nearly all -inf flagged panel (k = budget) costs one reduction
// and a gather.  Else 8-bit radix passes start at the highest bit that
// differs (a panel of window maxima shares its sign and most of its
// exponent) and stop as soon as the chosen bin holds exactly the entries
// still wanted.  Each warp counts into its own 256 bins with shared-memory
// adds the hardware aggregates per address (no add behind a branch: an
// entry that does not count goes to a sink bin), and a shuffle scan of
// the bins, 8 a lane, finds the digit.  Ids decide only inside the tie
// class at the k-th score (the same radix over 0x7fffffff - id), and the
// last krem copies of one (score, id) are taken by position.  After a
// step with more than k candidates the k-th score's high bits are a lower
// bound of the answer: later tiles admit only keys at or above it (ties
// stay in, so a tie class that straddles tiles or splits keeps its lowest
// ids in every split, and the merge the lowest of all).  Short splits,
// empty splits and splits wholly at or below the floor give (-inf, -1)
// slots, which never enter the merge.  The final top k is ranked (score
// desc, id asc) by a bitonic sort of 64-bit (score, id) keys in registers.
// The warm floor only prunes.  Every global address is long long.
// ---------------------------------------------------------------------------
namespace select_v4 {

constexpr int SEL_ROWS = 512;                         // entries a query stages per step
constexpr int SEL_QT = 8;                             // queries of a block, [C, Q] strides
constexpr int PITCH = hc::KMAX + SEL_ROWS + 4;        // words per query; % 32 == 4
constexpr int HIST = 257;  // 256 bins and a sink, per warp
constexpr int SEL = hc::KMAX + 1;  // the selected entries and a sink, per warp
constexpr int WARP_BYTES = PITCH * 8 + HIST * 4 + SEL * 8;
constexpr unsigned FULL = 0xffffffffu;

constexpr int NPL = (hc::KMAX + SEL_ROWS) / 32;  // entries a lane holds in a step
constexpr int LPT = SEL_ROWS / 32;               // tile loads a thread starts per step

struct Cut {  // the k largest values v: (v & mask) > prefix, then krem of == prefix
  uint32_t prefix, mask;
  uint32_t krem;
  bool all;  // every entry with (v & mask) == prefix is taken
};

// The rule that picks the k largest of the values v[j] (entry j * 32 +
// lane of the warp) whose bit j of `elig` is set.  One warp, values in
// registers; each pass counts an 8-bit digit into the warp's 256 bins in
// shared memory (hist, zeroed, left zeroed; entries that do not count go
// to bin 256, so no add sits behind a branch) with fire-and-forget adds, and
// a shuffle scan over the bins, 8 a lane, finds the digit of the k-th.
template <int N>
__device__ Cut radix_cut(const uint32_t (&v)[N], uint32_t elig, uint32_t k, uint32_t* hist) {
  const int lane = threadIdx.x & 31;
  uint32_t cnt = __popc(elig), a = ~0u, o = 0u;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool in = (elig >> j) & 1u;
    a &= in ? v[j] : ~0u;
    o |= in ? v[j] : 0u;
  }
  cnt = __reduce_add_sync(FULL, cnt);
  a = __reduce_and_sync(FULL, a);
  o = __reduce_or_sync(FULL, o);
  if (cnt <= k) return Cut{0u, 0u, cnt, true};
  if (a == o) return Cut{a, ~0u, k, false};  // more than k equal values
  const int hb = 31 - __clz(a ^ o);          // the highest bit that differs
  uint32_t mask = ~((2u << hb) - 1u);        // the bits every value shares
  uint32_t prefix = a & mask, krem = k;
  for (int shift = max(hb - 7, 0);; shift = max(shift - 8, 0)) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      atomicAdd(&hist[((elig >> j) & 1u) & ((v[j] & mask) == prefix)
                          ? (v[j] >> shift) & 255u : 256u], 1u);  // 256: a sink, never read
    __syncwarp();
    // lane l holds bins 255 - 8 l .. 248 - 8 l, best first
    uint32_t c[8], s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = hist[255 - 8 * lane - j];
      s += c[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) hist[255 - 8 * lane - j] = 0u;
    uint32_t inc = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t t = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += t;
    }
    const uint32_t excl = inc - s;
    const int src = __ffs(__ballot_sync(FULL, excl < krem && krem <= inc)) - 1;
    uint32_t digit = 0, before = excl, bin = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool here = bin == 0u && before + c[j] >= krem;
      digit = here ? 255u - 8u * lane - j : digit;
      bin = here ? c[j] : bin;
      before += bin == 0u ? c[j] : 0u;
    }
    digit = __shfl_sync(FULL, digit, src);
    before = __shfl_sync(FULL, before, src);
    bin = __shfl_sync(FULL, bin, src);
    krem -= before;
    prefix = (prefix & ~(255u << shift)) | (digit << shift);
    mask |= 255u << shift;
    __syncwarp();  // the bins are zeroed before the next pass adds
    if (bin == krem) return Cut{prefix, mask, krem, true};
    if (shift == 0) return Cut{prefix, mask, krem, false};  // ties at one value
  }
}

__device__ __forceinline__ uint32_t id_bits(int id) { return 0x7fffffffu - (uint32_t)id; }

// The top k of the entries key[0 .. n) (n <= N * 32; key 0: empty),
// appended in index order to sk / si; returns how many (min(k,
// admitted)).  lo is raised to a lower bound of the k-th key when more
// than k were admitted.
template <int N>
__device__ int warp_topk(const uint32_t* key, const int* id, int n, int k, uint32_t* hist,
                         uint32_t* sk, int* si, uint32_t& lo) {
  const int lane = threadIdx.x & 31;
  const uint32_t lt = (1u << lane) - 1u;
  uint32_t x[N];
  uint32_t elig = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int e = j * 32 + lane;
    x[j] = e < n ? key[e] : 0u;
    elig |= (uint32_t)(x[j] != 0u) << j;
  }
  const Cut c1 = radix_cut<N>(x, elig, (uint32_t)k, hist);
  lo = max(lo, c1.prefix);
  int taken = 0;
  if (c1.all) {  // the entries whose high bits reach the cut
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool take = ((elig >> j) & 1u) & ((x[j] & c1.mask) >= c1.prefix);
      const uint32_t tb = __ballot_sync(FULL, take);
      const int pos = take ? taken + __popc(tb & lt) : hc::KMAX;  // KMAX: a sink
      sk[pos] = x[j];
      si[pos] = take ? id[j * 32 + lane] : 0;
      taken += __popc(tb);
    }
    return taken;
  }
  // ties at the k-th score c1.prefix: the krem lowest ids of its class
  uint32_t y[N], tie = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool in = ((elig >> j) & 1u) && x[j] == c1.prefix;
    y[j] = in ? id_bits(id[j * 32 + lane]) : 0u;
    tie |= (uint32_t)in << j;
  }
  const Cut c2 = radix_cut<N>(y, tie, c1.krem, hist);
  uint32_t dups = 0;  // copies of one (score, id) at the cut, taken by position
#pragma unroll
  for (int j = 0; j < N; ++j) {
    bool take = ((elig >> j) & 1u) && x[j] > c1.prefix, dup = false;
    if ((tie >> j) & 1u) {
      const uint32_t hy = y[j] & c2.mask;
      take = hy > c2.prefix || (hy == c2.prefix && c2.all);
      dup = hy == c2.prefix && !c2.all;
    }
    const uint32_t db = __ballot_sync(FULL, dup);
    if (dup) take = dups + __popc(db & lt) < c2.krem;
    dups += __popc(db);
    const uint32_t tb = __ballot_sync(FULL, take);
    if (take) {
      const int pos = taken + __popc(tb & lt);
      sk[pos] = x[j];
      si[pos] = id[j * 32 + lane];
    }
    taken += __popc(tb);
  }
  return taken;
}

// key / id [0, n), n <= KMAX, into out[0, k): ranked (score desc, id asc)
// when `ranked`, else in place; slots past n are (-inf, -1).  Ranking is a
// bitonic sort of the 64-bit (score bits, id bits) keys, descending, four
// a lane (entry 4 lane + u): register swaps below stride 4, shuffles above.
__device__ void warp_write(const uint32_t* key, const int* id, int n, int k, bool ranked,
                           float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int PER = hc::KMAX / 32;
  const int lane = threadIdx.x & 31;
  for (int i = n + lane; i < k; i += 32) {
    out_s[i] = -INFINITY;
    out_i[i] = -1;
  }
  uint64_t kv[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = ranked ? PER * lane + u : lane + 32 * u;
    kv[u] = i < n ? ((uint64_t)key[i] << 32) | id_bits(id[i]) : 0ull;  // 0: below every entry
  }
  if (ranked) {
#pragma unroll
    for (int size = 2; size <= hc::KMAX; size <<= 1) {
#pragma unroll
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        uint64_t nk[PER];
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int i = PER * lane + u;
          const uint64_t other =
              stride < PER ? kv[(u ^ stride) & (PER - 1)]
                           : __shfl_xor_sync(FULL, kv[u], stride / PER);
          const bool keep_max = ((i & stride) == 0) == ((i & size) == 0);
          nk[u] = (keep_max == (kv[u] > other)) ? kv[u] : other;
        }
#pragma unroll
        for (int u = 0; u < PER; ++u) kv[u] = nk[u];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = ranked ? PER * lane + u : lane + 32 * u;
    if (i < n) {
      out_s[i] = hc::unordered_bits((uint32_t)(kv[u] >> 32));
      out_i[i] = (int)(0x7fffffffu - (uint32_t)kv[u]);
    }
  }
}

__global__ void __launch_bounds__(SEL_QT * 32) select_kernel(
    const float* __restrict__ s, const int* __restrict__ ids, const float* __restrict__ floor_,
    int Q, int C, long long sq, long long sc, int k, int rows_per_split, bool q_fast,
    float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t lo_s[SEL_QT];
  __shared__ float thr_s[SEL_QT];
  const int nq = q_fast ? SEL_QT : 1;  // queries of this block (blockDim.x = 32 nq)
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw);         // [nq][PITCH]
  int* idv = reinterpret_cast<int*>(keys + nq * PITCH);            // [nq][PITCH]
  uint32_t* hists = reinterpret_cast<uint32_t*>(idv + nq * PITCH);  // [nq][HIST]
  uint32_t* selk = hists + nq * HIST;                              // [nq][SEL]
  int* seli = reinterpret_cast<int*>(selk + nq * SEL);              // [nq][SEL]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * nq;
  const int q = q0 + warp;
  const long long c_lo = (long long)blockIdx.y * rows_per_split;
  const int c_begin = (int)min(c_lo, (long long)C);
  const int c_end = (int)min(c_lo + rows_per_split, (long long)C);
  uint32_t* key = keys + warp * PITCH;
  int* id = idv + warp * PITCH;
  uint32_t* hist = hists + warp * HIST;
  for (int i = lane; i < 256; i += 32) hist[i] = 0u;
  if (lane == 0) {
    lo_s[warp] = 0u;
    thr_s[warp] = (floor_ != nullptr && q < Q) ? floor_[q] : -INFINITY;
  }
  // Tile entry e = tid + u * 32 nq: query e % 8 = tid % 8 and row e / 8 =
  // tid / 8 + 32 u when the queries are the fast axis, else row e of the
  // block's one query.  The next tile's loads are started before this
  // tile's selection.
  const int my_q = q_fast ? tid % SEL_QT : 0;  // the query this thread stages
  const int r0 = q_fast ? tid / SEL_QT : tid;
  const bool my_live = q0 + my_q < Q;
  // one predicated load an entry (no branch around it); rows past the
  // tile and queries past Q stage -inf
  const long long q_off = (long long)(q0 + my_q) * sq;
  float pv[LPT];
  int pi[LPT];
  const long long step32 = 32 * sc;  // between a thread's entries
  auto fetch = [&](int c0) {
    const int rows = my_live ? min(SEL_ROWS, c_end - c0) : 0;
    const long long off0 = q_off + (long long)(c0 + r0) * sc;
    const float* sp = s + off0;
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      pv[u] = -INFINITY;
      if (r0 + 32 * u < rows) pv[u] = sp[u * step32];
    }
    if (ids != nullptr) {  // block-uniform
      const int* ip = ids + off0;
#pragma unroll
      for (int u = 0; u < LPT; ++u) {
        pi[u] = 0;
        if (r0 + 32 * u < rows) pi[u] = ip[u * step32];
      }
    } else {
#pragma unroll
      for (int u = 0; u < LPT; ++u) pi[u] = c0 + r0 + 32 * u;
    }
  };
  if (c_begin < c_end) fetch(c_begin);
  int n_run = 0;  // the running top k lies at [KMAX - n_run, KMAX)
  for (int c0 = c_begin; c0 < c_end; c0 += SEL_ROWS) {
    const int rows = min(SEL_ROWS, c_end - c0);
    __syncthreads();  // every warp is done with the last tile; lo_s, thr_s set
    const float thr = thr_s[my_q];
    const uint32_t lo_q = lo_s[my_q];
    uint32_t* key_q = keys + my_q * PITCH + hc::KMAX;
    int* id_q = idv + my_q * PITCH + hc::KMAX;
#pragma unroll
    for (int u = 0; u < LPT; ++u) {  // rows past the tile stage key 0, past n
      const uint32_t x = hc::ordered_bits(pv[u]);
      key_q[r0 + 32 * u] = (pv[u] > thr && x >= lo_q) ? x : 0u;  // -inf, NaN never enter
      id_q[r0 + 32 * u] = pi[u];
    }
    __syncthreads();
    if (c0 + SEL_ROWS < c_end) fetch(c0 + SEL_ROWS);
    if (q < Q) {  // warp-uniform
      const int base = hc::KMAX - n_run;
      uint32_t lo = lo_s[warp];
      const int taken = warp_topk<NPL>(key + base, id + base, n_run + rows, k, hist,
                                       selk + warp * SEL, seli + warp * SEL, lo);
      __syncwarp();
      for (int i = lane; i < taken; i += 32) {
        key[hc::KMAX - taken + i] = selk[warp * SEL + i];
        id[hc::KMAX - taken + i] = seli[warp * SEL + i];
      }
      n_run = taken;
      if (lane == 0) lo_s[warp] = lo;
      __syncwarp();
    }
  }
  if (q < Q) {  // one split: the answer, ranked; else this split's candidates
    const long long o = ((long long)q * gridDim.y + blockIdx.y) * k;
    warp_write(key + hc::KMAX - n_run, id + hc::KMAX - n_run, n_run, k, gridDim.y == 1,
               out_s + o, out_i + o);
  }
}

// `splits` blocks along the entries of each query; outputs [Q, splits, k].
cudaError_t launch_select(const float* s, const int* ids, const float* floor_, int Q, int C,
                          long long sq, long long sc, int k, int splits, float* out_s,
                          int* out_i, cudaStream_t stream) {
  const bool q_fast = sq < sc;
  const int nq = q_fast ? SEL_QT : 1;
  const int smem = nq * WARP_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows_per_split = (int)(((long long)C + splits - 1) / splits);
  dim3 grid((Q + nq - 1) / nq, splits);
  select_kernel<<<grid, nq * 32, smem, stream>>>(s, ids, floor_, Q, C, sq, sc, k,
                                                 rows_per_split, q_fast, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace select_v4

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
// (score desc, id asc); k <= 128.  One launch, one block per query (or 8
// queries) walking all C entries.
extern "C" int hc_select_topk(const void* scores, const void* ids, const void* floor_, int Q,
                              int C, long long stride_q, long long stride_c, int k,
                              void* out_s, void* out_i, void* stream) {
  if (Q <= 0 || C <= 0 || k <= 0 || k > hc::KMAX) return (int)cudaErrorInvalidValue;
  return (int)select_v4::launch_select(
      static_cast<const float*>(scores), static_cast<const int*>(ids),
      static_cast<const float*>(floor_), Q, C, stride_q, stride_c, k, 1,
      static_cast<float*>(out_s), static_cast<int*>(out_i), static_cast<cudaStream_t>(stream));
}

// Kernel 3 split over `splits` blocks along each query: the top k of each
// split into cand_s float / cand_i int32 [Q, splits * k], then their top k
// into out_s / out_i as hc_select_topk gives it.  Two launches.
extern "C" int hc_select_topk_split(const void* scores, const void* ids, const void* floor_,
                                    int Q, int C, long long stride_q, long long stride_c, int k,
                                    int splits, void* cand_s, void* cand_i, void* out_s,
                                    void* out_i, void* stream) {
  if (Q <= 0 || C <= 0 || k <= 0 || k > hc::KMAX || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cs = static_cast<float*>(cand_s);
  int* ci = static_cast<int*>(cand_i);
  cudaError_t err = select_v4::launch_select(
      static_cast<const float*>(scores), static_cast<const int*>(ids),
      static_cast<const float*>(floor_), Q, C, stride_q, stride_c, k, splits, cs, ci, st);
  if (err != cudaSuccess) return (int)err;
  const int m = splits * k;
  return (int)select_v4::launch_select(cs, ci, nullptr, Q, m, m, 1, k, 1,
                                       static_cast<float*>(out_s), static_cast<int*>(out_i),
                                       st);
}
