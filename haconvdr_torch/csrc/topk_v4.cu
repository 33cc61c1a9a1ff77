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
// and run one fmaf chain over d = 0 .. D-1 from 0.0f, zero-padded to the
// kernel's own stage depth (zeros add nothing to the chain); the int8 x
// int8 mode sums products in int32
// (__dp4a; mma.sync in the window kernel's route C), which is exact
// (|s| <= 768 * 127^2 < 2^24) in any order, and converts to float once.
//
// Modes: 0 = f32 x f32, 1 = bf16 x bf16, 2 = int8 x int8 (queries are the
// per-query int8 codes of pallas_topk_v4.py:855-861).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tile_fmaf.cuh"
#include "topk_keys.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// 1. window top-2 (replaces _window_top2_kernel, pallas_topk_v4.py:98)
//
// Per sw-row window and query: (v1 the max, a1 its lowest row, v2 the max
// with only row a1 masked), stored as [W, Q] panels.  Rows at or past
// n_valid score -inf; a window with no valid row gives (-inf, its first
// row, -inf).  Every route reduces partial triples of disjoint row sets by
// one rule (merge below), which gives the same triple in any order: the
// larger max wins, the lower row on a tie, and the loser's max joins the
// second maxima.  So every route gives the same bits whenever its scores
// are the same bits, and they are: each score is the one fmaf chain (float
// modes) or the one exact int32 sum (int8) of the file's score arithmetic.
//
// Bounds on the H100 (2,500,000 x 768 rows, 7.68 GB f32): the passage
// bytes, read once, over 3.35 TB/s (f32 2.29 ms, bf16 1.15, int8 0.573),
// or the products: 2 Q N D operations on the CUDA cores' 67 TFLOP/s
// (f32, bf16: 14.67 ms at Q 256, 0.057 ms at Q 1) or on the int8 tensor
// cores' 1,979 TOP/s (0.497 ms at Q 256).  Small batches are bound by the
// bytes, large ones by the products.  Three routes (the caller picks one,
// ops/topk_v4.window_route):
//
// A. window_stream, small Q, every mode: bytes-bound, so each passage row
//    is read once, in whole 16-byte cp.async copies.  A warp owns 64-row
//    slices (two rows a lane) and streams them through its own ring of
//    stages (no block barrier in the loop): two 128 bytes deep up to 8
//    queries a group, three 64 bytes deep at 16; its lanes
//    run the QA (<= 16) chains of both rows in d order against queries
//    held in shared memory for the whole block (float, or int8 words).
//    A slice's triples are merged across the warp by shuffles and into the
//    warp's partial of that window in shared memory; at the end the block
//    merges its four warps' partials.  Q > 16 runs groups of 16 queries,
//    neighbours in the grid, so the group's second pass reads the rows
//    from L2.
// B. window_tiled (float modes), larger Q: 128-row x QB-query tiles (QB
//    128, or 64 at Q <= 64) on the CUDA cores, 8 x 8 (8 x 4) outputs a
//    thread, so each 16-byte shared-memory load feeds 32 (16) fmaf.  The
//    tiles stream through three 128-byte-deep stages of 16-byte cp.async
//    copies (bf16: converted to a float buffer once a stage, each element
//    once), one block an SM (254 registers a thread, no spill).  A
//    thread's outputs stay in its own chain each, in d order.
// C. window_tiled (int8), larger Q: the same tiles on mma.sync m16n8k32
//    (int8 operands, exact int32 sums, fused_mlp.cu's fragment layout):
//    128-byte stages three deep for 64-query tiles, 64-byte stages four
//    deep for 128-query tiles (whose 128-byte stages spill registers).
// B and C share the epilogue: each thread folds its rows of a query into
// one triple, shuffles merge the 64 rows of a warp, and one thread a query
// merges the tile's two 64-row halves into the running triple of their
// window and stores each window once it ends.  Nothing of the score tile
// goes through shared memory.
// ---------------------------------------------------------------------------
namespace window {

constexpr unsigned FULL = 0xffffffffu;
constexpr int A_WARPS = 4;  // route A: warps of a block
constexpr int A_ROWS = 64;  // route A: rows of a warp's slice, two a lane
// route A's stages: rows 128 bytes deep, two stages, up to A_DEEP_QA queries
// a group (bytes-bound); 64 bytes, three stages, at 16 queries (bound by
// the products, and the queries' shared memory leaves room for two blocks
// an SM only so)
constexpr int A_DEEP_QA = 8;
constexpr int A_DEEP_CHUNK = 128;
constexpr int A_DEEP_STAGES = 2;
constexpr int A_BLOCK_ROWS = 256;                  // route A: rows of a block, at least
constexpr int T_ROWS = 128;                        // routes B, C: rows of a tile
constexpr int T_THREADS = 256;
// routes B and C: bytes of a staged row in a stage, stages, rows of a block
// and blocks an SM (the register cap: 128 a thread at two; route B runs one,
// 8 x 8 outputs a thread and no spill)
constexpr int B_CHUNK = 128;
constexpr int B_STAGES = 3;
constexpr int B_BLOCK_ROWS = 128;
constexpr int B_MIN_BLOCKS = 1;
constexpr int C_CHUNK = 128;      // route C at 64 queries a tile
constexpr int C_STAGES = 3;
constexpr int C_WIDE_CHUNK = 64;  // route C at 128 queries a tile (past 64 bytes, spills)
constexpr int C_WIDE_STAGES = 4;
constexpr int C_BLOCK_ROWS = 512;
constexpr int C_MIN_BLOCKS = 2;
constexpr int SMEM_MAX = 232448;

struct Tri {
  float v;  // max
  int a;    // its lowest row
  float s;  // second max
};

// the triple of the union of two disjoint row sets (in either order)
__device__ __forceinline__ Tri merge(const Tri& x, const Tri& y) {
  const bool xw = x.v > y.v || (x.v == y.v && x.a < y.a);
  return xw ? Tri{x.v, x.a, fmaxf(x.s, y.v)} : Tri{y.v, y.a, fmaxf(y.s, x.v)};
}

// merge across the lanes that differ in the bits LO .. 16 of the lane id
template <int LO>
__device__ __forceinline__ Tri warp_merge(Tri t) {
#pragma unroll
  for (int o = 16; o >= LO; o >>= 1) {
    const Tri u{__shfl_xor_sync(FULL, t.v, o), __shfl_xor_sync(FULL, t.a, o),
                __shfl_xor_sync(FULL, t.s, o)};
    t = merge(t, u);
  }
  return t;
}

// the 16-byte cp.async and stage_piece's narrower loads (2-byte: every
// mode's rows are 2-byte aligned) of tile_fmaf.cuh, which route B's
// product and bf16 widening also come from
using hc::tile::cp_async16;
using hc::tile::cp_async_commit;
using hc::tile::cp_async_wait;
using hc::tile::stage_piece;

// eight floats of a staged row: f32 as they are, bf16 widened (exact)
template <int MODE>
__device__ __forceinline__ void load8(const unsigned char* src, float (&x)[8]) {
  if constexpr (MODE == 0) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 16);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z,
    x[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

template <int MODE>
struct Elem {
  using T = typename std::conditional<MODE == 0, float,
                                      typename std::conditional<MODE == 1, __nv_bfloat16,
                                                                int8_t>::type>::type;
  static constexpr int SIZE = sizeof(T);
};

// route A's geometry for groups of QA queries
template <int MODE, int QA>
struct Stream {
  static constexpr int CH = QA <= A_DEEP_QA ? A_DEEP_CHUNK : 64;  // bytes of a row a stage
  static constexpr int STAGES = QA <= A_DEEP_QA ? A_DEEP_STAGES : 3;
  static constexpr int PITCH = CH + 16;  // bytes between staged rows: 8 rows fill the banks
  static constexpr int RING = STAGES * A_ROWS * PITCH;  // bytes of a warp's ring
  static constexpr int PER_CHUNK = CH / Elem<MODE>::SIZE;  // elements of a row a stage
  // bytes a staged query takes a chunk: floats (float modes), int8 (mode 2)
  static constexpr int Q_CHUNK = MODE == 2 ? CH : PER_CHUNK * 4;
};

// Stage the queries [q0, q0 + nq) of the block into shared memory, nch
// chunks of CH bytes of a row a query: floats (float modes), int8 words
// (mode 2); zeros past Q and past D.
template <int MODE, int CH>
__device__ __forceinline__ void stage_queries(const void* q_, int Q, int D, int q0, int nq,
                                              int nch, unsigned char* qs) {
  if constexpr (MODE == 2) {
    const int D4 = D / 4, n4 = nch * (CH / 4);
    const int* q4 = static_cast<const int*>(q_);
    int* out = reinterpret_cast<int*>(qs);
    for (int e = threadIdx.x; e < nq * n4; e += blockDim.x) {
      const int qi = e / n4, d = e - qi * n4;
      out[e] = (q0 + qi < Q && d < D4) ? q4[(size_t)(q0 + qi) * D4 + d] : 0;
    }
  } else {
    using T = typename Elem<MODE>::T;
    const int nd = nch * (CH / Elem<MODE>::SIZE);
    const T* q = static_cast<const T*>(q_);
    float* out = reinterpret_cast<float*>(qs);
    for (int e = threadIdx.x; e < nq * nd; e += blockDim.x) {
      const int qi = e / nd, d = e - qi * nd;
      out[e] = (q0 + qi < Q && d < D) ? to_f(q[(size_t)(q0 + qi) * D + d]) : 0.0f;
    }
  }
}

// ---- route A --------------------------------------------------------------
//
// Grid: one block per (group of QA queries, run of `per` windows), the
// groups of a run neighbours.  Shared memory: the group's queries, the four
// warps' rings, and the warps' partial triples [per][A_WARPS][QA].
template <int MODE, int QA>
__global__ void __launch_bounds__(A_WARPS * 32) window_stream(
    const void* __restrict__ q_, const void* __restrict__ p_, int Q, int D, int row_end, int sw,
    int W, int per, int n_groups, bool vec, float* __restrict__ v1, int* __restrict__ a1,
    float* __restrict__ v2) {
  using E = Stream<MODE, QA>;
  constexpr int SIZE = Elem<MODE>::SIZE;
  using Acc = typename std::conditional<MODE == 2, int, float>::type;
  static_assert(QA <= 32, "one lane a query in the slice merge");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = blockIdx.x % n_groups;
  const int w0 = (blockIdx.x / n_groups) * per;
  const int w1 = min(W, w0 + per);
  const int q0 = group * QA;
  const int row_bytes = D * SIZE;
  const int nch = (row_bytes + E::CH - 1) / E::CH;
  const int qrow = nch * E::Q_CHUNK;  // bytes of a staged query
  unsigned char* qs = smem;
  unsigned char* ring = smem + QA * qrow + warp * E::RING;
  Tri* part = reinterpret_cast<Tri*>(smem + QA * qrow + A_WARPS * E::RING);

  stage_queries<MODE, E::CH>(q_, Q, D, q0, QA, nch, qs);
  for (int e = tid; e < (w1 - w0) * A_WARPS * QA; e += A_WARPS * 32)
    part[e] = Tri{-INFINITY, (w0 + e / (A_WARPS * QA)) * sw, -INFINITY};
  __syncthreads();

  const int r_begin = w0 * sw;
  const int r_stop = min(w1 * sw, row_end);  // rows this block scores
  const int n_slices = r_stop > r_begin ? (r_stop - r_begin + A_ROWS - 1) / A_ROWS : 0;
  const int n_mine = n_slices > warp ? (n_slices - 1 - warp) / A_WARPS + 1 : 0;
  const int steps = n_mine * nch;  // (slice, chunk) steps of this warp
  const unsigned char* pb = static_cast<const unsigned char*>(p_);

  auto fill_stage = [&](int st) {
    const int sl = st / nch, c = st - sl * nch;
    const int r0 = r_begin + (warp + sl * A_WARPS) * A_ROWS;
    unsigned char* dst = ring + (st % E::STAGES) * (A_ROWS * E::PITCH);
    constexpr int PIECES = E::CH / 16;  // 16-byte pieces of a staged row
#pragma unroll
    for (int k = 0; k < A_ROWS * PIECES / 32; ++k) {
      const int e = lane + 32 * k, row = e / PIECES, u = e % PIECES;
      const int r = r0 + row;
      stage_piece(dst + row * E::PITCH + 16 * u,
                  r < row_end ? pb + (size_t)r * row_bytes : nullptr, c * E::CH + 16 * u,
                  row_bytes, vec, p_);
    }
  };

#pragma unroll
  for (int s = 0; s < E::STAGES - 1; ++s) {
    if (s < steps) fill_stage(s);
    cp_async_commit();
  }
  Acc acc0[QA], acc1[QA];  // the chains of rows lane and lane + 32
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<E::STAGES - 2>();
    __syncwarp();  // every lane's copies of step st are in; step st - 1's slot is free
    if (st + E::STAGES - 1 < steps) fill_stage(st + E::STAGES - 1);
    cp_async_commit();  // an empty group at the end keeps the wait count uniform
    const int sl = st / nch, c = st - sl * nch;
    if (c == 0) {
#pragma unroll
      for (int qi = 0; qi < QA; ++qi) acc0[qi] = acc1[qi] = 0;
    }
    const unsigned char* ra = ring + (st % E::STAGES) * (A_ROWS * E::PITCH) + lane * E::PITCH;
    const unsigned char* rb = ra + 32 * E::PITCH;
    if constexpr (MODE == 2) {
      const int* qc = reinterpret_cast<const int*>(qs) + c * (E::CH / 4);
      const int qstride = nch * (E::CH / 4);
#pragma unroll
      for (int sub = 0; sub < E::CH / 16; ++sub) {
        const int4 x = *reinterpret_cast<const int4*>(ra + 16 * sub);
        const int4 y = *reinterpret_cast<const int4*>(rb + 16 * sub);
#pragma unroll
        for (int qi = 0; qi < QA; ++qi) {
          const int4 w = *reinterpret_cast<const int4*>(qc + qi * qstride + 4 * sub);
          int s0 = acc0[qi], s1 = acc1[qi];
          s0 = __dp4a(w.x, x.x, s0), s1 = __dp4a(w.x, y.x, s1);
          s0 = __dp4a(w.y, x.y, s0), s1 = __dp4a(w.y, y.y, s1);
          s0 = __dp4a(w.z, x.z, s0), s1 = __dp4a(w.z, y.z, s1);
          s0 = __dp4a(w.w, x.w, s0), s1 = __dp4a(w.w, y.w, s1);
          acc0[qi] = s0, acc1[qi] = s1;
        }
      }
    } else {
      const float* qc = reinterpret_cast<const float*>(qs) + c * E::PER_CHUNK;
      const int qstride = nch * E::PER_CHUNK;
#pragma unroll
      for (int sub = 0; sub < E::PER_CHUNK / 8; ++sub) {
        float x[8], y[8];
        load8<MODE>(ra + 8 * SIZE * sub, x);
        load8<MODE>(rb + 8 * SIZE * sub, y);
#pragma unroll
        for (int qi = 0; qi < QA; ++qi) {
          const float4 w0_ = *reinterpret_cast<const float4*>(qc + qi * qstride + 8 * sub);
          const float4 w1_ = *reinterpret_cast<const float4*>(qc + qi * qstride + 8 * sub + 4);
          const float w[8] = {w0_.x, w0_.y, w0_.z, w0_.w, w1_.x, w1_.y, w1_.z, w1_.w};
          float s0 = acc0[qi], s1 = acc1[qi];
#pragma unroll
          for (int d = 0; d < 8; ++d) {
            s0 = fmaf(w[d], x[d], s0);
            s1 = fmaf(w[d], y[d], s1);
          }
          acc0[qi] = s0, acc1[qi] = s1;
        }
      }
    }
    if (c == nch - 1) {  // the slice is scored: merge it into the warp's partial
      const int r0 = r_begin + (warp + sl * A_WARPS) * A_ROWS;
      const int ra_row = r0 + lane, rb_row = r0 + lane + 32;
      Tri* pw = part + ((r0 / sw - w0) * A_WARPS + warp) * QA;
#pragma unroll
      for (int qi = 0; qi < QA; ++qi) {
        const float sa = ra_row < row_end ? (float)acc0[qi] : -INFINITY;
        const float sb = rb_row < row_end ? (float)acc1[qi] : -INFINITY;
        Tri t = sb > sa ? Tri{sb, rb_row, sa} : Tri{sa, ra_row, sb};
        t = warp_merge<1>(t);
        if (lane == qi) pw[qi] = merge(pw[qi], t);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < (w1 - w0) * QA; e += A_WARPS * 32) {
    const int wl = e / QA, qi = e - wl * QA;
    if (q0 + qi >= Q) continue;
    const Tri* pw = part + wl * A_WARPS * QA + qi;
    Tri t = pw[0];
#pragma unroll
    for (int k = 1; k < A_WARPS; ++k) t = merge(t, pw[k * QA]);
    const size_t o = (size_t)(w0 + wl) * Q + q0 + qi;
    v1[o] = t.v;
    a1[o] = t.a;
    v2[o] = t.s;
  }
}

// d += a . b for one m16n8k32 tile (int8 operands, int32 accumulators)
__device__ __forceinline__ void mma_s8(int (&d)[4], int a0, int a1_, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1_), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int MODE, int QB>
struct Tiled {
  static constexpr int CH = MODE != 2 ? B_CHUNK : QB > 64 ? C_WIDE_CHUNK : C_CHUNK;
  static constexpr int STAGES = MODE != 2 ? B_STAGES : QB > 64 ? C_WIDE_STAGES : C_STAGES;
  // B: a 16-byte pad, so the 8 rows a load instruction reads fill the banks;
  // C reads whole 64-byte row runs by quads, and 128-byte rows swizzle (SWZ)
  static constexpr int TP = MODE == 2 ? CH : CH + 16;
  static constexpr int SWZ = MODE == 2 && CH >= 128 ? 4 : 0;
  static constexpr int SLOT = (T_ROWS + QB) * TP;
  // bf16: a stage widened to floats, rows FP floats apart
  static constexpr int FP = CH / 2 + 4;
  static constexpr int SMEM = STAGES * SLOT + (MODE == 1 ? (T_ROWS + QB) * FP * 4 : 0);
  static constexpr int BLOCK_ROWS = MODE == 2 ? C_BLOCK_ROWS : B_BLOCK_ROWS;
  static constexpr int WN = QB / 4;  // queries of a warp
};

// ---- routes B and C -------------------------------------------------------
//
// Grid: one block per (tile of QB queries, run of `per` windows), the tiles
// of a run neighbours.  Warp (wm, wn) = (warp / 4, warp % 4) covers rows
// 64 wm .. 64 wm + 63 of a tile and queries wn QB/4 .. of the block's QB.
// Lane (g, t) = (lane / 4, lane % 4).  B: rows g + 8 i (i < 8), queries
// t + 4 j (j < QB / 16); C: rows 16 i + g + 8 h (i < 4, h < 2), queries
// 8 j + 2 t + e (j < QB / 32, e < 2), the m16n8 accumulator layout.
template <int MODE, int QB>
__global__ void __launch_bounds__(T_THREADS, MODE == 2 ? C_MIN_BLOCKS : B_MIN_BLOCKS)
    window_tiled(
    const void* __restrict__ q_, const void* __restrict__ p_, int Q, int D, int row_end, int sw,
    int W, int per, int n_qt, bool vec, float* __restrict__ v1, int* __restrict__ a1,
    float* __restrict__ v2) {
  using K = Tiled<MODE, QB>;
  constexpr int ESZ = Elem<MODE>::SIZE;
  constexpr int WN = K::WN;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Tri part[2][QB];  // a tile's triples of its two 64-row halves
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int qt = blockIdx.x % n_qt;
  const int w0 = (blockIdx.x / n_qt) * per, w1 = min(W, w0 + per);
  const int q0 = qt * QB;
  const int row_bytes = D * ESZ;
  const int KT = (row_bytes + K::CH - 1) / K::CH;
  const int r_begin = w0 * sw, r_stop = min(w1 * sw, row_end);
  const int n_tiles = r_stop > r_begin ? (r_stop - r_begin + T_ROWS - 1) / T_ROWS : 0;
  const int steps = n_tiles * KT;
  const unsigned char* pb = static_cast<const unsigned char*>(p_);
  const unsigned char* qb = static_cast<const unsigned char*>(q_);

  // A thread's 16-byte pieces of a stage: the same rows and units in every
  // stage of a tile, so their addresses are set once (tile 0, depth 0) and
  // each stage only offsets them.  Piece k is passage rows while k * T_THREADS
  // / PIECES < T_ROWS, then queries.
  constexpr int PIECES = K::CH / 16;  // 16-byte pieces of a staged row
  constexpr int NP = (T_ROWS + QB) * PIECES / T_THREADS;
  const unsigned char* src0[NP];
  int dst0[NP], row0[NP], unit0[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int e = tid + T_THREADS * k, row = e / PIECES, u = e % PIECES;
    row0[k] = row < T_ROWS ? row : row - T_ROWS;
    unit0[k] = 16 * u;
    dst0[k] = row * K::TP + 16 * (u ^ (K::SWZ * (row & 1)));
    src0[k] = (row < T_ROWS ? pb + (size_t)(r_begin + row) * row_bytes
                            : qb + (size_t)(q0 + row - T_ROWS) * row_bytes);
  }
  auto fill_stage = [&](int st) {
    const int tile = st / KT, kt = st - tile * KT;
    const int rows_left = row_end - (r_begin + tile * T_ROWS);  // valid rows of the tile
    const size_t tile_off = (size_t)tile * T_ROWS * row_bytes;
    unsigned char* dst = smem + (st % K::STAGES) * K::SLOT;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const bool is_p = k * T_THREADS / PIECES < T_ROWS;  // compile time
      const bool live = is_p ? row0[k] < rows_left : q0 + row0[k] < Q;
      const unsigned char* row = src0[k] + (is_p ? tile_off : 0);
      if (vec) {
        const int off = kt * K::CH + unit0[k];
        const bool full = live && off < row_bytes;
        cp_async16(dst + dst0[k], full ? static_cast<const void*>(row + off) : p_, full);
      } else {
        stage_piece(dst + dst0[k], live ? row : nullptr, kt * K::CH + unit0[k], row_bytes,
                    false, p_);
      }
    }
  };

  // the window of the running triples, and the triple of query q0 + tid
  // (threads tid < QB, in shared memory: no register across the loop)
  int cur = w0;
  __shared__ Tri run[QB];
  if (tid < QB) run[tid] = Tri{-INFINITY, w0 * sw, -INFINITY};
  auto store = [&](int w, const Tri& t) {
    if (tid < QB && q0 + tid < Q) {
      const size_t o = (size_t)w * Q + q0 + tid;
      v1[o] = t.v;
      a1[o] = t.a;
      v2[o] = t.s;
    }
  };

#pragma unroll
  for (int s = 0; s < K::STAGES - 1; ++s) {
    if (s < steps) fill_stage(s);
    cp_async_commit();
  }
  constexpr int NB = MODE == 2 ? 1 : QB / 16;      // route B: queries a thread
  constexpr int NTL = MODE == 2 ? QB / 32 : 1;      // route C: n8 tiles a warp
  float acc[MODE == 2 ? 1 : 8][NB];
  int iacc[MODE == 2 ? 4 : 1][NTL][4];
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<K::STAGES - 2>();
    __syncthreads();  // step st is in; every warp is done with step st - 1's slot
    if (st + K::STAGES - 1 < steps) fill_stage(st + K::STAGES - 1);
    cp_async_commit();
    const int tile = st / KT, kt = st - tile * KT;
    const unsigned char* slot = smem + (st % K::STAGES) * K::SLOT;
    if constexpr (MODE == 2) {
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NTL; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) iacc[i][j][e] = 0;
      }
      // lane (g, t4) of a quad holds bytes 16 t4 .. 16 t4 + 15 of each 64-byte
      // run of its rows, for A and B alike: a permutation of k that an
      // exact integer sum does not see (fused_mlp.cu)
      const unsigned char* a = slot + (wm * 64 + g) * K::TP;
      const unsigned char* b = slot + (T_ROWS + wn * WN + g) * K::TP;
#pragma unroll
      for (int kk = 0; kk < K::CH / 64; ++kk) {
        const int off = 16 * ((4 * kk + t4) ^ (K::SWZ * (g & 1)));
        int4 bf[NTL];
#pragma unroll
        for (int j = 0; j < NTL; ++j)
          bf[j] = *reinterpret_cast<const int4*>(b + j * 8 * K::TP + off);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int4 lo = *reinterpret_cast<const int4*>(a + i * 16 * K::TP + off);
          const int4 hi = *reinterpret_cast<const int4*>(a + (i * 16 + 8) * K::TP + off);
#pragma unroll
          for (int j = 0; j < NTL; ++j) {
            mma_s8(iacc[i][j], lo.x, hi.x, lo.y, hi.y, bf[j].x, bf[j].y);
            mma_s8(iacc[i][j], lo.z, hi.z, lo.w, hi.w, bf[j].z, bf[j].w);
          }
        }
      }
    } else {
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) acc[i][j] = 0.0f;
      }
      constexpr int KC = K::CH / ESZ;                     // depth of a stage
      constexpr int fp = MODE == 1 ? K::FP : K::TP / 4;   // floats between rows
      float* fb = reinterpret_cast<float*>(smem + K::STAGES * K::SLOT);
      if constexpr (MODE == 1) {  // widen the stage once: [T_ROWS + QB][FP] floats
        hc::tile::widen<hc::tile::Stage<K::CH, K::CH, QB>, __nv_bfloat16, __nv_bfloat16, K::FP>(
            slot, fb);
        __syncthreads();
      }
      const float* F = MODE == 1 ? fb : reinterpret_cast<const float*>(slot);
      hc::tile::product<QB, KC, fp, fp>(F, F + T_ROWS * fp, acc);
    }
    if (kt == KT - 1) {  // the tile is scored: its halves' triples, then the windows'
      const int r0 = r_begin + tile * T_ROWS + wm * 64;
      // a thread's rows of a query ascend, so each joins its triple as the
      // max if strictly larger (ties keep the lower row), else as a second
      // max; int8 folds the exact int32 sums (INT_MIN for rows past
      // n_valid) and converts the two maxima to float once
      const int valid = row_end - r0;  // rows of the half below n_valid
      if constexpr (MODE == 2) {
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int v = INT_MIN, s2 = INT_MIN, a = r0 + g;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int rr = 16 * i + g + 8 * h;
                const int x = rr < valid ? iacc[i][j][2 * h + e] : INT_MIN;
                if (x > v) {
                  s2 = v;
                  v = x;
                  a = r0 + rr;
                } else {
                  s2 = max(s2, x);
                }
              }
            Tri t{v == INT_MIN ? -INFINITY : (float)v, a,
                  s2 == INT_MIN ? -INFINITY : (float)s2};
            t = warp_merge<4>(t);
            if (g == 0) part[wm][wn * WN + 8 * j + 2 * t4 + e] = t;
          }
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          Tri t{g < valid ? acc[0][j] : -INFINITY, r0 + g, -INFINITY};
#pragma unroll
          for (int i = 1; i < 8; ++i) {
            const float x = g + 8 * i < valid ? acc[i][j] : -INFINITY;
            if (x > t.v) {
              t.s = t.v;
              t.v = x;
              t.a = r0 + g + 8 * i;
            } else {
              t.s = fmaxf(t.s, x);
            }
          }
          t = warp_merge<4>(t);
          if (g == 0) part[wm][wn * WN + t4 + 4 * j] = t;
        }
      }
      __syncthreads();
      const int t0 = r_begin + tile * T_ROWS;
      if (tid < QB) {
        int c = cur;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int hr = t0 + 64 * h;
          if (hr >= r_stop) break;  // past the block's windows, or past n_valid
          const int wh = hr / sw;
          Tri t = run[tid];
          if (wh != c) {
            store(c, t);
            c = wh;
            t = Tri{-INFINITY, wh * sw, -INFINITY};
          }
          run[tid] = merge(t, part[h][tid]);
        }
      }
      cur = (t0 + 64 < r_stop ? t0 + 64 : t0) / sw;  // the window of the last half merged
      // the next tile's epilogue writes part after a step's __syncthreads
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < QB) store(cur, run[tid]);
  for (int w = cur + 1; w < w1; ++w) store(w, Tri{-INFINITY, w * sw, -INFINITY});  // past n_valid
}

}  // namespace window

// ---------------------------------------------------------------------------
// 2. rescore_stream (replaces _rescore_kernel, pallas_topk_v4.py:522)
//
// out[q, b * sw + r] is query q's score of row win_ids[q, b] * sw + r;
// rows at or past n_valid and every row of a slot whose window id is
// negative (no flagged window; nothing is read for it) come out -inf.
//
// Bound on the H100: the bytes of the flagged windows, each read once
// (sw x D x the element size, 786 KB in f32 at sw 256: seven windows a
// query at Q 256 are 1.29 GB, 0.386 ms at 3.35 TB/s); each row costs 2 D
// operations, 256 times fewer a byte than the window kernel's at Q 256.
//
// Design: route A's streaming (section 1) with one query.  The grid is a
// list of warp tasks (query, slot, piece), the pieces of a window
// neighbours, one warp a block; a piece is ROWS rows of the slot's window,
// one a lane (a single request's seven windows at sw 256 give 112 warps).
// Each warp is its own task: it starts its ring's 16-byte cp.async copies
// of whole rows (2-byte loads off the 16-byte path), stages its query into
// its own shared memory (floats, or int8 words) while they are in flight,
// runs each row's chain in d order and stores its rows' scores; no block
// barrier, no merge.  A row's chain is the window kernel's (the same
// conversions, one fmaf chain from 0.0f in d order, zeros past D; in int8
// the exact int32 dp4a sum), so a rescored row equals the window kernel's
// value for it bit for bit.
// ---------------------------------------------------------------------------
namespace rescore {

// pieces of 16 rows, one a lane (lanes 16-31 only copy), two 256-byte
// stages, one warp a block, so that a single request's rows spread over
// as many warps and SMs as they can (probes/probe_torch_rescore.py
// --variants: 32-row pieces and three stages were slower; 8-row pieces
// faster at Q 1 only; 512-byte stages 0.5-1.5% faster in float32 at Q 8
// and 256, slower elsewhere; two rows a lane in 64-row pieces faster only
// at 32,768 rows, by 2.4 us at Q 16, and slower at Q 32 to 256)
constexpr int ROWS = 16;
constexpr int LANES = ROWS;          // lanes that score rows
constexpr int CH = 256;              // bytes of a row a stage
constexpr int PITCH = CH + 16;       // bytes between staged rows: 8 rows fill the banks
constexpr int STAGES = 2;
constexpr int BYTES = STAGES * ROWS * PITCH;  // a warp's ring
static_assert(CH % 16 == 0, "16-byte pieces");
static_assert(ROWS <= 32, "one row a lane");

// bytes of a staged query: floats (float modes), int8 words (mode 2), in
// chunks of CH bytes of a row
template <int MODE>
int query_bytes(int D) {
  const int size = window::Elem<MODE>::SIZE;
  const int nch = (D * size + CH - 1) / CH;
  return nch * (MODE == 2 ? CH : CH / size * 4);
}

// query q into qs, nch chunks of CH bytes of a row, zeros past D; the
// lanes of one warp, 16 bytes a load where `vec` (16-byte rows and base)
template <int MODE>
__device__ __forceinline__ void stage_query(const void* __restrict__ q_, int D, int q, int nch,
                                            bool vec, unsigned char* qs) {
  using T = typename window::Elem<MODE>::T;
  constexpr int SIZE = window::Elem<MODE>::SIZE;
  const int lane = threadIdx.x & 31;
  const T* qr = static_cast<const T*>(q_) + (size_t)q * D;
  const int n16 = nch * (CH / 16);  // 16-byte pieces of the staged row
  if (vec) {
    constexpr int PER = 16 / SIZE;  // elements of a piece
#pragma unroll 4
    for (int v = lane; v < n16; v += 32) {
      const uint4 u = v * PER < D ? __ldg(reinterpret_cast<const uint4*>(qr) + v)
                                  : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (MODE == 1) {  // 8 bf16 widened: 32 bytes of floats
        float4* o = reinterpret_cast<float4*>(qs) + 2 * v;
        o[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                           __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        o[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                           __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      } else {  // floats, or int8 words, as they are
        reinterpret_cast<uint4*>(qs)[v] = u;
      }
    }
    return;
  }
  if constexpr (MODE == 2) {
    const int D4 = D / 4, n4 = nch * (CH / 4);
    const int* q4 = reinterpret_cast<const int*>(qr);
    int* out = reinterpret_cast<int*>(qs);
    for (int d = lane; d < n4; d += 32) out[d] = d < D4 ? q4[d] : 0;
  } else {
    const int nd = nch * (CH / SIZE);
    float* out = reinterpret_cast<float*>(qs);
    for (int d = lane; d < nd; d += 32) out[d] = d < D ? to_f(qr[d]) : 0.0f;
  }
}

template <int MODE>
__global__ void __launch_bounds__(32) rescore_stream(
    const void* __restrict__ q_, const void* __restrict__ p_, int D, int row_end, int sw,
    int B, int pieces, long long n_tasks, bool vec, bool qvec, const int* __restrict__ win_ids,
    float* __restrict__ out) {
  constexpr int SIZE = window::Elem<MODE>::SIZE;
  using Acc = typename std::conditional<MODE == 2, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const long long task = blockIdx.x;
  if (task >= n_tasks) return;
  const long long qb = task / pieces;  // query * B + slot
  const int r0 = (int)(task - qb * pieces) * ROWS;  // the piece's first row in the window
  const int nr = min(ROWS, sw - r0);                // rows of the piece
  float* o = out + qb * sw + r0;
  const int win = win_ids[qb];
  const long long row0 = (long long)win * sw + r0;  // its first row in the passages
  const int live = win < 0 ? 0 : (int)max(0LL, min((long long)nr, row_end - row0));
  if (live == 0) {  // an empty slot, or a piece wholly past n_valid: read nothing
    for (int r = lane; r < nr; r += 32) o[r] = -INFINITY;
    return;
  }
  const int row_bytes = D * SIZE;
  const int nch = (row_bytes + CH - 1) / CH;
  unsigned char* ring = smem;
  unsigned char* qs = ring + BYTES;
  const unsigned char* pb = static_cast<const unsigned char*>(p_) + row0 * row_bytes;

  auto fill_stage = [&](int c) {
    unsigned char* dst = ring + (c % STAGES) * (ROWS * PITCH);
    constexpr int PIECES = CH / 16;  // 16-byte pieces of a staged row
#pragma unroll
    for (int k = 0; k < ROWS * PIECES / 32; ++k) {
      const int e = lane + 32 * k, row = e / PIECES, u = e % PIECES;
      window::stage_piece(dst + row * PITCH + 16 * u,
                          row < live ? pb + (size_t)row * row_bytes : nullptr, c * CH + 16 * u,
                          row_bytes, vec, p_);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) fill_stage(s);
    window::cp_async_commit();
  }
  // the query while the first stages are in flight (the loop's first
  // __syncwarp shows it to every lane)
  stage_query<MODE>(q_, D, (int)(qb / B), nch, qvec, qs);
  Acc acc = 0;  // the chain of row lane
  for (int c = 0; c < nch; ++c) {
    window::cp_async_wait<STAGES - 2>();
    __syncwarp();  // every lane's copies of stage c are in; stage c - 1's slot is free
    if (c + STAGES - 1 < nch) fill_stage(c + STAGES - 1);
    window::cp_async_commit();  // an empty group at the end keeps the wait count uniform
    if (lane >= LANES) continue;  // copies only
    const unsigned char* ra = ring + (c % STAGES) * (ROWS * PITCH) + lane * PITCH;
    if constexpr (MODE == 2) {
      const int* qc = reinterpret_cast<const int*>(qs) + c * (CH / 4);
#pragma unroll
      for (int sub = 0; sub < CH / 16; ++sub) {
        const int4 w = *reinterpret_cast<const int4*>(qc + 4 * sub);
        const int4 x = *reinterpret_cast<const int4*>(ra + 16 * sub);
        acc = __dp4a(w.x, x.x, acc);
        acc = __dp4a(w.y, x.y, acc);
        acc = __dp4a(w.z, x.z, acc);
        acc = __dp4a(w.w, x.w, acc);
      }
    } else {
      constexpr int PER_CHUNK = CH / SIZE;  // elements of a row a stage
      const float* qc = reinterpret_cast<const float*>(qs) + c * PER_CHUNK;
#pragma unroll
      for (int sub = 0; sub < PER_CHUNK / 8; ++sub) {
        const float4 w0 = *reinterpret_cast<const float4*>(qc + 8 * sub);
        const float4 w1 = *reinterpret_cast<const float4*>(qc + 8 * sub + 4);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        float x[8];
        window::load8<MODE>(ra + 8 * SIZE * sub, x);
#pragma unroll
        for (int d = 0; d < 8; ++d) acc = fmaf(w[d], x[d], acc);
      }
    }
  }
  if (lane < nr) o[lane] = lane < live ? (float)acc : -INFINITY;
}

template <int MODE>
cudaError_t launch(const void* q, const void* p, int Q, int D, int row_end, int sw, int B,
                   const int* win_ids, float* out, cudaStream_t stream) {
  // 16-byte copies need 16-byte rows and bases; else 2-byte loads (rows)
  // and scalar ones (the query)
  const bool rows16 = (D * window::Elem<MODE>::SIZE) % 16 == 0;
  const bool vec = rows16 && ((uintptr_t)p & 15) == 0;
  const bool qvec = rows16 && ((uintptr_t)q & 15) == 0;
  const int smem = BYTES + query_bytes<MODE>(D);
  if (smem > window::SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rescore_stream<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int pieces = (sw + ROWS - 1) / ROWS;
  const long long n_tasks = (long long)Q * B * pieces;
  if (n_tasks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rescore_stream<MODE><<<(unsigned)n_tasks, 32, (size_t)smem, stream>>>(
      q, p, D, row_end, sw, B, pieces, n_tasks, vec, qvec, win_ids, out);
  return cudaGetLastError();
}

}  // namespace rescore

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

namespace window {

// Route A with QA queries a group; the shared memory it needs (0: more than
// a block may have).
template <int MODE, int QA>
size_t stream_smem(int D, int sw) {
  using E = Stream<MODE, QA>;
  const int nch = (D * Elem<MODE>::SIZE + E::CH - 1) / E::CH;
  const int per = (A_BLOCK_ROWS + sw - 1) / sw;
  const size_t bytes = (size_t)QA * nch * E::Q_CHUNK + A_WARPS * E::RING +
                       (size_t)per * A_WARPS * QA * sizeof(Tri);
  return bytes <= SMEM_MAX ? bytes : 0;
}

template <int MODE, int QA>
cudaError_t launch_stream(const void* q, const void* p, int Q, int D, int row_end, int sw,
                          int W, bool vec, float* v1, int* a1, float* v2, cudaStream_t stream) {
  const size_t smem = stream_smem<MODE, QA>(D, sw);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_stream<MODE, QA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int per = (A_BLOCK_ROWS + sw - 1) / sw;
  const int n_groups = (Q + QA - 1) / QA;
  const long long blocks = (long long)((W + per - 1) / per) * n_groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  window_stream<MODE, QA><<<(unsigned)blocks, A_WARPS * 32, smem, stream>>>(
      q, p, Q, D, row_end, sw, W, per, n_groups, vec, v1, a1, v2);
  return cudaGetLastError();
}

template <int MODE, int QB>
cudaError_t launch_tiled(const void* q, const void* p, int Q, int D, int row_end, int sw, int W,
                         bool vec, float* v1, int* a1, float* v2, cudaStream_t stream) {
  using K = Tiled<MODE, QB>;
  cudaError_t err = cudaFuncSetAttribute(window_tiled<MODE, QB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return err;
  const int per = (K::BLOCK_ROWS + sw - 1) / sw;
  const int n_qt = (Q + QB - 1) / QB;
  const long long blocks = (long long)((W + per - 1) / per) * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  window_tiled<MODE, QB><<<(unsigned)blocks, T_THREADS, K::SMEM, stream>>>(
      q, p, Q, D, row_end, sw, W, per, n_qt, vec, v1, a1, v2);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(int route, const void* q, const void* p, int Q, int D, int row_end, int sw,
                   int W, bool vec, float* v1, int* a1, float* v2, cudaStream_t s) {
  if (route == 0) {  // A: the smallest group that holds Q, groups of 16 past it
    if (Q <= 1) return launch_stream<MODE, 1>(q, p, Q, D, row_end, sw, W, vec, v1, a1, v2, s);
    if (Q <= 4) return launch_stream<MODE, 4>(q, p, Q, D, row_end, sw, W, vec, v1, a1, v2, s);
    if (Q <= 8) return launch_stream<MODE, 8>(q, p, Q, D, row_end, sw, W, vec, v1, a1, v2, s);
    return launch_stream<MODE, 16>(q, p, Q, D, row_end, sw, W, vec, v1, a1, v2, s);
  }
  // B (float modes) and C (int8): tiles of 64 queries up to Q 64, else 128
  if ((route == 2) != (MODE == 2)) return cudaErrorInvalidValue;
  if (Q <= 64) return launch_tiled<MODE, 64>(q, p, Q, D, row_end, sw, W, vec, v1, a1, v2, s);
  return launch_tiled<MODE, 128>(q, p, Q, D, row_end, sw, W, vec, v1, a1, v2, s);
}

}  // namespace window

bool bad_mode_shape(int mode, int D, const void* q, const void* p) {
  if (mode < 0 || mode > 2) return true;
  // int8 x int8 reads 4-byte words: rows of D % 4 == 0 bytes, aligned bases
  return mode == 2 && (D % 4 != 0 || ((uintptr_t)q & 3) || ((uintptr_t)p & 3));
}

}  // namespace

// Kernel 1.  q [Q, D], p [N, D] of one mode (0 f32, 1 bf16, 2 int8 x int8);
// rows >= min(n_valid, N) score -inf; W windows of sw rows (a multiple of
// 64), W >= ceil(min(n_valid, N) / sw).  route: 0 = A (window_stream, any
// mode), 1 = B (window_tiled, f32 / bf16), 2 = C (window_tiled, int8).
// Outputs v1 float [W, Q], a1 int32 [W, Q], v2 float [W, Q].
extern "C" int hc_window_top2(const void* q, const void* p, int Q, int N, int D, int n_valid,
                              int sw, int W, int route, void* v1, void* a1, void* v2, int mode,
                              void* stream) {
  if (Q <= 0 || N < 0 || D <= 0 || sw <= 0 || sw % 64 != 0 || W <= 0 ||
      (long long)W * sw > 0x7fffffffLL || route < 0 || route > 2 ||
      bad_mode_shape(mode, D, q, p))
    return (int)cudaErrorInvalidValue;
  const int row_end = n_valid < N ? (n_valid < 0 ? 0 : n_valid) : N;
  const int esz = mode == 0 ? 4 : mode == 1 ? 2 : 1;
  // 16-byte copies need 16-byte rows and bases; else the 2-byte path
  const bool vec = (D * esz) % 16 == 0 && ((uintptr_t)q & 15) == 0 && ((uintptr_t)p & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o1 = static_cast<float*>(v1);
  int* oa = static_cast<int*>(a1);
  float* o2 = static_cast<float*>(v2);
  if (mode == 0)
    return (int)window::launch<0>(route, q, p, Q, D, row_end, sw, W, vec, o1, oa, o2, s);
  if (mode == 1)
    return (int)window::launch<1>(route, q, p, Q, D, row_end, sw, W, vec, o1, oa, o2, s);
  return (int)window::launch<2>(route, q, p, Q, D, row_end, sw, W, vec, o1, oa, o2, s);
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
  if (mode == 0) return (int)rescore::launch<0>(q, p, Q, D, row_end, sw, B, w, o, s);
  if (mode == 1) return (int)rescore::launch<1>(q, p, Q, D, row_end, sw, B, w, o, s);
  return (int)rescore::launch<2>(q, p, Q, D, row_end, sw, B, w, o, s);
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
