// The register-tiled score product on the CUDA cores that the v4 window
// kernel's route B (topk_v4.cu, window_tiled) and the v3 fused top-k
// (fused_topk.cu, topk_split_kernel) share: the 16-byte cp.async and
// stage_piece, the bf16 and int8 widening and the fmaf product; the v3
// kernel also stages through Stager (route B keeps the staging it shares
// with route C's swizzled rows).  Route B built from this header gives
// the same panels bit for bit, within 1.2% of the device time of its own
// earlier copy of this code at Q 1-512 (probes/probe_torch_window.py
// --other, NVIDIA H100 80GB HBM3 at 700 W).
//
// A tile is ROWS = 128 passage rows x QB query rows.  It streams through
// shared-memory stages, each holding PCH bytes of every passage row and QCH
// bytes of every query row (KC elements of depth), copied in 16-byte pieces
// by cp.async when rows and bases are 16-byte aligned (else by
// stage_piece's narrower loads), zeros past a row's end and past the last
// row or query.  A stage of 16-bit or 8-bit elements is widened to floats
// once, into a [ROWS + QB][FP] float buffer, so that every element converts
// once and the product reads floats only.
//
// THREADS = 256 threads.  Warp (wm, wn) = (warp / 4, warp % 4) covers rows
// 64 wm .. 64 wm + 63 of the tile and queries wn QB/4 .. of its QB; lane
// (g, t4) = (lane / 4, lane % 4) holds rows g + 8 i (i < 8) and queries t4 +
// 4 j (j < QB / 16): an 8 x QB/16 register tile, so each 16-byte
// shared-memory load feeds 32 (QB 128) or 16 (QB 64) fmaf.  Each output is
// one fmaf chain over d = 0, 1, ..., D-1 in d order from 0.0f (the zeros
// past D add nothing), the chain of route B and of topk_v4.cu's rescore
// kernel, so a row scores the same float in all three.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hc {
namespace tile {

constexpr int ROWS = 128;     // passage rows of a tile
constexpr int THREADS = 256;  // threads of a block

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  // src-size 0 zero-fills the 16 bytes
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes [off, off + 16) of a row of row_bytes bytes (row: nullptr past the
// end) into dst, zeros past the row: one 16-byte cp.async when `vec` (rows
// and bases 16-byte aligned), else ALIGN-byte loads: 2 for rows of 2- and
// 4-byte elements, 1 for int8 rows.
template <int ALIGN = 2>
__device__ __forceinline__ void stage_piece(unsigned char* dst, const unsigned char* row, int off,
                                            int row_bytes, bool vec, const void* base) {
  const int n = row == nullptr ? 0 : min(16, row_bytes - off);
  if (vec) {
    cp_async16(dst, n > 0 ? static_cast<const void*>(row + off) : base, n > 0);
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (ALIGN == 1) {
      w[k] = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * k + b < n) w[k] |= (uint32_t)row[off + 4 * k + b] << (8 * b);
    } else {
      const uint32_t lo = 4 * k < n ? *reinterpret_cast<const uint16_t*>(row + off + 4 * k) : 0u;
      const uint32_t hi =
          4 * k + 2 < n ? *reinterpret_cast<const uint16_t*>(row + off + 4 * k + 2) : 0u;
      w[k] = lo | (hi << 16);
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// A stage's layout: ROWS passage rows of PCH bytes, then QB query rows of
// QCH bytes, each row padded by 16 bytes, so that the 8 rows a load
// instruction reads fill the banks.
template <int PCH_, int QCH_, int QB_>
struct Stage {
  static constexpr int PCH = PCH_, QCH = QCH_, QB = QB_;
  static constexpr int PTP = PCH + 16, QTP = QCH + 16;  // bytes between rows
  static constexpr int PP = PCH / 16, QP = QCH / 16;     // 16-byte pieces of a row
  static constexpr int P_PIECES = ROWS * PP;
  static constexpr int NP = (P_PIECES + QB * QP) / THREADS;  // pieces of a thread
  static constexpr int NPP = P_PIECES / THREADS;             // of them passage pieces
  static constexpr int QOFF = ROWS * PTP;                    // bytes of the passage rows
  static constexpr int BYTES = QOFF + QB * QTP;
  static_assert(P_PIECES % THREADS == 0 && (QB * QP) % THREADS == 0,
                "every thread stages the same number of passage and query pieces");
};

// A thread's 16-byte pieces of a stage: the same rows and units in every
// stage of a tile, so their addresses are set once and each stage only
// offsets them.  Pieces k < S::NPP are passage rows, the rest queries.
// PALIGN is stage_piece's load width for passage rows off the 16-byte path.
template <class S, int PALIGN = 2>
struct Stager {
  const unsigned char* src[S::NP];
  int dst[S::NP], row[S::NP], unit[S::NP];

  // rows r_begin .. of pb (p_row_bytes a row) and queries q0 .. of qb
  __device__ __forceinline__ Stager(const unsigned char* pb, int p_row_bytes,
                                    const unsigned char* qb, int q_row_bytes, int r_begin,
                                    int q0) {
#pragma unroll
    for (int k = 0; k < S::NP; ++k) {
      const int e = threadIdx.x + THREADS * k;
      if (k < S::NPP) {
        const int r = e / S::PP, u = e % S::PP;
        row[k] = r;
        unit[k] = 16 * u;
        dst[k] = r * S::PTP + 16 * u;
        src[k] = pb + (size_t)(r_begin + r) * p_row_bytes;
      } else {
        const int eq = e - S::P_PIECES, r = eq / S::QP, u = eq % S::QP;
        row[k] = r;
        unit[k] = 16 * u;
        dst[k] = S::QOFF + r * S::QTP + 16 * u;
        src[k] = qb + (size_t)(q0 + r) * q_row_bytes;
      }
    }
  }

  // depth step kt of tile `tile` into `slot`: passage rows below rows_left
  // (counted from the tile's first row) and queries below queries_left
  // (from q0) are live, the rest zeros
  __device__ __forceinline__ void fill(unsigned char* slot, int tile, int kt, int rows_left,
                                       int queries_left, int p_row_bytes, int q_row_bytes,
                                       bool vec, const void* base) const {
    const size_t tile_off = (size_t)tile * ROWS * p_row_bytes;
#pragma unroll
    for (int k = 0; k < S::NP; ++k) {
      const bool is_p = k < S::NPP;  // compile time
      const bool live = row[k] < (is_p ? rows_left : queries_left);
      const unsigned char* r = src[k] + (is_p ? tile_off : 0);
      const int off = kt * (is_p ? S::PCH : S::QCH) + unit[k];
      const int rb = is_p ? p_row_bytes : q_row_bytes;
      if (vec) {
        const bool full = live && off < rb;
        cp_async16(slot + dst[k], full ? static_cast<const void*>(r + off) : base, full);
      } else if (is_p) {
        stage_piece<PALIGN>(slot + dst[k], live ? r : nullptr, off, rb, false, base);
      } else {
        stage_piece<2>(slot + dst[k], live ? r : nullptr, off, rb, false, base);
      }
    }
  }
};

// the floats of one 16-byte piece: 8 bf16 or 16 int8 values, exact
__device__ __forceinline__ void widen_piece(const unsigned char* src, float* out,
                                            const __nv_bfloat16*) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    o[k] = make_float4(__uint_as_float(w[2 * k] << 16), __uint_as_float(w[2 * k] & 0xffff0000u),
                       __uint_as_float(w[2 * k + 1] << 16),
                       __uint_as_float(w[2 * k + 1] & 0xffff0000u));
}
__device__ __forceinline__ void widen_piece(const unsigned char* src, float* out, const int8_t*) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = make_float4((float)(int8_t)(w[k] & 0xffu), (float)(int8_t)((w[k] >> 8) & 0xffu),
                       (float)(int8_t)((w[k] >> 16) & 0xffu), (float)(int8_t)(w[k] >> 24));
}

// Widen a stage of PT passage and QT query elements (bf16 or int8) into
// fb: [ROWS + QB][FP] floats, passages first.  The caller puts a block
// barrier between this and the product.
template <class S, typename PT, typename QT, int FP>
__device__ __forceinline__ void widen(const unsigned char* slot, float* fb) {
#pragma unroll
  for (int k = 0; k < S::NP; ++k) {
    const int e = threadIdx.x + THREADS * k;
    if (k < S::NPP) {
      const int r = e / S::PP, u = e % S::PP;
      widen_piece(slot + r * S::PTP + 16 * u, fb + r * FP + (16 / sizeof(PT)) * u,
                  static_cast<const PT*>(nullptr));
    } else {
      const int eq = e - S::P_PIECES, r = eq / S::QP, u = eq % S::QP;
      widen_piece(slot + S::QOFF + r * S::QTP + 16 * u,
                  fb + (ROWS + r) * FP + (16 / sizeof(QT)) * u, static_cast<const QT*>(nullptr));
    }
  }
}

// acc[i][j] += the KC-deep products of row g + 8 i of the warp's half and
// query t4 + 4 j of its quarter, in d order: P passage rows FPP floats
// apart, Qf query rows FPQ floats apart.
template <int QB, int KC, int FPP, int FPQ>
__device__ __forceinline__ void product(const float* P, const float* Qf,
                                        float (&acc)[8][QB / 16]) {
  constexpr int NB = QB / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const float* pr = P + (wm * 64 + g) * FPP;
  const float* qr = Qf + (wn * (QB / 4) + t4) * FPQ;
#pragma unroll
  for (int d4 = 0; d4 < KC / 4; ++d4) {
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = *reinterpret_cast<const float4*>(pr + 8 * i * FPP + 4 * d4);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(qr + 4 * j * FPQ + 4 * d4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float s = acc[i][j];
        s = fmaf(w.x, x[i].x, s);
        s = fmaf(w.y, x[i].y, s);
        s = fmaf(w.z, x[i].z, s);
        s = fmaf(w.w, x[i].w, s);
        acc[i][j] = s;
      }
    }
  }
}

}  // namespace tile
}  // namespace hc
