// Tensor-core attention forward for bf16, and the helpers every attention
// kernel of the port shares: the score and dropout arithmetic, the
// cp.async / ldmatrix / mma.sync primitives, the key-tile skipping
// (key_tiles) and the normalisation (probs) that the bf16 backward
// (attention_tc_bwd.cuh) repeats bit for bit and the f32 backward
// (attention_tf32_bwd.cuh) shares between its two kernels.  The f32 routes
// of rows 1, 11 and 12 build on these in 3xTF32 (attention_tf32.cuh).
//
// Replaces, for bfloat16 inputs: haconvdr_tpu/ops/fused_attention.py:30
// _attn_kernel (inference attention, through csrc/fused_attention.cu) and
// haconvdr_tpu/ops/flash_attention.py:105 _fwd_kernel (the trained tower's
// forward with hashed dropout, through csrc/flash_attention.cu).  Per batch
// row b and head h, with Q, K, V the column slices [h*d, H + h*d, 2H + h*d]
// of qkv [B, L, 3H] and bias = (1 - mask) * -1e9:
//   S  = Q K^T * scale + bias    f32
//   P  = softmax(S)              f32, normalised
//   Pt = keep ? P / (1 - rate) : 0        (flash only)
//   O  = bf16(Pt) V              f32 accumulation, written as bf16
//
// What bounds it on the H100: per (b, h) at L 512, d 64 the two products
// are 2 * 2 * L^2 * d = 67 MFLOP against 4 * L * d * 2 bytes of qkv and
// output, so the bf16 tensor-core rate (989 TFLOP/s) and the memory rate
// (3.35 TB/s) give bounds of the same order, and both sit far below the
// per-element work around the products: an IEEE expf per score in each
// pass, a correctly rounded division per probability and, for the flash
// forward, two murmur3 fmix32 rounds per element.  Those run on the CUDA
// cores and are what a block spends most of its time on once the products
// are on the tensor cores.  So the division is div_rn's branch-free
// sequence (the compiled IEEE division wraps each quotient in a slow-path
// branch, which keeps the element-wise work from overlapping), and each
// thread's registers are capped for four blocks an SM.
//
// Design:
// - one block per (64-query tile, head, batch row), four warps of 16 query
//   rows; products are mma.sync m16n8k16 bf16 -> f32.  Q, K and V tiles
//   come straight from qkv's rows by 16-byte cp.async (a head's 64 values
//   are 128 contiguous bytes) into padded shared rows (144 bytes: ldmatrix
//   is free of bank conflicts), 64-key K and V tiles double-buffered; Q is
//   held in registers as A fragments, K is read with ldmatrix, V with
//   ldmatrix.trans.  ~48 KB of shared memory a block.
// - two passes over the key tiles.  Pass 1 forms the scores and keeps each
//   row's running max and sum.  Pass 2 forms the same scores again, then
//   P = probs() (expf(s - m) / l, the quotient through div_rn), applies the
//   dropout keep mask at each element's own (row, column), rounds to bf16
//   and multiplies by V, with the C fragments of the scores repacked as the
//   A operand of P V (the two share a layout).  The reference normalises
//   (and drops) P in f32 before it rounds it to bf16; a one-pass online
//   softmax would round the unnormalised exp(s - m_running) and rescale O
//   at the end, which is another function.  The second pass is the price
//   of the reference's function: 1.5x the products of one pass.
// - each score is one routine (qk_dots): Q as the A operand, K as B, the
//   four k-steps of the head dim in order from a zero accumulator, then
//   score() with its multiply and add rounded on their own, then probs().
//   The flash backward (attention_tc_bwd.cuh) forms its probabilities
//   through the same three routines from the saved row (max, sum), so its
//   P equals the forward's bit for bit.  The tensor cores sum the exact
//   bf16 products in their own order, so a score differs from a CUDA-core
//   fmaf chain's by a few f32 ulps, far inside the bf16 tolerances.
// - key tiles whose 64 mask entries are all 0 are skipped in both passes
//   when the batch row has a valid key (key_tiles).  That is exact: the row
//   max then comes from a valid key, so a masked score s = dot * scale - 1e9
//   gives expf(s - m) = 0.0f, which adds exactly 0 to the sum and to O.
//   Where a row has no valid key at all nothing is skipped, since the
//   reference's softmax then runs over the masked scores.  Query tiles are
//   never skipped: padded query rows are outputs of the reference too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;     // head dim taken by the attention kernels
constexpr int MAXL = 512;  // longest sequence

// one score: the dot product's f32 sum times the scale, plus the padding
// bias, each rounded on its own (no contraction), identically in all kernels
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// RN(e / l), the IEEE quotient, without the division's slow-path branch,
// for l >= 1, y = RN(1 / l) and e = 0 or 2^-64 <= e <= 1: q0 = RN(e y) is
// within 1.5 ulp of e / l, one correction q1 = RN(q0 + r0 y), r0 = e - l q0,
// brings it within one ulp, and then r1 = e - l q1 is exact and
// RN(q1 + r1 y) is the correctly rounded quotient (Markstein's theorem:
// y within half an ulp of 1 / l, q1 within one ulp of e / l, no underflow,
// which e >= 2^-64 and l <= 2^9 keep far off).  So div_rn(e, l, y) equals
// e / l bit for bit wherever it is called.
constexpr float kDivMin = 0x1p-64f;
__device__ __forceinline__ float div_rn(float e, float l, float y) {
  const float q0 = __fmul_rn(e, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-l, q0, e), y, q0);
  return __fmaf_rn(__fmaf_rn(-l, q1, e), y, q1);
}

__device__ __forceinline__ float mask_bias(const int* mask, int b, int L, int j) {
  return (1.0f - (float)mask[(size_t)b * L + j]) * -1e9f;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// attention-probs dropout of one (b, h) tile (JAX _seed_for / _keep_mask)
struct Drop {
  int on;
  uint32_t s0, s1, thresh;
  float inv;

  __device__ Drop(int on_, int seed0, int seed1, unsigned thresh_, float inv_, int bh)
      : on(on_), thresh(thresh_), inv(inv_) {
    const uint32_t idx = (uint32_t)bh;  // (row0 + b) * num_heads + h: b's row in the whole batch
    s0 = (uint32_t)seed0 + idx * 0x9E3779B9u;
    s1 = (uint32_t)seed1 ^ ((idx + 1u) * 0x85EBCA6Bu);
  }
  __device__ __forceinline__ bool keep(int r, int c, int L) const {
    uint32_t h = fmix32((uint32_t)(r * L + c) ^ s0);
    return fmix32(h ^ s1) < thresh;
  }
  // Pt or dP from P or dPt: where(keep, x / (1 - rate), 0)
  __device__ __forceinline__ float apply(float x, int r, int c, int L) const {
    if (!on) return x;
    return keep(r, c, L) ? __fmul_rn(x, inv) : 0.0f;
  }
  // apply() in two halves, so that one hash serves Pt and dP of an element:
  // apply(x) == (kept(r, c, L) ? scaled(x) : 0)
  __device__ __forceinline__ bool kept(int r, int c, int L) const { return !on || keep(r, c, L); }
  __device__ __forceinline__ float scaled(float x) const { return on ? __fmul_rn(x, inv) : x; }
};

// ---------------------------------------------------------------------------
// tensor-core primitives (sm_80+ instructions, built for sm_90a)
// ---------------------------------------------------------------------------

constexpr int TC_LD = HD + 8;  // bf16 per shared row: 144 bytes, 16-byte aligned

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragments of 16 query rows x the whole head dim (4 k-steps) from a
// [row][d] bf16 tile with row stride TC_LD, starting at row r0
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[4][4], const __nv_bfloat16* tile,
                                             int r0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(qa[ks], tile + (r0 + r + (mi & 1) * 8) * TC_LD + ks * 16 + (mi >> 1) * 8);
}

// The dot products of the score routine: 16 query rows (A fragments qa)
// against N groups of 8 keys, rows key0 + 8n .. +7 of a [key][d] bf16 tile
// (row stride TC_LD).  Each element is the four k-steps of the head dim in
// order from a zero accumulator, whatever N is (each k-step goes to all N
// groups in turn, which keeps the tensor cores busy).  c[n] is an m16n8 C
// fragment: c[n][0], c[n][1] at row lane/4, keys 2 (lane%4) and +1;
// c[n][2], c[n][3] at row lane/4 + 8.  Every kernel that forms bf16 scores
// goes through this routine, so equal inputs give equal dots.
template <int N>
__device__ __forceinline__ void qk_dots(const uint32_t (&qa)[4][4], const __nv_bfloat16* ktile,
                                        int key0, int lane, float (&c)[N][4]) {
  const __nv_bfloat16* row = ktile + (key0 + (lane & 7)) * TC_LD + (lane >> 3) * 8;
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // d 0..31 (k-steps 0, 1), then 32..63 (2, 3)
    uint32_t b[N][4];
#pragma unroll
    for (int n = 0; n < N; ++n) ldsm_x4(b[n], row + n * 8 * TC_LD + half * 32);
#pragma unroll
    for (int n = 0; n < N; ++n) mma16816(c[n], qa[2 * half], b[n][0], b[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma16816(c[n], qa[2 * half + 1], b[n][2], b[n][3]);
  }
}

// rows row0..row0+n-1 of one head's 64 columns (col0) of a matrix with row
// stride rs into a [n][LD] tile by 16-byte cp.async (no registers, no
// branch), zero-filled past L; the caller commits, waits and syncs
template <int NTHREADS, int LD = TC_LD, typename T>
__device__ __forceinline__ void copy_rows(T* tile, const T* base, size_t rs, int row0, int n,
                                          int col0, int L, int tid) {
  constexpr int CPR = HD * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int EPC = 16 / (int)sizeof(T);       // elements a chunk
#pragma unroll
  for (int i = 0; i < (n * CPR + NTHREADS - 1) / NTHREADS; ++i) {
    const int c = tid + i * NTHREADS;
    if (n * CPR % NTHREADS != 0 && c >= n * CPR) break;
    const int r = c / CPR, k = (c % CPR) * EPC;
    const bool ok = row0 + r < L;
    cp_async16(tile + r * LD + k, base + (ok ? (size_t)(row0 + r) * rs : 0) + col0 + k, ok);
  }
}

constexpr int TC_BM = 64;   // query rows per block
constexpr int TC_BN = 64;   // keys per tile
constexpr int TC_NT = 128;  // four warps
constexpr int TC_MAXT = MAXL / TC_BN;

// The padding bias of row b's keys, bias[n_kt * 64] (-inf past L, so a key
// past L scores -inf and adds 0), and the row's active 64-key tiles in
// order: those with a valid key, or all of them where the row has none;
// their count at tiles[TC_MAXT].  The caller syncs before reading either.
template <int NTHREADS>
__device__ __forceinline__ void key_tiles(const int* mask, int b, int L, float* bias, int* tiles,
                                          int tid) {
  const int n_kt = (L + TC_BN - 1) / TC_BN;
  const int* mrow = mask + (size_t)b * L;
  for (int j = tid; j < n_kt * TC_BN; j += NTHREADS)
    bias[j] = j < L ? mask_bias(mask, b, L, j) : -INFINITY;
  if (tid < 32) {
    const int lane = tid;
    int n = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int j0 = kt * TC_BN + lane, j1 = j0 + 32;
      const bool v = (j0 < L && mrow[j0] != 0) || (j1 < L && mrow[j1] != 0);
      if (__any_sync(0xffffffffu, v)) {
        if (lane == 0) tiles[n] = kt;
        ++n;
      }
    }
    if (n == 0) {
      for (int kt = lane; kt < n_kt; kt += 32) tiles[kt] = kt;
      n = n_kt;
    }
    if (lane == 0) tiles[TC_MAXT] = n;
  }
}

// s[n][e] = score(dot, scale, bias) for the C fragments of 8N keys starting
// at key tile offset kbias (bias in shared memory, see key_tiles)
template <int N>
__device__ __forceinline__ void add_bias(float (&s)[N][4], const float* kbias, float scale,
                                         int t) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    const float2 kb = *reinterpret_cast<const float2*>(kbias + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = score(s[nt][e], scale, e & 1 ? kb.y : kb.x);
  }
}

// P = expf(s - m) / l in place on C fragments (rows g and g + 8 take m[0],
// l[0], y[0] and m[1], l[1], y[1]; y = RN(1 / l)): the quotient through
// div_rn, unless a lane of the warp holds an e below its range (a score
// more than 44 below its row's max), where the warp takes the IEEE
// division.  Either way each element is RN(expf(s - m) / l), the same bits
// in every kernel that calls this.
template <int N>
__device__ __forceinline__ void probs(float (&s)[N][4], const float (&m)[2], const float (&l)[2],
                                      const float (&y)[2]) {
  bool tiny = false;
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(s[nt][e] - m[e >> 1]);
      s[nt][e] = x;
      tiny |= x != 0.0f && x < kDivMin;
    }
  if (__any_sync(0xffffffffu, tiny)) {
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] / l[e >> 1];
  } else {
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = div_rn(s[nt][e], l[e >> 1], y[e >> 1]);
  }
}

// the B fragments of a [k][n] bf16 tile (row stride TC_LD) for k rows
// ks*16 .. +15, read with ldmatrix.trans: c[dn] += a b over the tile's 64
// columns (the forward's P V, the backward's dS K, Pt^T dO and dS^T Q)
__device__ __forceinline__ void mma_kn_tile(float (&c)[8][4], const uint32_t (&a)[4],
                                            const __nv_bfloat16* tile, int ks, int lane) {
  const __nv_bfloat16* row =
      tile + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * TC_LD + (lane >> 4) * 8;
#pragma unroll
  for (int dn = 0; dn < 8; dn += 2) {
    uint32_t vb[4];
    ldsm_x4_t(vb, row + dn * 8);
    mma16816(c[dn], a, vb[0], vb[1]);
    mma16816(c[dn + 1], a, vb[2], vb[3]);
  }
}

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

size_t tc_fwd_smem(int L) {
  return sizeof(__nv_bfloat16) * 5 * TC_BM * TC_LD +
         sizeof(float) * ((L + TC_BN - 1) / TC_BN) * TC_BN + sizeof(int) * (TC_MAXT + 1);
}

// kFlash: the trained tower's forward (dropout through dr, row stats
// written); otherwise the inference forward (no dropout, no stats)
template <bool kFlash>
__global__ void __launch_bounds__(TC_NT, 4) tc_attention_fwd(
    const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, float2* __restrict__ stats, int L, int H, int nh,
    float scale, int drop_on, int seed0, int seed1, unsigned thresh, float inv, int row0) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [64][TC_LD]
  __nv_bfloat16* Ks = Qs + TC_BM * TC_LD;                        // [2][64][TC_LD]
  __nv_bfloat16* Vs = Ks + 2 * TC_BN * TC_LD;                    // [2][64][TC_LD]
  // [n_kt * 64]: -inf past L, so a key past L scores -inf and adds 0
  float* bias = reinterpret_cast<float*>(Vs + 2 * TC_BN * TC_LD);
  const int n_kt = (L + TC_BN - 1) / TC_BN;
  int* tiles = reinterpret_cast<int*>(bias + n_kt * TC_BN);  // active key tiles, count last

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TC_BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = 3 * (size_t)H;
  const __nv_bfloat16* base = qkv + (size_t)b * L * rs;
  const Drop dr(kFlash ? drop_on : 0, seed0, seed1, thresh, inv, (row0 + b) * nh + h);

  copy_rows<TC_NT>(Qs, base, rs, q0, TC_BM, h * HD, L, tid);
  cp_async_commit();
  key_tiles<TC_NT>(mask, b, L, bias, tiles, tid);
  __syncthreads();
  const int n_act = tiles[TC_MAXT];
  const int n_steps = 2 * n_act;  // pass 1 over the active tiles, then pass 2

  auto load_step = [&](int step) {
    const int kt = tiles[step < n_act ? step : step - n_act], buf = step & 1;
    copy_rows<TC_NT>(Ks + buf * TC_BN * TC_LD, base, rs, kt * TC_BN, TC_BN, H + h * HD, L, tid);
    if (step >= n_act)
      copy_rows<TC_NT>(Vs + buf * TC_BN * TC_LD, base, rs, kt * TC_BN, TC_BN, 2 * H + h * HD, L,
                       tid);
  };
  load_step(0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's Q chunks
  __syncthreads();
  uint32_t qa[4][4];
  load_q_frags(qa, Qs, warp * 16, lane);

  // rows g and g + 8 of the warp's 16: running max, then the sum (each
  // lane holds a partial sum over its columns until pass 1 ends)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, y[2] = {};
  float o[8][4] = {};
  const int qr0 = q0 + warp * 16 + g;

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) load_step(step + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bool pass2 = step >= n_act;
    const int kt = tiles[pass2 ? step - n_act : step], buf = step & 1;
    const __nv_bfloat16* Kt = Ks + buf * TC_BN * TC_LD;
    float s[8][4];
    qk_dots<8>(qa, Kt, 0, lane, s);
    add_bias<8>(s, bias + kt * TC_BN, scale, t);
    if (!pass2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tm = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) tm = fmaxf(tm, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
        const float mn = fmaxf(m[i], tm);
        float sum = l[i] * expf(m[i] - mn);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          sum += expf(s[nt][2 * i] - mn);
          sum += expf(s[nt][2 * i + 1] - mn);
        }
        m[i] = mn;
        l[i] = sum;
      }
      if (step + 1 == n_act) {  // whole rows: reduce the sums over the 4 lanes of a row
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
          y[i] = __frcp_rn(l[i]);  // l >= 1: the max key adds expf(0) = 1
        }
      }
    } else {
      probs<8>(s, m, l, y);
      const __nv_bfloat16* Vt = Vs + buf * TC_BN * TC_LD;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // keys ks*16 .. ks*16 + 15 of the tile
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * ks + half;
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = s[nt][e];
            if (kFlash)
              p[e] = dr.apply(p[e], qr0 + 8 * (e >> 1), kt * TC_BN + nt * 8 + 2 * t + (e & 1), L);
          }
          pa[2 * half] = pack_bf16(p[0], p[1]);
          pa[2 * half + 1] = pack_bf16(p[2], p[3]);
        }
        mma_kn_tile(o, pa, Vt, ks, lane);
      }
    }
    __syncthreads();  // the buffer of this step is free for step + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qr0 + 8 * i;
    if (qr >= L) continue;
    __nv_bfloat16* orow = out + ((size_t)b * L + qr) * H + h * HD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8) =
          __floats2bfloat162_rn(o[dn][2 * i], o[dn][2 * i + 1]);
    if (kFlash && t == 0) stats[((size_t)b * nh + h) * L + qr] = make_float2(m[i], l[i]);
  }
}

// the forward for bf16 qkv [B, L, 3H] (head dim 64, L <= 512); stats
// (float2 [B, nh, L]) is written only by the flash instantiation
template <bool kFlash>
cudaError_t launch_tc_fwd(const void* qkv, const void* mask, void* out, void* stats, int B,
                          int L, int H, int nh, int drop_on, int seed0, int seed1,
                          unsigned thresh, float inv, int row0, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0) return cudaErrorInvalidValue;
  const size_t smem = tc_fwd_smem(L);
  cudaError_t err = cudaFuncSetAttribute(tc_attention_fwd<kFlash>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + TC_BM - 1) / TC_BM, nh, B);
  tc_attention_fwd<kFlash><<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float2*>(stats), L, H, nh,
      1.0f / sqrtf((float)HD), drop_on, seed0, seed1, thresh, inv, row0);
  return cudaGetLastError();
}

}  // namespace
