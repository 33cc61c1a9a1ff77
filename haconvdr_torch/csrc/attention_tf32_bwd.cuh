// f32 flash-attention backward on the tensor cores in 3xTF32.
//
// Replaces, for float32 inputs: haconvdr_tpu/ops/flash_attention.py:174
// _bwd_kernel (through csrc/flash_attention.cu, hc_flash_bwd dtype 0).  Per
// batch row b and head h, with Q, K, V the column slices of qkv [B, L, 3H],
// dO the head's slice of the output cotangent [B, L, H], P the forward's
// probabilities and Pt = keep ? P / (1 - rate) : 0 its dropped copy:
//   dV  = Pt^T dO
//   dPt = dO V^T
//   dP  = keep ? dPt / (1 - rate) : 0
//   D   = rowsum(dP * P)
//   dS  = P (dP - D)
//   dQ  = dS K * scale,  dK = dS^T Q * scale
// every value f32 (the reference's casts to the operand dtype are no-ops
// here).  All five products run as 3xTF32 products on mma.sync m16n8k8
// (attention_tf32.cuh's split: each operand x = big + small, three TF32
// products a term, ~2^-21 relative), which keeps the route within 1e-5 of
// the twin where one-term TF32 would not (tests/test_torch_flash_attention.py
// emulates both in numpy).
//
// What bounds it on the H100: at the reference geometry (B 64, L 512, 12
// heads, d 64) the five products are ~129 GFLOP, three TF32 products each
// at 495 TFLOP/s (~0.78 ms), against ~0.7 GB of qkv, dO, the row stats and
// dqkv (~0.21 ms at 3.35 TB/s): bound by operations.  As in the bf16
// backward, D must be whole before any dS, so the kernels form S and dPt
// three times and run nine products over L x L instead of five (29 TF32
// products: dK and dV take four each, see tile_kq), and each probability
// is rebuilt three times (expf, the division, two murmur3 rounds of the
// hash).  On top of mma.sync's dispatch rate come the splits: three ALU
// operations for each operand element at each use (Q, dO, K and V are
// split where they are read, not held split).
//
// Design: two launches on one stream, each output element with one writer
// (no atomics: the run is deterministic), tiles copied raw by 16-byte
// cp.async into padded shared rows (copy_rows; a qkv, dout or dqkv that is
// not 16-byte aligned is refused).
// - tf32_bwd_dq, one block per (64-query tile, head, batch row), four
//   warps, two blocks an SM (~113 KB of shared memory: Q, dO, two K and two
//   V tiles of 64 x 72 floats): 64-key K and V tiles stream through two
//   cp.async buffers, over the row's active key tiles twice.  Pass 1 forms
//   S through the forward's score routine (tf32_dots: Q as A, K as B, the
//   forward's split and k order), then score() and probs() from the saved
//   row (max, sum),
//   and dPt through the same routine (dO as A, V as B), and sums D =
//   rowsum(dP * P) in f32; D is written out for the second kernel.  Pass 2
//   forms P and dP again, dS = P (dP - D), splits dS's C fragments as the A
//   operand (as the forward does with P) and accumulates dQ += dS K.  Q and
//   dO stay in shared memory and are split at each use: held split they
//   would take 128 registers a thread beside the dQ, S and dPt accumulators.
//   K's rows of 72 floats keep the score product's float2 loads free of bank
//   conflicts; dQ's scalar loads of K (rows 2t, 2t + 1) meet two-way ones.
// - tf32_bwd_dkdv, one block per (64-key tile, head, batch row), eight
//   warps, two blocks an SM (~94 KB: K and V of the block's keys, two
//   buffers of 32-query Q and dO tiles, the Pt and dS tiles): each warp
//   forms S and dPt for 16 queries against 16 of the block's keys through
//   the same routine (so P and dPt are the dQ kernel's bit for bit: an
//   element depends only on its row, its key and the routine's order),
//   writes Pt and dS as f32 [query][key] tiles, and each warp reads 16 keys
//   back as the A operand of dV += Pt^T dO and dK += dS^T Q over 32 head
//   dims, with the query index as the k-step in natural order (slot t
//   query t, slot t + 4 query t + 4): rows of 72 floats keep those 32-bit
//   loads, and the B loads of dO and Q, free of bank conflicts.  The
//   swapped product K Q^T would give keys as rows directly, but it would
//   round otherwise than Q K^T; the round trip keeps P the dQ kernel's.
//   dK and dV sum over all L queries, and a key with few valid rows makes
//   them large (one valid key: dV is the sum of L rows of dO), so their
//   running sums are doubles fed with each tile's f32 sum, B is split in
//   three tf32 terms there, and dV sums keep * P (scaled by 1 / (1 - rate)
//   once, at the end): see tile_kq.
// - skipping, as in the bf16 backward: an all-masked 64-key tile of a row
//   that has a valid key has P = 0.0f exactly, so tf32_bwd_dq skips it in
//   both passes and tf32_bwd_dkdv writes zeros for its dK and dV and
//   returns.  Query tiles are never skipped: padded queries carry a
//   cotangent.

#pragma once

#include "attention_tc_bwd.cuh"
#include "attention_tf32.cuh"

namespace {

constexpr int F_BQ = 32;  // query rows of the dK/dV kernel's streamed Q / dO tiles
constexpr int F_NT = 256;  // threads of the dK/dV kernel: eight warps

size_t tf32_bwd_dq_smem(int L) {  // Q, dO, two K and two V tiles, bias, tile list
  return sizeof(float) * ((size_t)6 * TC_BN * F_LDK + ((L + TC_BN - 1) / TC_BN) * TC_BN) +
         sizeof(int) * (TC_MAXT + 1);
}

size_t tf32_bwd_dkdv_smem(int L) {  // K, V, two Q and two dO tiles, Pt, dS, bias, tile list
  return sizeof(float) * ((size_t)(2 * TC_BN + 6 * F_BQ) * F_LDK +
                          ((L + TC_BN - 1) / TC_BN) * TC_BN) +
         sizeof(int) * (TC_MAXT + 1);
}

// acc += c with f32 adds rounded to nearest.  An mma.sync's f32
// accumulation is not such an add (the tensor cores align and cut the
// addends), and a chain of hundreds of them drifted: dV ended 3.1e-5 off
// the twin on an H100 at a 9-key row of B 8, L 512 data when it accumulated
// all 512 queries in the tensor cores.  So the dQ kernel sums each key
// tile's product from zero (24 mma.sync) and adds it to dQ here.
__device__ __forceinline__ void add_tile(float (&acc)[8][4], const float (&c)[8][4]) {
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = __fadd_rn(acc[dn][e], c[dn][e]);
}

// c += a b as mma3xtf32 does, summed from zero and added to c rounded to
// nearest, with b split in three tf32 terms (big + small + rest, exactly b)
// and a fourth product big(a) * rest(b): a two-term split leaves up to
// 2^-22 of each b behind, and dV sums L of them
__device__ __forceinline__ void mma4xtf32_rn(float (&c)[4], const uint32_t (&ab)[4],
                                             const uint32_t (&as)[4], float b0, float b1) {
  uint32_t b0b, b0s, b1b, b1s;
  split_tf32(b0, b0b, b0s);
  split_tf32(b1, b1b, b1s);
  const uint32_t b0r = tf32_rna(b0 - __uint_as_float(b0b) - __uint_as_float(b0s));
  const uint32_t b1r = tf32_rna(b1 - __uint_as_float(b1b) - __uint_as_float(b1s));
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma1688(d, ab, b0r, b1r);
  mma1688(d, as, b0b, b1b);
  mma1688(d, ab, b0s, b1s);
  mma1688(d, ab, b0b, b1b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], d[i]);
}

// acc += A^T X for the 16 keys k0 .. k0 + 15 against 32 columns of X: A a
// [query][key] f32 tile of F_BQ queries (keep * P or dS), X a [query][d]
// tile (dO or Q) from its first column, the query index the k-step in
// natural order (slot t query 8 ks + t, slot t + 4 query 8 ks + t + 4): A's
// 32-bit loads (rows of 72 floats) and X's are free of bank conflicts.
// dK and dV sum over all L queries, and a key with few valid rows makes
// them large (one valid key: dV is the sum of L rows of dO, |dV| up to ~80
// at L 512), where the route's 1e-5 is about one f32 ulp.  So each
// k-step's products are summed from zero (mma4xtf32_rn), each tile's sum
// is an f32 sum of four k-steps, and the running sum over the tiles is a
// double.
__device__ __forceinline__ void tile_kq(double (&acc)[4][4], const float* A, const float* X,
                                        int k0, int g, int t) {
  float c[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < F_BQ / 8; ++ks) {
    const int a0 = (ks * 8 + t) * F_LDK + k0 + g, x0 = (ks * 8 + t) * F_LDK + g;
    uint32_t ab[4], as[4];
    split_tf32(A[a0], ab[0], as[0]);
    split_tf32(A[a0 + 8], ab[1], as[1]);
    split_tf32(A[a0 + 4 * F_LDK], ab[2], as[2]);
    split_tf32(A[a0 + 4 * F_LDK + 8], ab[3], as[3]);
#pragma unroll
    for (int dn = 0; dn < 4; ++dn)
      mma4xtf32_rn(c[dn], ab, as, X[x0 + dn * 8], X[x0 + 4 * F_LDK + dn * 8]);
  }
#pragma unroll
  for (int dn = 0; dn < 4; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] += (double)c[dn][e];
}

// dQ and D per 64-query tile (see the head note)
__global__ void __launch_bounds__(TC_NT, 2) tf32_bwd_dq(
    const float* __restrict__ qkv, const int* __restrict__ mask, const float* __restrict__ dout,
    const float2* __restrict__ stats, float* __restrict__ dvec, float* __restrict__ dqkv, int L,
    int H, int nh, float scale, int drop_on, int seed0, int seed1, unsigned thresh, float inv,
    int row0) {
  extern __shared__ __align__(16) unsigned char f32_smem_raw[];
  float* Qs = reinterpret_cast<float*>(f32_smem_raw);  // [64][F_LDK]
  float* Os = Qs + TC_BM * F_LDK;                     // [64][F_LDK] dO
  float* Ks = Os + TC_BM * F_LDK;                     // [2][64][F_LDK]
  float* Vs = Ks + 2 * TC_BN * F_LDK;                 // [2][64][F_LDK]
  float* bias = Vs + 2 * TC_BN * F_LDK;
  const int n_kt = (L + TC_BN - 1) / TC_BN;
  int* tiles = reinterpret_cast<int*>(bias + n_kt * TC_BN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TC_BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * nh + h;
  const size_t rs = 3 * (size_t)H;
  const float* base = qkv + (size_t)b * L * rs;
  const Drop dr(drop_on, seed0, seed1, thresh, inv, (row0 + b) * nh + h);

  copy_rows<TC_NT, F_LDK>(Qs, base, rs, q0, TC_BM, h * HD, L, tid);
  copy_rows<TC_NT, F_LDK>(Os, dout + (size_t)b * L * H, H, q0, TC_BM, h * HD, L, tid);
  cp_async_commit();
  key_tiles<TC_NT>(mask, b, L, bias, tiles, tid);
  __syncthreads();
  const int n_act = tiles[TC_MAXT];
  const int n_steps = 2 * n_act;  // pass 1 (D), then pass 2 (dQ)

  auto load_step = [&](int step) {
    const int kt = tiles[step < n_act ? step : step - n_act], buf = step & 1;
    copy_rows<TC_NT, F_LDK>(Ks + buf * TC_BN * F_LDK, base, rs, kt * TC_BN, TC_BN, H + h * HD,
                            L, tid);
    copy_rows<TC_NT, F_LDK>(Vs + buf * TC_BN * F_LDK, base, rs, kt * TC_BN, TC_BN,
                            2 * H + h * HD, L, tid);
  };
  load_step(0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's Q and dO chunks
  __syncthreads();
  auto q_frags = [&](int ks, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    split_a_rows(Qs, warp * 16, ks, g, t, ab, as);
  };
  auto o_frags = [&](int ks, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    split_a_rows(Os, warp * 16, ks, g, t, ab, as);
  };

  const int qr0 = q0 + warp * 16 + g;
  float m[2], l[2], y[2];
  row_stats(stats + (size_t)bh * L, qr0, L, m, l, y);
  float D[2] = {0.0f, 0.0f};  // per-lane partial sums until pass 1 ends
  float dq[8][4] = {};

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) load_step(step + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bool pass2 = step >= n_act;
    const int kt = tiles[pass2 ? step - n_act : step], buf = step & 1;
    const float* Kt = Ks + buf * TC_BN * F_LDK;
    float p[8][4], dp[8][4];
    tf32_dots<8>(q_frags, Kt, g, t, p);
    add_bias<8>(p, bias + kt * TC_BN, scale, t);
    probs<8>(p, m, l, y);
    tf32_dots<8>(o_frags, Vs + buf * TC_BN * F_LDK, g, t, dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = dr.apply(dp[nt][e], qr0 + 8 * (e >> 1), kt * TC_BN + nt * 8 + 2 * t + (e & 1),
                             L);
    if (!pass2) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) D[e >> 1] = fmaf(dp[nt][e], p[nt][e], D[e >> 1]);
      if (step + 1 == n_act) {  // whole rows: reduce over the 4 lanes of a row
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          D[i] += __shfl_xor_sync(0xffffffffu, D[i], 1);
          D[i] += __shfl_xor_sync(0xffffffffu, D[i], 2);
        }
      }
    } else {  // this tile's dS K from zero, then one rounded add into dq
      float c[8][4] = {};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {  // keys 8 nt + 2t, + 1 of the tile
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[e] = __fmul_rn(p[nt][e], __fsub_rn(dp[nt][e], D[e >> 1]));
        uint32_t ab[4], as[4];
        split_c_as_a(ds, ab, as);
        mma_kn_tf32<F_LDK>(c, ab, as, Kt, nt * 8, g, t);
      }
      add_tile(dq, c);
    }
    __syncthreads();  // the buffer of this step is free for step + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qr0 + 8 * i;
    if (qr >= L) continue;
    float* row = dqkv + ((size_t)b * L + qr) * rs + h * HD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<float2*>(row + dn * 8) =
          make_float2(dq[dn][2 * i] * scale, dq[dn][2 * i + 1] * scale);
    if (t == 0) dvec[(size_t)bh * L + qr] = D[i];
  }
}

// dK and dV per 64-key tile (see the head note)
__global__ void __launch_bounds__(F_NT, 2) tf32_bwd_dkdv(
    const float* __restrict__ qkv, const int* __restrict__ mask, const float* __restrict__ dout,
    const float2* __restrict__ stats, const float* __restrict__ dvec, float* __restrict__ dqkv,
    int L, int H, int nh, float scale, int drop_on, int seed0, int seed1, unsigned thresh,
    float inv, int row0) {
  extern __shared__ __align__(16) unsigned char f32_smem_raw[];
  float* Ks = reinterpret_cast<float*>(f32_smem_raw);  // [64][F_LDK] block keys
  float* Vs = Ks + TC_BN * F_LDK;                     // [64][F_LDK]
  float* Qs = Vs + TC_BN * F_LDK;                     // [2][32][F_LDK]
  float* Os = Qs + 2 * F_BQ * F_LDK;                  // [2][32][F_LDK] dO
  float* Pts = Os + 2 * F_BQ * F_LDK;                 // [32 queries][F_LDK] Pt
  float* dSs = Pts + F_BQ * F_LDK;                    // [32 queries][F_LDK] dS
  float* bias = dSs + F_BQ * F_LDK;
  const int n_kt = (L + TC_BN - 1) / TC_BN;
  int* tiles = reinterpret_cast<int*>(bias + n_kt * TC_BN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, k0 = kt * TC_BN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * nh + h;
  const size_t rs = 3 * (size_t)H;
  const float* base = qkv + (size_t)b * L * rs;
  const float* obase = dout + (size_t)b * L * H;
  const Drop dr(drop_on, seed0, seed1, thresh, inv, (row0 + b) * nh + h);

  key_tiles<F_NT>(mask, b, L, bias, tiles, tid);
  __syncthreads();
  bool active = false;
  for (int i = 0; i < tiles[TC_MAXT]; ++i) active |= tiles[i] == kt;
  if (!active) {  // P = 0 on every key of the tile: dK = dV = 0
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = tid; c < TC_BN * 32; c += F_NT) {  // 32 chunks of 4 a row: dK, then dV
      const int r = c >> 5, part = (c >> 4) & 1, k = (c & 15) * 4;
      if (k0 + r < L)
        *reinterpret_cast<float4*>(dqkv + ((size_t)b * L + k0 + r) * rs + (1 + part) * H +
                                   h * HD + k) = zero;
    }
    return;
  }

  copy_rows<F_NT, F_LDK>(Ks, base, rs, k0, TC_BN, H + h * HD, L, tid);
  copy_rows<F_NT, F_LDK>(Vs, base, rs, k0, TC_BN, 2 * H + h * HD, L, tid);
  auto load_tile = [&](int rt) {
    const int buf = rt & 1;
    copy_rows<F_NT, F_LDK>(Qs + buf * F_BQ * F_LDK, base, rs, rt * F_BQ, F_BQ, h * HD, L, tid);
    copy_rows<F_NT, F_LDK>(Os + buf * F_BQ * F_LDK, obase, H, rt * F_BQ, F_BQ, h * HD, L, tid);
  };
  load_tile(0);
  cp_async_commit();

  // S and dPt: warp w takes queries 16 (w & 1) .. + 15 of the tile against
  // keys 16 (w >> 1) .. + 15 of the block.  dV and dK: warp w owns keys
  // 16 (w & 3) .. + 15 and head dims 32 (w >> 2) .. + 31
  const int qw = 16 * (warp & 1), kw = 16 * (warp >> 1);
  const int ko = 16 * (warp & 3), dw = 32 * (warp >> 2);
  const float2* st = stats + (size_t)bh * L;
  const float* dv_row = dvec + (size_t)bh * L;
  double dk[4][4] = {}, dv[4][4] = {};
  const int n_qt = (L + F_BQ - 1) / F_BQ;
  for (int rt = 0; rt < n_qt; ++rt) {
    if (rt + 1 < n_qt) load_tile(rt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = rt & 1;
    const float* Qt = Qs + buf * F_BQ * F_LDK;
    const float* Ot = Os + buf * F_BQ * F_LDK;
    const int qr0 = rt * F_BQ + qw + g;
    float m[2], l[2], y[2], D[2];
    row_stats(st, qr0, L, m, l, y);
#pragma unroll
    for (int i = 0; i < 2; ++i) D[i] = qr0 + 8 * i < L ? dv_row[qr0 + 8 * i] : 0.0f;

    float p[2][4], dp[2][4];
    tf32_dots<2>([&](int ks, uint32_t (&ab)[4], uint32_t (&as)[4]) {
      split_a_rows(Qt, qw, ks, g, t, ab, as);
    }, Ks + kw * F_LDK, g, t, p);
    add_bias<2>(p, bias + k0 + kw, scale, t);
    probs<2>(p, m, l, y);
    tf32_dots<2>([&](int ks, uint32_t (&ab)[4], uint32_t (&as)[4]) {
      split_a_rows(Ot, qw, ks, g, t, ab, as);
    }, Vs + kw * F_LDK, g, t, dp);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float pt[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = qr0 + 8 * (e >> 1), key = k0 + kw + nt * 8 + 2 * t + (e & 1);
        const bool keep = dr.kept(qr, key, L);
        const float dpe = keep ? dr.scaled(dp[nt][e]) : 0.0f;
        pt[e] = keep ? p[nt][e] : 0.0f;  // dV takes the 1 / (1 - rate) at the end
        ds[e] = __fmul_rn(p[nt][e], __fsub_rn(dpe, D[e >> 1]));
        if (qr >= L) pt[e] = ds[e] = 0.0f;
      }
      const int off = (qw + g) * F_LDK + kw + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(Pts + off) = make_float2(pt[0], pt[1]);
      *reinterpret_cast<float2*>(Pts + off + 8 * F_LDK) = make_float2(pt[2], pt[3]);
      *reinterpret_cast<float2*>(dSs + off) = make_float2(ds[0], ds[1]);
      *reinterpret_cast<float2*>(dSs + off + 8 * F_LDK) = make_float2(ds[2], ds[3]);
    }
    __syncthreads();

    tile_kq(dv, Pts, Ot + dw, ko, g, t);  // dV += (keep * P)^T dO
    tile_kq(dk, dSs, Qt + dw, ko, g, t);  // dK += dS^T Q
    __syncthreads();  // Pt, dS and this tile's buffers are free
  }

  const double vscale = dr.on ? (double)dr.inv : 1.0;  // dV = Pt^T dO
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + ko + g + 8 * i;
    if (key >= L) continue;
    float* row = dqkv + ((size_t)b * L + key) * rs + h * HD + dw + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      *reinterpret_cast<float2*>(row + H + dn * 8) =
          make_float2((float)dk[dn][2 * i] * scale, (float)dk[dn][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(row + 2 * H + dn * 8) =
          make_float2((float)(dv[dn][2 * i] * vscale), (float)(dv[dn][2 * i + 1] * vscale));
    }
  }
}

// the backward for f32 qkv [B, L, 3H] and dout [B, L, H] (head dim 64,
// L <= 512): tf32_bwd_dq (dQ, D into dvec [B, nh, L]), then tf32_bwd_dkdv
cudaError_t launch_tf32_bwd(const void* qkv, const void* mask, const void* dout,
                            const void* stats, void* dvec, void* dqkv, int B, int L, int H,
                            int nh, int drop_on, int seed0, int seed1, unsigned thresh, float inv,
                            int row0, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dqkv)) % 16)
    return cudaErrorInvalidValue;  // copy_rows and the zero rows move 16-byte chunks
  const float scale = 1.0f / sqrtf((float)HD);
  const auto* q = static_cast<const float*>(qkv);
  const int* m = static_cast<const int*>(mask);
  const auto* g = static_cast<const float*>(dout);
  const auto* st = static_cast<const float2*>(stats);
  auto* dv = static_cast<float*>(dvec);
  auto* dx = static_cast<float*>(dqkv);
  const dim3 grid((L + TC_BM - 1) / TC_BM, nh, B);
  size_t smem = tf32_bwd_dq_smem(L);
  cudaError_t err =
      cudaFuncSetAttribute(tf32_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tf32_bwd_dq<<<grid, TC_NT, smem, stream>>>(q, m, g, st, dv, dx, L, H, nh, scale, drop_on,
                                             seed0, seed1, thresh, inv, row0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = tf32_bwd_dkdv_smem(L);
  err = cudaFuncSetAttribute(tf32_bwd_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  tf32_bwd_dkdv<<<grid, F_NT, smem, stream>>>(q, m, g, st, dv, dx, L, H, nh, scale, drop_on,
                                               seed0, seed1, thresh, inv, row0);
  return cudaGetLastError();
}

}  // namespace
