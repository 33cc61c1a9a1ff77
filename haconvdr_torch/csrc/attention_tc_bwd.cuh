// Tensor-core flash-attention backward for bf16.
//
// Replaces, for bfloat16 inputs: haconvdr_tpu/ops/flash_attention.py:174
// _bwd_kernel (through csrc/flash_attention.cu, hc_flash_bwd dtype 1).  Per
// batch row b and head h, with Q, K, V the column slices of qkv [B, L, 3H],
// dO the head's slice of the output cotangent [B, L, H], P the forward's
// probabilities and Pt = keep ? P / (1 - rate) : 0 its dropped copy:
//   dV  = round(Pt)^T dO
//   dPt = dO V^T
//   dP  = keep ? dPt / (1 - rate) : 0
//   D   = rowsum(dP * P)                          f32
//   dS  = P (dP - D)
//   dQ  = round(dS) K * scale,  dK = round(dS)^T Q * scale
// where round() is the cast to bf16 and every product sums in f32.  All five
// products (S, dPt, dV, dQ, dK) have bf16 operands, so each is mma.sync
// m16n8k16 bf16 -> f32 on the tensor cores.
//
// What bounds it on the H100: at the reference geometry (B 64, L 512, 12
// heads, d 64) five products of 2 L^2 d per (b, h) are ~129 GFLOP (~0.13 ms
// at 989 TFLOP/s) against ~0.35 GB of qkv, dO, the row stats and dqkv
// (~0.105 ms at 3.35 TB/s).  Both sit well below the work the backward
// repeats because D must be whole before any dS: each probability is
// rebuilt three times (expf, the division, two murmur3 rounds of the
// dropout hash a time, on the CUDA cores), and the products run 9 times
// over L x L instead of 5.  So the element-wise work and mma.sync's dispatch
// rate (not wgmma's) bound it, as they bound the forwards; and with two or
// three blocks of four warps an SM (168-249 registers a thread) little of
// mma.sync's latency hides behind the syncs between a tile's phases.
// Larger tiles on wgmma with warp specialisation are the next step.
//
// Design: two launches on one stream, each output element with one writer
// (no atomics: the run is deterministic), each block four warps of 16 rows
// and 64-row tiles, ~57-76 KB of shared memory a block (no f32 [rows][L]
// panel), operands staged raw by cp.async into padded rows (copy_rows) and
// read by ldmatrix(.trans), as in the forward.
// - tc_bwd_dq, one block per (64-query tile, head, batch row): Q and dO are
//   held in registers as A fragments; 64-key K and V tiles stream through
//   two cp.async buffers, over the row's active key tiles twice.  Pass 1
//   forms S (qk_dots with Q as A and K as B, the forward's routine, then
//   score() and probs() from the saved row (max, sum): P equals the
//   forward's bit for bit) and dPt (the same routine with dO as A and V as
//   B), and sums D = rowsum(dP * P) in f32; D is written out for the second
//   kernel.  Pass 2 forms P and dP again, dS = P (dP - D) rounded to bf16,
//   repacks dS's C fragments as the A operand (as the forward does for P V)
//   and accumulates dQ += dS K with K read by ldmatrix.trans.  D is JAX's
//   D, the sum of dP * P: FlashAttention's rowsum(dO * O) is another
//   function here, because O comes from bf16(Pt) and is rounded to bf16.
// - tc_bwd_dkdv, one block per (64-key tile, head, batch row): K and V of
//   the block's keys stay in shared memory; 64-row Q and dO tiles stream
//   through two cp.async buffers.  Each warp forms S and dPt for its 16
//   queries against the block's 64 keys through the same two routines (so
//   P and dPt are the dQ kernel's bit for bit), then round(Pt) and round(dS)
//   go to shared memory as bf16 [query][key] tiles, and each warp reads the
//   16 keys it owns back with ldmatrix.trans as the A operand of
//   dV += Pt^T dO and dK += dS^T Q.  The swapped product K Q^T would give
//   keys as rows directly, but nothing guarantees that the tensor cores
//   round it as they round Q K^T; the round trip through shared memory (2 x
//   9 KB) keeps P the forward's.
// - skipping: an all-masked 64-key tile of a row that has a valid key has
//   P = 0.0f exactly (attention_tc.cuh), so dS = 0 there and D gets nothing
//   from it: tc_bwd_dq skips it in both passes, and tc_bwd_dkdv writes
//   zeros for its dK and dV and returns.  Query tiles are never skipped:
//   padded queries carry a cotangent.

#pragma once

#include "attention_tc.cuh"

namespace {

size_t tc_bwd_dq_smem(int L) {  // Q, dO, two K and two V tiles, bias, tile list
  return sizeof(__nv_bfloat16) * 6 * TC_BN * TC_LD +
         sizeof(float) * ((L + TC_BN - 1) / TC_BN) * TC_BN + sizeof(int) * (TC_MAXT + 1);
}

size_t tc_bwd_dkdv_smem(int L) {  // K, V, two Q and two dO tiles, Pt, dS, bias, tile list
  return sizeof(__nv_bfloat16) * 8 * TC_BN * TC_LD +
         sizeof(float) * ((L + TC_BN - 1) / TC_BN) * TC_BN + sizeof(int) * (TC_MAXT + 1);
}

// the saved (max, sum) of query rows qr and qr + 8, and y = RN(1 / sum);
// a row past L gets (0, 1): its Q and dO rows are zero and its terms are
// zeroed by the caller
__device__ __forceinline__ void row_stats(const float2* st, int qr, int L, float (&m)[2],
                                          float (&l)[2], float (&y)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 v = qr + 8 * i < L ? st[qr + 8 * i] : make_float2(0.0f, 1.0f);
    m[i] = v.x;
    l[i] = v.y;
    y[i] = __frcp_rn(v.y);
  }
}

// dQ and D per 64-query tile (see the head note).  Three blocks an SM cap
// it at 168 registers (a 132-byte spill); two blocks, without the spill,
// were no faster on the H100.
__global__ void __launch_bounds__(TC_NT, 3) tc_bwd_dq(
    const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ mask,
    const __nv_bfloat16* __restrict__ dout, const float2* __restrict__ stats,
    float* __restrict__ dvec, __nv_bfloat16* __restrict__ dqkv, int L, int H, int nh,
    float scale, int drop_on, int seed0, int seed1, unsigned thresh, float inv, int row0) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [64][TC_LD]
  __nv_bfloat16* Os = Qs + TC_BM * TC_LD;                        // [64][TC_LD] dO
  __nv_bfloat16* Ks = Os + TC_BM * TC_LD;                        // [2][64][TC_LD]
  __nv_bfloat16* Vs = Ks + 2 * TC_BN * TC_LD;                    // [2][64][TC_LD]
  float* bias = reinterpret_cast<float*>(Vs + 2 * TC_BN * TC_LD);
  const int n_kt = (L + TC_BN - 1) / TC_BN;
  int* tiles = reinterpret_cast<int*>(bias + n_kt * TC_BN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TC_BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * nh + h;
  const size_t rs = 3 * (size_t)H;
  const __nv_bfloat16* base = qkv + (size_t)b * L * rs;
  const Drop dr(drop_on, seed0, seed1, thresh, inv, (row0 + b) * nh + h);

  copy_rows<TC_NT>(Qs, base, rs, q0, TC_BM, h * HD, L, tid);
  copy_rows<TC_NT>(Os, dout + (size_t)b * L * H, H, q0, TC_BM, h * HD, L, tid);
  cp_async_commit();
  key_tiles<TC_NT>(mask, b, L, bias, tiles, tid);
  __syncthreads();
  const int n_act = tiles[TC_MAXT];
  const int n_steps = 2 * n_act;  // pass 1 (D), then pass 2 (dQ)

  auto load_step = [&](int step) {
    const int kt = tiles[step < n_act ? step : step - n_act], buf = step & 1;
    copy_rows<TC_NT>(Ks + buf * TC_BN * TC_LD, base, rs, kt * TC_BN, TC_BN, H + h * HD, L, tid);
    copy_rows<TC_NT>(Vs + buf * TC_BN * TC_LD, base, rs, kt * TC_BN, TC_BN, 2 * H + h * HD, L,
                     tid);
  };
  load_step(0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's Q and dO chunks
  __syncthreads();
  uint32_t qa[4][4], oa[4][4];
  load_q_frags(qa, Qs, warp * 16, lane);
  load_q_frags(oa, Os, warp * 16, lane);

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
    const __nv_bfloat16* Kt = Ks + buf * TC_BN * TC_LD;
    float p[8][4], dp[8][4];
    qk_dots<8>(qa, Kt, 0, lane, p);
    add_bias<8>(p, bias + kt * TC_BN, scale, t);
    probs<8>(p, m, l, y);
    qk_dots<8>(oa, Vs + buf * TC_BN * TC_LD, 0, lane, dp);
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
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // keys ks*16 .. +15 of the tile
        uint32_t sa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * ks + half;
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d[e] = __fmul_rn(p[nt][e], __fsub_rn(dp[nt][e], D[e >> 1]));
          sa[2 * half] = pack_bf16(d[0], d[1]);
          sa[2 * half + 1] = pack_bf16(d[2], d[3]);
        }
        mma_kn_tile(dq, sa, Kt, ks, lane);
      }
    }
    __syncthreads();  // the buffer of this step is free for step + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qr0 + 8 * i;
    if (qr >= L) continue;
    __nv_bfloat16* row = dqkv + ((size_t)b * L + qr) * rs + h * HD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(row + dn * 8) =
          __floats2bfloat162_rn(dq[dn][2 * i] * scale, dq[dn][2 * i + 1] * scale);
    if (t == 0) dvec[(size_t)bh * L + qr] = D[i];
  }
}

// dK and dV per 64-key tile (see the head note)
__global__ void __launch_bounds__(TC_NT, 2) tc_bwd_dkdv(
    const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ mask,
    const __nv_bfloat16* __restrict__ dout, const float2* __restrict__ stats,
    const float* __restrict__ dvec, __nv_bfloat16* __restrict__ dqkv, int L, int H, int nh,
    float scale, int drop_on, int seed0, int seed1, unsigned thresh, float inv, int row0) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [64][TC_LD] block keys
  __nv_bfloat16* Vs = Ks + TC_BN * TC_LD;                        // [64][TC_LD]
  __nv_bfloat16* Qs = Vs + TC_BN * TC_LD;                        // [2][64][TC_LD]
  __nv_bfloat16* Os = Qs + 2 * TC_BM * TC_LD;                    // [2][64][TC_LD] dO
  __nv_bfloat16* Pts = Os + 2 * TC_BM * TC_LD;                   // [64 queries][TC_LD] bf16(Pt)
  __nv_bfloat16* dSs = Pts + TC_BM * TC_LD;                      // [64 queries][TC_LD] bf16(dS)
  float* bias = reinterpret_cast<float*>(dSs + TC_BM * TC_LD);
  const int n_kt = (L + TC_BN - 1) / TC_BN;
  int* tiles = reinterpret_cast<int*>(bias + n_kt * TC_BN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, k0 = kt * TC_BN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * nh + h;
  const size_t rs = 3 * (size_t)H;
  const __nv_bfloat16* base = qkv + (size_t)b * L * rs;
  const __nv_bfloat16* obase = dout + (size_t)b * L * H;
  const Drop dr(drop_on, seed0, seed1, thresh, inv, (row0 + b) * nh + h);

  key_tiles<TC_NT>(mask, b, L, bias, tiles, tid);
  __syncthreads();
  bool active = false;
  for (int i = 0; i < tiles[TC_MAXT]; ++i) active |= tiles[i] == kt;
  if (!active) {  // P = 0 on every key of the tile: dK = dV = 0
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int c = tid; c < TC_BN * 16; c += TC_NT) {  // 16 chunks of 8 a row: dK, then dV
      const int r = c >> 4, part = (c >> 3) & 1, k = (c & 7) * 8;
      if (k0 + r < L)
        *reinterpret_cast<uint4*>(dqkv + ((size_t)b * L + k0 + r) * rs + (1 + part) * H + h * HD +
                                  k) = zero;
    }
    return;
  }

  copy_rows<TC_NT>(Ks, base, rs, k0, TC_BN, H + h * HD, L, tid);
  copy_rows<TC_NT>(Vs, base, rs, k0, TC_BN, 2 * H + h * HD, L, tid);
  auto load_tile = [&](int rt) {
    const int buf = rt & 1;
    copy_rows<TC_NT>(Qs + buf * TC_BM * TC_LD, base, rs, rt * TC_BM, TC_BM, h * HD, L, tid);
    copy_rows<TC_NT>(Os + buf * TC_BM * TC_LD, obase, H, rt * TC_BM, TC_BM, h * HD, L, tid);
  };
  load_tile(0);
  cp_async_commit();

  const float2* st = stats + (size_t)bh * L;
  const float* dv_row = dvec + (size_t)bh * L;
  float dk[8][4] = {}, dv[8][4] = {};
  const int n_qt = (L + TC_BM - 1) / TC_BM;
  for (int rt = 0; rt < n_qt; ++rt) {
    if (rt + 1 < n_qt) load_tile(rt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = rt & 1;
    const __nv_bfloat16* Qt = Qs + buf * TC_BM * TC_LD;
    const __nv_bfloat16* Ot = Os + buf * TC_BM * TC_LD;
    const int qr0 = rt * TC_BM + warp * 16 + g;
    float m[2], l[2], y[2], D[2];
    row_stats(st, qr0, L, m, l, y);
#pragma unroll
    for (int i = 0; i < 2; ++i) D[i] = qr0 + 8 * i < L ? dv_row[qr0 + 8 * i] : 0.0f;

    // the warp's 16 queries against the block's 64 keys, as in tc_bwd_dq
    float p[8][4], dp[8][4];
    {
      uint32_t qa[4][4];
      load_q_frags(qa, Qt, warp * 16, lane);
      qk_dots<8>(qa, Ks, 0, lane, p);
    }
    add_bias<8>(p, bias + k0, scale, t);
    probs<8>(p, m, l, y);
    {
      uint32_t oa[4][4];
      load_q_frags(oa, Ot, warp * 16, lane);
      qk_dots<8>(oa, Vs, 0, lane, dp);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float pt[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = qr0 + 8 * (e >> 1), key = k0 + nt * 8 + 2 * t + (e & 1);
        const bool keep = dr.kept(qr, key, L);
        const float dpe = keep ? dr.scaled(dp[nt][e]) : 0.0f;
        pt[e] = keep ? dr.scaled(p[nt][e]) : 0.0f;
        ds[e] = __fmul_rn(p[nt][e], __fsub_rn(dpe, D[e >> 1]));
        if (qr >= L) pt[e] = ds[e] = 0.0f;
      }
      const int off = (warp * 16 + g) * TC_LD + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(Pts + off) = pack_bf16(pt[0], pt[1]);
      *reinterpret_cast<uint32_t*>(Pts + off + 8 * TC_LD) = pack_bf16(pt[2], pt[3]);
      *reinterpret_cast<uint32_t*>(dSs + off) = pack_bf16(ds[0], ds[1]);
      *reinterpret_cast<uint32_t*>(dSs + off + 8 * TC_LD) = pack_bf16(ds[2], ds[3]);
    }
    __syncthreads();

    // warp w owns keys 16w .. 16w + 15: A fragments of Pt^T and dS^T (keys
    // as rows) by ldmatrix.trans of the [query][key] tiles
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // queries ks*16 .. +15 of the tile
      const int off = (ks * 16 + (mi >> 1) * 8 + r) * TC_LD + warp * 16 + (mi & 1) * 8;
      uint32_t a[4];
      ldsm_x4_t(a, Pts + off);
      mma_kn_tile(dv, a, Ot, ks, lane);
      ldsm_x4_t(a, dSs + off);
      mma_kn_tile(dk, a, Qt, ks, lane);
    }
    __syncthreads();  // Pt, dS and this tile's buffers are free
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g + 8 * i;
    if (key >= L) continue;
    __nv_bfloat16* row = dqkv + ((size_t)b * L + key) * rs + h * HD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(row + H + dn * 8) =
          __floats2bfloat162_rn(dk[dn][2 * i] * scale, dk[dn][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(row + 2 * H + dn * 8) =
          __floats2bfloat162_rn(dv[dn][2 * i], dv[dn][2 * i + 1]);
    }
  }
}

// the backward for bf16 qkv [B, L, 3H] and dout [B, L, H] (head dim 64,
// L <= 512): tc_bwd_dq (dQ, D into dvec [B, nh, L]), then tc_bwd_dkdv
cudaError_t launch_tc_bwd(const void* qkv, const void* mask, const void* dout, const void* stats,
                          void* dvec, void* dqkv, int B, int L, int H, int nh, int drop_on,
                          int seed0, int seed1, unsigned thresh, float inv, int row0,
                          cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dqkv)) % 16)
    return cudaErrorInvalidValue;  // copy_rows and the zero rows move 16-byte chunks
  const float scale = 1.0f / sqrtf((float)HD);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const int* m = static_cast<const int*>(mask);
  const auto* g = static_cast<const __nv_bfloat16*>(dout);
  const auto* st = static_cast<const float2*>(stats);
  auto* dv = static_cast<float*>(dvec);
  auto* dx = static_cast<__nv_bfloat16*>(dqkv);
  const dim3 grid((L + TC_BM - 1) / TC_BM, nh, B);
  size_t smem = tc_bwd_dq_smem(L);
  cudaError_t err =
      cudaFuncSetAttribute(tc_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tc_bwd_dq<<<grid, TC_NT, smem, stream>>>(q, m, g, st, dv, dx, L, H, nh, scale, drop_on, seed0,
                                           seed1, thresh, inv, row0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = tc_bwd_dkdv_smem(L);
  err = cudaFuncSetAttribute(tc_bwd_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tc_bwd_dkdv<<<grid, TC_NT, smem, stream>>>(q, m, g, st, dv, dx, L, H, nh, scale, drop_on, seed0,
                                             seed1, thresh, inv, row0);
  return cudaGetLastError();
}

}  // namespace
