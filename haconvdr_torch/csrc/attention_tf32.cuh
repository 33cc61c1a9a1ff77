// f32 attention on the tensor cores in 3xTF32: the helpers that every f32
// attention kernel of the port shares, and the one f32 forward of rows 1
// and 11.
//
// Replaces, for float32 inputs: haconvdr_tpu/ops/fused_attention.py:30
// _attn_kernel (inference attention, through csrc/fused_attention.cu) and
// haconvdr_tpu/ops/flash_attention.py:105 _fwd_kernel (the trained tower's
// forward with hashed dropout, through csrc/flash_attention.cu).  Per batch
// row b and head h, with Q, K, V the column slices [h*d, H + h*d, 2H + h*d]
// of qkv [B, L, 3H] and bias = (1 - mask) * -1e9:
//   S  = Q K^T * scale + bias    f32
//   P  = softmax(S)              f32
//   Pt = keep ? P / (1 - rate) : 0        (flash only)
//   O  = Pt V                    f32
// The reference rounds P to V's dtype before P V, which is f32 here: P is
// not rounded, so the bf16 route's reason for two passes (normalise before
// rounding) does not hold.  One pass with an online softmax (a running row
// max m; O and the row sum l rescaled by expf(m_old - m_new) as m grows;
// one division of O by l at the end) differs from the reference's
// exp(s - m) / l then P V only by rounding.  The flash forward applies the
// keep mask to the unnormalised e = expf(s - m) before P V, while l sums the
// undropped e, as the reference's softmax does; it writes each row's final
// (m, l) as float2 [B, nh, L] for the backward (attention_tf32_bwd.cuh).
//
// The split: plain TF32 (495 TFLOP/s on the H100) keeps about 3 decimal
// digits and would break the route's agreement with the twin (1e-4 for row
// 1, 1e-5 for rows 11-12; tests/test_torch_fused_attention.py and
// tests/test_torch_flash_attention.py emulate both in numpy).  So each
// operand is split x = big + small, big = cvt.rna.tf32(x), small =
// cvt.rna.tf32(x - big), and each product is small*big + big*small +
// big*big on mma.sync m16n8k8 tf32 with f32 accumulators: about 2^-21
// relative per product, at the level of an f32 fmaf chain, for three
// tensor-core products.
//
// What bounds it on the H100: per (b, h) at L 512, d 64 the two products
// are 2 * 2 * L^2 * d = 67 MFLOP against 4 * L * d * 4 bytes, so it is
// bound by operations: three TF32 products a product at 495 TFLOP/s (an
// effective 165 TFLOP/s).  With the products on the tensor cores, what is
// left to bound it is mma.sync's dispatch rate, the splits (three ALU
// operations per operand element) and the online softmax's expf per score
// (and, for the flash forward, two murmur3 fmix32 rounds per element).
//
// Design: one block per (64-query tile, head, batch row), four warps of 16
// query rows.  Q (split once, held in registers as A fragments) and
// double-buffered 64-key K and V tiles are copied raw by 16-byte cp.async
// into padded shared rows: K and Q rows of 72 floats (the float2 B loads
// of K are free of bank conflicts), V rows of 68 (its scalar B loads at
// rows 2t, 2t + 1 are too).  ldmatrix moves 16-bit elements only, so the
// tf32 fragments come from 32-bit shared loads.  The d index of the score
// product's k-step and the key index of P V's k-step are permuted (k-slot t
// takes element 2t, slot t + 4 element 2t + 1), which lets a lane read K as
// float2 and reuse its score C fragments (columns 2t, 2t + 1) as P's A
// fragments: a sum's order is the tensor core's own either way.  All-masked
// key tiles are skipped exactly as in the bf16 route (key_tiles).  ~90 KB
// of shared memory a block: two blocks an SM.

#pragma once

#include "attention_tc.cuh"

namespace {

constexpr int F_LDK = HD + 8;  // floats per Q / K (and, in the backward, dO / V) row
constexpr int F_LDV = HD + 4;  // floats per V row of the forward

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += a b for one m16n8k8 tile, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32 (a = ab + as, b = (b0b, b1b) + (b0s, b1s)): the two
// cross terms first, then big * big
__device__ __forceinline__ void mma3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], float b0, float b1) {
  uint32_t b0b, b0s, b1b, b1s;
  split_tf32(b0, b0b, b0s);
  split_tf32(b1, b1b, b1s);
  mma1688(c, as, b0b, b1b);
  mma1688(c, ab, b0s, b1s);
  mma1688(c, ab, b0b, b1b);
}

// The split A fragments of rows row0 .. row0 + 15 of a [row][d] f32 tile
// (row stride F_LDK) for k-step ks of the head dim, in the score product's
// k order: slot t takes d = 8 ks + 2t, slot t + 4 takes 8 ks + 2t + 1
__device__ __forceinline__ void split_a_rows(const float* tile, int row0, int ks, int g, int t,
                                             uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const float* r0 = tile + (row0 + g) * F_LDK + ks * 8 + 2 * t;
  const float2 lo = *reinterpret_cast<const float2*>(r0);
  const float2 hi = *reinterpret_cast<const float2*>(r0 + 8 * F_LDK);
  split_tf32(lo.x, ab[0], as[0]);
  split_tf32(hi.x, ab[1], as[1]);
  split_tf32(lo.y, ab[2], as[2]);
  split_tf32(hi.y, ab[3], as[3]);
}

// The score routine of the f32 route: c[n] = A B^T for 16 rows of A (split
// fragments from get_a(ks, ab, as), k order as in split_a_rows) against the
// 8N rows of a [key][d] f32 tile (row stride F_LDK, starting at ktile), the
// eight k-steps of the head dim in order from a zero accumulator, each a
// 3xTF32 product.  c[n] is an m16n8 C fragment: c[n][0], c[n][1] at row g,
// keys 8n + 2t and + 1; c[n][2], c[n][3] at row g + 8.  An element depends
// only on its row of A, its key and this order, so every kernel that forms
// scores (or dPt = dO V^T) through it gets the same bits for the same
// inputs, whatever N and the tile offset are.
template <int N, typename GetA>
__device__ __forceinline__ void tf32_dots(GetA get_a, const float* ktile, int g, int t,
                                          float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
  const float* krow = ktile + g * F_LDK + 2 * t;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t ab[4], as[4];
    get_a(ks, ab, as);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float2 kv = *reinterpret_cast<const float2*>(krow + n * 8 * F_LDK + ks * 8);
      mma3xtf32(c[n], ab, as, kv.x, kv.y);
    }
  }
}

// The split A fragments of a product P X whose k-step is 8 columns of a C
// fragment c (columns 2t, 2t + 1 at rows g and g + 8): slot t takes column
// 2t, slot t + 4 column 2t + 1
__device__ __forceinline__ void split_c_as_a(const float (&c)[4], uint32_t (&ab)[4],
                                             uint32_t (&as)[4]) {
  split_tf32(c[0], ab[0], as[0]);
  split_tf32(c[2], ab[1], as[1]);
  split_tf32(c[1], ab[2], as[2]);
  split_tf32(c[3], ab[3], as[3]);
}

// o[dn] += A X over X's 64 columns, X a [k][n] f32 tile (row stride LD)
// whose k-step is rows k0 + 2t (slot t) and k0 + 2t + 1 (slot t + 4), as
// split_c_as_a orders them (the forward's P V, the dQ kernel's dS K)
template <int LD>
__device__ __forceinline__ void mma_kn_tf32(float (&o)[8][4], const uint32_t (&ab)[4],
                                            const uint32_t (&as)[4], const float* tile, int k0,
                                            int g, int t) {
  const float* v0 = tile + (k0 + 2 * t) * LD + g;
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) mma3xtf32(o[dn], ab, as, v0[dn * 8], v0[LD + dn * 8]);
}

size_t tf32_fwd_smem(int L) {
  return sizeof(float) * ((size_t)3 * TC_BM * F_LDK + 2 * TC_BN * F_LDV +
                          ((L + TC_BN - 1) / TC_BN) * TC_BN) +
         sizeof(int) * (TC_MAXT + 1);
}

// kFlash: the trained tower's forward (dropout through dr, row stats
// written); otherwise the inference forward (no dropout, no stats)
template <bool kFlash>
__global__ void __launch_bounds__(TC_NT, 2) tf32_attention_fwd(
    const float* __restrict__ qkv, const int* __restrict__ mask, float* __restrict__ out,
    float2* __restrict__ stats, int L, int H, int nh, float scale, int drop_on, int seed0,
    int seed1, unsigned thresh, float inv, int row0) {
  extern __shared__ __align__(16) unsigned char f32_smem_raw[];
  float* Qs = reinterpret_cast<float*>(f32_smem_raw);  // [64][F_LDK]
  float* Ks = Qs + TC_BM * F_LDK;                     // [2][64][F_LDK]
  float* Vs = Ks + 2 * TC_BN * F_LDK;                 // [2][64][F_LDV]
  float* bias = Vs + 2 * TC_BN * F_LDV;               // [n_kt * 64]
  const int n_kt = (L + TC_BN - 1) / TC_BN;
  int* tiles = reinterpret_cast<int*>(bias + n_kt * TC_BN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TC_BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = 3 * (size_t)H;
  const float* base = qkv + (size_t)b * L * rs;
  const Drop dr(kFlash ? drop_on : 0, seed0, seed1, thresh, inv, (row0 + b) * nh + h);

  copy_rows<TC_NT, F_LDK>(Qs, base, rs, q0, TC_BM, h * HD, L, tid);
  cp_async_commit();
  key_tiles<TC_NT>(mask, b, L, bias, tiles, tid);
  __syncthreads();
  const int n_act = tiles[TC_MAXT];
  auto load_tile = [&](int i) {
    const int kt = tiles[i], buf = i & 1;
    copy_rows<TC_NT, F_LDK>(Ks + buf * TC_BN * F_LDK, base, rs, kt * TC_BN, TC_BN, H + h * HD, L,
                            tid);
    copy_rows<TC_NT, F_LDV>(Vs + buf * TC_BN * F_LDV, base, rs, kt * TC_BN, TC_BN,
                            2 * H + h * HD, L, tid);
  };
  load_tile(0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's Q chunks
  __syncthreads();

  // the warp's 16 query rows as split A fragments, once
  uint32_t qb[8][4], qs[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) split_a_rows(Qs, warp * 16, ks, g, t, qb[ks], qs[ks]);
  auto q_frags = [&](int ks, uint32_t (&ab)[4], uint32_t (&as)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ab[i] = qb[ks][i];
      as[i] = qs[ks][i];
    }
  };

  // rows g and g + 8 of the warp's 16: running max and (per-lane) sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[8][4] = {};
  const int qr0 = q0 + warp * 16 + g;
  for (int i = 0; i < n_act; ++i) {
    if (i + 1 < n_act) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kt = tiles[i], buf = i & 1;
    const float* Vt = Vs + buf * TC_BN * F_LDV;

    float s[8][4];
    tf32_dots<8>(q_frags, Ks + buf * TC_BN * F_LDK, g, t, s);
    add_bias<8>(s, bias + kt * TC_BN, scale, t);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) tm = fmaxf(tm, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
      const float mn = fmaxf(m[r], tm);  // finite: key kt * 64 < L scores finite
      const float alpha = expf(m[r] - mn);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * r] = expf(s[nt][2 * r] - mn);
        s[nt][2 * r + 1] = expf(s[nt][2 * r + 1] - mn);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
        o[nt][2 * r] *= alpha;
        o[nt][2 * r + 1] *= alpha;
      }
      l[r] = l[r] * alpha + sum;
      m[r] = mn;
    }

    // O += Pt V: k-step nt takes keys 8 nt + 2t (slots t) and 8 nt + 2t + 1
    // (slots t + 4), which are this lane's C columns of s[nt]; the flash
    // forward drops the unnormalised e here, after l has summed it
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (kFlash) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = dr.apply(s[nt][e], qr0 + 8 * (e >> 1), kt * TC_BN + nt * 8 + 2 * t + (e & 1),
                              L);
      }
      uint32_t pb[4], ps[4];
      split_c_as_a(s[nt], pb, ps);
      mma_kn_tf32<F_LDV>(o, pb, ps, Vt, nt * 8, g, t);
    }
    __syncthreads();  // the buffer of this tile is free for tile i + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qr = qr0 + 8 * r;
    if (qr >= L) continue;
    float* orow = out + ((size_t)b * L + qr) * H + h * HD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<float2*>(orow + dn * 8) =
          make_float2(o[dn][2 * r] / l[r], o[dn][2 * r + 1] / l[r]);
    if (kFlash && t == 0) stats[((size_t)b * nh + h) * L + qr] = make_float2(m[r], l[r]);
  }
}

// the forward for f32 qkv [B, L, 3H] (head dim 64, L <= 512, 16-byte
// aligned for cp.async); stats (float2 [B, nh, L]) is written only by the
// flash instantiation
template <bool kFlash>
cudaError_t launch_tf32_fwd(const void* qkv, const void* mask, void* out, void* stats, int B,
                            int L, int H, int nh, int drop_on, int seed0, int seed1,
                            unsigned thresh, float inv, int row0, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0) return cudaErrorInvalidValue;
  const size_t smem = tf32_fwd_smem(L);
  cudaError_t err = cudaFuncSetAttribute(tf32_attention_fwd<kFlash>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + TC_BM - 1) / TC_BM, nh, B);
  tf32_attention_fwd<kFlash><<<grid, TC_NT, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int*>(mask), static_cast<float*>(out),
      static_cast<float2*>(stats), L, H, nh, 1.0f / sqrtf((float)HD), drop_on, seed0, seed1,
      thresh, inv, row0);
  return cudaGetLastError();
}

}  // namespace
