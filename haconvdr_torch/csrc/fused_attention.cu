// Inference attention straight from the fused QKV projection.
//
// Replaces: haconvdr_tpu/ops/fused_attention.py:30 _attn_kernel (Pallas,
// reached through fused_attention_qkv).  Same math: per batch row and
// head, softmax(Q K^T * scale + bias) V with Q, K, V the column slices
// [h*d, H + h*d, 2H + h*d] of qkv [B, L, 3H]; bias = (1 - mask) * -1e9;
// f32 scores and softmax; P cast to V's dtype before P V; f32 accumulation;
// the context is written as [B, L, H] (no head transposes on either side).
//
// bfloat16: the tensor-core forward of attention_tc.cuh (mma.sync, two
// passes so that P is normalised before it is rounded, all-masked key
// tiles skipped exactly; its head says what bounds it), without dropout
// or row stats.
//
// float32: one pass on the tensor cores in 3xTF32.  The reference computes
// f32 scores, an f32 softmax and P cast to V's dtype, which is f32 here: P
// is not rounded, so the bf16 route's reason for two passes (normalise
// before rounding) does not hold.  An online softmax (a running row max m;
// O and the row sum l rescaled by expf(m_old - m_new) as m grows; one
// division of O by l at the end) differs from the reference's exp(s - m) / l
// then P V only by rounding.
//
// What bounds it on the H100: per (b, h) at L 512, d 64 the two products
// are 2 * 2 * L^2 * d = 67 MFLOP against 4 * L * d * 4 bytes, so it is
// bound by operations.  Plain TF32 (495 TFLOP/s) keeps about 3 decimal
// digits and would break the 1e-4 agreement with the twin, so each
// operand is split x = big + small, big = cvt.rna.tf32(x), small =
// cvt.rna.tf32(x - big), and each product is big*small + small*big +
// big*big on mma.sync m16n8k8 tf32 with f32 accumulators: about 2^-21
// relative per product, at the level of an f32 fmaf chain, for three
// tensor-core products (an effective 165 TFLOP/s; at B 8 with
// chip_smoke.py's ragged lengths about 0.025 ms, against 0.062 ms at the
// CUDA cores' f32 rate of 67 TFLOP/s).  With the products on
// the tensor cores, what is left to bound it is mma.sync's dispatch rate, the
// splits (three ALU operations per operand element) and the online
// softmax's expf per score.
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

#include "attention_tc.cuh"

namespace {

constexpr int F_LDK = HD + 8;  // floats per Q / K row
constexpr int F_LDV = HD + 4;  // floats per V row

size_t f32_smem(int L) {
  return sizeof(float) * ((size_t)3 * TC_BM * F_LDK + 2 * TC_BN * F_LDV +
                          ((L + TC_BN - 1) / TC_BN) * TC_BN) +
         sizeof(int) * (TC_MAXT + 1);
}

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

__global__ void __launch_bounds__(TC_NT, 2) attn_f32_kernel(const float* __restrict__ qkv,
                                                            const int* __restrict__ mask,
                                                            float* __restrict__ out, int L,
                                                            int H, float scale) {
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

  // A fragments of the warp's 16 query rows, split: k-step ks takes d =
  // 8 ks + 2t (slots t) and 8 ks + 2t + 1 (slots t + 4)
  uint32_t qb[8][4], qs[8][4];
  {
    const float* r0 = Qs + (warp * 16 + g) * F_LDK + 2 * t;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const float2 lo = *reinterpret_cast<const float2*>(r0 + ks * 8);
      const float2 hi = *reinterpret_cast<const float2*>(r0 + 8 * F_LDK + ks * 8);
      split_tf32(lo.x, qb[ks][0], qs[ks][0]);
      split_tf32(hi.x, qb[ks][1], qs[ks][1]);
      split_tf32(lo.y, qb[ks][2], qs[ks][2]);
      split_tf32(hi.y, qb[ks][3], qs[ks][3]);
    }
  }

  // rows g and g + 8 of the warp's 16: running max and (per-lane) sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[8][4] = {};
  for (int i = 0; i < n_act; ++i) {
    if (i + 1 < n_act) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kt = tiles[i], buf = i & 1;
    const float* Kt = Ks + buf * TC_BN * F_LDK;
    const float* Vt = Vs + buf * TC_BN * F_LDV;

    float s[8][4] = {};
    const float* krow = Kt + g * F_LDK + 2 * t;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 kv = *reinterpret_cast<const float2*>(krow + nt * 8 * F_LDK + ks * 8);
        mma3xtf32(s[nt], qb[ks], qs[ks], kv.x, kv.y);
      }
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

    // O += P V: k-step nt takes keys 8 nt + 2t (slots t) and 8 nt + 2t + 1
    // (slots t + 4), which are this lane's C columns of s[nt]
    const float* vrow = Vt + 2 * t * F_LDV + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t pb[4], ps[4];
      split_tf32(s[nt][0], pb[0], ps[0]);
      split_tf32(s[nt][2], pb[1], ps[1]);
      split_tf32(s[nt][1], pb[2], ps[2]);
      split_tf32(s[nt][3], pb[3], ps[3]);
      const float* v0 = vrow + nt * 8 * F_LDV;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) mma3xtf32(o[dn], pb, ps, v0[dn * 8], v0[F_LDV + dn * 8]);
    }
    __syncthreads();  // the buffer of this tile is free for tile i + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qr = q0 + warp * 16 + g + 8 * r;
    if (qr >= L) continue;
    float* orow = out + ((size_t)b * L + qr) * H + h * HD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<float2*>(orow + dn * 8) =
          make_float2(o[dn][2 * r] / l[r], o[dn][2 * r + 1] / l[r]);
  }
}

cudaError_t launch_f32(const void* qkv, const void* mask, void* out, int B, int L, int H,
                       int num_heads, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0) return cudaErrorInvalidValue;
  const size_t smem = f32_smem(L);
  cudaError_t err = cudaFuncSetAttribute(
      attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + TC_BM - 1) / TC_BM, num_heads, B);
  attn_f32_kernel<<<grid, TC_NT, smem, stream>>>(static_cast<const float*>(qkv),
                                                 static_cast<const int*>(mask),
                                                 static_cast<float*>(out), L, H,
                                                 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mask is int32 [B, L].  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for shapes the kernel
// does not take; the Python wrapper checks those first).
extern "C" int hc_fused_attention(const void* qkv, const void* mask, void* out, int B,
                                  int L, int H, int num_heads, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || L > MAXL || num_heads <= 0 || H != num_heads * HD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(qkv, mask, out, B, L, H, num_heads, s);
  if (dtype == 1)
    return (int)launch_tc_fwd<false>(qkv, mask, out, nullptr, B, L, H, num_heads, 0, 0, 0, 0u,
                                     1.0f, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
