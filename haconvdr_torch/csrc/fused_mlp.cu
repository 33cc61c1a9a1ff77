// The whole int8 MLP block of an inference tower in one kernel.
//
// Replaces: haconvdr_tpu/ops/fused_mlp.py:56 _mlp_kernel (fused_mlp_block).
// Same math, op for op (the plain twin, ops/fused_mlp.py, is the unfused
// composition):
//   y1 = (xq . W1)_int32 -> f32 * (xs / 127) * s1 + b1 -> bf16
//   g  = tanh-GELU(y1) in f32 -> bf16
//   gq, gs = per-row int8 codes of g (ln_quant.cuh:quant_code)
//   y2 = (gq . W2)_int32 -> f32 * (gs / 127) * s2 + b2
//   t  = x + bf16(y2)                       (bf16 add: the carry dtype)
//   y, yq, ys = LayerNorm(t) -> bf16 and its codes (ln_quant.cuh)
// The int32 sums are exact (|sum| <= 3072 * 127^2 < 2^31), the int32 ->
// f32 cast rounds to nearest (__int2float_rn, as .to(torch.float32)), the
// dequantization rounds each product and sum on its own, and the GELU is
// written as PyTorch's CUDA tanh-GELU writes it.
//
// What bounds it on the H100: at H = 768, I = 3072 the block does
// 2 * 2 * 768 * 3072 = 9.4 Mop per row in int8 x int8 -> int32 and moves
// ~6 B per row element in device memory, so the activations cost little;
// the 4.5 MiB of int8 weights, re-read from L2 by every block, are the
// traffic that bounds it (4.5 MiB per 16 rows: ~29 GB of L2 reads at
// [98,304, 768]).  The [rows, 3072] intermediate never leaves shared memory.
//
// Design: a block owns T = 16 rows, the M of the tensor-core instruction
// mma.sync m16n8k32 (int8 in, exact int32 sums).  The weights stay in
// nn.Linear's [out, in] layout, K-contiguous, which is the column-major B
// that mma.row.col takes: a lane loads 16 contiguous bytes of one weight
// row straight from global memory (L2) for two instructions.  Within each
// 64-wide k chunk, lane t of a quad holds bytes 16t..16t+15 of its row for
// both A and B, a permutation of k that an exact integer sum does not see.
// Shared memory holds the xq tile, g as bf16 [16, 3072] (96 KB), its codes,
// then t: ~158 KB at H = 768, above the 48 KB default (opt-in below), so
// one block runs per SM with 12 warps.  Rows are padded by 16 bytes (bf16
// g) or 64 bytes (int8 tiles) so a quad's loads and stores hit distinct
// banks.  Rows past the end are zeros and are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_quant.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int T = 16;       // rows per block: the M of m16n8k32
constexpr int NWARPS = 12;
constexpr int NT = 32 * NWARPS;
constexpr int NTILE = 4;    // 8-column tiles per warp step (A fragments reused)
constexpr int QPAD = 64;    // bytes of padding per int8 shared row
constexpr int GPAD = 8;     // bf16 elements of padding per g row
constexpr size_t MAX_SMEM = 232448;  // 227 KB: a block's limit on sm_90

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

__host__ __device__ size_t gt_bytes(int H, int I) {
  const size_t g = (size_t)T * (I + GPAD) * sizeof(bf16);
  const size_t t = (size_t)T * H * sizeof(float);
  return align16(g > t ? g : t);
}

size_t smem_bytes(int H, int I) {
  return gt_bytes(H, I) + (size_t)T * (I + QPAD) + (size_t)T * (H + QPAD) + 3 * T * sizeof(float);
}

// d += a . b for one m16n8k32 tile (int8 operands, int32 accumulators)
__device__ __forceinline__ void mma_s8(int (&d)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[j] += A_s [16, K] (shared, row stride lda) . W[n0 + 8 j + (0..7), :]^T
// for j < NTILE; W is [N, K] int8 in global memory, K % 64 == 0.
// Accumulator layout (m16n8): acc[j][i] is row g + 8 (i >= 2), column
// n0 + 8 j + 2 tig + (i & 1), with g = lane / 4 and tig = lane % 4.
__device__ __forceinline__ void tile_product(const int8_t* A_s, int lda,
                                             const int8_t* __restrict__ W, int K, int n0,
                                             int (&acc)[NTILE][4], int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int8_t* a_lo = A_s + g * lda + tig * 16;
  const int8_t* a_hi = a_lo + 8 * lda;
  const int8_t* w = W + (size_t)(n0 + g) * K + tig * 16;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 64) {
    const int4 lo = *reinterpret_cast<const int4*>(a_lo + k0);
    const int4 hi = *reinterpret_cast<const int4*>(a_hi + k0);
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
      const int4 b = __ldg(reinterpret_cast<const int4*>(w + (size_t)j * 8 * K + k0));
      mma_s8(acc[j], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
      mma_s8(acc[j], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
    }
  }
}

// x * (xs / 127) * s + b, each step rounded on its own
__device__ __forceinline__ float dequant(int acc, float xs_127, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs_127), s), b);
}

// PyTorch's CUDA tanh-GELU, written the same way (ActivationGeluKernel.cu)
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = (float)(M_SQRT2 * M_2_SQRTPI * 0.5);
  constexpr float kKappa = (float)0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__global__ void __launch_bounds__(NT, 1)
    mlp_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ xq,
               const float* __restrict__ xs, const int8_t* __restrict__ w1,
               const float* __restrict__ s1, const float* __restrict__ b1,
               const int8_t* __restrict__ w2, const float* __restrict__ s2,
               const float* __restrict__ b2, const float* __restrict__ lns,
               const float* __restrict__ lnb, float eps, int rows, int H, int I,
               bf16* __restrict__ y, int8_t* __restrict__ yq, float* __restrict__ ys) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* g_s = reinterpret_cast<bf16*>(smem);    // [T][I + GPAD], then
  float* t_s = reinterpret_cast<float*>(smem);  // [T][H] once g is coded
  int8_t* gq_s = reinterpret_cast<int8_t*>(smem + gt_bytes(H, I));  // [T][I + QPAD]
  int8_t* xq_s = gq_s + (size_t)T * (I + QPAD);                      // [T][H + QPAD]
  float* xs_s = reinterpret_cast<float*>(xq_s + (size_t)T * (H + QPAD));  // xs / 127
  float* gs_s = xs_s + T;                                                  // gs
  float* gs127_s = gs_s + T;                                               // gs / 127

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long row0 = (long long)blockIdx.x * T;
  const int nrows = (int)min((long long)T, rows - row0);
  const int lq = H + QPAD, lg = I + GPAD, lgq = I + QPAD;

  // 1. the xq tile (zero rows past the end) and xs / 127
  const int hv = H / 16;
  for (int e = tid; e < T * hv; e += NT) {
    const int r = e / hv, c = e % hv;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < nrows) v = *reinterpret_cast<const int4*>(xq + (size_t)(row0 + r) * H + 16 * c);
    *reinterpret_cast<int4*>(xq_s + r * lq + 16 * c) = v;
  }
  if (tid < T) xs_s[tid] = tid < nrows ? __fdiv_rn(xs[row0 + tid], 127.0f) : 0.0f;
  __syncthreads();

  // 2. intermediate dense, dequantized, + b1 -> bf16 -> GELU -> bf16 into g_s
  for (int nb = warp * NTILE; nb < I / 8; nb += NWARPS * NTILE) {
    int acc[NTILE][4] = {};
    tile_product(xq_s, lq, w1, H, nb * 8, acc, lane);
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + (i >= 2 ? 8 : 0);
        const int c = (nb + j) * 8 + 2 * tig + (i & 1);
        const float v = hc::round_to<bf16>(dequant(acc[j][i], xs_s[r], s1[c], b1[c]));
        g_s[r * lg + c] = __float2bfloat16_rn(gelu_tanh(v));
      }
    }
  }
  __syncthreads();

  // 3. per-row scale of g, then its codes
  for (int r = warp; r < T; r += NWARPS) {
    float m = 0.0f;
    for (int c = lane; c < I; c += 32) m = fmaxf(m, fabsf(__bfloat162float(g_s[r * lg + c])));
    m = hc::warp_max(m);
    if (lane == 0) {
      const float s = fmaxf(m, 1e-30f);
      gs_s[r] = s;
      gs127_s[r] = __fdiv_rn(s, 127.0f);
    }
  }
  __syncthreads();
  for (int e = tid; e < T * I; e += NT) {
    const int r = e / I, c = e % I;
    gq_s[r * lgq + c] = hc::quant_code(__bfloat162float(g_s[r * lg + c]), gs_s[r]);
  }
  __syncthreads();

  // 4. output dense, dequantized, + b2 -> bf16, + x in bf16 -> t_s
  for (int nb = warp * NTILE; nb < H / 8; nb += NWARPS * NTILE) {
    int acc[NTILE][4] = {};
    tile_product(gq_s, lgq, w2, I, nb * 8, acc, lane);
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + (i >= 2 ? 8 : 0);
        const int c = (nb + j) * 8 + 2 * tig + (i & 1);
        const float y2 = hc::round_to<bf16>(dequant(acc[j][i], gs127_s[r], s2[c], b2[c]));
        const float xv = r < nrows ? __bfloat162float(x[(size_t)(row0 + r) * H + c]) : 0.0f;
        t_s[r * H + c] = hc::round_to<bf16>(__fadd_rn(xv, y2));
      }
    }
  }
  __syncthreads();

  // 5. LayerNorm + codes of each row (one warp per row)
  const int vpl = H / 32;
  for (int r = warp; r < nrows; r += NWARPS) {
    float v[hc::LN_MAX_VPL];
#pragma unroll
    for (int i = 0; i < hc::LN_MAX_VPL; ++i)
      if (i < vpl) v[i] = t_s[r * H + lane + 32 * i];
    const size_t base = (size_t)(row0 + r) * H;
    hc::ln_row_store<bf16, true>(v, H, lane, lns, lnb, eps, y + base, yq + base, ys + row0 + r);
  }
}

}  // namespace

// x bf16 [rows, H]; xq int8 [rows, H]; xs float32 [rows]; w1 int8 [I, H]
// and w2 int8 [H, I] ([out, in], 16-byte aligned); s1, b1 float32 [I];
// s2, b2, lns, lnb float32 [H]; outputs y bf16 [rows, H], yq int8
// [rows, H], ys float32 [rows].  Takes H % 64 == 0, 64 <= H <= 1024,
// I % 64 == 0 and shared memory within 227 KB; returns
// cudaErrorInvalidValue otherwise (the Python wrapper checks first).
extern "C" int hc_fused_mlp(const void* x, const void* xq, const void* xs, const void* w1,
                            const void* s1, const void* b1, const void* w2, const void* s2,
                            const void* b2, const void* lns, const void* lnb, float eps,
                            int rows, int H, int I, void* y, void* yq, void* ys, void* stream) {
  if (rows <= 0 || H < 64 || H % 64 || H > 32 * hc::LN_MAX_VPL || I < 64 || I % 64)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H, I);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + T - 1) / T;
  mlp_kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(xq),
      static_cast<const float*>(xs), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), eps, rows, H, I, static_cast<bf16*>(y),
      static_cast<int8_t*>(yq), static_cast<float*>(ys));
  return (int)cudaGetLastError();
}
