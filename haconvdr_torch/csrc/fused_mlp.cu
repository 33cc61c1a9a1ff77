// The int8 MLP block of an inference tower: four kernels on one stream.
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
// The int32 sums are exact (|sum| <= I * 127^2 < 2^31), the int32 -> f32
// cast rounds to nearest (__int2float_rn, as .to(torch.float32)), the
// dequantization rounds each product and sum on its own, and the GELU is
// written as PyTorch's CUDA tanh-GELU writes it.
//
// What bounds it on the H100: the products, 2 * 2 * H * I = 9.4 Mop per row
// at H = 768, I = 3072 (0.93 Top at [98,304, 768]: 0.47 ms at 1,979 Top/s),
// and the operand traffic from L2 into the SMs.  The first version kept the
// whole [16, I] intermediate of 16 rows in shared memory and read the int8
// weights straight from L2 for every 16 rows: ~29 GB of L2 reads at
// [98,304, 768] bounded it (5.35 ms).  A row's g scale is the maximum over
// all I columns and must exist before any code of g can, which is what
// pinned the rows to 16.
//
// Design: the block is cut where the row maximum is needed.
//  1. mlp_gemm<UP>: g = bf16(GELU(bf16(dequant(xq . W1^T)))) into a
//     [rows, I] bf16 scratch, in 128 x 128 (rows x columns) tiles; each
//     row's max |g| reaches gmax[rows] by atomicMax on the float's bits
//     (for non-negative floats the bits order as integers, so the maximum
//     is exact in any order; gmax is zeroed first).
//  2. quant_kernel: gq, gs = the codes of g, each element coded once.
//  3. mlp_gemm<DOWN>: t = bf16(x + bf16(dequant(gq . W2^T))) into a
//     [rows, H] bf16 scratch, the same 128 x 128 tiles.
//  4. LayerNorm + codes of t: fused_ln.cu's kernel (row 9, no residual).
// A tile of W then serves 128 rows, not 16: ~7 GB of L2 reads at
// [98,304, 768].  Whole rows of t in one block (LayerNorm in the epilogue
// of 3) would need 768 int32 accumulators a row: 192 a thread at 256
// threads for 64 rows, past the register file, so the LayerNorm is its own
// pass over t (0.3 GB at [98,304, 768]).  Scratch a row: 3 I + 2 H + 8
// bytes (10,760 at H = 768, I = 3072).
//
// The products run on mma.sync m16n8k32 (int8 in, exact int32 sums) in
// 128 x 128 tiles, two blocks of eight warps an SM, each warp 64 x 32
// outputs (4 x 4 tiles, 64 int32 accumulators a thread: the register file
// holds no more at 16 warps an SM).  A stage holds a 128-byte k chunk of
// 128 rows of A and 128 rows of W (W in nn.Linear's [out, in] layout,
// K-contiguous, is the column-major B that mma.row.col takes), 32 KB,
// three stages deep, filled with 16-byte cp.async.cg copies (zeros past
// the last row and past K).  Within each 64-byte half of a chunk, lane t of
// a quad holds bytes 16t..16t+15 of its row for both A and B, a permutation
// of k that an exact integer sum does not see; rows are swizzled (SWZ) so
// the 8 lanes of a 16-byte shared-memory phase read 128 bytes on 32 banks.
//
// What limits it (NVIDIA H100 80GB HBM3, 700 W; probes/
// probe_torch_int8_tower.py --variants at [98,304, 768]): the down-
// projection takes 1.05 ms, and each of its streams alone takes about half
// of that: the copies from L2 (0.53 ms, ~7 TB/s), the products alone
// (0.51 ms), the shared-memory fragment loads with the products (0.75 ms
// without the copies).  They barely overlap: a warp stalls on its own
// copies and fragment loads.  Larger warp tiles (64 x 64) leave one block
// an SM and measured 19-36% slower; a producer warp with mbarriers capped
// the product warps' registers and spilled, and a persistent grid and a
// two-stream row pipeline measured slower too (development runs).  The
// up-projection adds its GELU epilogue and 4x the tiles (1.57 ms).

// Split mode (a tensor-parallel tower: the block's inner dimension I cut
// over tp ranks, rank r holding columns [r I/tp, (r + 1) I/tp) of W1 and the
// same rows of W2).  Two row maxima would break: the row's max |g| (the g
// scale) spans every rank's columns, and y2's int32 sums span every rank's
// products.  So the block runs as three entry points the caller strings
// together over the group:
//   hc_fused_mlp_split_up     memset + mlp_gemm<UP> on the rank's I/tp
//                             columns: g and its partial row maxima gmax;
//   (the caller takes the group's maximum of gmax, exact in any order, and
//    hands it back to every rank)
//   hc_fused_mlp_split_down   quant_kernel with the group's gmax (so every
//                             rank codes g with the global scale), then
//                             mlp_gemm<PARTIAL>: the raw int32 products
//                             [rows, H] of the rank's columns;
//   hc_fused_mlp_split_finish split_sum: the tp partials summed in int32
//                             (exact), then (gs / 127) * s2 + b2, the bf16
//                             cast and the residual add as mlp_gemm<DOWN>'s
//                             epilogue does them, into t; then fused_ln.cu's
//                             LayerNorm with codes, as step 4.
// Every code and every int32 sum is the un-split block's, so the split
// block's y, yq and ys equal the un-split kernel's bit for bit.  Dequantizing
// per rank and summing floats would round differently.  The split adds the
// partials' traffic: tp x rows x H x 4 bytes written and read again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_quant.cuh"

// fused_ln.cu: LayerNorm (+ residual) (+ codes)
extern "C" int hc_fused_ln(const void* x, const void* r, const void* scale, const void* bias,
                           float eps, int rows, int H, int x_dtype, int out_dtype, void* y,
                           void* yq, void* ys, void* stream);

namespace {

using bf16 = __nv_bfloat16;

// tile rows, columns and k bytes a stage; a warp's rows and columns;
// threads, stages, blocks an SM
constexpr int BM = 128, BN = 128, BK = 128, WM = 64, WN = 32, NT = 256, STAGES = 3, MINB = 2;
constexpr int MT = WM / 16, NTL = WN / 8;      // a warp's m16n8 tiles
constexpr int SMEM = STAGES * (BM + BN) * BK;  // 96 KB
// shared rows of 128 bytes and more: 16-byte unit u of row r sits at
// u ^ 4 (r & 1), so the two rows that 8 lanes read together fill the 32
// banks (64-byte rows need no swizzle)
constexpr int SWZ = BK >= 128 ? 4 : 0;
constexpr int UP = 0, DOWN = 1, PARTIAL = 2;  // PARTIAL: the raw int32 sums (split mode)
static_assert(BK % 64 == 0 && NT == 32 * (BM / WM) * (BN / WN), "tile shape");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  // src-size 0 zero-fills the 16 bytes (rows past the end)
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Copy the k chunk kt of the block's A rows [m0, m0 + BM) and W rows
// [n0, n0 + BN) into stage slot s (zeros past the last row and past K).
__device__ __forceinline__ void load_stage(int8_t* smem, int s, const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ W, int M, int N, int K,
                                           int m0, int n0, int kt) {
  int8_t* As = smem + s * BM * BK;
  int8_t* Bs = smem + STAGES * BM * BK + s * BN * BK;
  const int k0 = kt * BK;
#pragma unroll
  for (int e = threadIdx.x; e < BM * (BK / 16); e += NT) {
    const int r = e / (BK / 16), u = e % (BK / 16);
    const bool full = m0 + r < M && k0 + 16 * u < K;
    cp_async16(As + r * BK + 16 * (u ^ (SWZ * (r & 1))),
               full ? A + (size_t)(m0 + r) * K + k0 + 16 * u : A, full);
  }
#pragma unroll
  for (int e = threadIdx.x; e < BN * (BK / 16); e += NT) {
    const int r = e / (BK / 16), u = e % (BK / 16);
    const bool full = n0 + r < N && k0 + 16 * u < K;
    cp_async16(Bs + r * BK + 16 * (u ^ (SWZ * (r & 1))),
               full ? W + (size_t)(n0 + r) * K + k0 + 16 * u : W, full);
  }
}

// The epilogue of one tile (acc[i][j][2h + e] is row m0 + wm WM + 16 i + g
// + 8 h, column n0 + wn WN + 8 j + 2 tig + e):
//   UP:      out = bf16(GELU(bf16(dequant(C, a_scale / 127, ws, wb)))) [M, N];
//            row_max[r - m0] = max |out[r, n0 .. n0 + BN)| as float bits
//   DOWN:    out = bf16(x + bf16(dequant(C, a_scale / 127, ws, wb))) [M, N]
//   PARTIAL: out = C, int32 [M, N] (a_scale, ws, wb and x unused)
template <int MODE>
__device__ __forceinline__ void epilogue(const int (&acc)[MT][NTL][4], int M, int N, int m0,
                                         int n0, int wm, int wn, int g, int tig,
                                         const float* __restrict__ a_scale,
                                         const float* __restrict__ ws,
                                         const float* __restrict__ wb,
                                         const bf16* __restrict__ x, void* __restrict__ out_,
                                         unsigned* row_max) {
  bf16* out = static_cast<bf16*>(out_);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * WM + 16 * i + g + 8 * h;
      const int r = m0 + rl;
      const bool live = r < M;
      const float s_127 = (MODE != PARTIAL && live) ? __fdiv_rn(a_scale[r], 127.0f) : 0.0f;
      float m = 0.0f;
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const int c = n0 + wn * WN + 8 * j + 2 * tig;
        if (c >= N) continue;
        if (MODE == PARTIAL) {
          if (live)
            *reinterpret_cast<int2*>(static_cast<int*>(out_) + (size_t)r * N + c) =
                make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          continue;
        }
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = hc::round_to<bf16>(dequant(acc[i][j][2 * h + e], s_127, ws[c + e], wb[c + e]));
        if (MODE == UP) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = hc::round_to<bf16>(gelu_tanh(v[e]));
            m = fmaxf(m, fabsf(v[e]));
          }
        } else if (live) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)r * N + c);
          v[0] = hc::round_to<bf16>(__fadd_rn(__low2float(xv), v[0]));
          v[1] = hc::round_to<bf16>(__fadd_rn(__high2float(xv), v[1]));
        }
        if (live) *reinterpret_cast<uint32_t*>(out + (size_t)r * N + c) = pack_bf16(v[0], v[1]);
      }
      if (MODE == UP) {  // the quad's maximum of row r, then the block's
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (tig == 0 && live) atomicMax(&row_max[rl], __float_as_uint(m));
      }
    }
  }
}

// C [M, N] = A [M, K] . W [N, K]^T (int8, exact int32) on one BM x BN tile
// (blockIdx.x the column tile, blockIdx.y the row tile), then
// epilogue<MODE>; UP also folds the tile's row maxima into gmax[M].
// a_scale is xs (UP) or gs (DOWN), one per row.  K % 16 == 0, N % 8 == 0.
template <int MODE>
__global__ void __launch_bounds__(NT, MINB)
    mlp_gemm(const int8_t* __restrict__ A, const int8_t* __restrict__ W, int M, int N, int K,
             const float* __restrict__ a_scale, const float* __restrict__ ws,
             const float* __restrict__ wb, const bf16* __restrict__ x, void* __restrict__ out,
             unsigned* __restrict__ gmax) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ unsigned row_max[BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = (K + BK - 1) / BK;
  if (MODE == UP && tid < BM) row_max[tid] = 0u;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(smem, s, A, W, M, N, K, m0, n0, s);
    cp_async_commit();
  }

  int acc[MT][NTL][4] = {};
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk kt is in; every warp is done with chunk kt - 1's slot
    if (kt + STAGES - 1 < KT)
      load_stage(smem, (kt + STAGES - 1) % STAGES, A, W, M, N, K, m0, n0, kt + STAGES - 1);
    cp_async_commit();  // an empty group at the end keeps the wait count uniform

    const int s = kt % STAGES;
    const int8_t* a = smem + s * BM * BK + (wm * WM + g) * BK;
    const int8_t* b = smem + STAGES * BM * BK + s * BN * BK + (wn * WN + g) * BK;
#pragma unroll
    for (int kk = 0; kk < BK / 64; ++kk) {  // 64-byte k steps: two products each
      const int off = 16 * ((4 * kk + tig) ^ (SWZ * (g & 1)));
      int4 bf[NTL];
#pragma unroll
      for (int j = 0; j < NTL; ++j) bf[j] = *reinterpret_cast<const int4*>(b + j * 8 * BK + off);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int4 lo = *reinterpret_cast<const int4*>(a + i * 16 * BK + off);
        const int4 hi = *reinterpret_cast<const int4*>(a + (i * 16 + 8) * BK + off);
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          mma_s8(acc[i][j], lo.x, hi.x, lo.y, hi.y, bf[j].x, bf[j].y);
          mma_s8(acc[i][j], lo.z, hi.z, lo.w, hi.w, bf[j].z, bf[j].w);
        }
      }
    }
  }

  epilogue<MODE>(acc, M, N, m0, n0, wm, wn, g, tig, a_scale, ws, wb, x, out, row_max);
  if (MODE == UP) {
    __syncthreads();
    if (tid < BM && m0 + tid < M) atomicMax(&gmax[m0 + tid], row_max[tid]);
  }
}

// gq, gs = the per-row codes of g: gs = max(max |g|, 1e-30), from gmax's
// bits; one thread an 8-column chunk.
__global__ void __launch_bounds__(256)
    quant_kernel(const bf16* __restrict__ g, const unsigned* __restrict__ gmax, int rows, int I,
                 int8_t* __restrict__ gq, float* __restrict__ gs) {
  const long long chunks = (long long)rows * (I / 8);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= chunks) return;
  const long long r = e / (I / 8);
  const size_t off = (size_t)e * 8;
  const float s = fmaxf(__uint_as_float(gmax[r]), 1e-30f);
  float v[8];
  hc::load_run<8>(g + off, v);
  hc::store_codes_run<8>(gq + off, v, s);
  if (off == (size_t)r * I) gs[r] = s;
}

// split mode, step 3: t = bf16(x + bf16(dequant(sum_k part[k], gs / 127, s2,
// b2))) [rows, H] from the tp int32 planes part [tp, rows, H] (the sums
// exact in int32, the rest as mlp_gemm<DOWN>'s epilogue); one thread a pair
// of columns.  Bytes bound: tp x 4 + 2 + 2 bytes an element.
__global__ void __launch_bounds__(256)
    split_sum_kernel(const int* __restrict__ part, int tp, int rows, int H,
                     const float* __restrict__ gs, const float* __restrict__ s2,
                     const float* __restrict__ b2, const bf16* __restrict__ x,
                     bf16* __restrict__ t) {
  const long long pairs = (long long)rows * (H / 2);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pairs) return;
  const long long r = e / (H / 2);
  const int c = 2 * (int)(e % (H / 2));
  const size_t off = (size_t)r * H + c, plane = (size_t)rows * H;
  int a0 = 0, a1 = 0;
  for (int k = 0; k < tp; ++k) {
    const int2 v = *reinterpret_cast<const int2*>(part + k * plane + off);
    a0 += v.x;
    a1 += v.y;
  }
  const float s_127 = __fdiv_rn(gs[r], 127.0f);
  const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off);
  const float v0 = hc::round_to<bf16>(dequant(a0, s_127, s2[c], b2[c]));
  const float v1 = hc::round_to<bf16>(dequant(a1, s_127, s2[c + 1], b2[c + 1]));
  *reinterpret_cast<uint32_t*>(t + off) =
      pack_bf16(hc::round_to<bf16>(__fadd_rn(__low2float(xv), v0)),
                hc::round_to<bf16>(__fadd_rn(__high2float(xv), v1)));
}

template <int MODE>
cudaError_t launch_gemm(const int8_t* A, const int8_t* W, int M, int N, int K,
                        const float* a_scale, const float* ws, const float* wb, const bf16* x,
                        void* out, unsigned* gmax, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(mlp_gemm<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mlp_gemm<MODE><<<grid, NT, SMEM, stream>>>(A, W, M, N, K, a_scale, ws, wb, x, out, gmax);
  return cudaGetLastError();
}

#define HC_TRY(expr)                        \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

}  // namespace

// x bf16 [rows, H]; xq int8 [rows, H]; xs float32 [rows]; w1 int8 [I, H]
// and w2 int8 [H, I] ([out, in]); s1, b1 float32 [I]; s2, b2, lns, lnb
// float32 [H]; outputs y bf16 [rows, H], yq int8 [rows, H], ys float32
// [rows]; scratch g bf16 [rows, I], gmax uint32 [rows], gq int8 [rows, I],
// gs float32 [rows], t bf16 [rows, H].  xq, w1, w2, g and gq 16-byte
// aligned.  Takes H % 64 == 0, 64 <= H <= 1024, I % 64 == 0,
// 64 <= I <= 131,072 (exact int32 sums); returns cudaErrorInvalidValue
// otherwise (the Python wrapper checks first).

extern "C" int hc_fused_mlp(const void* x, const void* xq, const void* xs, const void* w1,
                            const void* s1, const void* b1, const void* w2, const void* s2,
                            const void* b2, const void* lns, const void* lnb, float eps,
                            int rows, int H, int I, void* y, void* yq, void* ys, void* g,
                            void* gmax, void* gq, void* gs, void* t, void* stream) {
  if (rows <= 0 || H < 64 || H % 64 || H > 32 * hc::LN_MAX_VPL || I < 64 || I % 64 ||
      I > 131072)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* xqb = static_cast<const int8_t*>(xq);
  const float* xsb = static_cast<const float*>(xs);
  bf16* gb = static_cast<bf16*>(g);
  unsigned* gm = static_cast<unsigned*>(gmax);
  int8_t* gqb = static_cast<int8_t*>(gq);
  float* gsb = static_cast<float*>(gs);
  bf16* tb = static_cast<bf16*>(t);
  HC_TRY(cudaMemsetAsync(gm, 0, sizeof(unsigned) * (size_t)rows, s));

  HC_TRY(launch_gemm<UP>(xqb, static_cast<const int8_t*>(w1), rows, I, H, xsb,
                        static_cast<const float*>(s1), static_cast<const float*>(b1), nullptr,
                        gb, gm, s));
  const long long chunks = (long long)rows * (I / 8);
  quant_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, s>>>(gb, gm, rows, I, gqb, gsb);
  HC_TRY(cudaGetLastError());
  HC_TRY(launch_gemm<DOWN>(gqb, static_cast<const int8_t*>(w2), rows, H, I, gsb,
                          static_cast<const float*>(s2), static_cast<const float*>(b2), xb, tb,
                          nullptr, s));
  return hc_fused_ln(tb, nullptr, lns, lnb, eps, rows, H, 1, 1, y, yq, ys, stream);
}

// Split mode (see the head note): rank r's I columns (I = the full inner
// dimension / tp), H and I as hc_fused_mlp takes them.
// Step 1: xq int8 [rows, H], xs float32 [rows], w1 int8 [I, H], s1, b1
// float32 [I] -> g bf16 [rows, I], gmax uint32 [rows] (the rank's row
// maxima of |g| as float bits).
extern "C" int hc_fused_mlp_split_up(const void* xq, const void* xs, const void* w1,
                                     const void* s1, const void* b1, int rows, int H, int I,
                                     void* g, void* gmax, void* stream) {
  if (rows <= 0 || H < 64 || H % 64 || H > 32 * hc::LN_MAX_VPL || I < 64 || I % 64 ||
      I > 131072)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* gm = static_cast<unsigned*>(gmax);
  HC_TRY(cudaMemsetAsync(gm, 0, sizeof(unsigned) * (size_t)rows, s));
  HC_TRY(launch_gemm<UP>(static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1), rows, I,
                        H, static_cast<const float*>(xs), static_cast<const float*>(s1),
                        static_cast<const float*>(b1), nullptr, g, gm, s));
  return 0;
}

// Step 2: g bf16 [rows, I], gmax uint32 [rows] (the group's maxima), w2
// int8 [H, I] -> scratch gq int8 [rows, I], gs float32 [rows] (the global
// g scales), part int32 [rows, H] (the rank's raw products).
extern "C" int hc_fused_mlp_split_down(const void* g, const void* gmax, const void* w2,
                                       int rows, int H, int I, void* gq, void* gs, void* part,
                                       void* stream) {
  if (rows <= 0 || H < 64 || H % 64 || H > 32 * hc::LN_MAX_VPL || I < 64 || I % 64 ||
      I > 131072)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* gqb = static_cast<int8_t*>(gq);
  const long long chunks = (long long)rows * (I / 8);
  quant_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const unsigned*>(gmax), rows, I, gqb,
      static_cast<float*>(gs));
  HC_TRY(cudaGetLastError());
  HC_TRY(launch_gemm<PARTIAL>(gqb, static_cast<const int8_t*>(w2), rows, H, I, nullptr, nullptr,
                             nullptr, nullptr, part, nullptr, s));
  return 0;
}

// Step 3: part int32 [tp, rows, H] (every rank's step-2 output, in rank
// order), gs float32 [rows], x bf16 [rows, H] (the residual), s2, b2, lns,
// lnb float32 [H] -> scratch t bf16 [rows, H], then y bf16 [rows, H], yq
// int8 [rows, H], ys float32 [rows].  tp x I <= 131,072 keeps the sums exact.
extern "C" int hc_fused_mlp_split_finish(const void* part, int tp, const void* gs,
                                         const void* x, const void* s2, const void* b2,
                                         const void* lns, const void* lnb, float eps, int rows,
                                         int H, void* t, void* y, void* yq, void* ys,
                                         void* stream) {
  if (rows <= 0 || tp <= 0 || H < 64 || H % 64 || H > 32 * hc::LN_MAX_VPL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pairs = (long long)rows * (H / 2);
  split_sum_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, s>>>(
      static_cast<const int*>(part), tp, rows, H, static_cast<const float*>(gs),
      static_cast<const float*>(s2), static_cast<const float*>(b2), static_cast<const bf16*>(x),
      static_cast<bf16*>(t));
  HC_TRY(cudaGetLastError());
  return hc_fused_ln(t, nullptr, lns, lnb, eps, rows, H, 1, 1, y, yq, ys, stream);
}
