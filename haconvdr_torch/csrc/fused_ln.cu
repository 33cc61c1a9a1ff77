// (residual +) LayerNorm (+ per-row int8 quantization) in one pass.
//
// Replaces: haconvdr_tpu/ops/fused_ln.py:66 _kernel_with_res, :72
// _kernel_no_res (fused_residual_ln) and :91 _kernel_with_res_q, :96
// _kernel_no_res_q (fused_residual_ln_quant).  One kernel body; the residual
// and the quant tail are template switches.  Same math: t = x + r added in
// x's dtype (bf16 + bf16 rounds to bf16, as JAX's x + r.astype(x.dtype));
// LayerNorm in f32 (mean first, then the variance of the centred values);
// y stored in the output dtype; with the quant tail, y's per-row int8 codes
// and scale computed from the stored (rounded) y.  See ln_quant.cuh.
//
// What bounds it on the H100: bytes.  Per element it reads x (2 B bf16 or
// 4 B f32) and the residual (2 B) and writes y (2 B) and the codes (1 B):
// about 7 B against ~10 flops, far below the card's ~300 flops per byte.
// At the corpus-encode shape [98,304, 768] that is ~0.5 GB, ~0.16 ms at
// 3.35 TB/s.  One warp owns a row, held in registers, so every input byte
// is read once and every output byte written once.
//
// Two instances of the one body:
//  * ln_fixed_kernel, H = 768 at compile time (the towers' width).  The
//    first version (ln_generic_kernel) issued four scalar memory
//    instructions per element (x, scale, bias, y: 2-byte loads and stores
//    lane-strided, the weights re-read for every row) and one row per warp
//    in flight, and reached 38% of the bytes bound without a residual.
//    Here a lane moves 16-byte vectors (ln_quant.cuh's runs: 8 bf16
//    columns, or 4 where x or y is f32, so a warp's loads stay contiguous),
//    issues all of its row's loads before it uses one, and reads scale and
//    bias from shared memory, staged once a block.  Weights held in
//    registers across a grid-stride loop over rows, or two rows a warp,
//    more than doubled the registers and measured slower in development
//    runs: one row a warp, as many blocks as rows need.
//  * ln_generic_kernel, any other H % 32 == 0 <= 1024 (and unaligned
//    pointers): lane-strided scalars, as first written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_quant.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row
constexpr int NT = 32 * ROWS_PER_BLOCK;
constexpr int FIXED_H = 768;       // the compile-time width of ln_fixed_kernel

template <typename TX, typename TO, bool RES, bool QUANT>
__global__ void __launch_bounds__(NT) ln_generic_kernel(const TX* __restrict__ x,
                                                        const TX* __restrict__ r,
                                                        const float* __restrict__ scale,
                                                        const float* __restrict__ bias,
                                                        float eps, int rows, int H,
                                                        TO* __restrict__ y,
                                                        int8_t* __restrict__ yq,
                                                        float* __restrict__ ys) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps only: the row is warp-uniform
  const size_t base = (size_t)row * H;
  const int vpl = H / 32;
  float v[hc::LN_MAX_VPL];
#pragma unroll
  for (int i = 0; i < hc::LN_MAX_VPL; ++i) {
    if (i < vpl) {
      const int c = lane + 32 * i;
      float t = hc::to_f(x[base + c]);
      if (RES) t = hc::round_to<TX>(__fadd_rn(t, hc::to_f(r[base + c])));
      v[i] = t;
    }
  }
  hc::ln_row_store<TO, QUANT>(v, H, lane, scale, bias, eps, y + base,
                              QUANT ? yq + base : nullptr, QUANT ? ys + row : nullptr);
}

template <typename TX, typename TO, bool RES, bool QUANT>
__global__ void __launch_bounds__(NT) ln_fixed_kernel(const TX* __restrict__ x,
                                                      const TX* __restrict__ r,
                                                      const float* __restrict__ scale,
                                                      const float* __restrict__ bias, float eps,
                                                      int rows, TO* __restrict__ y,
                                                      int8_t* __restrict__ yq,
                                                      float* __restrict__ ys) {
  constexpr int NV = FIXED_H / 256;  // 256-column slabs: 8 columns of each a lane
  // 16-byte vectors of bf16; of f32 where either side is f32 (ln_quant.cuh)
  constexpr int V = sizeof(TX) == 4 || sizeof(TO) == 4 ? 4 : 8;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  __shared__ __align__(16) float w_s[2][FIXED_H];  // scale, bias
  for (int c = threadIdx.x; c < FIXED_H; c += NT) {
    w_s[0][c] = scale[c];
    w_s[1][c] = bias[c];
  }
  __syncthreads();
  if (row >= rows) return;  // whole warps only: the row is warp-uniform
  const size_t base = (size_t)row * FIXED_H;
  float v[NV][8];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int h = 0; h < 8 / V; ++h)
      hc::load_run<V>(x + base + hc::run_col<V>(j, h, lane), v[j] + V * h);
  if (RES) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float w[8];
#pragma unroll
      for (int h = 0; h < 8 / V; ++h)
        hc::load_run<V>(r + base + hc::run_col<V>(j, h, lane), w + V * h);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[j][e] = hc::round_to<TX>(__fadd_rn(v[j][e], w[e]));
    }
  }
  hc::ln_chunks_store<TO, QUANT, NV, V>(v, w_s[0], w_s[1], eps, lane, y + base,
                                        QUANT ? yq + base : nullptr, QUANT ? ys + row : nullptr);
}

bool aligned(const void* p, size_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

template <typename TX, typename TO, bool RES, bool QUANT>
cudaError_t launch(const void* x, const void* r, const float* scale, const float* bias,
                   float eps, int rows, int H, void* y, int8_t* yq, float* ys,
                   cudaStream_t stream) {
  const bool fixed = H == FIXED_H && aligned(x, 16) && (!RES || aligned(r, 16)) &&
                     aligned(y, 16) && (!QUANT || aligned(yq, 8));
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (fixed) {
    ln_fixed_kernel<TX, TO, RES, QUANT><<<blocks, NT, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(r), scale, bias, eps, rows,
        static_cast<TO*>(y), yq, ys);
    return cudaGetLastError();
  }
  ln_generic_kernel<TX, TO, RES, QUANT><<<blocks, NT, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(r), scale, bias, eps, rows, H,
      static_cast<TO*>(y), yq, ys);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t dispatch_flags(const void* x, const void* r, const float* scale,
                           const float* bias, float eps, int rows, int H, void* y,
                           int8_t* yq, float* ys, cudaStream_t s) {
  if (r != nullptr && yq != nullptr)
    return launch<TX, TO, true, true>(x, r, scale, bias, eps, rows, H, y, yq, ys, s);
  if (r != nullptr)
    return launch<TX, TO, true, false>(x, r, scale, bias, eps, rows, H, y, yq, ys, s);
  if (yq != nullptr)
    return launch<TX, TO, false, true>(x, r, scale, bias, eps, rows, H, y, yq, ys, s);
  return launch<TX, TO, false, false>(x, r, scale, bias, eps, rows, H, y, yq, ys, s);
}

}  // namespace

// x (and r, in x's dtype) [rows, H]; scale, bias float32 [H]; dtype codes
// 0 = float32, 1 = bfloat16.  r == NULL: no residual.  yq == NULL: no quant
// tail (else yq int8 [rows, H] and ys float32 [rows]).  Takes H % 32 == 0,
// 32 <= H <= 1024 and any rows >= 1; returns cudaErrorInvalidValue
// otherwise (the Python wrapper checks first).
extern "C" int hc_fused_ln(const void* x, const void* r, const void* scale, const void* bias,
                           float eps, int rows, int H, int x_dtype, int out_dtype, void* y,
                           void* yq, void* ys, void* stream) {
  if (rows <= 0 || H < 32 || H % 32 || H > 32 * hc::LN_MAX_VPL || (yq == nullptr) != (ys == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  int8_t* q = static_cast<int8_t*>(yq);
  float* qs = static_cast<float*>(ys);
  if (x_dtype == 0 && out_dtype == 0)
    return (int)dispatch_flags<float, float>(x, r, sc, bi, eps, rows, H, y, q, qs, s);
  if (x_dtype == 0 && out_dtype == 1)
    return (int)dispatch_flags<float, __nv_bfloat16>(x, r, sc, bi, eps, rows, H, y, q, qs, s);
  if (x_dtype == 1 && out_dtype == 0)
    return (int)dispatch_flags<__nv_bfloat16, float>(x, r, sc, bi, eps, rows, H, y, q, qs, s);
  if (x_dtype == 1 && out_dtype == 1)
    return (int)dispatch_flags<__nv_bfloat16, __nv_bfloat16>(x, r, sc, bi, eps, rows, H, y, q,
                                                              qs, s);
  return (int)cudaErrorInvalidValue;
}
