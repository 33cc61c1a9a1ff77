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
// 3.35 TB/s.  Design: one warp per row, the row in registers (24 values a
// lane at H = 768), so every input byte is read once and every output
// byte written once; consecutive lanes touch consecutive columns.  Eight
// rows (warps) per block; the grid covers any row count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_quant.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row
constexpr int NT = 32 * ROWS_PER_BLOCK;

template <typename TX, typename TO, bool RES, bool QUANT>
__global__ void __launch_bounds__(NT) ln_kernel(const TX* __restrict__ x,
                                                const TX* __restrict__ r,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias, float eps,
                                                int rows, int H, TO* __restrict__ y,
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
cudaError_t launch(const void* x, const void* r, const float* scale, const float* bias,
                   float eps, int rows, int H, void* y, int8_t* yq, float* ys,
                   cudaStream_t stream) {
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  ln_kernel<TX, TO, RES, QUANT><<<blocks, NT, 0, stream>>>(
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
