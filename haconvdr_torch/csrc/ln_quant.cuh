// The LayerNorm + per-row int8 quantization tail shared by fused_ln.cu and
// fused_mlp.cu (the epilogue of haconvdr_tpu/ops/fused_ln.py:_ln_body /
// _quant_tail and of ops/fused_mlp.py:_mlp_kernel).
//
// One warp owns one row of H <= 1024 values (H % 32 == 0); lane l holds
// columns l, l + 32, ... in registers.  Arithmetic, in the order of the
// plain twin (haconvdr_torch/ops/fused_ln.py:layer_norm, quantize_rows):
//   mean = sum(t) / H; var = sum((t - mean)^2) / H      (f32, centred: not
//                                                      Welford, not E[t^2] - m^2)
//   y = (t - mean) * rsqrt(var + eps) * scale + bias    (f32), stored as TO
//   ys = max(max|yb|, 1e-30), yq = clip(rint(yb / ys * 127), -127, 127)
// where yb is y rounded to TO, as the consuming int8 dense reads it.  Every
// product and sum of the affine and the quantization is rounded on its own
// (__fmul_rn / __fadd_rn: nvcc would otherwise contract them into FMAs,
// which the twin's separate torch ops do not do); the division is IEEE and
// the rounding half to even, as torch.round and jnp.round.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hc {

constexpr int LN_MAX_VPL = 32;  // values per lane: H <= 32 * 32

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// butterfly reductions: every lane ends with the same value (each step adds
// the same two operands on both lanes of a pair)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// clip(rint(v / s * 127), -127, 127)
__device__ __forceinline__ int8_t quant_code(float v, float s) {
  const float q = rintf(__fmul_rn(__fdiv_rn(v, s), 127.0f));
  return (int8_t)(int)fminf(fmaxf(q, -127.0f), 127.0f);
}

// LayerNorm of the row in v (lane-strided, see above), stored as TO at
// y_row; with QUANT also its int8 codes at q_row and the row scale at *s_out.
template <typename TO, bool QUANT>
__device__ __forceinline__ void ln_row_store(float (&v)[LN_MAX_VPL], int H, int lane,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ bias, float eps,
                                             TO* __restrict__ y_row, int8_t* __restrict__ q_row,
                                             float* __restrict__ s_out) {
  const int vpl = H / 32;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_MAX_VPL; ++i)
    if (i < vpl) s = __fadd_rn(s, v[i]);
  const float mean = __fdiv_rn(warp_sum(s), (float)H);
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_MAX_VPL; ++i) {
    if (i < vpl) {
      const float d = __fsub_rn(v[i], mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
  }
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)H), eps));
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_MAX_VPL; ++i) {
    if (i < vpl) {
      const int c = lane + 32 * i;
      const float y =
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), inv), scale[c]), bias[c]);
      const TO yb = from_f<TO>(y);
      y_row[c] = yb;
      v[i] = to_f(yb);
      amax = fmaxf(amax, fabsf(v[i]));
    }
  }
  if (QUANT) {
    const float ys = fmaxf(warp_max(amax), 1e-30f);
#pragma unroll
    for (int i = 0; i < LN_MAX_VPL; ++i)
      if (i < vpl) q_row[lane + 32 * i] = quant_code(v[i], ys);
    if (lane == 0) *s_out = ys;
  }
}

}  // namespace hc
