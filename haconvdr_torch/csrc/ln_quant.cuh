// The LayerNorm + per-row int8 quantization of fused_ln.cu (the body of
// haconvdr_tpu/ops/fused_ln.py:_ln_body / _quant_tail, and the epilogue of
// ops/fused_mlp.py:_mlp_kernel, which fused_mlp.cu runs through fused_ln.cu).
//
// One warp owns one row of H <= 1024 values.  ln_row_store takes any
// H % 32 == 0, lane l holding columns l, l + 32, ...; ln_chunks_store takes
// H = 256 NV in vectors (see there).  Arithmetic, in the order of the
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

// ---- chunks of 8 columns: the vectors of the fixed-width path -------------
// Lane l of a warp holds 8 columns of each 256-column slab j of a row in
// v[j][0..7], as 8 / V runs of V contiguous columns: run h at column
// 256 j + 32 V h + V l.  Neighbouring lanes sit on neighbouring vectors, so
// a warp's load or store of one run covers 32 V contiguous columns.  V = 8
// moves 16 bytes of bf16 a lane; V = 4 16 bytes of f32 (8 of bf16, 4 of
// codes).  Every address is aligned to its vector.

template <int V>
__device__ __forceinline__ int run_col(int j, int h, int lane) {
  return 256 * j + 32 * V * h + V * lane;
}

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* v) {  // lower half first
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
// v holds values already rounded to bf16: the truncation is exact
__device__ __forceinline__ uint32_t pack_bf16x2(const float* v) {
  return (__float_as_uint(v[0]) >> 16) | (__float_as_uint(v[1]) & 0xffff0000u);
}

template <int V> __device__ __forceinline__ void load_run(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
  }
}
template <int V> __device__ __forceinline__ void load_run(const __nv_bfloat16* p, float* v) {
  if (V == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    unpack_bf16x2(a.x, v); unpack_bf16x2(a.y, v + 2);
    unpack_bf16x2(a.z, v + 4); unpack_bf16x2(a.w, v + 6);
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(a.x, v); unpack_bf16x2(a.y, v + 2);
  }
}
template <int V> __device__ __forceinline__ void store_run(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int V> __device__ __forceinline__ void store_run(__nv_bfloat16* p, const float* v) {
  if (V == 8)
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v), pack_bf16x2(v + 2), pack_bf16x2(v + 4), pack_bf16x2(v + 6));
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v), pack_bf16x2(v + 2));
}
__device__ __forceinline__ uint32_t pack_codes4(const float* v, float s) {
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (uint32_t)(uint8_t)quant_code(v[i], s) << (8 * i);
  return w;
}
template <int V> __device__ __forceinline__ void store_codes_run(int8_t* p, const float* v,
                                                                 float s) {
  if (V == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_codes4(v, s), pack_codes4(v + 4, s));
  else
    *reinterpret_cast<uint32_t*>(p) = pack_codes4(v, s);
}

// ln_row_store for a row held in NV slabs of runs of V (H = 256 NV): the
// same arithmetic, summed in the lane's order.  scale and bias are read a
// run at a time (from shared memory, in fused_ln.cu).
template <typename TO, bool QUANT, int NV, int V>
__device__ __forceinline__ void ln_chunks_store(float (&v)[NV][8], const float* scale,
                                                const float* bias, float eps, int lane,
                                                TO* __restrict__ y_row,
                                                int8_t* __restrict__ q_row,
                                                float* __restrict__ s_out) {
  constexpr float H = 256.0f * NV;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) s = __fadd_rn(s, v[j][e]);
  const float mean = __fdiv_rn(warp_sum(s), H);
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = __fsub_rn(v[j][e], mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), H), eps));
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int h = 0; h < 8 / V; ++h) {
      const int c = run_col<V>(j, h, lane);
      float sc[V], bi[V];
      load_run<V>(scale + c, sc);
      load_run<V>(bias + c, bi);
      float* vr = v[j] + V * h;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(vr[e], mean), inv), sc[e]), bi[e]);
        vr[e] = round_to<TO>(y);
        amax = fmaxf(amax, fabsf(vr[e]));
      }
      store_run<V>(y_row + c, vr);
    }
  }
  if (QUANT) {
    const float ys = fmaxf(warp_max(amax), 1e-30f);
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int h = 0; h < 8 / V; ++h)
        store_codes_run<V>(q_row + run_col<V>(j, h, lane), v[j] + V * h, ys);
    if (lane == 0) *s_out = ys;
  }
}

}  // namespace hc
