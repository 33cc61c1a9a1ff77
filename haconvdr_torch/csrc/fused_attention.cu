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
// float32: the 3xTF32 tensor-core forward of attention_tf32.cuh (one pass
// with an online softmax, each product split into three TF32 products on
// mma.sync m16n8k8; its head says why and what bounds it), without
// dropout or row stats: the same kernel body as row 11's f32 route.

#include "attention_tf32.cuh"

// dtype: 0 = float32, 1 = bfloat16.  mask is int32 [B, L].  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for shapes the kernel
// does not take; the Python wrapper checks those first).
extern "C" int hc_fused_attention(const void* qkv, const void* mask, void* out, int B,
                                  int L, int H, int num_heads, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || L > MAXL || num_heads <= 0 || H != num_heads * HD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_tf32_fwd<false>(qkv, mask, out, nullptr, B, L, H, num_heads, 0, 0, 0,
                                      0u, 1.0f, 0, s);
  if (dtype == 1)
    return (int)launch_tc_fwd<false>(qkv, mask, out, nullptr, B, L, H, num_heads, 0, 0, 0, 0u,
                                     1.0f, 0, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
