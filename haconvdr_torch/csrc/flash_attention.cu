// Differentiable attention with hashed dropout: forward and backward.
//
// Replaces: haconvdr_tpu/ops/flash_attention.py:105 _fwd_kernel and :174
// _bwd_kernel (Pallas, reached through flash_attention_qkv_vjp, the
// trained query tower's attention).  Same math: per batch row b and head h,
// with Q, K, V the column slices [h*d, H + h*d, 2H + h*d] of qkv [B, L, 3H]:
//   forward   S = Q K^T * scale + bias, P = softmax(S) (f32),
//             Pt = keep ? P / (1 - rate) : 0, O = round(Pt) V;
//   backward  dV = round(Pt)^T dO, dPt = dO V^T, dP = keep ? dPt / (1 - rate)
//             : 0, D = rowsum(dP * P), dS = P (dP - D),
//             dQ = round(dS) K * scale, dK = round(dS)^T Q * scale,
// where round() is the cast to the operand dtype and every sum is f32.  The
// keep mask is the JAX package's counter-based hash (murmur3 fmix32 twice
// over the element counter r * L + c of the (b, h) tile, seeded per
// (b, h)), so the same seed words give JAX's mask bit for bit and the
// backward regenerates it: no mask is stored.  A launch over rows a:b of a
// batch cut over data-parallel slots passes row0 = a, so each tile is
// seeded by its row's index in the whole batch (the seed words hash the
// tile index non-linearly: s1 = seed1 ^ ((idx + 1) * 0x85EBCA6B), so no
// change of the words could stand in for the offset).
//
// Residuals: JAX keeps only the primal inputs.  The forward here also
// saves each query row's softmax max and sum (float2 [B, nh, L]), so the
// backward rebuilds P from them instead of rerunning the row reductions
// (the bf16 route with the forward's exact operations: P in its backward
// equals the forward's bit for bit).
//
// What bounds it on the H100: at the reference geometry (B 64, L 512, 12
// heads, d 64) the forward does 4 B L^2 H = 51.5 GFLOP against ~0.2 GB of
// bf16 qkv and output (a bound of ~0.06 ms in bf16, bytes-bound at
// tensor-core rates), the backward ~2.5x those FLOPs; the f32 route's
// bounds are below.
//
// Design, one kernel body per route and direction, each with its own head
// note:
// - bf16 forward: the tensor-core forward of attention_tc.cuh (two passes
//   so that P is normalised before it is rounded), with the dropout mask
//   and the row stats on.
// - bf16 backward: attention_tc_bwd.cuh (all five products on mma.sync
//   m16n8k16; a dQ kernel that also sums D, then a dK/dV kernel).
// - f32 forward: the 3xTF32 forward of attention_tf32.cuh, row 1's f32
//   kernel with the dropout and the row stats on (one pass, online softmax:
//   f32 P is not rounded; the keep mask applied to the unnormalised
//   expf(s - m), the row sum over the undropped values).
// - f32 backward: attention_tf32_bwd.cuh, the bf16 backward's two launches
//   with every product in 3xTF32 (tf32_bwd_dq, then tf32_bwd_dkdv).
// f32 bounds and occupancy on the H100 at the reference geometry (B 64,
// L 512, 12 heads): each product is three TF32 products at 495 TFLOP/s,
// so both directions are bound by operations (forward ~0.31 ms for 51.5
// GFLOP, backward ~0.78 ms for ~129 GFLOP, the backward's recomputation not
// counted); all three f32 kernels run two blocks of four warps an SM
// (~90, ~113 and ~94 KB of shared memory).  What bounds them in practice is
// mma.sync's dispatch rate (three a product), the operand splits (three
// ALU operations an element at each use) and the per-element softmax and
// hash work.
// The f32 route rounds nothing to an operand dtype, so the backward's P =
// expf(s - m) / l from the saved stats differs from the forward's online
// softmax only by rounding: the route is held to the twins within 1e-5, not
// bit for bit between directions (the bf16 route's P is bit-equal).
// No atomics in either route: each output element has one writer, and the
// run is deterministic.

#include "attention_tc_bwd.cuh"
#include "attention_tf32_bwd.cuh"

namespace {

bool bad_shape(int B, int L, int H, int nh) {
  return B <= 0 || L <= 0 || L > MAXL || nh <= 0 || H != nh * HD;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mask is int32 [B, L]; stats float2
// [B, nh, L] (row max, row sum).  drop_on 0 ignores seed0, seed1, thresh,
// inv and row0.  row0 is the first row's index in the whole batch: row b
// draws the mask of tile (row0 + b) * nh + h, so a slice of rows a:b
// launched with row0 = a draws rows a:b of the whole batch's masks.
// Returns the cudaError_t of the launch.
extern "C" int hc_flash_fwd(const void* qkv, const void* mask, void* out, void* stats, int B,
                            int L, int H, int nh, int dtype, int drop_on, int seed0, int seed1,
                            unsigned thresh, float inv, int row0, void* stream) {
  if (bad_shape(B, L, H, nh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)  // the 3xTF32 forward of attention_tf32.cuh
    return (int)launch_tf32_fwd<true>(qkv, mask, out, stats, B, L, H, nh, drop_on, seed0,
                                      seed1, thresh, inv, row0, s);
  if (dtype == 1)  // the tensor-core forward of attention_tc.cuh
    return (int)launch_tc_fwd<true>(qkv, mask, out, stats, B, L, H, nh, drop_on, seed0, seed1,
                                    thresh, inv, row0, s);
  return (int)cudaErrorInvalidValue;
}

// dout [B, L, H] in qkv's dtype; dvec float [B, nh, L] scratch; dqkv
// [B, L, 3H] in qkv's dtype, every element written; row0 as the forward's.
extern "C" int hc_flash_bwd(const void* qkv, const void* mask, const void* dout,
                            const void* stats, void* dvec, void* dqkv, int B, int L, int H,
                            int nh, int dtype, int drop_on, int seed0, int seed1,
                            unsigned thresh, float inv, int row0, void* stream) {
  if (bad_shape(B, L, H, nh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)  // the 3xTF32 backward of attention_tf32_bwd.cuh
    return (int)launch_tf32_bwd(qkv, mask, dout, stats, dvec, dqkv, B, L, H, nh, drop_on, seed0,
                                seed1, thresh, inv, row0, s);
  if (dtype == 1)  // the tensor-core backward of attention_tc_bwd.cuh
    return (int)launch_tc_bwd(qkv, mask, dout, stats, dvec, dqkv, B, L, H, nh, drop_on, seed0,
                              seed1, thresh, inv, row0, s);
  return (int)cudaErrorInvalidValue;
}
