// Inference attention straight from the fused QKV projection.
//
// Replaces: haconvdr_tpu/ops/fused_attention.py:30 _attn_kernel (Pallas,
// reached through fused_attention_qkv).  Same math: per batch row and
// head, softmax(Q K^T * scale + bias) V with Q, K, V the column slices
// [h*d, H + h*d, 2H + h*d] of qkv [B, L, 3H]; bias = (1 - mask) * -1e9;
// f32 scores and softmax; P cast to V's dtype before P V; f32 accumulation;
// the context is written as [B, L, H] (no head transposes on either side).
//
// What bounds it on the H100: at L = 512, d = 64 the work per (b, h) is
// 2 * 2 * L^2 * d = 67 MFLOP against 4 * L * d elements of traffic, so it
// is compute-bound; this first version runs on the CUDA cores (FMA), not
// the tensor cores, and is bounded by the f32 FMA rate and shared-memory
// bandwidth.  One head's K and V in f32 at L = 512 is 256 KB, more than the
// 227 KB a block may hold, so K and V are never resident whole.
//
// Design: one block per (32-query tile, head, batch row).  The block keeps
// its 32 x L score rows in shared memory (64 KB at L = 512) and streams K,
// then V, through one 64-key tile.  Holding whole score rows (instead of an
// online softmax) reproduces the reference exactly: the softmax sees every
// score of the row, and P is normalised before it is rounded to V's dtype.
// ~93 KB of shared memory per block lets two blocks share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HD = 64;   // head dim taken by the kernel
constexpr int QT = 32;   // query rows per block
constexpr int KT = 64;   // keys per K / V tile
constexpr int NT = 256;  // threads per block (16 x 16)
constexpr int MAXL = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// value rounded to T and widened back (P's cast to V's dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(NT) attn_kernel(const T* __restrict__ qkv,
                                                  const int* __restrict__ mask,
                                                  T* __restrict__ out, int L, int H,
                                                  float scale) {
  extern __shared__ float smem[];
  const int SP = L + 1;                 // score row stride (odd: no bank conflicts)
  float* S = smem;                      // [QT][SP]   scores, then probabilities
  float* Qs = S + QT * SP;              // [QT][HD+1] query tile
  float* KV = Qs + QT * (HD + 1);       // [KT][HD+1] current K or V tile
  float* bias = KV + KT * (HD + 1);     // [L]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_stride = 3 * (size_t)H;
  const T* base = qkv + (size_t)b * L * row_stride;

  for (int j = tid; j < L; j += NT)
    bias[j] = (1.0f - (float)mask[(size_t)b * L + j]) * -1e9f;
  for (int e = tid; e < QT * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int qr = q0 + r;
    Qs[r * (HD + 1) + d] = qr < L ? to_f(base[qr * row_stride + h * HD + d]) : 0.0f;
  }

  // ---- scores: S[r][j] = (q_r . k_j) * scale + bias_j
  const int n_kt = (L + KT - 1) / KT;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // previous tile fully consumed (and Qs / bias written)
    for (int e = tid; e < KT * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int key = kt * KT + r;
      KV[r * (HD + 1) + d] = key < L ? to_f(base[key * row_stride + H + h * HD + d]) : 0.0f;
    }
    __syncthreads();
    float acc[2][4] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[2], kc[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) qa[a] = Qs[(ty + 16 * a) * (HD + 1) + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = KV[(tx + 16 * c) * (HD + 1) + d];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(qa[a], kc[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kt * KT + tx + 16 * c;
        if (key < L) S[(ty + 16 * a) * SP + key] = acc[a][c] * scale + bias[key];
      }
  }
  __syncthreads();

  // ---- softmax per row (one warp per 4 rows), f32; P rounded to V's dtype
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < QT; r += NT / 32) {
    float* row = S + r * SP;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < L; j += 32) row[j] = round_to<T>(row[j] / sum);
  }

  // ---- context: O[r][c] = sum_j P[r][j] v_j[c]
  float acc[2][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // probabilities written / previous V tile consumed
    for (int e = tid; e < KT * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int key = kt * KT + r;
      KV[r * (HD + 1) + d] =
          key < L ? to_f(base[key * row_stride + 2 * H + h * HD + d]) : 0.0f;
    }
    __syncthreads();
    const int nk = min(KT, L - kt * KT);
    for (int j = 0; j < nk; ++j) {
      float pa[2], vc[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) pa[a] = S[(ty + 16 * a) * SP + kt * KT + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) vc[c] = KV[j * (HD + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(pa[a], vc[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int qr = q0 + ty + 16 * a;
    if (qr >= L) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[((size_t)b * L + qr) * H + h * HD + tx + 16 * c] = from_f<T>(acc[a][c]);
  }
}

size_t smem_bytes(int L) {
  return sizeof(float) * ((size_t)QT * (L + 1) + QT * (HD + 1) + KT * (HD + 1) + L);
}

template <typename T>
cudaError_t launch(const void* qkv, const void* mask, void* out, int B, int L, int H,
                   int num_heads, cudaStream_t stream) {
  const size_t smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + QT - 1) / QT, num_heads, B);
  const float scale = 1.0f / sqrtf((float)HD);
  attn_kernel<T><<<grid, NT, smem, stream>>>(static_cast<const T*>(qkv),
                                             static_cast<const int*>(mask),
                                             static_cast<T*>(out), L, H, scale);
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
  if (dtype == 0) return (int)launch<float>(qkv, mask, out, B, L, H, num_heads, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(qkv, mask, out, B, L, H, num_heads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
