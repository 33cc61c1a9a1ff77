// The routed experts of a mixture-of-experts layer (DeepSeek-V2's
// DeepseekV2MoE.moe_infer): the router's softmax and greedy top-k, the
// tokens grouped by expert, then each expert's SwiGLU MLP over its own
// tokens, scaled by the route weight and summed into each token's row.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts.  It
// was added for the DeepSeek-V2 query tower (models/deepseek_v2.py), whose
// 26 expert layers hold ~80% of a token's operations.
//
// Three launches a layer, all sized from upper bounds the host knows
// without reading anything back (T tokens, k experts a token, E experts),
// so nothing in the forward waits for the device:
//
//   moe_route_kernel   one warp a token: softmax of its f32 logits [E]
//                      (exp(x - max) / sum), the k largest probabilities
//                      (ties to the lower expert), each times the scaling
//                      factor.  Assignment (token, expert) takes a slot
//                      of its expert by atomicAdd on counts[e] and writes
//                      (token, weight) at perm[e * cap + slot], cap = T (an
//                      expert gets each token at most once).  Slots are
//                      in no fixed order; a row's result does not depend
//                      on its slot.
//   moe_gemm_kernel<UP>   per expert e, over its counts[e] tokens: gate
//                      and up rows of w13[e] ([2I, H]: the I gate rows,
//                      then the I up rows) against the tokens' rows of x
//                      (gathered by index as they are copied), then
//                      h = bf16(bf16(silu(bf16(g))) * bf16(u)) written to
//                      a compact [sum(counts), I] buffer, expert after
//                      expert (PyTorch's rounding of the published
//                      act_fn(gate_proj(x)) * up_proj(x) in bf16).  Block
//                      (0, 0) also adds counts[] into the per-expert load
//                      accumulator and the largest count into the sum of
//                      the largest loads (int64, read off the forward).
//   moe_gemm_kernel<DOWN> per expert, h rows against w2[e] ([H, I]); each
//                      output rounded to bf16 (the expert's bf16 output),
//                      times the route weight in f32, and added into the
//                      token's f32 row of y [T, H] (atomics: a token's k
//                      terms arrive in no fixed order, so its f32 sum may
//                      differ in the last bit run to run).
//
// Both GEMMs share one body: 128 x 128 output tiles, 8 warps of 64 x 32,
// bf16 mma.sync m16n8k16 with f32 accumulators (64 a thread, two blocks an
// SM), k in steps of 64 through a three-stage ring of 16-byte cp.async
// copies (zeros past the expert's last row, past N and past K; 16-byte
// units of a 128-byte row swizzled by the row's low 3 bits so that
// ldmatrix reads 8 rows on 32 banks).  The grid is (N tiles, M tiles),
// the M tiles counted as ceil(T k / 128) + E, enough for any split of the
// T k rows over E experts; each block scans counts[] in shared memory to
// find its expert and rows, and blocks past the last tile return.  N tiles
// run fastest, so the blocks of one row tile run together and the row tile
// and the expert's weights stay in L2.  For UP, a tile's 128 B rows hold
// 64 outputs interleaved by eights (gate rows o..o+7, then up rows
// o..o+7), so each thread holds the gate and up sums of the same outputs.
//
// What bounds it: at the published widths (H 2048, I 1408, 64 experts,
// ~2,000 rows an expert at 126,000 assignments) the products, 2 x 3 x H x
// I operations an assignment at the bf16 tensor-core rate; the experts'
// weights (1.1 GB a layer) are read once at 3.35 TB/s in a sixth of that
// time.  mma.sync reaches well under the wgmma rate that the 989 TFLOP/s
// peak assumes; a wgmma + TMA body is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_E = 64;  // experts a layer (the routing kernel's two logits a lane)
constexpr int MAX_TOPK = 16;
constexpr int BM = 128, BN = 128, BK = 64, WM = 64, WN = 32, NT = 256, STAGES = 3, MINB = 2;
constexpr int MT = WM / 16, NTL = WN / 8;           // a warp's m16n8 tiles
constexpr int SMEM = STAGES * (BM + BN) * BK * 2;   // 96 KB
constexpr int UP = 0, DOWN = 1;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// routing
// ---------------------------------------------------------------------------

// one warp a token, PER logits a lane
constexpr int PER = MAX_E / 32;
__global__ void __launch_bounds__(256) moe_route_kernel(
    const float* __restrict__ logits, int T, int E, int K, float scale,
    int* __restrict__ counts, int* __restrict__ perm_tok, float* __restrict__ perm_w, int cap) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (t >= T) return;
  float v[PER];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < E ? logits[(size_t)t * E + e] : -INFINITY;
    mx = fmaxf(mx, v[i]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = lane + 32 * i < E ? expf(v[i] - mx) : 0.0f;
    sum += v[i];
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = lane + 32 * i < E ? v[i] / sum : -1.0f;
  for (int k = 0; k < K; ++k) {
    // the largest probability left, the lowest expert on a tie
    float best = -2.0f;
    int bi = 1 << 30;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (v[i] > best) best = v[i], bi = lane + 32 * i;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ob > best || (ob == best && oi < bi)) best = ob, bi = oi;
    }
    if (bi >= E) break;  // NaN logits: nothing left to take
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (lane + 32 * i == bi) v[i] = -1.0f;  // taken
    if (lane == 0) {
      const int slot = atomicAdd(&counts[bi], 1);
      perm_tok[(size_t)bi * cap + slot] = t;
      perm_w[(size_t)bi * cap + slot] = best * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// grouped GEMMs
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  // src-size 0 zero-fills the 16 bytes
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the element offset of 16-byte unit u of shared row r (BK bf16 a row)
__device__ __forceinline__ int swz(int r, int u) { return r * BK + 8 * (u ^ (r & 7)); }

// Weight row of tile row s (0 .. BN) for block column n0 (a multiple of
// BN).  DOWN: row n0 + s of w2[e] (valid below N).  UP: output
// o = n0 / 2 + 8 (s / 16) + s % 8 of the I outputs, its gate row o
// (s % 16 < 8) or its up row I + o (valid while o < I; N = 2 I).
template <int MODE>
__device__ __forceinline__ int weight_row(int s, int n0, int N, bool& ok) {
  if (MODE == DOWN) {
    ok = n0 + s < N;
    return n0 + s;
  }
  const int I = N / 2;
  const int o = n0 / 2 + 8 * (s / 16) + (s % 8);
  ok = o < I;
  return (s % 16 < 8) ? o : I + o;
}

template <int MODE>
__global__ void __launch_bounds__(NT, MINB) moe_gemm_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ W, const int* __restrict__ counts,
    const int* __restrict__ perm_tok, const float* __restrict__ perm_w, int cap, int E, int N,
    int K, void* __restrict__ out_, long long* __restrict__ loads,
    long long* __restrict__ max_sum) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int s_cnt[MAX_E], s_tile0[MAX_E + 1], s_row0[MAX_E + 1];
  __shared__ int s_tok[BM];
  __shared__ float s_w[BM];
  __shared__ int s_e;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < E; e += NT) s_cnt[e] = counts[e];
  if (tid == 0) s_e = -1;
  __syncthreads();
  if (warp == 0) {  // exclusive scans of the tiles and rows an expert, 8 experts a lane
    int c[8], tl = 0, rw = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane * 8 + i;
      c[i] = e < E ? s_cnt[e] : 0;
      tl += (c[i] + BM - 1) / BM;
      rw += c[i];
    }
    int tl_inc = tl, rw_inc = rw;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, tl_inc, o);
      const int b = __shfl_up_sync(0xffffffffu, rw_inc, o);
      if (lane >= o) tl_inc += a, rw_inc += b;
    }
    int tp = tl_inc - tl, rp = rw_inc - rw;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane * 8 + i;
      if (e < E) s_tile0[e] = tp, s_row0[e] = rp;
      tp += (c[i] + BM - 1) / BM;
      rp += c[i];
    }
    if (lane == 31) s_tile0[E] = tl_inc, s_row0[E] = rw_inc;
  }
  __syncthreads();
  if (MODE == UP && loads != nullptr && blockIdx.x == 0 && blockIdx.y == 0) {
    if (warp == 0) {
      int m = 0;
      for (int e = lane; e < E; e += 32) {
        loads[e] += s_cnt[e];
        m = max(m, s_cnt[e]);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) max_sum[0] += m;
    }
  }
  const int mt = blockIdx.y;
  if (mt >= s_tile0[E]) return;
  for (int e = tid; e < E; e += NT)
    if (s_tile0[e] <= mt && mt < s_tile0[e + 1]) s_e = e;
  __syncthreads();
  const int e = s_e;
  const int slot0 = (mt - s_tile0[e]) * BM;
  const int rows = min(BM, s_cnt[e] - slot0);
  const int crow0 = s_row0[e] + slot0;  // the tile's first row of the compact buffer
  for (int r = tid; r < BM; r += NT) {
    const bool live = r < rows;
    const size_t p = (size_t)e * cap + slot0 + r;
    s_tok[r] = live ? perm_tok[p] : 0;
    s_w[r] = live ? perm_w[p] : 0.0f;
  }
  __syncthreads();

  const int n0 = blockIdx.x * BN;
  const bf16* We = W + (size_t)e * N * K;
  bf16* As = smem;
  bf16* Bs = smem + STAGES * BM * BK;
  const int KT = (K + BK - 1) / BK;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + s * BM * BK;
    bf16* bs = Bs + s * BN * BK;
#pragma unroll
    for (int i = 0; i < BM * (BK / 8) / NT; ++i) {
      const int c = tid + i * NT, r = c / (BK / 8), u = c % (BK / 8);
      const bool full = r < rows && k0 + 8 * u < K;
      const size_t row = MODE == UP ? (size_t)s_tok[r] : (size_t)(crow0 + r);
      cp_async16(as + swz(r, u), full ? A + row * K + k0 + 8 * u : A, full);
    }
#pragma unroll
    for (int i = 0; i < BN * (BK / 8) / NT; ++i) {
      const int c = tid + i * NT, r = c / (BK / 8), u = c % (BK / 8);
      bool ok;
      const int wr = weight_row<MODE>(r, n0, N, ok);
      const bool full = ok && k0 + 8 * u < K;
      cp_async16(bs + swz(r, u), full ? We + (size_t)wr * K + k0 + 8 * u : We, full);
    }
  };

  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * BM * BK;
    const bf16* bs = Bs + (kt % STAGES) * BN * BK;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4], b[NTL][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * WM + 16 * i + (lane & 15);
        ldmatrix_x4(a[i], as + swz(r, 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int jp = 0; jp < NTL / 2; ++jp) {
        const int r = wn * WN + 16 * jp + (lane & 7) + 8 * (lane >> 4);
        uint32_t t[4];
        ldmatrix_x4(t, bs + swz(r, 2 * kk + ((lane >> 3) & 1)));
        b[2 * jp][0] = t[0];
        b[2 * jp][1] = t[1];
        b[2 * jp + 1][0] = t[2];
        b[2 * jp + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: acc[i][j][2 h + q] is tile row wm WM + 16 i + g + 8 h, tile
  // column wn WN + 8 j + 2 tig + q
  const int g = lane >> 2, tig = lane & 3;
  if (MODE == UP) {
    const int I = N / 2;
    bf16* out = static_cast<bf16*>(out_);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * WM + 16 * i + g + 8 * h;
        if (rl >= rows) continue;
#pragma unroll
        for (int j = 0; j < NTL; j += 2) {
          const int o = (n0 + wn * WN) / 2 + 8 * (j / 2) + 2 * tig;
          if (o >= I) continue;
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float gt = round_bf16(acc[i][j][2 * h + q]);
            const float up = round_bf16(acc[i][j + 1][2 * h + q]);
            const float act = round_bf16(gt / (1.0f + expf(-gt)));
            v[q] = act * up;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(crow0 + rl) * I + o) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
  } else {
    float* y = static_cast<float*>(out_);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * WM + 16 * i + g + 8 * h;
        if (rl >= rows) continue;
        const float w = s_w[rl];
        float* yr = y + (size_t)s_tok[rl] * N;
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          const int c = n0 + wn * WN + 8 * j + 2 * tig;
          if (c >= N) continue;
          const float2 v = make_float2(w * round_bf16(acc[i][j][2 * h]),
                                       w * round_bf16(acc[i][j][2 * h + 1]));
          atomicAdd(reinterpret_cast<float2*>(yr + c), v);
        }
      }
  }
}

template <int MODE>
cudaError_t launch_gemm(const void* A, const void* W, const int* counts, const int* perm_tok,
                        const float* perm_w, int cap, int E, int N, int K, int tiles, void* out,
                        long long* loads, long long* max_sum, cudaStream_t s) {
  static bool configured = false;  // the shared-memory opt-in, once a process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, tiles);
  moe_gemm_kernel<MODE><<<grid, NT, SMEM, s>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(W), counts, perm_tok, perm_w, cap, E,
      N, K, out, loads, max_sum);
  return cudaGetLastError();
}

}  // namespace

// logits f32 [T, E]; counts int32 [E] (zeroed here); perm_tok int32 and
// perm_w f32 [E, cap] (cap >= T).  E <= 64, 1 <= K <= min(16, E).
extern "C" int hc_moe_route(const void* logits, int T, int E, int K, float scale, void* counts,
                            void* perm_tok, void* perm_w, int cap, void* stream) {
  if (T <= 0 || E <= 0 || E > MAX_E || K <= 0 || K > MAX_TOPK || K > E || cap < T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * E, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + 7) / 8), block(256);
  const float* l = static_cast<const float*>(logits);
  int* c = static_cast<int*>(counts);
  int* pt = static_cast<int*>(perm_tok);
  float* pw = static_cast<float*>(perm_w);
  moe_route_kernel<<<grid, block, 0, s>>>(l, T, E, K, scale, c, pt, pw, cap);
  return (int)cudaGetLastError();
}

// mode 0 (UP): A = x bf16 [T, K = H] (rows gathered through perm_tok),
// W = w13 bf16 [E, N = 2 I, K], out = h bf16 [sum(counts), I]; loads int64
// [E] and max_sum int64 [1] accumulate (or NULL).  mode 1 (DOWN): A = h
// bf16 [sum(counts), K = I], W = w2 bf16 [E, N = H, K], out = y f32 [T, N]
// (added into).  tiles: M tiles of the grid, >= ceil(T k / 128) + E.
// K % 8 == 0; N even (UP: N % 16 == 0).
extern "C" int hc_moe_gemm(int mode, const void* A, const void* W, const void* counts,
                           const void* perm_tok, const void* perm_w, int cap, int E, int N, int K,
                           int tiles, void* out, void* loads, void* max_sum, void* stream) {
  if (E <= 0 || E > MAX_E || N <= 0 || K <= 0 || K % 8 != 0 || N % 2 != 0 || tiles <= 0 ||
      tiles > 65535 || (mode == UP && N % 16 != 0) || (mode != UP && mode != DOWN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  const int* pt = static_cast<const int*>(perm_tok);
  const float* pw = static_cast<const float*>(perm_w);
  if (mode == UP)
    return (int)launch_gemm<UP>(A, W, c, pt, pw, cap, E, N, K, tiles, out,
                                static_cast<long long*>(loads), static_cast<long long*>(max_sum),
                                s);
  return (int)launch_gemm<DOWN>(A, W, c, pt, pw, cap, E, N, K, tiles, out, nullptr, nullptr, s);
}
