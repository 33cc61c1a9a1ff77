// The int8 dense of an inference tower, and the per-token int8 codes of its
// input.
//
// Replaces: no TPU kernel.  The JAX package leaves the int8 dense to XLA
// (haconvdr_tpu/models/encoder.py:114-139, _dense: the dynamic codes of x,
// the int8 product with int32 sums, then the dequantization and the bias).
// The port had composed it from torch._int_mm and PyTorch elementwise ops
// (ops/int8_dense.py:int8_dense_plain, the plain twin); those passes over
// the [M, N] int32 product moved ~38 bytes an output element, against the
// 2 of the bf16 the next op reads.
//
// Same math, op for op (bit for bit the twin):
//   xq, xs = per-row int8 codes of x (ln_quant.cuh:quant_code)   [row_codes]
//   y = (xq . W^T)_int32 -> f32 * (xs / 127) * kernel_scale + bias -> TO
// __int2float_rn, __fdiv_rn(xs, 127), two __fmul_rn and one __fadd_rn, in
// that order (no FMA contraction), then __float2bfloat16_rn for a bf16 out:
// fused_mlp.cu's mlp_gemm epilogue, on another tile.
//
// What bounds it on the H100: at [53,248, 768] x [2304, 768]^T (the encode
// cell's QKV dense) 0.188 Top (0.095 ms at 1,979 Top/s) against 0.29 GB of
// bytes (the codes in, the bf16 y out: 0.086 ms at 3.35 TB/s): the products
// and the store of y weigh about the same.  So the epilogue works from the
// accumulator registers and writes y once, in its final type.
//
// Design (int8_dense_kernel): output tiles of BM x 192, BM = 64 a consumer
// warpgroup (one or two), dealt to a persistent grid of one block an SM.  A producer warp keeps a ring of STAGES k-chunks of
// 128 bytes of the A rows and the W rows filled by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, rows and columns past M, N and
// K zero-filled by the copy engine) against one "full" mbarrier a stage,
// running on into the block's next tile while the consumers finish one.
// Each consumer warpgroup runs wgmma m64n192k32 s8.s8 -> s32 (four a chunk)
// on its 64 rows straight from shared memory and arrives on the stage's
// "empty" barrier once the products that read it have retired.  K = 768
// at every ANCE dense but the f32-carry tower's down dense (3,072): 6-24
// chunks.  The epilogue dequantizes from the accumulator registers into a
// warp's staging rows in shared memory, 64 columns at a time, and stores
// each row's run as whole 16-byte vectors: stored straight from the
// fragment (8 rows x 16 bytes a warp store), y left at 0.75 TB/s and the
// dense took 0.35 ms at the QKV shape; staged, 0.20 (the products alone
// 0.13; probes/probe_torch_int8_dense.py --variants).  BN 192 divides every
// ANCE width (768, 2,304, 3,072, a tp rank's 576, 1,152 and 1,536); any
// other N % 64 == 0 masks the last tile's 64-column runs.  The host picks
// 128 or 64 rows a tile (hc_int8_dense).  Exact: |sum| <= K 127^2 < 2^31
// for K <= 131,072.
//
// row_codes_kernel: one warp a row, two passes over the row (its maximum,
// then its codes; the second read hits L1), 16-byte loads: bytes bound,
// 3 bytes an element from bf16, 5 from f32.

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_quant.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 128;  // k bytes a stage: one 128-byte swizzle row
constexpr int BN = 192;  // columns a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// a wait that never completes (a lost copy) traps, a launch error, rather
// than holding the card: 2^26 tries are seconds, a real wait microseconds
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// the box of the map at (c0 k bytes, c1 rows) into shared dst; completes
// its bytes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows with the 128-byte
// swizzle, 8-row groups 1,024 bytes apart (the layout TMA writes); the
// start advances by 32 bytes a k32 step inside the swizzled row
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A . B^T for one m64n192k32 step: A 64 rows and B 192 rows of 32
// bytes (s8 in, s32 sums); scale_d 0 overwrites d
#define HC_ACC8(i)                                                                         \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

__device__ __forceinline__ void wgmma_s8(int (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : HC_ACC8(0), HC_ACC8(8), HC_ACC8(16), HC_ACC8(24), HC_ACC8(32), HC_ACC8(40),
        HC_ACC8(48), HC_ACC8(56), HC_ACC8(64), HC_ACC8(72), HC_ACC8(80), HC_ACC8(88)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef HC_ACC8

__device__ __forceinline__ float dequant(int acc, float xs_127, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs_127), s), b);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int CWG, int STAGES, typename TO>
struct Tile {
  static constexpr int BM = 64 * CWG;
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK, STAGE = A_BYTES + B_BYTES;
  static constexpr int CT = 128 * CWG;  // the consumer warpgroups' threads
  static constexpr int NT = CT + 32;    // then the producer warp
  // a consumer warp's staging rows of y: 16 rows of 64 columns, each padded
  // by 16 bytes (the fragment's writes then miss each other's banks)
  static constexpr int RS = 64 + 16 / (int)sizeof(TO);
  static constexpr int OUT_WARP = 16 * RS;  // elements
  // the ring (aligned to 1,024 bytes by hand: the slack), 2 STAGES mbarriers,
  // two tiles' column scales and biases (float [2][2][BN]), the staging rows
  static constexpr int SMEM =
      1024 + STAGES * STAGE + 16 * STAGES + 16 * BN + 4 * CWG * OUT_WARP * (int)sizeof(TO);
  static_assert(STAGE % 1024 == 0, "tile shape");
};

// y [M, N] (TO) = dequant((A [M, K] . W [N, K]^T)_int32), BM x BN tiles
// (the column tile fastest) dealt to a persistent grid: block b takes tiles
// b, b + gridDim.x, ...  The producer runs on into the next tile's chunks
// while the consumers finish a tile, so a tile's epilogue overlaps the
// next one's copies.
template <int CWG, int STAGES, typename TO>
__global__ void __launch_bounds__(Tile<CWG, STAGES, TO>::NT, 1)
    int8_dense_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w, int M, int N, int K,
                      const float* __restrict__ xs, const float* __restrict__ ks,
                      const float* __restrict__ bias, TO* __restrict__ y) {
  using T = Tile<CWG, STAGES, TO>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * T::STAGE;  // full[s] at 8 s, empty[s] at 8 (STAGES + s)
  float* cols = reinterpret_cast<float*>(smem_raw + (bars + 16 * STAGES - smem_u32(smem_raw)));
  TO* out_rows = reinterpret_cast<TO*>(cols + 4 * BN);
  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + T::BM - 1) / T::BM);
  const int KT = (K + BK - 1) / BK;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 4 * CWG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= T::CT) {  // the producer warp: one lane issues the copies
    if (tid == T::CT) {
      int it = 0;  // the block's chunk count, across its tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = (t % tiles_n) * BN, m0 = (t / tiles_n) * T::BM;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) - 1) & 1);
          const uint32_t full = bars + 8 * s, a = ring + s * T::STAGE;
          mbar_expect_tx(full, T::STAGE);
          tma_load(a, &map_a, full, kt * BK, m0);
          tma_load(a + T::A_BYTES, &map_w, full, kt * BK, n0);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  int it = 0;
  for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
    const int n0 = (t % tiles_n) * BN, m0 = (t / tiles_n) * T::BM;
    // the tile's column scales and biases, read while the products run
    float* cb = cols + (i & 1) * 2 * BN;
    for (int c = tid; c < BN; c += T::CT) {
      const bool in = n0 + c < N;
      cb[c] = in ? ks[n0 + c] : 0.0f;
      cb[BN + c] = in ? bias[n0 + c] : 0.0f;
    }
    // acc[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h of the warpgroup's
    // 64, column 8 j + 2 (lane % 4) + e of the tile
    const int r0 = m0 + 64 * wg + 16 * warp + lane / 4;
    const float xs0 = r0 < M ? xs[r0] : 0.0f, xs1 = r0 + 8 < M ? xs[r0 + 8] : 0.0f;
    int acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(bars + 8 * s, (it / STAGES) & 1);
      const uint32_t a = ring + s * T::STAGE;
      const uint64_t da = desc_sw128(a + wg * 64 * BK), db = desc_sw128(a + T::A_BYTES);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k) wgmma_s8(acc, da + 2 * k, db + 2 * k, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products have retired: free its stage
      fence_regs(acc);
      if (kt > 0 && lane == 0) mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));  // the tile's last
    asm volatile("bar.sync 1, %0;\n" ::"n"(T::CT) : "memory");  // the columns are in

    // y, 64 columns at a time, through the warp's staging rows: the
    // fragment's pairs in, then each row's 64 columns out as whole 16-byte
    // vectors (a row's 128 or 256 bytes from adjacent lanes)
    const float s_127[2] = {__fdiv_rn(xs0, 127.0f), __fdiv_rn(xs1, 127.0f)};
    TO* rows = out_rows + (4 * wg + warp) * T::OUT_WARP;
    const int wr0 = m0 + 64 * wg + 16 * warp;  // the warp's first row
    constexpr int VR = 64 * (int)sizeof(TO) / 16, VE = 16 / (int)sizeof(TO);  // a row's vectors
#pragma unroll
    for (int cc = 0; cc < BN / 64; ++cc) {
      if (n0 + 64 * cc < N) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * cc + jj, cl = 8 * j + 2 * (lane % 4);
          const float2 sc = *reinterpret_cast<const float2*>(cb + cl);
          const float2 bi = *reinterpret_cast<const float2*>(cb + BN + cl);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store_pair(rows + (lane / 4 + 8 * h) * T::RS + 8 * jj + 2 * (lane % 4),
                       dequant(acc[4 * j + 2 * h], s_127[h], sc.x, bi.x),
                       dequant(acc[4 * j + 2 * h + 1], s_127[h], sc.y, bi.y));
        }
        __syncwarp();
#pragma unroll
        for (int v = lane; v < 16 * VR; v += 32) {
          const int rr = v / VR, cv = v % VR;
          if (wr0 + rr < M)
            *reinterpret_cast<uint4*>(y + (size_t)(wr0 + rr) * N + n0 + 64 * cc + VE * cv) =
                *reinterpret_cast<const uint4*>(rows + rr * T::RS + VE * cv);
        }
        __syncwarp();
      }
    }
  }
}

// xq [rows, K], xs [rows]: the per-row int8 codes of x (quantize_rows);
// one warp a row, 16 bytes a lane a step; K % 8 == 0, rows 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(256)
    row_codes_kernel(const T* __restrict__ x, int rows, int K, int8_t* __restrict__ xq,
                     float* __restrict__ xs) {
  constexpr int V = 16 / sizeof(T);
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* row = x + r * K;
  float v[V];
  float amax = 0.0f;
  for (int c = V * lane; c < K; c += 32 * V) {
    hc::load_run<V>(row + c, v);
#pragma unroll
    for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  const float s = fmaxf(hc::warp_max(amax), 1e-30f);
  for (int c = V * lane; c < K; c += 32 * V) {
    hc::load_run<V>(row + c, v);
    hc::store_codes_run<V>(xq + r * K + c, v, s);
  }
  if (lane == 0) xs[r] = s;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime (no libcuda link)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// rows x inner int8 bytes, row-major, boxes of box_rows x 128 bytes
bool make_map(CUtensorMap* map, const void* base, int inner, int rows, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CWG, int STAGES, typename TO>
cudaError_t launch_dense(const void* xq, const void* w, int M, int N, int K, const float* xs,
                         const float* ks, const float* bias, void* y, int sms,
                         cudaStream_t stream) {
  using T = Tile<CWG, STAGES, TO>;
  CUtensorMap ma, mw;
  if (!make_map(&ma, xq, K, M, T::BM) || !make_map(&mw, w, K, N, BN))
    return cudaErrorInvalidValue;
  auto kernel = int8_dense_kernel<CWG, STAGES, TO>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + T::BM - 1) / T::BM);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, T::NT, T::SMEM, stream>>>(ma, mw, M, N, K, xs, ks, bias,
                                           static_cast<TO*>(y));
  return cudaGetLastError();
}

// 128 rows a tile (two consumer warpgroups) unless such tiles would not
// fill the SMs once, then 64 (one).  (NVIDIA H100 80GB HBM3,
// probes/probe_torch_int8_dense.py: 128 rows led 64 by 17-25% down to
// 9,000 rows, 64 led at 40; BN 192 led 256 by 1-6% at 53,248 rows.)
template <typename TO>
cudaError_t dispatch(const void* xq, const void* w, int M, int N, int K, const float* xs,
                     const float* ks, const float* bias, void* y, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles128 = (long long)((M + 127) / 128) * ((N + BN - 1) / BN);
  return tiles128 >= sms ? launch_dense<2, 4, TO>(xq, w, M, N, K, xs, ks, bias, y, sms, s)
                         : launch_dense<1, 5, TO>(xq, w, M, N, K, xs, ks, bias, y, sms, s);
}

}  // namespace

// xq int8 [M, K], xs float32 [M] (the row scales), w int8 [N, K]
// ([out, in]), ks, bias float32 [N] -> y [M, N], float32 (out_dtype 0) or
// bfloat16 (1).  Takes M >= 1, K % 64 == 0 with 64 <= K <= 131,072,
// N % 64 == 0, xq and w 16-byte aligned; returns cudaErrorInvalidValue
// otherwise (the wrapper checks first).
extern "C" int hc_int8_dense(const void* xq, const void* xs, const void* w, const void* ks,
                             const void* bias, int M, int N, int K, int out_dtype, void* y,
                             void* stream) {
  if (M <= 0 || K < 64 || K % 64 || K > 131072 || N < 64 || N % 64 ||
      (reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(w)) % 16 ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xsf = static_cast<const float*>(xs);
  const float* ksf = static_cast<const float*>(ks);
  const float* bf = static_cast<const float*>(bias);
  const cudaError_t err =
      out_dtype == 0 ? dispatch<float>(xq, w, M, N, K, xsf, ksf, bf, y, s)
                     : dispatch<bf16>(xq, w, M, N, K, xsf, ksf, bf, y, s);
  return (int)err;
}

// x [rows, K] float32 (x_dtype 0) or bfloat16 (1) -> xq int8 [rows, K], xs
// float32 [rows].  K % 64 == 0, x 16-byte aligned.
extern "C" int hc_row_codes(const void* x, int rows, int K, int x_dtype, void* xq, void* xs,
                            void* stream) {
  if (rows <= 0 || K < 64 || K % 64 || reinterpret_cast<uintptr_t>(x) % 16 ||
      (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  if (x_dtype == 0)
    row_codes_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), rows, K,
                                                   static_cast<int8_t*>(xq),
                                                   static_cast<float*>(xs));
  else
    row_codes_kernel<bf16><<<blocks, 256, 0, s>>>(static_cast<const bf16*>(x), rows, K,
                                                  static_cast<int8_t*>(xq),
                                                  static_cast<float*>(xs));
  return (int)cudaGetLastError();
}
