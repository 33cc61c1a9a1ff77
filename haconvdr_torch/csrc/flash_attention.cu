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
// backward regenerates it: no mask is stored.
//
// Residuals: JAX keeps only the primal inputs.  The forward here also
// saves each query row's softmax max and sum (float2 [B, nh, L]), so the
// backward rebuilds P with the forward's exact operations instead of
// rerunning the row reductions: P in the backward equals the forward's bit
// for bit.
//
// What bounds it on the H100: at the reference geometry (B 64, L 512, 12
// heads, d 64, bf16) the forward does 4 B L^2 H = 51.5 GFLOP against ~0.2 GB
// of qkv and output (a bound of ~0.06 ms, bytes-bound at tensor-core
// rates), the backward ~2.5x those FLOPs.
//
// Design:
// - bf16 forward: the tensor-core forward of attention_tc.cuh (its head
//   says what bounds it, why it takes two passes to normalise P before it
//   rounds it, and why skipping all-masked key tiles is exact), with the
//   dropout mask and the row stats on.
// - bf16 backward: the tensor-core backward of attention_tc_bwd.cuh (all
//   five products on mma.sync; a dQ kernel that also sums D, then a dK/dV
//   kernel; its head says what bounds it).
// - f32 forward and backward (not yet redesigned): on the CUDA cores
//   (fmaf), as ported.  Their agreement with the twin is 1e-5, and plain
//   TF32 keeps about 3 digits; the 3xTF32 split of fused_attention.cu's
//   f32 route would keep it, and is the next step for these kernels.
//   Forward: one block per (32-query tile, head, batch row) keeps its 32 x L
//   score rows in shared memory and streams K, then V, through one 64-key
//   tile, so the softmax sees whole rows and P is normalised (and dropped)
//   before P V.  Backward, two launches on one stream: a dQ kernel, one
//   block per (32-query tile, head, batch row), streams K and V tiles, keeps
//   the block's P and dP rows in shared memory (2 x 32 x L f32), reduces D
//   per row (written out for the second kernel), forms dS in place and
//   streams K again for dQ; a dK/dV kernel, one block per (32-key tile,
//   head, batch row), streams 64-query tiles of Q and dO, rebuilds P and dP
//   for its keys from the saved row stats and D, and accumulates dK and dV
//   in registers.
// No atomics in either route: each output element has one writer, and the
// run is deterministic.

#include "attention_tc_bwd.cuh"

namespace {

constexpr int HP = HD + 1;
// the f32 kernels
constexpr int QT = 32;   // query rows per block (forward, dQ)
constexpr int KT = 64;   // keys per streamed K / V tile (forward, dQ)
constexpr int CT = 32;   // keys per block (dK / dV)
constexpr int RT = 64;   // query rows per streamed Q / dO tile (dK / dV)
constexpr int NT = 256;  // threads per block (16 x 16)

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) fwd_kernel(const float* __restrict__ qkv,
                                                 const int* __restrict__ mask,
                                                 float* __restrict__ out,
                                                 float2* __restrict__ stats, int L, int H,
                                                 int nh, float scale, int drop_on, int seed0,
                                                 int seed1, unsigned thresh, float inv) {
  extern __shared__ __align__(16) float smem[];
  const int SP = L + 1;
  float* S = smem;                 // [QT][SP] scores, then probabilities
  float* Qs = S + QT * SP;         // [QT][HP]
  float* KV = Qs + QT * HP;        // [KT][HP] current K or V tile
  float* bias = KV + KT * HP;      // [L]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = 3 * (size_t)H;
  const float* base = qkv + (size_t)b * L * rs;
  const Drop dr(drop_on, seed0, seed1, thresh, inv, b * nh + h);

  for (int j = tid; j < L; j += NT) bias[j] = mask_bias(mask, b, L, j);
  for (int e = tid; e < QT * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int qr = q0 + r;
    Qs[r * HP + d] = qr < L ? base[qr * rs + h * HD + d] : 0.0f;
  }

  const int n_kt = (L + KT - 1) / KT;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    for (int e = tid; e < KT * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int key = kt * KT + r;
      KV[r * HP + d] = key < L ? base[key * rs + H + h * HD + d] : 0.0f;
    }
    __syncthreads();
    float acc[2][4] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[2], kc[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) qa[a] = Qs[(ty + 16 * a) * HP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = KV[(tx + 16 * c) * HP + d];
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
        if (key < L) S[(ty + 16 * a) * SP + key] = score(acc[a][c], scale, bias[key]);
      }
  }
  __syncthreads();

  // softmax per row (one warp per 4 rows); dropout
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
    const int qr = q0 + r;
    if (lane == 0 && qr < L) stats[((size_t)b * nh + h) * L + qr] = make_float2(m, sum);
    for (int j = lane; j < L; j += 32) row[j] = dr.apply(row[j] / sum, qr, j, L);
  }

  float acc[2][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    for (int e = tid; e < KT * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int key = kt * KT + r;
      KV[r * HP + d] = key < L ? base[key * rs + 2 * H + h * HD + d] : 0.0f;
    }
    __syncthreads();
    const int nk = min(KT, L - kt * KT);
    for (int j = 0; j < nk; ++j) {
      float pa[2], vc[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) pa[a] = S[(ty + 16 * a) * SP + kt * KT + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) vc[c] = KV[j * HP + tx + 16 * c];
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
      out[((size_t)b * L + qr) * H + h * HD + tx + 16 * c] = acc[a][c];
  }
}

// ---------------------------------------------------------------------------
// f32 backward 1: dQ and the row sums D, per 32-query tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) bwd_dq_kernel(const float* __restrict__ qkv,
                                                    const int* __restrict__ mask,
                                                    const float* __restrict__ dout,
                                                    const float2* __restrict__ stats,
                                                    float* __restrict__ dvec,
                                                    float* __restrict__ dqkv, int L, int H, int nh,
                                                    float scale, int drop_on, int seed0,
                                                    int seed1, unsigned thresh, float inv) {
  extern __shared__ __align__(16) float smem[];
  const int SP = L + 1;
  float* P = smem;                 // [QT][SP] probabilities (undropped)
  float* dP = P + QT * SP;         // [QT][SP] dP, then dS
  float* Qs = dP + QT * SP;        // [QT][HP]
  float* dOs = Qs + QT * HP;       // [QT][HP]
  float* Ks = dOs + QT * HP;       // [KT][HP]
  float* Vs = Ks + KT * HP;        // [KT][HP]
  float* bias = Vs + KT * HP;      // [L]
  float* rmax = bias + L;          // [QT]
  float* rsum = rmax + QT;         // [QT]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * nh + h;
  const size_t rs = 3 * (size_t)H;
  const float* base = qkv + (size_t)b * L * rs;
  const float* obase = dout + (size_t)b * L * H;
  const Drop dr(drop_on, seed0, seed1, thresh, inv, bh);

  for (int j = tid; j < L; j += NT) bias[j] = mask_bias(mask, b, L, j);
  for (int r = tid; r < QT; r += NT) {
    const float2 st = q0 + r < L ? stats[(size_t)bh * L + q0 + r] : make_float2(0.0f, 1.0f);
    rmax[r] = st.x;
    rsum[r] = st.y;
  }
  for (int e = tid; e < QT * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int qr = q0 + r;
    Qs[r * HP + d] = qr < L ? base[qr * rs + h * HD + d] : 0.0f;
    dOs[r * HP + d] = qr < L ? obase[qr * (size_t)H + h * HD + d] : 0.0f;
  }

  const int n_kt = (L + KT - 1) / KT;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    for (int e = tid; e < KT * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int key = kt * KT + r;
      Ks[r * HP + d] = key < L ? base[key * rs + H + h * HD + d] : 0.0f;
      Vs[r * HP + d] = key < L ? base[key * rs + 2 * H + h * HD + d] : 0.0f;
    }
    __syncthreads();
    float sacc[2][4] = {}, dacc[2][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[2], oa[2], kc[4], vc[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        qa[a] = Qs[(ty + 16 * a) * HP + d];
        oa[a] = dOs[(ty + 16 * a) * HP + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kc[c] = Ks[(tx + 16 * c) * HP + d];
        vc[c] = Vs[(tx + 16 * c) * HP + d];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sacc[a][c] = fmaf(qa[a], kc[c], sacc[a][c]);
          dacc[a][c] = fmaf(oa[a], vc[c], dacc[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kt * KT + tx + 16 * c;
        if (key >= L) continue;
        P[r * SP + key] = prob(score(sacc[a][c], scale, bias[key]), rmax[r], rsum[r]);
        dP[r * SP + key] = dr.apply(dacc[a][c], q0 + r, key, L);
      }
    }
  }
  __syncthreads();

  // D = rowsum(dP * P), then dS = P (dP - D), one warp per row
  for (int r = warp; r < QT; r += NT / 32) {
    const float* prow = P + r * SP;
    float* drow = dP + r * SP;
    float dsum = 0.0f;
    for (int j = lane; j < L; j += 32) dsum = fmaf(drow[j], prow[j], dsum);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (lane == 0 && q0 + r < L) dvec[(size_t)bh * L + q0 + r] = dsum;
    for (int j = lane; j < L; j += 32) drow[j] = prow[j] * (drow[j] - dsum);
  }

  // dQ = dS K * scale
  float acc[2][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    for (int e = tid; e < KT * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int key = kt * KT + r;
      Ks[r * HP + d] = key < L ? base[key * rs + H + h * HD + d] : 0.0f;
    }
    __syncthreads();
    const int nk = min(KT, L - kt * KT);
    for (int j = 0; j < nk; ++j) {
      float sa[2], kc[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) sa[a] = dP[(ty + 16 * a) * SP + kt * KT + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = Ks[j * HP + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(sa[a], kc[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int qr = q0 + ty + 16 * a;
    if (qr >= L) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dqkv[((size_t)b * L + qr) * rs + h * HD + tx + 16 * c] = acc[a][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// f32 backward 2: dK and dV, per 32-key tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(const float* __restrict__ qkv,
                                                      const int* __restrict__ mask,
                                                      const float* __restrict__ dout,
                                                      const float2* __restrict__ stats,
                                                      const float* __restrict__ dvec,
                                                      float* __restrict__ dqkv, int L, int H,
                                                      int nh, float scale, int drop_on,
                                                      int seed0, int seed1, unsigned thresh,
                                                      float inv) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TP = RT + 1;
  float* Ks = smem;                // [CT][HP]
  float* Vs = Ks + CT * HP;        // [CT][HP]
  float* Qs = Vs + CT * HP;        // [RT][HP]
  float* dOs = Qs + RT * HP;       // [RT][HP]
  float* Pt = dOs + RT * HP;       // [CT][TP] Pt of (key, query)
  float* dS = Pt + CT * TP;        // [CT][TP]
  float* rmax = dS + CT * TP;      // [RT]
  float* rsum = rmax + RT;         // [RT]
  float* rd = rsum + RT;           // [RT]
  float* kb = rd + RT;             // [CT] bias of the block's keys

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * CT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * nh + h;
  const size_t rs = 3 * (size_t)H;
  const float* base = qkv + (size_t)b * L * rs;
  const float* obase = dout + (size_t)b * L * H;
  const Drop dr(drop_on, seed0, seed1, thresh, inv, bh);

  for (int e = tid; e < CT * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int key = c0 + r;
    Ks[r * HP + d] = key < L ? base[key * rs + H + h * HD + d] : 0.0f;
    Vs[r * HP + d] = key < L ? base[key * rs + 2 * H + h * HD + d] : 0.0f;
  }
  for (int c = tid; c < CT; c += NT) kb[c] = c0 + c < L ? mask_bias(mask, b, L, c0 + c) : 0.0f;

  float dk[2][4] = {}, dv[2][4] = {};
  const int n_rt = (L + RT - 1) / RT;
  for (int rt = 0; rt < n_rt; ++rt) {
    __syncthreads();
    for (int e = tid; e < RT * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int qr = rt * RT + r;
      Qs[r * HP + d] = qr < L ? base[qr * rs + h * HD + d] : 0.0f;
      dOs[r * HP + d] = qr < L ? obase[qr * (size_t)H + h * HD + d] : 0.0f;
    }
    for (int r = tid; r < RT; r += NT) {
      const int qr = rt * RT + r;
      const float2 st = qr < L ? stats[(size_t)bh * L + qr] : make_float2(0.0f, 1.0f);
      rmax[r] = st.x;
      rsum[r] = st.y;
      rd[r] = qr < L ? dvec[(size_t)bh * L + qr] : 0.0f;
    }
    __syncthreads();
    // keys ty + 16a against queries tx + 16j: the dQ kernel's fmaf chains
    // for the scores and dPt
    float sacc[2][4] = {}, dacc[2][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float ka[2], va[2], qj[4], oj[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        ka[a] = Ks[(ty + 16 * a) * HP + d];
        va[a] = Vs[(ty + 16 * a) * HP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qj[j] = Qs[(tx + 16 * j) * HP + d];
        oj[j] = dOs[(tx + 16 * j) * HP + d];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sacc[a][j] = fmaf(qj[j], ka[a], sacc[a][j]);
          dacc[a][j] = fmaf(oj[j], va[a], dacc[a][j]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int kl = ty + 16 * a, key = c0 + kl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tx + 16 * j, qr = rt * RT + ql;
        float pt = 0.0f, ds = 0.0f;
        if (key < L && qr < L) {
          const float p = prob(score(sacc[a][j], scale, kb[kl]), rmax[ql], rsum[ql]);
          pt = dr.apply(p, qr, key, L);
          ds = p * (dr.apply(dacc[a][j], qr, key, L) - rd[ql]);
        }
        Pt[kl * TP + ql] = pt;
        dS[kl * TP + ql] = ds;
      }
    }
    __syncthreads();
    for (int i = 0; i < RT; ++i) {
      float pa[2], sa[2], oc[4], qc[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        pa[a] = Pt[(ty + 16 * a) * TP + i];
        sa[a] = dS[(ty + 16 * a) * TP + i];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        oc[c] = dOs[i * HP + tx + 16 * c];
        qc[c] = Qs[i * HP + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dv[a][c] = fmaf(pa[a], oc[c], dv[a][c]);
          dk[a][c] = fmaf(sa[a], qc[c], dk[a][c]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = c0 + ty + 16 * a;
    if (key >= L) continue;
    float* row = dqkv + ((size_t)b * L + key) * rs + h * HD + tx;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      row[H + 16 * c] = dk[a][c] * scale;
      row[2 * H + 16 * c] = dv[a][c];
    }
  }
}

size_t fwd_smem(int L) {
  return sizeof(float) * ((size_t)QT * (L + 1) + QT * HP + KT * HP + L);
}
size_t dq_smem(int L) {
  return sizeof(float) * ((size_t)2 * QT * (L + 1) + 2 * QT * HP + 2 * KT * HP + L + 2 * QT);
}
size_t dkdv_smem() {
  return sizeof(float) * ((size_t)2 * CT * HP + 2 * RT * HP + 2 * CT * (RT + 1) + 3 * RT + CT);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t launch_fwd_f32(const void* qkv, const void* mask, void* out, void* stats, int B,
                           int L, int H, int nh, int drop_on, int seed0, int seed1,
                           unsigned thresh, float inv, cudaStream_t stream) {
  const size_t smem = fwd_smem(L);
  cudaError_t err = allow_smem(fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + QT - 1) / QT, nh, B);
  fwd_kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int*>(mask), static_cast<float*>(out),
      static_cast<float2*>(stats), L, H, nh, 1.0f / sqrtf((float)HD), drop_on, seed0, seed1,
      thresh, inv);
  return cudaGetLastError();
}

cudaError_t launch_bwd_f32(const void* qkv, const void* mask, const void* dout,
                           const void* stats, void* dvec, void* dqkv, int B, int L, int H, int nh,
                           int drop_on, int seed0, int seed1, unsigned thresh, float inv,
                           cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)HD);
  const float* q = static_cast<const float*>(qkv);
  const int* m = static_cast<const int*>(mask);
  const float* g = static_cast<const float*>(dout);
  const float2* st = static_cast<const float2*>(stats);
  float* dv = static_cast<float*>(dvec);
  float* dx = static_cast<float*>(dqkv);
  size_t smem = dq_smem(L);
  cudaError_t err = allow_smem(bwd_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<<<dim3((L + QT - 1) / QT, nh, B), NT, smem, stream>>>(
      q, m, g, st, dv, dx, L, H, nh, scale, drop_on, seed0, seed1, thresh, inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = dkdv_smem();
  err = allow_smem(bwd_dkdv_kernel, smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<<<dim3((L + CT - 1) / CT, nh, B), NT, smem, stream>>>(
      q, m, g, st, dv, dx, L, H, nh, scale, drop_on, seed0, seed1, thresh, inv);
  return cudaGetLastError();
}

bool bad_shape(int B, int L, int H, int nh) {
  return B <= 0 || L <= 0 || L > MAXL || nh <= 0 || H != nh * HD;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mask is int32 [B, L]; stats float2
// [B, nh, L] (row max, row sum).  drop_on 0 ignores seed0, seed1, thresh
// and inv.  Returns the cudaError_t of the launch.
extern "C" int hc_flash_fwd(const void* qkv, const void* mask, void* out, void* stats, int B,
                            int L, int H, int nh, int dtype, int drop_on, int seed0, int seed1,
                            unsigned thresh, float inv, void* stream) {
  if (bad_shape(B, L, H, nh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd_f32(qkv, mask, out, stats, B, L, H, nh, drop_on, seed0, seed1,
                               thresh, inv, s);
  if (dtype == 1)  // the tensor-core forward of attention_tc.cuh
    return (int)launch_tc_fwd<true>(qkv, mask, out, stats, B, L, H, nh, drop_on, seed0, seed1,
                                    thresh, inv, s);
  return (int)cudaErrorInvalidValue;
}

// dout [B, L, H] in qkv's dtype; dvec float [B, nh, L] scratch; dqkv
// [B, L, 3H] in qkv's dtype, every element written.
extern "C" int hc_flash_bwd(const void* qkv, const void* mask, const void* dout,
                            const void* stats, void* dvec, void* dqkv, int B, int L, int H,
                            int nh, int dtype, int drop_on, int seed0, int seed1,
                            unsigned thresh, float inv, void* stream) {
  if (bad_shape(B, L, H, nh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd_f32(qkv, mask, dout, stats, dvec, dqkv, B, L, H, nh, drop_on, seed0,
                               seed1, thresh, inv, s);
  if (dtype == 1)  // the tensor-core backward of attention_tc_bwd.cuh
    return (int)launch_tc_bwd(qkv, mask, dout, stats, dvec, dqkv, B, L, H, nh, drop_on, seed0,
                              seed1, thresh, inv, s);
  return (int)cudaErrorInvalidValue;
}
