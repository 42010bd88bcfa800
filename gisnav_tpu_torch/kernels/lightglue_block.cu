// One fused LightGlue transformer block for Hopper (sm_90a).
//
// Replaces the TPU kernel `_block_pallas` of
// gisnav_tpu/matching/lightglue_fused.py (reached through `fused_block` and
// `fused_block_dual`): x + FFN([x | out_proj(attn(q, k, v))]) with 4 heads of
// 64, an additive key bias, and every bf16 rounding point of the JAX
// reference `_block_reference`. With sets = 2 the query rows of half s attend
// key half s, or half 1 - s when `cross` is set: the half is picked from the
// block index, so no swapped copy of k/v exists.
//
// Two launches per block:
//  1. attention (`attn_kernel`): one block per 64 query rows and head. Key
//     and value tiles of 64 rows are staged in shared memory; the logits are
//     never written to device memory. A first sweep over the key tiles keeps
//     the online softmax max and sum; a second sweep forms the normalised
//     probabilities, rounds them to bf16 as the reference does before P.V,
//     and accumulates P.V on the tensor cores (WMMA bf16, f32 accumulate).
//     The second sweep recomputes Q.K^T: it costs 1.5x the logit flops, and
//     buys the reference's exact rounding of P.
//  2. epilogue (`ffn_kernel`): one block per 16 rows; out_proj, the FFN as
//     x @ W1x + m @ W1m (the concat never exists), bf16 rounding, f32
//     LayerNorm (eps 1e-6), tanh gelu, fc2, bf16 rounding and the residual,
//     all in shared memory. Weights stream from L2.
//
// Bound on an H100 at 2x2048 keypoints: operations (~6.4 GFLOP of bf16
// matmul per block against ~25 MB of traffic).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math_constants.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int DH = 64;   // head width
constexpr int BQ = 64;   // query rows per attention block
constexpr int BK = 64;   // keys per tile
constexpr int DIM = 256;
constexpr int FF = 512;
constexpr int RE = 16;   // rows per epilogue block

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// copy a 64x64 bf16 tile (row stride `ld` elements) into shared memory
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ld) {
  for (int v = threadIdx.x; v < 64 * 8; v += blockDim.x) {
    int r = v >> 3, c = (v & 7) * 8;
    *reinterpret_cast<uint4*>(dst + r * 64 + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  }
}

// S[warp rows] = Q[warp rows] . K^T for one key tile -> Ss (f32, ld 64)
__device__ __forceinline__ void qk_tile(const __nv_bfloat16* Qs,
                                        const __nv_bfloat16* Ks, float* Ss,
                                        int warp) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragA a;
      FragBc b;
      wmma::load_matrix_sync(a, Qs + warp * 16 * 64 + kk * 16, 64);
      wmma::load_matrix_sync(b, Ks + j * 16 * 64 + kk * 16, 64);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(Ss + warp * 16 * 64 + j * 16, c, 64,
                            wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(128)
attn_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ msg,
            int N, int Kk, int sets, int cross, float scale) {
  __shared__ __align__(128) __nv_bfloat16 Qs[BQ * 64];
  __shared__ __align__(128) __nv_bfloat16 Ks[BK * 64];  // also holds P
  __shared__ __align__(128) __nv_bfloat16 Vs[BK * 64];
  __shared__ __align__(128) float Ss[BQ * 64];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb = blockIdx.x * BQ, h = blockIdx.y;
  const int s = sets > 1 ? qb / (N / sets) : 0;
  const int ks = sets > 1 ? (s ^ cross) : 0;
  const __nv_bfloat16* kbase = k + (size_t)ks * Kk * DIM + h * DH;
  const __nv_bfloat16* vbase = v + (size_t)ks * Kk * DIM + h * DH;
  const float* bbase = bias + (size_t)ks * Kk;

  load_tile(Qs, q + (size_t)qb * DIM + h * DH, DIM);

  // each lane pair owns one row of the warp's 16; a lane covers 32 columns
  const int row = warp * 16 + (lane >> 1);
  const int cb = (lane & 1) * 32;
  float m = -CUDART_INF_F, l = 0.0f;

  // sweep 1: row max and softmax denominator
  for (int t = 0; t < Kk; t += BK) {
    __syncthreads();
    load_tile(Ks, kbase + (size_t)t * DIM, DIM);
    __syncthreads();
    qk_tile(Qs, Ks, Ss, warp);
    __syncwarp();
    float tmax = -CUDART_INF_F;
    for (int c = 0; c < 32; ++c)
      tmax = fmaxf(tmax, Ss[row * 64 + cb + c] * scale + bbase[t + cb + c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float mn = fmaxf(m, tmax);
    float part = 0.0f;
    for (int c = 0; c < 32; ++c)
      part += expf(Ss[row * 64 + cb + c] * scale + bbase[t + cb + c] - mn);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    l = l * expf(m - mn) + part;
    m = mn;
  }

  // sweep 2: P = bf16(exp(logit - m) / l), O += P.V
  FragC o[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  __nv_bfloat16* Ps = Ks;
  for (int t = 0; t < Kk; t += BK) {
    __syncthreads();
    load_tile(Ks, kbase + (size_t)t * DIM, DIM);
    load_tile(Vs, vbase + (size_t)t * DIM, DIM);
    __syncthreads();
    qk_tile(Qs, Ks, Ss, warp);
    __syncthreads();  // every warp is done reading Ks before P overwrites it
    for (int c = 0; c < 32; ++c) {
      float lg = Ss[row * 64 + cb + c] * scale + bbase[t + cb + c];
      Ps[row * 64 + cb + c] = __float2bfloat16(expf(lg - m) / l);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, Ps + warp * 16 * 64 + kk * 16, 64);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        FragBr b;
        wmma::load_matrix_sync(b, Vs + kk * 16 * 64 + j * 16, 64);
        wmma::mma_sync(o[j], a, b, o[j]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Ss + warp * 16 * 64 + j * 16, o[j], 64,
                            wmma::mem_row_major);
  __syncwarp();
  for (int c = 0; c < 32; ++c)
    msg[(size_t)(qb + row) * DIM + h * DH + cb + c] =
        __float2bfloat16(Ss[row * 64 + cb + c]);
}

// acc(16 x 16 tile n0) = A (16 x K, smem, ld lda) . B (K x ldb, global)
__device__ __forceinline__ void row_gemm(FragC& c, const __nv_bfloat16* A,
                                         int lda, const __nv_bfloat16* B,
                                         int ldb, int K, int n0) {
  for (int kk = 0; kk < K; kk += 16) {
    FragA a;
    FragBr b;
    wmma::load_matrix_sync(a, A + kk, lda);
    wmma::load_matrix_sync(b, B + (size_t)kk * ldb + n0, ldb);
    wmma::mma_sync(c, a, b, c);
  }
}

constexpr int FFN_SMEM = RE * DIM * 2 * 3 + RE * FF * 4 + RE * FF * 2;

__global__ void __launch_bounds__(256)
ffn_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ msg,
           const __nv_bfloat16* __restrict__ wout,
           const float* __restrict__ bout,
           const __nv_bfloat16* __restrict__ w1x,
           const __nv_bfloat16* __restrict__ w1m,
           const float* __restrict__ b1, const float* __restrict__ lns,
           const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Am = reinterpret_cast<__nv_bfloat16*>(smem);  // msg
  __nv_bfloat16* Ax = Am + RE * DIM;                            // bf16(x)
  __nv_bfloat16* Am2 = Ax + RE * DIM;                           // out_proj
  float* F = reinterpret_cast<float*>(Am2 + RE * DIM);          // staging
  __nv_bfloat16* G = reinterpret_cast<__nv_bfloat16*>(F + RE * FF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t r0 = (size_t)blockIdx.x * RE;

  for (int e = tid; e < RE * DIM; e += 256) {
    Am[e] = msg[r0 * DIM + e];
    Ax[e] = __float2bfloat16(x[r0 * DIM + e]);
  }
  __syncthreads();

  // out_proj: m2 = bf16(msg @ wout + bout)
  for (int j = 0; j < 2; ++j) {
    int n0 = (warp * 2 + j) * 16;
    FragC c;
    wmma::fill_fragment(c, 0.0f);
    row_gemm(c, Am, DIM, wout, DIM, DIM, n0);
    wmma::store_matrix_sync(F + n0, c, FF, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < RE * DIM; e += 256) {
    int r = e / DIM, n = e % DIM;
    Am2[e] = __float2bfloat16(F[r * FF + n] + bout[n]);
  }
  __syncthreads();

  // fc1: y = bf16(x @ W1x + m2 @ W1m + b1)
  for (int j = 0; j < 4; ++j) {
    int n0 = (warp * 4 + j) * 16;
    FragC c;
    wmma::fill_fragment(c, 0.0f);
    row_gemm(c, Ax, DIM, w1x, FF, DIM, n0);
    row_gemm(c, Am2, DIM, w1m, FF, DIM, n0);
    wmma::store_matrix_sync(F + n0, c, FF, wmma::mem_row_major);
  }
  __syncthreads();

  // LayerNorm (f32) + tanh gelu -> bf16 G; one warp per two rows
  for (int rr = 0; rr < 2; ++rr) {
    int r = warp * 2 + rr;
    float y[FF / 32];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < FF / 32; ++i) {
      int n = lane + 32 * i;
      y[i] = round_bf16(F[r * FF + n] + b1[n]);
      s1 += y[i];
      s2 += y[i] * y[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mu = s1 / FF;
    const float var = fmaxf(s2 / FF - mu * mu, 0.0f);
    const float inv = rsqrtf(var + 1e-6f);
    const float cg = 0.7978845608028654f;  // sqrt(2 / pi)
#pragma unroll
    for (int i = 0; i < FF / 32; ++i) {
      int n = lane + 32 * i;
      float yn = (y[i] - mu) * inv * lns[n] + lnb[n];
      float g = 0.5f * yn * (1.0f + tanhf(cg * (yn + 0.044715f * yn * yn * yn)));
      G[r * FF + n] = __float2bfloat16(g);
    }
  }
  __syncthreads();

  // fc2 + residual: out = x + bf16(g @ W2 + b2)
  for (int j = 0; j < 2; ++j) {
    int n0 = (warp * 2 + j) * 16;
    FragC c;
    wmma::fill_fragment(c, 0.0f);
    row_gemm(c, G, FF, w2, DIM, FF, n0);
    wmma::store_matrix_sync(F + n0, c, FF, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < RE * DIM; e += 256) {
    int r = e / DIM, n = e % DIM;
    out[r0 * DIM + e] = x[r0 * DIM + e] + round_bf16(F[r * FF + n] + b2[n]);
  }
}

}  // namespace

extern "C" int gisnav_lg_attention(const void* q, const void* k, const void* v,
                                   const float* bias, void* msg, int N, int Kk,
                                   int heads, int sets, int cross, float scale,
                                   void* stream) {
  if (heads * DH != DIM || N % (BQ * sets) || Kk % BK) return -1;
  dim3 grid(N / BQ, heads);
  attn_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, bias, (__nv_bfloat16*)msg, N, Kk, sets, cross,
      scale);
  return (int)cudaGetLastError();
}

extern "C" int gisnav_lg_ffn(const float* x, const void* msg, const void* wout,
                             const float* bout, const void* w1x,
                             const void* w1m, const float* b1,
                             const float* lns, const float* lnb,
                             const void* w2, const float* b2, float* out,
                             int N, void* stream) {
  if (N % RE) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FFN_SMEM);
  if (err != cudaSuccess) return (int)err;
  ffn_kernel<<<N / RE, 256, FFN_SMEM, (cudaStream_t)stream>>>(
      x, (const __nv_bfloat16*)msg, (const __nv_bfloat16*)wout, bout,
      (const __nv_bfloat16*)w1x, (const __nv_bfloat16*)w1m, b1, lns, lnb,
      (const __nv_bfloat16*)w2, b2, out);
  return (int)cudaGetLastError();
}
