// Masked multi-head attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `masked_attention_pallas` of
// gisnav_tpu/matching/pallas_attention.py, the attention of the LightGlue
// module route: out = softmax(q k^T / sqrt(D) + key_bias) v per head, with the
// reference's rounding points: bf16 q/k/v, f32 logits scaled after the
// product, f32 bias and softmax, the normalised probabilities rounded to bf16
// before P.V, f32 output.
//
// q, k and v keep the module's (K, H, D) layout: a head is a column slice of
// D at row stride H*D, so no transposed copy exists and the output is written
// in place as (Kq, H, D) f32.
//
// One block per 64 query rows and head, 4 warps of 16 rows. Key and value
// tiles of 64 rows are staged in shared memory and the logits never reach
// device memory. Rounding bf16(p / denom) needs the final denominator, which
// a one-pass online softmax does not have, so the key tiles are swept twice:
// once for the row max and sum, once to form bf16(P) and accumulate P.V on
// the tensor cores (WMMA bf16, f32 accumulate). The second sweep recomputes
// Q.K^T: 1.5x the logit flops for the reference's exact rounding of P.
//
// Bound on an H100: operations (4*Kq*Kk*H*D flop of bf16 matmul against
// (Kq + 2*Kk)*H*D*2 + Kq*H*D*4 bytes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math_constants.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
// row strides of the logit tile (f32) and the probability tile (bf16),
// padded so that the 16 rows of a warp spread over the shared-memory banks
constexpr int LDS = BK + 4;
constexpr int LDP = BK + 8;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <int D>
constexpr int smem_bytes() {
  return (BQ + 2 * BK) * D * 2 + BQ * LDS * 4 + BQ * LDP * 2;
}

// copy a 64 x D bf16 tile (row stride `ld` elements) into shared memory
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t ld) {
  for (int v = threadIdx.x; v < 64 * (D / 8); v += blockDim.x) {
    int r = v / (D / 8), c = (v % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * D + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// S[warp rows] = Q[warp rows] . K^T for one key tile -> Ss (f32, ld LDS)
template <int D>
__device__ __forceinline__ void qk_tile(const __nv_bfloat16* Qs,
                                        const __nv_bfloat16* Ks, float* Ss,
                                        int warp) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBc b;
      wmma::load_matrix_sync(a, Qs + warp * 16 * D + kk * 16, D);
      wmma::load_matrix_sync(b, Ks + j * 16 * D + kk * 16, D);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(Ss + warp * 16 * LDS + j * 16, c, LDS,
                            wmma::mem_row_major);
  }
}

template <int D>
__global__ void __launch_bounds__(128)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int Kk, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * D;
  __nv_bfloat16* Vs = Ks + BK * D;
  float* Ss = reinterpret_cast<float*>(Vs + BK * D);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + BQ * LDS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb = blockIdx.x * BQ, h = blockIdx.y;
  const size_t ld = (size_t)heads * D;
  const __nv_bfloat16* kbase = k + h * D;
  const __nv_bfloat16* vbase = v + h * D;

  load_tile<D>(Qs, q + (size_t)qb * ld + h * D, ld);

  // each lane pair owns one row of the warp's 16; a lane covers the 32
  // even or the 32 odd columns, so a pair reads neighbouring words
  const int row = warp * 16 + (lane >> 1);
  const int cb = lane & 1;
  const float* srow = Ss + row * LDS + cb;
  float m = -CUDART_INF_F, l = 0.0f;

  // sweep 1: row max and softmax denominator
  for (int t = 0; t < Kk; t += BK) {
    __syncthreads();
    load_tile<D>(Ks, kbase + (size_t)t * ld, ld);
    __syncthreads();
    qk_tile<D>(Qs, Ks, Ss, warp);
    __syncwarp();
    const float* brow = bias + t + cb;
    float tmax = -CUDART_INF_F;
    for (int c = 0; c < BK; c += 2)
      tmax = fmaxf(tmax, srow[c] * scale + brow[c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float mn = fmaxf(m, tmax);
    float part = 0.0f;
    for (int c = 0; c < BK; c += 2)
      part += expf(srow[c] * scale + brow[c] - mn);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    l = l * expf(m - mn) + part;
    m = mn;
    __syncwarp();
  }

  // sweep 2: P = bf16(exp(logit - m) / l), O += P.V
  FragC o[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int t = 0; t < Kk; t += BK) {
    __syncthreads();
    load_tile<D>(Ks, kbase + (size_t)t * ld, ld);
    load_tile<D>(Vs, vbase + (size_t)t * ld, ld);
    __syncthreads();
    qk_tile<D>(Qs, Ks, Ss, warp);
    __syncwarp();
    for (int c = 0; c < BK; c += 2) {
      float lg = srow[c] * scale + bias[t + cb + c];
      Ps[row * LDP + cb + c] = __float2bfloat16(expf(lg - m) / l);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, Ps + warp * 16 * LDP + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragBr b;
        wmma::load_matrix_sync(b, Vs + kk * 16 * D + j * 16, D);
        wmma::mma_sync(o[j], a, b, o[j]);
      }
    }
  }
  // the warp's 16 x D result goes straight to its (Kq, H, D) slot
  float* obase = out + (size_t)(qb + warp * 16) * ld + h * D;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(obase + j * 16, o[j], (unsigned)ld,
                            wmma::mem_row_major);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           float* out, int Kq, int Kk, int heads, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Kq / BQ, heads);
  attention_kernel<D><<<grid, 128, smem_bytes<D>(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, bias, out, Kk, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (Kq, H, D), k/v (Kk, H, D) bf16; bias (Kk,) f32; out (Kq, H, D) f32
extern "C" int gisnav_masked_attention(const void* q, const void* k,
                                       const void* v, const float* bias,
                                       float* out, int Kq, int Kk, int heads,
                                       int D, float scale, void* stream) {
  if (Kq % BQ || Kk % BK || heads < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, bias, out, Kq, Kk, heads, scale, s);
    case 64: return launch<64>(q, k, v, bias, out, Kq, Kk, heads, scale, s);
    case 128: return launch<128>(q, k, v, bias, out, Kq, Kk, heads, scale, s);
    default: return -1;
  }
}
