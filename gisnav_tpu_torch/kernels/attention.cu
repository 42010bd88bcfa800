// Masked multi-head attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `masked_attention_pallas` of
// gisnav_tpu/matching/pallas_attention.py, the attention of the LightGlue
// module route: out = softmax(q k^T / sqrt(D) + key_bias) v per head, with the
// reference's rounding points: bf16 q/k/v, f32 logits scaled after the
// product, f32 bias and softmax, the normalised probabilities rounded to bf16
// before P.V, f32 output. q, k and v keep the module's (K, H, D) layout: a
// head is a column slice of D at row stride H*D, so no transposed copy exists
// and the output is written in place as (Kq, H, D) f32.
//
// Bound on an H100: operations (4*Kq*Kk*H*D flop of bf16 matmul against
// (Kq + 2*Kk)*H*D*2 + Kq*H*D*4 bytes), but at the path's shapes (a few
// thousand rows, 4 heads) the whole problem is some tens of microseconds of
// tensor-core time, so what decides the time is how much of the card works
// at once and how little each logit costs beside its product. The design:
//
// * bf16(p / denom) needs the row's final max and denominator, so the keys
//   are swept twice (attention_core.cuh): launch 1 computes the statistics,
//   launch 2 recomputes Q.K^T and accumulates P.V. 1.5x the logit flops buys
//   the reference's rounding of P.
// * The logits live only in `mma.sync` accumulator fragments: max and sum are
//   per-lane with one quad merge at the end, P is packed to bf16 in registers
//   as the A operand of P.V. No logit or probability touches shared memory.
// * K, V and the bias arrive by `cp.async` through a 3-stage ring of
//   swizzled tiles, one barrier a tile.
// * The grid is (Kq/64, H, splits): the keys are split 1/2/4/8 ways (the
//   wrapper chooses so that every SM holds several blocks), so no warp walks
//   all keys. Launch 1 writes each split's (m, l) to a scratch tensor;
//   launch 2 merges them exactly (m = max m_s, l = sum l_s exp(m_s - m), in
//   split order). The splits of one (row block, head) form a thread-block
//   cluster in launch 2: each block leaves its partial O in its own shared
//   memory and, after a cluster barrier, sums a 64/splits-row slice over all
//   peers through distributed shared memory in split order and writes it.
//   No atomics: two runs give the same bits.
// * A leading pair axis (the counterpart of the JAX package's vmap of the
//   TPU kernel over training pairs) folds into the grid's y: block row
//   y = pair * H + head, so B problems of one shape are one launch pair, and
//   each pair's blocks compute exactly what a call for that pair alone would.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace cg = cooperative_groups;

namespace {

using attn::BK;
using attn::BQ;
using attn::THREADS;

// row stride (f32) of the partial-O tile a block leaves for its cluster
template <int D>
__host__ __device__ constexpr int ldo() {
  return D + 4;
}

template <int D>
__host__ __device__ constexpr int pv_smem_bytes() {
  return attn::ring_bytes<D, true>() > BQ * ldo<D>() * 4
             ? attn::ring_bytes<D, true>()
             : BQ * ldo<D>() * 4;
}

__device__ __forceinline__ void split_range(int tiles, int splits, int s,
                                            int& t0, int& t1) {
  t0 = tiles * s / splits;
  t1 = tiles * (s + 1) / splits;
}

// launch 1: stats (splits, B*H, Kq) float2 = (max, sum of exp) over the
// split
template <int D>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const float* __restrict__ bias, float2* __restrict__ stats,
             int Kq, int Kk, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qb = blockIdx.x * BQ, hb = blockIdx.y, s = blockIdx.z;
  const int h = hb % heads, b = hb / heads;
  const size_t ld = (size_t)heads * D;
  q += (size_t)b * Kq * ld;
  k += (size_t)b * Kk * ld;
  bias += (size_t)b * Kk;
  int t0, t1;
  split_range(Kk / BK, gridDim.z, s, t0, t1);

  attn::load_tile_async<D>(attn::smem_u32(smem), q + (size_t)qb * ld + h * D,
                           ld);
  attn::cp_async_commit();
  const attn::KeySource src{k + h * D, nullptr, bias, ld};
  float m[2], l[2];
  attn::sweep_stats<D>(smem, src, t0, t1, scale, m, l);
  if ((threadIdx.x & 3) == 0) {
    float2* dst = stats + ((size_t)s * gridDim.y + hb) * Kq + qb;
    dst[attn::acc_row(0)] = make_float2(m[0], l[0]);
    dst[attn::acc_row(2)] = make_float2(m[1], l[1]);
  }
}

// launch 2: out (B, Kq, H, D) f32; cluster (1, 1, splits) when splits > 1
template <int D>
__global__ void __launch_bounds__(THREADS)
pv_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
          const float2* __restrict__ stats, float* __restrict__ out, int Kq,
          int Kk, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qb = blockIdx.x * BQ, hb = blockIdx.y, s = blockIdx.z;
  const int h = hb % heads, b = hb / heads;
  const int splits = gridDim.z;
  const size_t ld = (size_t)heads * D;
  q += (size_t)b * Kq * ld;
  k += (size_t)b * Kk * ld;
  v += (size_t)b * Kk * ld;
  bias += (size_t)b * Kk;
  out += (size_t)b * Kq * ld;
  int t0, t1;
  split_range(Kk / BK, splits, s, t0, t1);

  attn::load_tile_async<D>(attn::smem_u32(smem), q + (size_t)qb * ld + h * D,
                           ld);
  attn::cp_async_commit();

  // the rows' final statistics: the splits' partials merged in split order
  float m[2], inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2* src = stats + (size_t)hb * Kq + qb + attn::acc_row(2 * i);
    float2 ml = src[0];
    for (int p = 1; p < splits; ++p) {
      const float2 o = src[(size_t)p * gridDim.y * Kq];
      attn::merge_stats(ml.x, ml.y, o.x, o.y);
    }
    m[i] = ml.x;
    inv_l[i] = 1.0f / ml.y;
  }

  const attn::KeySource src{k + h * D, v + h * D, bias, ld};
  float o[D / 8][4];
  attn::sweep_pv<D>(smem, src, t0, t1, scale, m, inv_l, o);

  float* obase = out + (size_t)qb * ld + h * D;
  if (splits == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; c += 2)
        *reinterpret_cast<float2*>(obase + (size_t)attn::acc_row(c) * ld +
                                   attn::acc_col(n)) =
            make_float2(o[n][c], o[n][c + 1]);
    }
    return;
  }

  // partial O into this block's shared memory (over the ring, once every
  // warp has left it), then each block of the cluster sums its slice of rows
  attn::cp_async_wait<0>();
  __syncthreads();
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; c += 2)
      *reinterpret_cast<float2*>(os + attn::acc_row(c) * ldo<D>() +
                                 attn::acc_col(n)) =
          make_float2(o[n][c], o[n][c + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = BQ / splits;
  const int row0 = (int)cluster.block_rank() * rows;
  for (int e = threadIdx.x; e < rows * (D / 4); e += THREADS) {
    const int row = row0 + e / (D / 4), c4 = (e % (D / 4)) * 4;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int p = 0; p < splits; ++p) {
      const float* peer = cluster.map_shared_rank(os, p);
      const float4 t =
          *reinterpret_cast<const float4*>(peer + row * ldo<D>() + c4);
      sum.x += t.x;
      sum.y += t.y;
      sum.z += t.z;
      sum.w += t.w;
    }
    *reinterpret_cast<float4*>(obase + (size_t)row * ld + c4) = sum;
  }
  // no block may leave while a peer still reads its shared memory
  cluster.sync();
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, const float* bias, float2* stats,
           float* out, int Kq, int Kk, int heads, int pairs, int splits,
           float scale, cudaStream_t stream) {
  constexpr int smem1 = attn::ring_bytes<D, false>();
  constexpr int smem2 = pv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      pv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(Kq / BQ, heads * pairs, splits);
  stats_kernel<D><<<grid, THREADS, smem1, stream>>>(q, k, bias, stats, Kq, Kk,
                                                    heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pv_kernel<D>, q, k, v, bias,
                           (const float2*)stats, out, Kq, Kk, heads, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Kq, H, D), k/v (B, Kk, H, D) bf16; bias (B, Kk) f32; stats scratch
// (splits, B, H, Kq, 2) f32; out (B, Kq, H, D) f32, B = pairs. Two launches;
// returns 0 when the card accepted both.
extern "C" int gisnav_masked_attention(const void* q, const void* k,
                                       const void* v, const float* bias,
                                       float* stats, float* out, int Kq,
                                       int Kk, int heads, int pairs, int D,
                                       int splits, float scale,
                                       void* stream) {
  if (Kq % BQ || Kk % BK || heads < 1 || pairs < 1 ||
      (long long)heads * pairs > 65535)
    return -1;
  if ((splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      splits > Kk / BK)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* qb = (const __nv_bfloat16*)q;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)k;
  const __nv_bfloat16* vb = (const __nv_bfloat16*)v;
  float2* st = (float2*)stats;
  switch (D) {
    case 32:
      return launch<32>(qb, kb, vb, bias, st, out, Kq, Kk, heads, pairs,
                        splits, scale, s);
    case 64:
      return launch<64>(qb, kb, vb, bias, st, out, Kq, Kk, heads, pairs,
                        splits, scale, s);
    case 128:
      return launch<128>(qb, kb, vb, bias, st, out, Kq, Kk, heads, pairs,
                         splits, scale, s);
    default:
      return -1;
  }
}
