// One fused LightGlue transformer block for Hopper (sm_90a).
//
// Replaces the TPU kernel `_block_pallas` of
// gisnav_tpu/matching/lightglue_fused.py (reached through `fused_block` and
// `fused_block_dual`; its `sets=1` body is also `_block_pallas` of
// gisnav_tpu/matching/_old_lgf.py): x + FFN([x | out_proj(attn(q, k, v))])
// with 4 heads of 64, an additive key bias, and every bf16 rounding point of
// the plain version `_block_plain`. With sets = 2 the query rows of half s
// attend key half s, or half 1 - s when `cross` is set: the half is picked
// from the block index, so no swapped copy of k/v exists.
//
// Two launches per block:
//  1. attention (`attn_kernel`) on the two-sweep core of
//     attention_core.cuh (the one masked_attention runs): one block of 4
//     warps owns 64 query rows of one head and a range of 64-key tiles; the
//     logits live only in `mma.sync` fragments, K/V/bias arrive through a
//     3-stage `cp.async` ring. The keys are split `splits` ways
//     (`key_splits`), and the splits of one (row block, head) form a
//     thread-block cluster, so the launch is one: each block sweeps its keys
//     for (max, sum), leaves them in shared memory, and after a cluster
//     barrier merges every peer's pair through distributed shared memory in
//     split order (all blocks hold the same bits); it then sweeps again for
//     P = bf16(exp(logit - m) / l) and P.V, and the partial O of the splits
//     are added in split order over the cluster and rounded to bf16 once.
//     No atomics: two runs give the same bits.
//  2. epilogue (`ffn_kernel`): one block of 8 warps per 32 rows; out_proj,
//     the FFN as x @ W1x + m2 @ W1m (the concat never exists), f32 LayerNorm
//     (eps 1e-6), tanh gelu, fc2 and the residual, with the plain version's
//     bf16 rounding points. The four weight matrices stream through one
//     3-stage `cp.async` ring of swizzled 32-row tiles (one barrier a tile,
//     the next product's first tiles in flight during the previous one's
//     epilogue); the products are `mma.sync.m16n8k16` on `ldmatrix`
//     fragments, each warp a column slice of all 32 rows, and LayerNorm's row
//     sums meet through shared memory. Every activation stays on chip.
//
// Bound on an H100 at 2x2048 keypoints: operations (~6.4 GFLOP of bf16
// matmul a block against ~25 MB of traffic). At the path's shapes that is
// some microseconds of tensor-core time, so what decides the time is how much
// of the card works at once: 512 attention blocks at the dual shape, and the
// epilogue reading its 0.9 MB of weights from L2 once per 32 rows.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace cg = cooperative_groups;

namespace {

using attn::BK;
using attn::BQ;
using attn::mma_16816;
using attn::tile_off;
using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::ldmatrix_x4;
using ptx::ldmatrix_x4_trans;
using ptx::pack_bf16;
using ptx::smem_u32;

constexpr int DH = 64;  // head width
constexpr int DIM = 256;
constexpr int FF = 512;

// ---------------------------------------------------------------------------
// attention
// ---------------------------------------------------------------------------

constexpr int LDO = DH + 4;  // row stride (f32) of a block's partial-O tile
constexpr int RING = attn::ring_bytes<DH, true>();
constexpr int MAIN = RING > BQ * LDO * 4 ? RING : BQ * LDO * 4;
// Q tile + ring (the partial O later overlays them), then 64 rows' (m, l)
constexpr int ATTN_SMEM = MAIN + BQ * 8;

// q (N, 256) bf16, N = sets * Kq rows; k/v (sets * Kk, 256) bf16; bias
// (sets, Kk) f32; msg (N, 256) bf16. Grid (N / 64, heads, splits), cluster
// (1, 1, splits).
__global__ void __launch_bounds__(attn::THREADS)
attn_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ msg,
            int N, int Kk, int sets, int cross, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float2* stats_s = reinterpret_cast<float2*>(smem + MAIN);
  const int qb = blockIdx.x * BQ, h = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int s = qb / (N / sets);
  const int ks = s ^ cross;  // cross is 0 with one set
  const size_t koff = (size_t)ks * Kk * DIM + h * DH;
  const attn::KeySource src{k + koff, v + koff, bias + (size_t)ks * Kk, DIM};
  const int tiles = Kk / BK;
  const int t0 = tiles * split / splits, t1 = tiles * (split + 1) / splits;

  attn::load_tile_async<DH>(smem_u32(smem), q + (size_t)qb * DIM + h * DH,
                            DIM);
  cp_async_commit();
  float m[2], l[2];
  attn::sweep_stats<DH>(smem, src, t0, t1, scale, m, l);

  // the rows' statistics over all keys: the splits' pairs merged in split
  // order, the same bits in every block of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  float inv_l[2];
  if (splits > 1) {
    if ((threadIdx.x & 3) == 0) {
      stats_s[attn::acc_row(0)] = make_float2(m[0], l[0]);
      stats_s[attn::acc_row(2)] = make_float2(m[1], l[1]);
    }
    cluster.sync();  // also: every warp has left the ring
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = attn::acc_row(2 * i);
      float2 ml = cluster.map_shared_rank(stats_s, 0)[row];
      for (int p = 1; p < splits; ++p) {
        const float2 o = cluster.map_shared_rank(stats_s, p)[row];
        attn::merge_stats(ml.x, ml.y, o.x, o.y);
      }
      m[i] = ml.x;
      l[i] = ml.y;
    }
  } else {
    __syncthreads();  // every warp has left the ring
  }
  inv_l[0] = 1.0f / l[0];
  inv_l[1] = 1.0f / l[1];

  float o[DH / 8][4];
  attn::sweep_pv<DH>(smem, src, t0, t1, scale, m, inv_l, o);

  __nv_bfloat16* obase = msg + (size_t)qb * DIM + h * DH;
  if (splits == 1) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; c += 2)
        *reinterpret_cast<uint32_t*>(obase +
                                     (size_t)attn::acc_row(c) * DIM +
                                     attn::acc_col(n)) =
            pack_bf16(o[n][c], o[n][c + 1]);
    }
    return;
  }

  // partial O into this block's shared memory (over Q and the ring, once
  // every warp has left them), then each block of the cluster sums its
  // slice of rows over all peers in split order and rounds it once
  cp_async_wait<0>();
  __syncthreads();
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; c += 2)
      *reinterpret_cast<float2*>(os + attn::acc_row(c) * LDO +
                                 attn::acc_col(n)) =
          make_float2(o[n][c], o[n][c + 1]);
  }
  cluster.sync();
  const int rows = BQ / splits;
  const int row0 = (int)cluster.block_rank() * rows;
  for (int e = threadIdx.x; e < rows * (DH / 4); e += attn::THREADS) {
    const int row = row0 + e / (DH / 4), c4 = (e % (DH / 4)) * 4;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int p = 0; p < splits; ++p) {
      const float4 t = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(os, p) + row * LDO + c4);
      sum.x += t.x;
      sum.y += t.y;
      sum.z += t.z;
      sum.w += t.w;
    }
    *reinterpret_cast<uint2*>(obase + (size_t)row * DIM + c4) =
        make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
  }
  // no block may leave while a peer still reads its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// epilogue
// ---------------------------------------------------------------------------

constexpr int RE = 32;          // rows a block
constexpr int ETHREADS = 256;   // 8 warps: column slices of each product
constexpr int WK = 32;          // weight rows a ring stage
constexpr int WSTAGES = 3;
constexpr int WSLOT = WK * FF * 2;  // a stage holds up to 512 columns
// the weight tiles in ring order: out_proj, fc1 (W1x then W1m), fc2
constexpr int T_FC1 = DIM / WK;             // 8
constexpr int T_FC1M = T_FC1 + DIM / WK;    // 16
constexpr int T_FC2 = T_FC1M + DIM / WK;    // 24
constexpr int T_ALL = T_FC2 + FF / WK;      // 40
constexpr int A_BYTES = RE * DIM * 2;       // a 32 x 256 bf16 tile
// ring | msg | bf16(x) | m2 (g, 32 x 512, later over bf16(x) and m2) |
// LayerNorm's per-warp row sums
constexpr int FFN_SMEM = WSTAGES * WSLOT + 3 * A_BYTES + 8 * RE * 8;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Weights {
  const __nv_bfloat16* wout;  // (256, 256)
  const __nv_bfloat16* w1x;   // (256, 512)
  const __nv_bfloat16* w1m;   // (256, 512)
  const __nv_bfloat16* w2;    // (512, 256)
};

// rows [r0, r0 + 32) of a (K, NOUT) weight into a swizzled ring slot
template <int NOUT>
__device__ __forceinline__ void load_wslice(uint32_t dst,
                                            const __nv_bfloat16* w, int r0) {
  constexpr int CH = NOUT / 8;
  for (int e = threadIdx.x; e < WK * CH; e += ETHREADS) {
    const int r = e / CH, c = e % CH;
    cp_async16(dst + tile_off<NOUT>(r, c),
               w + (size_t)(r0 + r) * NOUT + c * 8);
  }
}

__device__ __forceinline__ void load_wtile(uint32_t ring, const Weights& w,
                                           int t) {
  const uint32_t dst = ring + (t % WSTAGES) * WSLOT;
  if (t < T_FC1)
    load_wslice<DIM>(dst, w.wout, t * WK);
  else if (t < T_FC1M)
    load_wslice<FF>(dst, w.w1x, (t - T_FC1) * WK);
  else if (t < T_FC2)
    load_wslice<FF>(dst, w.w1m, (t - T_FC1M) * WK);
  else
    load_wslice<DIM>(dst, w.w2, (t - T_FC2) * WK);
}

// acc (the warp's NOUT/8 columns of all 32 rows) += A[:, 32 k from chunk
// kc0] (32 x KA bf16, swizzled) . B (the 32 x NOUT stage)
template <int KA, int NOUT>
__device__ __forceinline__ void mma_stage(float (&acc)[2][NOUT / 64][4],
                                          uint32_t a_tile, int kc0,
                                          uint32_t b_stage, int warp,
                                          int lane) {
  constexpr int NT = NOUT / 64;  // 8-column tiles a warp
  const int mat = lane >> 3, r = lane & 7;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < WK / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], a_tile + tile_off<KA>(mi * 16 + arow,
                                               kc0 + kk * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, b_stage + tile_off<NOUT>(kk * 16 + r + (mat & 1) * 8,
                                      warp * NT + np * 2 + (mat >> 1)));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_16816(acc[mi][2 * np], a[mi], b[0], b[1]);
        mma_16816(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.0f;
}

// bf16 pair at (row, col) of a swizzled tile of D columns
template <int D>
__device__ __forceinline__ void st_pair(uint32_t tile, int row, int col,
                                        uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                   tile + tile_off<D>(row, col >> 3) + (col & 7) * 2),
               "r"(v)
               : "memory");
}

__global__ void __launch_bounds__(ETHREADS, 1)
ffn_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ msg,
           Weights w, const float* __restrict__ bout,
           const float* __restrict__ b1, const float* __restrict__ lns,
           const float* __restrict__ lnb, const float* __restrict__ b2,
           float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  const uint32_t am = ring + WSTAGES * WSLOT;  // msg
  const uint32_t ax = am + A_BYTES;            // bf16(x)
  const uint32_t am2 = ax + A_BYTES;           // out_proj
  const uint32_t g = ax;                       // gelu, 32 x 512
  float2* part = reinterpret_cast<float2*>(smem + WSTAGES * WSLOT +
                                           3 * A_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t r0 = (size_t)blockIdx.x * RE;
  const float* xb = x + r0 * DIM;

  for (int e = tid; e < RE * DIM / 8; e += ETHREADS) {
    const int r = e / (DIM / 8), c = e % (DIM / 8);
    cp_async16(am + tile_off<DIM>(r, c), msg + (r0 + r) * DIM + c * 8);
    const float* xr = xb + r * DIM + c * 8;
    const float4 a = *reinterpret_cast<const float4*>(xr);
    const float4 b = *reinterpret_cast<const float4*>(xr + 4);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     ax + tile_off<DIM>(r, c)),
                 "r"(pack_bf16(a.x, a.y)), "r"(pack_bf16(a.z, a.w)),
                 "r"(pack_bf16(b.x, b.y)), "r"(pack_bf16(b.z, b.w))
                 : "memory");
  }
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < WSTAGES - 1; ++t) {
    load_wtile(ring, w, t);
    cp_async_commit();
  }
  // tile t has landed and every warp has left tile t - 1, whose slot takes
  // tile t + 2; returns tile t's slot
  auto step = [&](int t) {
    cp_async_wait<WSTAGES - 2>();
    __syncthreads();
    if (t + WSTAGES - 1 < T_ALL) load_wtile(ring, w, t + WSTAGES - 1);
    cp_async_commit();
    return ring + (t % WSTAGES) * WSLOT;
  };
  // this thread's accumulator (mi, j, c): row mi*16 + lane/4 (+8 for c >= 2)
  // of the block, column warp*8*NT + 8j + 2*(lane%4) (+1 for odd c)
  const int rq = lane >> 2, cq = 2 * (lane & 3);

  // out_proj: m2 = bf16(bf16(msg) @ Wout + bout)
  {
    float acc[2][DIM / 64][4];
    zero(acc);
    for (int t = 0; t < T_FC1; ++t)
      mma_stage<DIM, DIM>(acc, am, t * (WK / 8), step(t), warp, lane);
#pragma unroll
    for (int j = 0; j < DIM / 64; ++j) {
      const int col = warp * (DIM / 8) + 8 * j + cq;
      const float2 bb = *reinterpret_cast<const float2*>(bout + col);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          st_pair<DIM>(am2, mi * 16 + rq + 8 * hh, col,
                       pack_bf16(acc[mi][j][2 * hh] + bb.x,
                                 acc[mi][j][2 * hh + 1] + bb.y));
    }
  }

  // fc1: y = bf16(bf16(x) @ W1x + m2 @ W1m + b1), then LayerNorm and gelu
  {
    float acc[2][FF / 64][4];
    zero(acc);
    for (int t = T_FC1; t < T_FC1M; ++t)
      mma_stage<DIM, FF>(acc, ax, (t - T_FC1) * (WK / 8), step(t), warp,
                         lane);
    for (int t = T_FC1M; t < T_FC2; ++t)
      mma_stage<DIM, FF>(acc, am2, (t - T_FC1M) * (WK / 8), step(t), warp,
                         lane);
    // y and this warp's share of each row's sum and sum of squares
    float s1[2][2], s2[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) s1[mi][hh] = s2[mi][hh] = 0.0f;
#pragma unroll
    for (int j = 0; j < FF / 64; ++j) {
      const int col = warp * (FF / 8) + 8 * j + cq;
      const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float y = round_bf16(acc[mi][j][c] + ((c & 1) ? bb.y : bb.x));
          acc[mi][j][c] = y;
          s1[mi][c >> 1] += y;
          s2[mi][c >> 1] += y * y;
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          s1[mi][hh] += __shfl_xor_sync(0xffffffffu, s1[mi][hh], off);
          s2[mi][hh] += __shfl_xor_sync(0xffffffffu, s2[mi][hh], off);
        }
        if ((lane & 3) == 0)
          part[warp * RE + mi * 16 + rq + 8 * hh] =
              make_float2(s1[mi][hh], s2[mi][hh]);
      }
    __syncthreads();  // every warp is past fc1: bf16(x) and m2 are free
    const float cg_ = 0.7978845608028654f;  // sqrt(2 / pi)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mi * 16 + rq + 8 * hh;
        float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float2 ps = part[p * RE + row];
          t1 += ps.x;
          t2 += ps.y;
        }
        const float mu = t1 / FF;
        const float var = fmaxf(t2 / FF - mu * mu, 0.0f);
        const float inv = rsqrtf(var + 1e-6f);
#pragma unroll
        for (int j = 0; j < FF / 64; ++j) {
          const int col = warp * (FF / 8) + 8 * j + cq;
          float gv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float yn = (acc[mi][j][2 * hh + e] - mu) * inv *
                                 lns[col + e] +
                             lnb[col + e];
            gv[e] = 0.5f * yn *
                    (1.0f + tanhf(cg_ * (yn + 0.044715f * yn * yn * yn)));
          }
          st_pair<FF>(g, row, col, pack_bf16(gv[0], gv[1]));
        }
      }
  }

  // fc2 + residual: out = x + bf16(g @ W2 + b2)
  {
    float acc[2][DIM / 64][4];
    zero(acc);
    for (int t = T_FC2; t < T_ALL; ++t)
      mma_stage<FF, DIM>(acc, g, (t - T_FC2) * (WK / 8), step(t), warp, lane);
#pragma unroll
    for (int j = 0; j < DIM / 64; ++j) {
      const int col = warp * (DIM / 8) + 8 * j + cq;
      const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const size_t at = (size_t)(mi * 16 + rq + 8 * hh) * DIM + col;
          const float2 xv = *reinterpret_cast<const float2*>(xb + at);
          *reinterpret_cast<float2*>(out + r0 * DIM + at) = make_float2(
              xv.x + round_bf16(acc[mi][j][2 * hh] + bb.x),
              xv.y + round_bf16(acc[mi][j][2 * hh + 1] + bb.y));
        }
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// q (N, 256), k/v (sets * Kk, 256) bf16; bias (sets, Kk) f32; msg (N, 256)
// bf16. One launch: grid (N / 64, heads, splits) in clusters of `splits`.
extern "C" int gisnav_lg_attention(const void* q, const void* k, const void* v,
                                   const float* bias, void* msg, int N, int Kk,
                                   int heads, int sets, int cross, int splits,
                                   float scale, void* stream) {
  if (heads * DH != DIM || (sets != 1 && sets != 2) || (cross && sets != 2) ||
      N % (BQ * sets) || Kk % BK)
    return -1;
  if ((splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      splits > Kk / BK)
    return -1;
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ATTN_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BQ, heads, splits);
  cfg.blockDim = dim3(attn::THREADS);
  cfg.dynamicSmemBytes = ATTN_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_kernel, (const __nv_bfloat16*)q,
                           (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                           bias, (__nv_bfloat16*)msg, N, Kk, sets, cross,
                           scale);
  if (err != cudaSuccess) return (int)err;
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
  const Weights w{(const __nv_bfloat16*)wout, (const __nv_bfloat16*)w1x,
                  (const __nv_bfloat16*)w1m, (const __nv_bfloat16*)w2};
  ffn_kernel<<<N / RE, ETHREADS, FFN_SMEM, (cudaStream_t)stream>>>(
      x, (const __nv_bfloat16*)msg, w, bout, b1, lns, lnb, b2, out);
  return (int)cudaGetLastError();
}
