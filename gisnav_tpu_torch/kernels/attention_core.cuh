// Two-sweep masked-attention core for Hopper (sm_90a), shared device code.
//
// One block of 4 warps owns 64 query rows of one head (16 rows a warp) and a
// range of 64-key tiles. Both sweeps keep the logits in the accumulator
// fragments of `mma.sync.m16n8k16` (bf16 operands, f32 sums):
//
//   sweep 1 (`sweep_stats`): per row the running max m and the sum l of
//     exp(logit - m) over the block's keys;
//   sweep 2 (`sweep_pv`): with the final m and 1/l of the whole row,
//     P = bf16(exp(logit - m) / l) is packed in registers into the A operand
//     of the second product and O += P.V accumulates in registers.
//
// Partial (m, l) of key ranges merge exactly with `merge_stats`; partial O
// of key ranges add. K, V and the key bias arrive through a ring of STAGES
// shared-memory stages filled by `cp.async`; the tiles are XOR-swizzled by
// 16-byte chunk so that every `ldmatrix` is free of bank conflicts.
//
// A tile is addressed as 64 rows of D contiguous bf16 at a row stride `ld`
// (elements): a head of a (K, H, D) tensor is the column slice h*D of its
// (K, H*D) matrix, and the column slice h*64 of a (N, 256) activation is the
// same thing. The caller owns the result fragment `o` and stores it as it
// likes (f32 or bf16, global or shared), see `acc_row` / `acc_col`.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ptx.cuh"

namespace attn {

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 128;  // 4 warps, 16 query rows each
constexpr int STAGES = 3;     // ring depth

using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::ldmatrix_x4;
using ptx::ldmatrix_x4_trans;
using ptx::pack_bf16;
using ptx::smem_u32;

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile of
// D bf16 a row: 8 rows of one chunk column fall into 8 different banks
template <int D>
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  constexpr int CH = D / 8;
  const int sw = CH >= 8 ? (row & 7) : ((row >> 1) & 3);
  return static_cast<uint32_t>(row * CH + (chunk ^ sw)) * 16u;
}

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * D * 2;
}

// one ring stage: K tile, V tile (sweep 2 only), 64 f32 of key bias
template <int D, bool WITH_V>
__host__ __device__ constexpr int stage_bytes() {
  return (WITH_V ? 2 : 1) * tile_bytes<D>() + BK * 4;
}

template <int D, bool WITH_V>
__host__ __device__ constexpr int ring_bytes() {
  return tile_bytes<D>() + STAGES * stage_bytes<D, WITH_V>();
}

// where a head's keys, values and bias lie
struct KeySource {
  const __nv_bfloat16* k;  // first key row of the head's column slice
  const __nv_bfloat16* v;
  const float* bias;  // additive f32 bias a key
  size_t ld;          // row stride of k and v in elements
};

// 64 rows x D bf16 from `src` (row stride ld) into the swizzled tile at dst
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                size_t ld) {
  constexpr int CH = D / 8;
  for (int v = threadIdx.x; v < 64 * CH; v += THREADS) {
    const int r = v / CH, c = v % CH;
    cp_async16(dst + tile_off<D>(r, c), src + (size_t)r * ld + c * 8);
  }
}

template <int D, bool WITH_V>
__device__ __forceinline__ void load_stage_async(uint32_t stage,
                                                 const KeySource& src,
                                                 int tile) {
  const size_t row0 = (size_t)tile * BK;
  load_tile_async<D>(stage, src.k + row0 * src.ld, src.ld);
  if (WITH_V)
    load_tile_async<D>(stage + tile_bytes<D>(), src.v + row0 * src.ld, src.ld);
  if (threadIdx.x < BK / 4)
    cp_async16(stage + (WITH_V ? 2 : 1) * tile_bytes<D>() + threadIdx.x * 16,
               src.bias + row0 + threadIdx.x * 4);
}

// the warp's 16 query rows as A fragments, one per 16 columns of D
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             uint32_t qs, int warp, int lane) {
  const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + tile_off<D>(row, kk * 2 + (lane >> 4)));
}

// x[j][c]: logits of the warp's 16 rows against the tile's 64 keys,
// scale * (q . k) + bias, each operation rounded on its own as the plain
// version rounds. Fragment j holds keys 8j..8j+7; c = 0, 1 are row
// lane/4 at keys 8j + 2*(lane%4) + c, c = 2, 3 the same keys at row + 8.
template <int D>
__device__ __forceinline__ void tile_logits(float (&x)[8][4],
                                            const uint32_t (&qf)[D / 16][4],
                                            uint32_t ks, const float* bias_s,
                                            float scale, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.0f;
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + tile_off<D>(jp * 16 + r + (mat >> 1) * 8,
                                      kk * 2 + (mat & 1)));
      mma_16816(x[2 * jp], qf[kk], b[0], b[1]);
      mma_16816(x[2 * jp + 1], qf[kk], b[2], b[3]);
    }
  }
  const float2* b2 = reinterpret_cast<const float2*>(bias_s) + (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = b2[4 * j];
    x[j][0] = __fadd_rn(__fmul_rn(x[j][0], scale), b.x);
    x[j][1] = __fadd_rn(__fmul_rn(x[j][1], scale), b.y);
    x[j][2] = __fadd_rn(__fmul_rn(x[j][2], scale), b.x);
    x[j][3] = __fadd_rn(__fmul_rn(x[j][3], scale), b.y);
  }
}

// exact merge of two partial softmax statistics
__device__ __forceinline__ void merge_stats(float& m, float& l, float m2,
                                            float l2) {
  const float mn = fmaxf(m, m2);
  l = __fadd_rn(__fmul_rn(l, __expf(m - mn)), __fmul_rn(l2, __expf(m2 - mn)));
  m = mn;
}

// Fills the first STAGES - 1 stages of the ring at `ring` with tiles t0...
// and waits for the Q tile, whose cp.async group the caller committed just
// before; returns with the Q tile visible to the whole block.
template <int D, bool WITH_V>
__device__ __forceinline__ void ring_fill(uint32_t ring, const KeySource& src,
                                          int t0, int t1) {
  constexpr int SB = stage_bytes<D, WITH_V>();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t0 + i < t1) load_stage_async<D, WITH_V>(ring + i * SB, src, t0 + i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
}

// Runs `body(stage offset from ring)` over tiles [t0, t1) after `ring_fill`.
// One barrier a tile: the stage refilled after it is the one that every warp
// finished reading before it.
template <int D, bool WITH_V, typename Body>
__device__ __forceinline__ void ring_loop(uint32_t ring, const KeySource& src,
                                          int t0, int t1, Body body) {
  constexpr int SB = stage_bytes<D, WITH_V>();
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = t + STAGES - 1;
    if (nxt < t1)
      load_stage_async<D, WITH_V>(ring + ((nxt - t0) % STAGES) * SB, src, nxt);
    cp_async_commit();
    body(((t - t0) % STAGES) * SB);
  }
}

// Sweep 1 over tiles [t0, t1): on return m[i], l[i] (i = 0: row lane/4 of
// the warp's 16, i = 1: row + 8) hold the row's max and sum over those keys,
// equal in the four lanes of a quad. `smem` holds the Q tile, whose cp.async
// group the caller has just committed, then the ring.
template <int D>
__device__ __forceinline__ void sweep_stats(unsigned char* smem,
                                            const KeySource& src, int t0,
                                            int t1, float scale, float (&m)[2],
                                            float (&l)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t qs = smem_u32(smem), ring = qs + tile_bytes<D>();
  uint32_t qf[D / 16][4];
  m[0] = m[1] = -CUDART_INF_F;
  l[0] = l[1] = 0.0f;
  ring_fill<D, false>(ring, src, t0, t1);
  load_q_frags<D>(qf, qs, warp, lane);
  ring_loop<D, false>(ring, src, t0, t1, [&](int stage) {
    float x[8][4];
    const float* bias_s = reinterpret_cast<const float*>(
        smem + tile_bytes<D>() + stage + tile_bytes<D>());
    tile_logits<D>(x, qf, ring + stage, bias_s, scale, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = x[0][2 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tmax = fmaxf(tmax, fmaxf(x[j][2 * i], x[j][2 * i + 1]));
      const float mn = fmaxf(m[i], tmax);
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part += __expf(x[j][2 * i] - mn) + __expf(x[j][2 * i + 1] - mn);
      l[i] = l[i] * __expf(m[i] - mn) + part;
      m[i] = mn;
    }
  });
  // each lane kept the statistics of its own 16 keys a tile: merge the quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], off);
      merge_stats(m[i], l[i], m2, l2);
    }
  }
}

// Sweep 2 over tiles [t0, t1): o += bf16(exp(logit - m) * inv_l) . V with
// the rows' final m and 1/l. o[n][c]: columns 8n + 2*(lane%4) + (c&1) of D,
// row lane/4 (c < 2) or row + 8 (c >= 2) of the warp's 16.
template <int D>
__device__ __forceinline__ void sweep_pv(unsigned char* smem,
                                         const KeySource& src, int t0, int t1,
                                         float scale, const float (&m)[2],
                                         const float (&inv_l)[2],
                                         float (&o)[D / 8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t qs = smem_u32(smem), ring = qs + tile_bytes<D>();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  const int mat = lane >> 3, r = lane & 7;
  ring_fill<D, true>(ring, src, t0, t1);
  load_q_frags<D>(qf, qs, warp, lane);
  ring_loop<D, true>(ring, src, t0, t1, [&](int stage) {
    float x[8][4];
    const float* bias_s = reinterpret_cast<const float*>(
        smem + tile_bytes<D>() + stage + 2 * tile_bytes<D>());
    tile_logits<D>(x, qf, ring + stage, bias_s, scale, lane);
    const uint32_t vs = ring + stage + tile_bytes<D>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = 2 * kk + (h >> 1), i = h & 1;
        a[h] = pack_bf16(__expf(x[j][2 * i] - m[i]) * inv_l[i],
                         __expf(x[j][2 * i + 1] - m[i]) * inv_l[i]);
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + tile_off<D>(kk * 16 + r + (mat & 1) * 8,
                                              np * 2 + (mat >> 1)));
        mma_16816(o[2 * np], a, b[0], b[1]);
        mma_16816(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  });
}

// row (of the block's 64) and first column (of D) of o[n][c], c in {0, 2}
__device__ __forceinline__ int acc_row(int c) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + (c >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int n) {
  return n * 8 + 2 * (threadIdx.x & 3);
}

}  // namespace attn
