// SuperPoint VGG-trunk convolutions for Hopper (sm_90a).
//
// Replaces the TPU kernels `stem_stage_pallas` and `conv_stage_pallas` of
// gisnav_tpu/features/pallas_conv.py. Computes, per launch, one 3x3 SAME
// convolution with bf16 operands and f32 accumulation, then the epilogue of
// the JAX reference `vgg_stage_reference`: the conv sum rounded to bf16, plus
// the f32 bias, relu, rounded to bf16 again, and optionally the 2x2 maxpool.
// A VGG stage is two launches with the bf16 intermediate in device memory;
// SAME zero padding of the second conv then comes for free.
//
// Bound on an H100: operations (conv1b at 1088x1920 is 154 GFLOP against
// ~0.3 GB of traffic), so what counts is the share of the tensor cores' rate
// that the inner loop reaches, and that is set by shared-memory traffic per
// product and by what overlaps. Design, `conv3x3_wgmma`:
//
// * An implicit GEMM on `wgmma.m64n64k16` (bf16, f32 accumulators in
//   registers). A block of two warpgroups owns an 8x16 pixel tile and 64
//   output channels (32 accumulators a thread, so two blocks fit an SM
//   without spills; 128-channel blocks spilled and were no faster); K walks
//   9 taps x Cin in steps of one tap and 64 channels.
// * A comes from registers. The (8+2)x(16+2) halo patch of the tile lies in
//   shared memory, 128 bytes a pixel and 64-channel slice, its 16-byte chunks
//   XOR-swizzled by pixel index. `ldmatrix` takes one address a lane, so a
//   tap is a shifted view of the patch at no cost and any pixel can sit in
//   any row of the 64-row tile: no im2col buffer exists, and the rows are
//   ordered for the pool (below). A shared-memory descriptor could not
//   express rows that jump at the end of a patch line, and TMA's im2col mode
//   would load each pixel once a tap instead of once; hence registers.
// * B is one tap's 64 x 64 weight tile, rows of 64 output channels (128
//   bytes) as they lie in the (9, Cin, Cout) tensor, under the 128-byte
//   swizzle, read by descriptor (transposed B, "MN-major").
// * Convs of 64 input channels (conv1b and stage 2 are two thirds of the
//   trunk's flops) keep all nine taps of their 64 output channels (72 KB)
//   resident: a block is persistent, loads them once and walks pixel tiles.
//   128 input channels stream weight tiles through a 4-stage `cp.async`
//   ring, two steps ahead, one barrier a step. Two blocks share an SM, so one
//   block's loads and epilogue run under the other's products; within a block
//   the next step's `ldmatrix` runs under the current step's `wgmma` (two A
//   register sets), and the next tile's patch is requested before the
//   epilogue of the current one.
// * The epilogue stays in registers: round, bias, relu, round on the
//   accumulator fragment. A warp's 16 rows are a 2x8 pixel patch with the two
//   image rows in the fragment's two row halves, so three of a pool window's
//   partners lie in one thread and its `__shfl_xor 4` neighbour. bf16 pairs
//   are transposed inside each quad by shuffles so that every thread stores
//   16 bytes of 8 consecutive channels.
//
// * The stem (`STEM`, one launch for conv1a + conv1b [+ pool]) is the
//   resident 64-channel variant whose patch stage computes conv1a instead of
//   loading it: the 1->64 conv has K = 9, far too thin for the tensor cores,
//   so the block `cp.async`es the tile's (8+4)x(16+4) f32 image window (zero
//   outside the image) and rounds it to bf16 once, and its threads compute
//   the 64 conv1a channels of each (8+2)x(16+2) patch pixel on the CUDA
//   cores (f32 `fmaf` over the nine taps in order, round, bias, relu, round;
//   zero for a patch pixel outside the image, conv1b's SAME padding) straight
//   into the swizzled patch, two pixels of a row at a time. The (H, W, 64)
//   intermediate never exists. The next tile's window is requested as soon
//   as the patch is built, under this tile's products; the halo recompute
//   (1.4x conv1a's work) runs under the other block's `wgmma`.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::ldmatrix_x4;
using ptx::pack_bf16;
using ptx::smem_u32;

constexpr int TH = 8;         // tile rows
constexpr int TW = 16;        // tile columns
constexpr int PW = TW + 2;    // patch columns
constexpr int PATCH_PIX = (TH + 2) * PW;
constexpr int SLICE_BYTES = PATCH_PIX * 128;  // one 64-channel patch slice
constexpr int NB = 64;        // output channels of a block
constexpr int WT = 64 * 128;  // weight tile: 64 k rows x 64 output channels
constexpr int THREADS = 256;  // two warpgroups
constexpr int WSTAGES = 4;    // weight ring of the streaming variant
constexpr int WINW = TW + 4;  // stem: image window columns
constexpr int WIN_PIX = (TH + 4) * WINW;
// stem: conv1a's f32 weights (9 x 64) and bias (64), the f32 image window
constexpr int STEM_BYTES = (9 * 64 + 64 + WIN_PIX) * 4;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 4-byte async copy global -> shared; `bytes` = 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// makes shared memory written by cp.async visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// descriptor of a 16 x 64 slice (k rows x output channels) of a weight panel
// under the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes
// apart (one 64-channel panel an instruction, so no second panel stride)
__device__ __forceinline__ uint64_t weight_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32 over the warpgroup) += a (64 x 16 bf16 from registers) .
// b (16 x 64 bf16 by descriptor, transposed)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// v[i] of the quad's lane t -> v[t] of lane i (lanes by quad index q)
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const uint32_t recv =
        __shfl_xor_sync(0xffffffffu, (q & 1) ? v[i] : v[i + 1], 1);
    if (q & 1)
      v[i] = recv;
    else
      v[i + 1] = recv;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t recv =
        __shfl_xor_sync(0xffffffffu, (q & 2) ? v[i] : v[i + 2], 2);
    if (q & 2)
      v[i] = recv;
    else
      v[i + 2] = recv;
  }
}

// CIN = 64 keeps its nine weight tiles resident, CIN = 128 streams; the
// stem (CIN = 64) adds conv1a's weights and its image window
template <int CIN, bool STEM>
__host__ __device__ constexpr int conv_smem_bytes() {
  return 1024 + (CIN == 64 ? 9 : WSTAGES) * WT + (CIN / 64) * SLICE_BYTES +
         NB * 4 + (STEM ? STEM_BYTES : 0);
}

// x (H, W, CIN) bf16, w (9, CIN, Cout) bf16 (HWIO), bias (Cout) f32,
// out (H, W, Cout) or pooled (H/2, W/2, Cout) bf16. grid (blocks walking
// the pixel tiles, Cout / NB). STEM: x is the (H, W) f32 image, CIN = 64
// channels of conv1a come from it with weights wa (9, 64) bf16 and bias ba
// (64) f32.
template <int CIN, bool STEM>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_wgmma(const void* __restrict__ xin,
              const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
              int H, int W, int Cout, int pool, int tiles_x, int ntiles,
              const __nv_bfloat16* __restrict__ wa,
              const float* __restrict__ ba) {
  static_assert(!STEM || CIN == 64, "the stem's conv1b has 64 inputs");
  constexpr int SL = CIN / 64;  // 64-channel slices
  constexpr int NS = 9 * SL;    // k steps: one tap of one slice
  constexpr bool RESIDENT = CIN == 64;
  constexpr int NST = RESIDENT ? NS : WSTAGES;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xin);
  const float* img = static_cast<const float*>(xin);

  extern __shared__ unsigned char raw[];
  // the 128-byte swizzle of the weight tiles counts from 1024-byte lines
  const uint32_t wsm = (smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t psm = wsm + NST * WT;
  float* bias_s = reinterpret_cast<float*>(raw + (psm - smem_u32(raw)) +
                                           SL * SLICE_BYTES);
  float* wa_s = bias_s + NB;   // stem: conv1a weights, tap-major
  float* ba_s = wa_s + 9 * 64;  // stem: conv1a bias
  float* win_s = ba_s + 64;     // stem: the tile's image window

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wq = (tid >> 5) & 3;
  const int n0 = blockIdx.y * NB;
  for (int i = tid; i < NB; i += THREADS) bias_s[i] = bias[n0 + i];
  if (STEM) {
    for (int i = tid; i < 9 * 64; i += THREADS)
      wa_s[i] = __bfloat162float(wa[i]);
    for (int i = tid; i < 64; i += THREADS) ba_s[i] = ba[i];
  }

  auto load_patch = [&](int tile) {
    const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
    for (int v = tid; v < SL * PATCH_PIX * 8; v += THREADS) {
      const int sl = v / (PATCH_PIX * 8), rem = v % (PATCH_PIX * 8);
      const int pix = rem >> 3, ch = rem & 7;
      const int gy = y0 + pix / PW - 1, gx = x0 + pix % PW - 1;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const __nv_bfloat16* src =
          ok ? x + ((size_t)gy * W + gx) * CIN + sl * 64 + ch * 8 : x;
      cp_async16(psm + sl * SLICE_BYTES + pix * 128 + ((ch ^ (pix & 7)) << 4),
                 src, ok ? 16 : 0);
    }
  };
  // stem: the image rows y0 - 2 .. y0 + TH + 1, columns x0 - 2 .. x0 + TW + 1
  auto load_window = [&](int tile) {
    const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
    for (int v = tid; v < WIN_PIX; v += THREADS) {
      const int gy = y0 - 2 + v / WINW, gx = x0 - 2 + v % WINW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(smem_u32(win_s + v), ok ? img + (size_t)gy * W + gx : img,
                ok ? 4 : 0);
    }
  };
  // stem: conv1a of every patch pixel into the swizzled patch, with the
  // arithmetic of a direct conv (fmaf over the taps in order, from 0) on the
  // window's bf16-rounded values. A thread always owns the same 8 channels
  // and takes two neighbouring pixels of a patch row at a time (PW is even),
  // so their 12 window values and each tap's 8 weights are read once for
  // both: 256 threads = 32 pixel pairs a pass
  auto build_patch = [&](int tile) {
    const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
    const int ch = tid & 7;
    const float4 bl = *reinterpret_cast<const float4*>(ba_s + ch * 8);
    const float4 bh = *reinterpret_cast<const float4*>(ba_s + ch * 8 + 4);
    const float bb[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
    for (int pp = tid >> 3; pp < PATCH_PIX / 2; pp += THREADS / 8) {
      const int pix = 2 * pp, py = pix / PW, px = pix % PW;
      const int gy = y0 + py - 1, gx = x0 + px - 1;
      const bool row_in = gy >= 0 && gy < H;
      const bool in0 = row_in && gx >= 0 && gx < W;
      const bool in1 = row_in && gx + 1 < W;  // gx + 1 >= 0 always
      float s[2][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[0][i] = s[1][i] = 0.0f;
      if (in0 || in1) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* wr = win_s + (py + dy) * WINW + px;
          const float2 ta = *reinterpret_cast<const float2*>(wr);
          const float2 tb = *reinterpret_cast<const float2*>(wr + 2);
          const float tv[4] = {ta.x, ta.y, tb.x, tb.y};
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* wt = wa_s + (dy * 3 + dx) * 64 + ch * 8;
            const float4 w0 = *reinterpret_cast<const float4*>(wt);
            const float4 w1 = *reinterpret_cast<const float4*>(wt + 4);
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              s[0][i] = fmaf(tv[dx], wv[i], s[0][i]);
              s[1][i] = fmaf(tv[dx + 1], wv[i], s[1][i]);
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t pk[4] = {0u, 0u, 0u, 0u};
        if (e ? in1 : in0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 r = __bfloat1622float2(
                __floats2bfloat162_rn(s[e][2 * i], s[e][2 * i + 1]));
            pk[i] = pack_bf16(fmaxf(r.x + bb[2 * i], 0.0f),
                              fmaxf(r.y + bb[2 * i + 1], 0.0f));
          }
        }
        const int p = pix + e;
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         psm + p * 128 + ((ch ^ (p & 7)) << 4)),
                     "r"(pk[0]), "r"(pk[1]), "r"(pk[2]), "r"(pk[3])
                     : "memory");
      }
    }
  };
  // step s = slice s / 9, tap s % 9: 64 k rows of 64 output channels
  auto load_weights = [&](int s, int stage) {
    const __nv_bfloat16* src0 =
        w + ((size_t)((s % 9) * CIN + (s / 9) * 64)) * Cout + n0;
    for (int v = tid; v < 512; v += THREADS) {
      const int k = v >> 3, ch = v & 7;
      cp_async16(wsm + stage * WT + k * 128 + ((ch ^ (k & 7)) << 4),
                 src0 + (size_t)k * Cout + ch * 8);
    }
  };
  auto prologue = [&](int tile, bool first) {
    if (STEM)
      load_window(tile);
    else
      load_patch(tile);
    if (RESIDENT) {
      if (first)
        for (int s = 0; s < NS; ++s) load_weights(s, s);
      cp_async_commit();
    } else {
      load_weights(0, 0);
      cp_async_commit();
      load_weights(1, 1);
      cp_async_commit();
    }
  };

  // this lane's ldmatrix row: fragment row r of warp wq is pixel
  // (2 wq + r / 8, 8 wg + r % 8) of the tile; lanes 16.. take the upper
  // 8 channels of a 16-channel step
  const int pp0 = (2 * wq + ((lane >> 3) & 1)) * PW + 8 * wg + (lane & 7);
  const int kc = lane >> 4;

  int tile = blockIdx.x;
  if (tile < ntiles) prologue(tile, true);
  while (tile < ntiles) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    // two A register sets: the next step's ldmatrix runs under this step's
    // products
    uint32_t a[2][4][4];

    if (RESIDENT) {
      cp_async_wait<0>();
      // stem: each thread rounds the window values its own copies brought
      if (STEM)
        for (int v = tid; v < WIN_PIX; v += THREADS)
          win_s[v] = round_bf16(win_s[v]);
      fence_proxy_async();
      __syncthreads();
    }
    if (STEM) {
      build_patch(tile);
      __syncthreads();  // the patch is whole, every thread has left the window
      if (tile + (int)gridDim.x < ntiles) load_window(tile + gridDim.x);
      cp_async_commit();
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!RESIDENT) {
        // step s has landed; every warp is past the products of step s - 2
        // (it waited for them at the end of step s - 1 at the latest), whose
        // stage takes step s + 2
        cp_async_wait<1>();
        fence_proxy_async();
        __syncthreads();
        if (s + 2 < NS) load_weights(s + 2, (s + 2) % WSTAGES);
        cp_async_commit();
      }
      const int pp = pp0 + ((s % 9) / 3) * PW + (s % 9) % 3;
      const uint32_t arow = psm + (s / 9) * SLICE_BYTES + pp * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(a[s & 1][kk], arow + (((kk * 2 + kc) ^ (pp & 7)) << 4));
      wgmma_fence();
      const uint32_t wst = wsm + (RESIDENT ? s : s % WSTAGES) * WT;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16(acc, a[s & 1][kk], weight_desc(wst + kk * 2048));
      wgmma_commit();
      wgmma_wait<1>();  // step s - 1 is done: its A registers are free
    }
    wgmma_wait<0>();
    __syncthreads();  // every warp has left the patch and the ring
    const int next = tile + gridDim.x;
    if (!STEM && next < ntiles) prologue(next, false);

    // epilogue on the fragment: thread holds rows g and g + 8 of its warp,
    // i.e. pixels (2 wq, 8 wg + g) and (2 wq + 1, 8 wg + g) of the tile,
    // channels 8 j + 2 q, + 1 of every 8-channel chunk j
    const int g = lane >> 2, q = lane & 3;
    const int gy = (tile / tiles_x) * TH + 2 * wq;
    const int gx = (tile % tiles_x) * TW + 8 * wg + g;
#pragma unroll
    for (int jm = 0; jm < 2; ++jm) {
      uint32_t v[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * jm + i;
        const float2 b =
            *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * q);
        float e[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          e[c] = fmaxf(
              round_bf16(acc[4 * j + c]) + ((c & 1) ? b.y : b.x), 0.0f);
        if (pool) {
          e[0] = fmaxf(e[0], e[2]);
          e[1] = fmaxf(e[1], e[3]);
          e[0] = fmaxf(e[0], __shfl_xor_sync(0xffffffffu, e[0], 4));
          e[1] = fmaxf(e[1], __shfl_xor_sync(0xffffffffu, e[1], 4));
        }
        v[0][i] = pack_bf16(e[0], e[1]);
        v[1][i] = pack_bf16(e[2], e[3]);
      }
      // after the transpose this thread holds chunk 4 jm + q whole
      const int n = n0 + (4 * jm + q) * 8;
      quad_transpose(v[0], q);
      if (pool) {
        if (!(g & 1) && gy < H && gx < W)
          *reinterpret_cast<uint4*>(
              out + ((size_t)(gy >> 1) * (W >> 1) + (gx >> 1)) * Cout + n) =
              make_uint4(v[0][0], v[0][1], v[0][2], v[0][3]);
      } else {
        quad_transpose(v[1], q);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (gy + r < H && gx < W)
            *reinterpret_cast<uint4*>(
                out + ((size_t)(gy + r) * W + gx) * Cout + n) =
                make_uint4(v[r][0], v[r][1], v[r][2], v[r][3]);
      }
    }
    tile = next;
  }
  cp_async_wait<0>();
}

template <int CIN, bool STEM = false>
int launch_conv(const void* x, const void* w, const float* bias, void* out,
                int H, int W, int Cout, int pool, int sms,
                cudaStream_t stream, const void* wa = nullptr,
                const float* ba = nullptr) {
  constexpr int smem = conv_smem_bytes<CIN, STEM>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgmma<CIN, STEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW;
  const int ntiles = tiles_x * ((H + TH - 1) / TH);
  // two blocks an SM, each walking every (2 * sms)-th tile
  dim3 grid(ntiles < 2 * sms ? ntiles : 2 * sms, Cout / NB);
  conv3x3_wgmma<CIN, STEM><<<grid, THREADS, smem, stream>>>(
      x, (const __nv_bfloat16*)w, bias, (__nv_bfloat16*)out, H, W, Cout, pool,
      tiles_x, ntiles, (const __nv_bfloat16*)wa, ba);
  return (int)cudaGetLastError();
}

int sm_count(int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace

// Cin in {64, 128}, Cout a multiple of 64; H and W even when pooling
extern "C" int gisnav_conv3x3(const void* x, const void* w, const float* bias,
                              void* out, int H, int W, int Cin, int Cout,
                              int pool, void* stream) {
  if ((Cin != 64 && Cin != 128) || Cout % 64 || Cout < 64 || H < 1 || W < 1 ||
      (pool && (H % 2 || W % 2)))
    return -1;
  int sms = 0;
  if (int err = sm_count(sms)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return Cin == 64
             ? launch_conv<64>(x, w, bias, out, H, W, Cout, pool, sms, s)
             : launch_conv<128>(x, w, bias, out, H, W, Cout, pool, sms, s);
}

// The stem in one launch: img (H, W) f32; conv1a w1a (9, 64) bf16, b1a (64)
// f32; conv1b w1b (9, 64, 64) bf16, b1b (64) f32; out (H, W, 64) or pooled
// (H/2, W/2, 64) bf16. H and W even when pooling.
extern "C" int gisnav_stem(const float* img, const void* w1a, const float* b1a,
                           const void* w1b, const float* b1b, void* out, int H,
                           int W, int pool, void* stream) {
  if (H < 1 || W < 1 || (pool && (H % 2 || W % 2))) return -1;
  int sms = 0;
  if (int err = sm_count(sms)) return err;
  return launch_conv<64, true>(img, w1b, b1b, out, H, W, 64, pool, sms,
                               (cudaStream_t)stream, w1a, b1a);
}
