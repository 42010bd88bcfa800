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
// Bound on an H100: operations. conv1b at 1088x1920 is 154 GFLOP against
// ~0.6 GB of traffic. Design: an implicit GEMM on the tensor cores (WMMA
// bf16 m16n16k16). A block owns an 8x16 pixel tile and 64 output channels;
// per 16-channel slice of the input it stages the (8+2)x(16+2) halo patch and
// the 9 tap matrices in shared memory, and each tap is one shifted view of the
// patch (pixel stride 16 channels), so no im2col buffer exists anywhere.
// The stem's 1->64 conv has K = 9, far too thin for the tensor cores: it is a
// direct per-pixel kernel (conv1_cin1) writing the bf16 NHWC intermediate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TR = 8;       // tile rows (one warp each)
constexpr int TC = 16;      // tile columns (= WMMA M)
constexpr int CC = 16;      // input channels per k slice (= WMMA K)
constexpr int NB = 64;      // output channels per block
constexpr int PR = TR + 2;  // patch rows
constexpr int PC = TC + 2;  // patch columns
constexpr int THREADS = TR * 32;

constexpr int PATCH_ELEMS = PR * PC * CC;   // bf16
constexpr int WTILE_ELEMS = 9 * CC * NB;    // bf16
constexpr int STAGE_FLOATS = TR * TC * NB;  // f32 accumulator staging
constexpr int SMEM_BYTES =
    (PATCH_ELEMS + WTILE_ELEMS) * 2 > STAGE_FLOATS * 4
        ? (PATCH_ELEMS + WTILE_ELEMS) * 2
        : STAGE_FLOATS * 4;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// x (H, W, Cin) bf16, w (9, Cin, Cout) bf16 (HWIO), bias (Cout) f32,
// out (H, W, Cout) or pooled (H/2, W/2, Cout) bf16.
__global__ void __launch_bounds__(THREADS)
conv3x3_wmma(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
             int H, int W, int Cin, int Cout, int pool) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wt = patch + PATCH_ELEMS;
  float* stage = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int y0 = blockIdx.y * TR;
  const int x0 = blockIdx.x * TC;
  const int n0 = blockIdx.z * NB;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB / 16];
#pragma unroll
  for (int j = 0; j < NB / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    // halo patch: PR*PC pixels x 16 channels, two 16-byte vectors per pixel
    for (int v = tid; v < PR * PC * 2; v += THREADS) {
      int pix = v >> 1, half = v & 1;
      int py = pix / PC, px = pix - py * PC;
      int gy = y0 + py - 1, gx = x0 + px - 1;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        val = *reinterpret_cast<const uint4*>(
            x + ((size_t)gy * W + gx) * Cin + c0 + half * 8);
      *reinterpret_cast<uint4*>(patch + pix * CC + half * 8) = val;
    }
    // tap matrices: 9 x (16 x 64), 8 bf16 per vector
    for (int v = tid; v < 9 * CC * NB / 8; v += THREADS) {
      int e = v * 8;
      int t = e / (CC * NB);
      int r = (e / NB) % CC;
      int col = e % NB;
      *reinterpret_cast<uint4*>(wt + e) = *reinterpret_cast<const uint4*>(
          w + ((size_t)t * Cin + c0 + r) * Cout + n0 + col);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      int dy = t / 3, dx = t % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, patch + ((warp + dy) * PC + dx) * CC, CC);
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wt + t * CC * NB + j * 16, NB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }

  // epilogue: staging [pixel (row*16+col)][64 channels] f32
#pragma unroll
  for (int j = 0; j < NB / 16; ++j)
    wmma::store_matrix_sync(stage + warp * TC * NB + j * 16, acc[j], NB,
                            wmma::mem_row_major);
  __syncthreads();

  if (!pool) {
    for (int e = tid; e < TR * TC * NB; e += THREADS) {
      int pix = e / NB, n = e % NB;
      int gy = y0 + pix / TC, gx = x0 + pix % TC;
      if (gy >= H || gx >= W) continue;
      float v = fmaxf(round_bf16(stage[e]) + bias[n0 + n], 0.0f);
      out[((size_t)gy * W + gx) * Cout + n0 + n] = __float2bfloat16(v);
    }
  } else {
    const int Ho = H / 2, Wo = W / 2;
    for (int e = tid; e < (TR / 2) * (TC / 2) * NB; e += THREADS) {
      int pix = e / NB, n = e % NB;
      int py = pix / (TC / 2), px = pix % (TC / 2);
      int gy = y0 / 2 + py, gx = x0 / 2 + px;
      if (gy >= Ho || gx >= Wo) continue;
      float b = bias[n0 + n];
      float m = 0.0f;  // relu outputs are >= 0
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int p = (2 * py + (k >> 1)) * TC + 2 * px + (k & 1);
        m = fmaxf(m, fmaxf(round_bf16(stage[p * NB + n]) + b, 0.0f));
      }
      out[((size_t)gy * Wo + gx) * Cout + n0 + n] = __float2bfloat16(m);
    }
  }
}

// Stem conv1a: (H, W) f32 image -> (H, W, 64) bf16, weights (9, 64) f32
// holding bf16 values. The image is rounded to bf16 as the reference does.
__global__ void conv1_cin1(const float* __restrict__ img,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int H, int W) {
  __shared__ float ws[9 * 64];
  __shared__ float bs[64];
  for (int i = threadIdx.x; i < 9 * 64; i += blockDim.x) ws[i] = w[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) bs[i] = bias[i];
  __syncthreads();
  int gx = blockIdx.x * blockDim.x + threadIdx.x;
  int gy = blockIdx.y;
  if (gx >= W) return;
  float tap[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    int yy = gy + t / 3 - 1, xx = gx + t % 3 - 1;
    tap[t] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                 ? round_bf16(img[(size_t)yy * W + xx])
                 : 0.0f;
  }
  __nv_bfloat16* o = out + ((size_t)gy * W + gx) * 64;
#pragma unroll 4
  for (int n = 0; n < 64; n += 2) {
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      s0 = fmaf(tap[t], ws[t * 64 + n], s0);
      s1 = fmaf(tap[t], ws[t * 64 + n + 1], s1);
    }
    __nv_bfloat162 pr;
    pr.x = __float2bfloat16(fmaxf(round_bf16(s0) + bs[n], 0.0f));
    pr.y = __float2bfloat16(fmaxf(round_bf16(s1) + bs[n + 1], 0.0f));
    *reinterpret_cast<__nv_bfloat162*>(o + n) = pr;
  }
}

}  // namespace

extern "C" int gisnav_conv3x3(const void* x, const void* w, const float* bias,
                              void* out, int H, int W, int Cin, int Cout,
                              int pool, void* stream) {
  if (Cin % CC || Cout % NB || (pool && (H % 2 || W % 2))) return -1;
  dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, Cout / NB);
  conv3x3_wmma<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, bias,
      (__nv_bfloat16*)out, H, W, Cin, Cout, pool);
  return (int)cudaGetLastError();
}

extern "C" int gisnav_conv1_cin1(const float* img, const float* w,
                                 const float* bias, void* out, int H, int W,
                                 void* stream) {
  dim3 grid((W + 127) / 128, H);
  conv1_cin1<<<grid, 128, 0, (cudaStream_t)stream>>>(
      img, w, bias, (__nv_bfloat16*)out, H, W);
  return (int)cudaGetLastError();
}
