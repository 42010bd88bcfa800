// Keypoint NMS + per-cell select for Hopper (sm_90a).
//
// Replaces the TPU kernel `nms_select_pallas` of
// gisnav_tpu/features/pallas_nms.py. In one pass over the (H, W) f32 detector
// heatmap it computes the 9x9 non-maximum suppression (`core >= pooled`),
// border suppression, the 4x4 cell maximum, and each cell's sub-pixel
// keypoint position: a 3x3 soft-argmax (temperature T) on the raw heatmap,
// clipped to +-0.5 px, averaged over the cell's tied survivors.
// Rows and columns outside the image read as zero. The Pallas kernel's
// column roll wraps at row ends instead, but only into columns that border
// suppression zeroes, so the kept values are the same.
//
// The same kernel without the position half (`SELECT` false) replaces
// `nms_cellmax_pallas` of the same file: NMS, border suppression and the cell
// maximum only. Both instances select input values with the same
// comparisons, so their cell maxima are bit-identical.
//
// Bound on an H100: bytes (one read of the heatmap, 3 small writes, ~60
// flops and 9 exps per pixel). Design: a block stages a 32x128 tile plus its
// 4-pixel halo in shared memory once, builds the separable 9-wide row max
// there, and each thread then owns one 4x4 cell end to end, so no cell
// reduction crosses threads and no intermediate map reaches device memory.
#include <cuda_runtime.h>

namespace {

constexpr int R = 4;      // NMS radius
constexpr int TRW = 32;   // tile rows
constexpr int TCL = 128;  // tile columns
constexpr int SR = TRW + 2 * R;
constexpr int SC = TCL + 2 * R;
constexpr int THREADS = (TRW / 4) * (TCL / 4);  // one thread per cell

template <bool SELECT>
__global__ void __launch_bounds__(THREADS)
nms_select(const float* __restrict__ heat, float* __restrict__ cell_max,
           float* __restrict__ cell_x, float* __restrict__ cell_y, int H,
           int W, int border, float inv_t) {
  __shared__ float slab[SR][SC];
  __shared__ float rowmax[SR][TCL];
  const int y0 = blockIdx.y * TRW, x0 = blockIdx.x * TCL;
  const int tid = threadIdx.x;

  for (int i = tid; i < SR * SC; i += THREADS) {
    int r = i / SC, c = i % SC;
    int gy = y0 + r - R, gx = x0 + c - R;
    slab[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                     ? heat[(size_t)gy * W + gx]
                     : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < SR * TCL; i += THREADS) {
    int r = i / TCL, c = i % TCL;
    float m = slab[r][c];
#pragma unroll
    for (int d = 1; d <= 2 * R; ++d) m = fmaxf(m, slab[r][c + d]);
    rowmax[r][c] = m;
  }
  __syncthreads();

  const int cr = tid / (TCL / 4), cc = tid % (TCL / 4);
  const int hb = H / 4, wb = W / 4;
  const int oy = blockIdx.y * (TRW / 4) + cr, ox = blockIdx.x * (TCL / 4) + cc;
  if (oy >= hb || ox >= wb) return;

  float best = 0.0f, sx_sum = 0.0f, sy_sum = 0.0f, cnt = 0.0f;
  for (int p = 0; p < 16; ++p) {
    const int ly = cr * 4 + (p >> 2), lx = cc * 4 + (p & 3);
    const int gy = y0 + ly, gx = x0 + lx;
    const float core = slab[ly + R][lx + R];
    float pooled = rowmax[ly][lx];
#pragma unroll
    for (int d = 1; d <= 2 * R; ++d) pooled = fmaxf(pooled, rowmax[ly + d][lx]);
    const bool keep = core >= pooled && gx >= border && gx < W - border &&
                      gy >= border && gy < H - border;
    const float nms = keep ? core : 0.0f;
    best = fmaxf(best, nms);
    if (!SELECT || !(keep && core > 0.0f)) continue;
    // 3x3 soft-argmax on the raw heatmap, summed in the Pallas order
    float m3 = core;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx)
        m3 = fmaxf(m3, slab[ly + R + dy][lx + R + dx]);
    float s = 0.0f, sx = 0.0f, sy = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        float e = expf((slab[ly + R + dy][lx + R + dx] - m3) * inv_t);
        s += e;
        sx += e * (float)dx;
        sy += e * (float)dy;
      }
    const float ddx = fminf(fmaxf(sx / s, -0.5f), 0.5f);
    const float ddy = fminf(fmaxf(sy / s, -0.5f), 0.5f);
    sx_sum += (float)gx + ddx;
    sy_sum += (float)gy + ddy;
    cnt += 1.0f;
  }
  const float denom = fmaxf(cnt, 1.0f);
  const size_t o = (size_t)oy * wb + ox;
  cell_max[o] = best;
  if (SELECT) {
    cell_x[o] = sx_sum / denom;
    cell_y[o] = sy_sum / denom;
  }
}

}  // namespace

extern "C" int gisnav_nms_select(const float* heat, float* cell_max,
                                 float* cell_x, float* cell_y, int H, int W,
                                 int border, float inv_t, void* stream) {
  if (H % 4 || W % 4) return -1;
  dim3 grid((W + TCL - 1) / TCL, (H + TRW - 1) / TRW);
  nms_select<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      heat, cell_max, cell_x, cell_y, H, W, border, inv_t);
  return (int)cudaGetLastError();
}

extern "C" int gisnav_nms_cellmax(const float* heat, float* cell_max, int H,
                                  int W, int border, void* stream) {
  if (H % 4 || W % 4) return -1;
  dim3 grid((W + TCL - 1) / TCL, (H + TRW - 1) / TRW);
  nms_select<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      heat, cell_max, nullptr, nullptr, H, W, border, 0.0f);
  return (int)cudaGetLastError();
}
